"""Quadrature FM discriminator.

Counterpart of ``fm_radio_tpu/ops/discriminator.py`` (parity:
``FM_Demod::Process``, ``fm_demod.cpp:30-45``): y[n] = wrap(theta[n] -
theta[n-1]) / (2*pi*Fd*Ts) * 0.5, carrying the previous phase.  The 0.5 is
compensated by the x2 of the audio mix (``broadcast_fm_demod.cpp:582-584``).
"""

from __future__ import annotations

import math

import torch

from fm_radio_tpu_torch.ops.cmath import f32, wrap_phase


def disc_scale(fd: float, fs: float) -> float:
    """Discriminator gain 1/(2*pi*Fd*Ts)*0.5 as a float32 scalar."""
    return f32(1.0 / (2.0 * math.pi * fd * (1.0 / fs)) * 0.5)


def discriminate_theta(prev_theta: torch.Tensor, theta: torch.Tensor,
                       scale: float):
    """Phase track theta [C, N] (rad) -> (theta[:, -1], wrapped difference
    times ``scale``), with ``prev_theta`` [C] as theta[-1]."""
    prev = torch.cat([prev_theta[:, None], theta[:, :-1]], dim=-1)
    return theta[:, -1], wrap_phase(theta - prev) * scale


def fm_discriminate_p(prev_theta: torch.Tensor, xp, fd: float, fs: float):
    """xp = (re [C, N], im [C, N]) f32.  Returns (new_prev_theta [C],
    y [C, N])."""
    xr, xi = xp
    return discriminate_theta(prev_theta, torch.atan2(xi, xr),
                              disc_scale(fd, fs))
