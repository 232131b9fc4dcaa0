"""Block-level automatic gain control.

Counterpart of ``fm_radio_tpu/ops/agc.py`` (parity: ``AGC_Filter``,
``src/dsp/agc.h:6-31``): one gain update per block — measure the average
power, track the gain toward sqrt(target / power) with beta = 0.2, scale the
block by the updated gain.  Only the scalar gain is carried.
"""

from __future__ import annotations

import torch

from fm_radio_tpu_torch.ops.cmath import div_scalar, f32


def agc_init_state(channels: int, device=None) -> torch.Tensor:
    """Initial gain 0.1 per channel (``agc.h:10``)."""
    return torch.full((channels,), 0.1, dtype=torch.float32, device=device)


def mean_last(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis: the sum divided by the count, as
    ``jnp.mean`` divides."""
    return div_scalar(torch.sum(x, dim=-1), x.shape[-1])


def _agc_gain(gain, avg_power, target_power, beta):
    # on silence hold the gain instead of driving it to inf/NaN
    safe_power = torch.clamp(avg_power, min=f32(1e-20))
    target_gain = torch.sqrt(torch.full_like(safe_power, f32(target_power))
                             / safe_power)
    return torch.where(avg_power > f32(1e-12),
                       gain + f32(beta) * (target_gain - gain), gain)


def agc_update_gain(gain, xp, target_power: float = 1.0, beta: float = 0.2):
    """Track the gain state without applying it (the pilot PLL's phase
    detector is amplitude-invariant)."""
    xr, xi = xp
    return _agc_gain(gain, mean_last(xr * xr + xi * xi), target_power, beta)


def agc_process_p(gain, xp, target_power: float = 1.0, beta: float = 0.2):
    """xp = (re, im) f32 [C, N].  Returns (new_gain, (yr, yi))."""
    xr, xi = xp
    new_gain = _agc_gain(gain, mean_last(xr * xr + xi * xi), target_power,
                         beta)
    g = new_gain[:, None]
    return new_gain, (xr * g, xi * g)
