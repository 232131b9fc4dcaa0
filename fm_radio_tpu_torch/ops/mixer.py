"""Harmonic PLL mixer: y[n] = x[n] * exp(j*2*pi*(dt[n]*harmonic + offset)).

Counterpart of ``fm_radio_tpu/ops/mixer.py`` (parity:
``apply_harmonic_pll_scalar``, ``apply_harmonic_pll.cpp:11-24``).  The
extract kernel builds its phasors differently (one base phasor and complex
products, ``kernels/extract.py``); this is the op-level form.
"""

from __future__ import annotations

import torch

from fm_radio_tpu_torch.ops.cmath import chebyshev_sine, f32, wrap_cycles


def apply_harmonic_pll_p(dt: torch.Tensor, xp, harmonic: float, offset):
    """dt: [C, N] NCO phase (cycles); xp = (re, im) f32 [C, N]; offset a
    scalar or [C].  Returns (yr, yi)."""
    offset = torch.as_tensor(offset, dtype=torch.float32, device=dt.device)
    if offset.ndim == 1:
        offset = offset[:, None]
    xr, xi = xp
    dt_sin = dt * f32(harmonic) + offset
    dt_cos = wrap_cycles(dt_sin + 0.25)
    dt_sin = wrap_cycles(dt_sin)
    c = chebyshev_sine(dt_cos)
    s = chebyshev_sine(dt_sin)
    return xr * c - xi * s, xr * s + xi * c
