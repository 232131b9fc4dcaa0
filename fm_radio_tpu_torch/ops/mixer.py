"""Harmonic PLL mixer: y[n] = x[n] * exp(j*2*pi*(dt[n]*harmonic + offset)).

Counterpart of ``fm_radio_tpu/ops/mixer.py`` (parity:
``apply_harmonic_pll_scalar``, ``apply_harmonic_pll.cpp:11-24``).  The
extract kernel builds its phasors differently (one base phasor and complex
products, ``kernels/extract.py``); this is the op-level form.
``freq_shift_p`` is the tuner's mix-down of ``tune`` (PyTorch ops on the
input's device).
"""

from __future__ import annotations

import numpy as np
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


def freq_shift_p(phase0, xp, f_norm: float):
    """Complex downconversion by ``f_norm`` cycles a sample with carried
    phase (``fm_radio_tpu/ops/mixer.py::freq_shift_p``; the role of the
    RTL-SDR tuner's retune, ``device.cpp:74-83``, for recorded wideband
    captures): y[n] = x[n] * e^{-j 2 pi (f_norm n + phase0)}.

    phase0: [C] carried phase in cycles; xp: (re, im) float32 [C, N].
    Returns (phase0', (yr, yi)).  The wrapped ramp is built in float64 on
    the host, as the JAX package builds it (a float32 ramp loses ~1e-4
    cycles by n ~ 1000)."""
    xr, xi = xp
    n = xr.shape[-1]
    ramp = np.mod(np.float64(f_norm) * np.arange(n), 1.0).astype(np.float32)
    p0 = torch.as_tensor(phase0, dtype=torch.float32, device=xr.device)
    ph = wrap_cycles(p0[:, None]
                     + torch.from_numpy(ramp).to(xr.device)[None, :])
    c = chebyshev_sine(wrap_cycles(ph + 0.25))
    s = chebyshev_sine(ph)
    # e^{-j 2 pi ph} = c - j s
    yr = xr * c + xi * s
    yi = xi * c - xr * s
    new_phase = p0 + f32(np.mod(np.float64(f_norm) * n, 1.0))
    return new_phase - torch.round(new_phase), (yr, yi)
