"""Feed-forward FIR ops: polyphase decimator and Hilbert transform.

Counterpart of ``fm_radio_tpu/ops/fir.py`` in plain float32 PyTorch.  Each
output is the decimated correlation y[i] = sum_k w_rev[k] * x_pad[i*m + k]
over the carried overlap-save tail ``x_pad = [hist | x]``, summed tap by tap
from the oldest sample — the order the CUDA kernels use too
(``csrc/common.cuh::fir_point``).  All arrays are ``[..., T]``.
"""

from __future__ import annotations

import torch


def correlate(w_rev, x_pad: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """y[..., i] = sum_k w_rev[k] * x_pad[..., i*m + k] for i < n, summed
    from k = 0 up; ``w_rev`` is a sequence of Python floats."""
    y = x_pad[..., 0 : m * n : m] * w_rev[0]
    for k in range(1, len(w_rev)):
        y = y + x_pad[..., k : k + m * n : m] * w_rev[k]
    return y


def decimate_core(taps: torch.Tensor, hist: torch.Tensor, x: torch.Tensor,
                  m: int):
    """Streaming decimating FIR on one real plane.

    taps: [NN] natural-order impulse response; hist: [..., NN - m] carried
    input tail; x: [..., T] with T % m == 0.  Returns (new_hist, y [..., T/m]).
    """
    nn = taps.shape[0]
    halo = nn - m
    if hist.shape[-1] != halo or x.shape[-1] % m:
        raise ValueError(f"tail {hist.shape[-1]} != {halo} or "
                         f"{x.shape[-1]} % {m} != 0")
    x_pad = torch.cat([hist.to(x.dtype), x], dim=-1)
    y = correlate(taps.flip(0).tolist(), x_pad, m, x.shape[-1] // m)
    return x_pad[..., x_pad.shape[-1] - halo :], y


def polyphase_decimate_p(taps, state: torch.Tensor, xp, factor: int,
                         imag_out: bool = True):
    """Decimate-by-``factor`` FIR (``polyphase_filter.h:36-64``) on a
    plane-tuple signal: output i is the filter with its window ending at
    input sample (i+1)*factor - 1.  ``xp`` = (re [C, T], im [C, T]) f32;
    ``state`` complex64 [C, NN - factor].  Returns (state', (yr, yi)), or
    (state', yr) when ``imag_out=False`` (the imag tail is still carried)."""
    xr, xi = xp
    hr, yr = decimate_core(taps, state.real, xr, factor)
    if not imag_out:
        x_pad = torch.cat([state.imag, xi], dim=-1)
        hi = x_pad[:, x_pad.shape[-1] - (taps.shape[0] - factor) :]
        return torch.complex(hr, hi), yr
    hi, yi = decimate_core(taps, state.imag, xi, factor)
    return torch.complex(hr, hi), (yr, yi)


def hilbert_fir_p(taps, state: torch.Tensor, x: torch.Tensor):
    """Analytic-signal generator (``hilbert_fir_filter.h:25-46``): the real
    plane is the input delayed by (K-1)/2 samples, the imaginary plane the
    K-tap Hilbert FIR.  state: [C, K-1] f32.  Returns (state', (re, im))."""
    k = taps.shape[0]
    d = (k - 1) // 2
    t = x.shape[-1]
    new_state, im = decimate_core(taps, state, x, 1)
    re = torch.cat([state, x], dim=-1)[:, d : d + t]
    return new_state, (re, im)
