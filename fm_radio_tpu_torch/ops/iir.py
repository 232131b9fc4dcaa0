"""IIR filters as the plain recurrence.

Counterpart of ``fm_radio_tpu/ops/iir.py``.  The JAX package reformulates
the recurrence for the TPU (blocked Toeplitz matmuls, associative scans);
here it is the direct form of ``iir_filter.h:41-46``, one time step after
the other in float32 — the same order as the CUDA kernels' serial loops
(``csrc/k12.cu``):

    ff[n] = sum_{j=order..0} b[j] x[n-j]        (oldest input first)
    y[n]  = ff[n] - a[1] y[n-1] - ... - a[r] y[n-r]

Coefficients are real (SciPy convention, ``ops/design.py``) and are rounded
to float32 first, as the JAX package does; complex signals are filtered as
stacked real/imag channels.
"""

from __future__ import annotations

import torch

from fm_radio_tpu_torch.ops.cmath import f32


def iir_init_state(channels: int, order: int, device=None) -> dict:
    """State: last ``order`` inputs and outputs, newest first (zeros at
    start, ``iir_filter.h:24-31``)."""
    z = torch.zeros((channels, order), dtype=torch.float32, device=device)
    return {"x_hist": z, "y_hist": z.clone()}


def iir_filter(b, a, state: dict, x: torch.Tensor):
    """Apply the IIR filter (b, a) along the last axis of ``x`` [C, N].
    Returns (new_state, y)."""
    b = [f32(v) for v in b]
    a = [f32(v) for v in a]
    ob, r = len(b) - 1, len(a) - 1
    n = x.shape[-1]
    # oldest .. newest inputs, so column ob + i is x[i]
    x_pad = torch.cat([state["x_hist"][:, :ob].flip(-1), x], dim=-1)
    ff = x_pad[:, 0:n] * b[ob]
    for j in range(ob - 1, -1, -1):
        ff = ff + x_pad[:, ob - j : ob - j + n] * b[j]

    ys = list(state["y_hist"][:, :r].unbind(-1))  # newest first
    out = []
    for f_n in ff.t().unbind(0):
        y_n = f_n
        for j in range(r):
            y_n = y_n - ys[j] * a[j + 1]
        ys = [y_n] + ys[:-1]
        out.append(y_n)
    y = torch.stack(out, dim=-1)
    x_hist = x_pad[:, x_pad.shape[-1] - ob :].flip(-1)
    return {"x_hist": x_hist, "y_hist": torch.stack(ys, dim=-1)}, y


def iir_filter_planes(b, a, state_ri: dict, xp):
    """Real-coefficient IIR on a plane-tuple complex signal xp = (re, im);
    ``state_ri`` holds stacked [2C, order] histories (re rows, then im)."""
    xr, xi = xp
    c = xr.shape[0]
    new, y = iir_filter(b, a, state_ri, torch.cat([xr, xi], dim=0))
    return new, (y[:c], y[c:])
