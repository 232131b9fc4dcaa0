"""19 kHz pilot PLL over the precomputed pilot phase: CUDA kernel and plain
version.

Counterpart of ``fm_radio_tpu/kernels/pll_pallas.py::_pilot_pll_run``
(reached through ``pilot_pll_pallas_theta``).  Per channel, one serial loop
over theta [C, N] (cycles): 1-pole loop filter, clipped PI controller, NCO,
and the phase error pe = 2*pi*wrap(theta + t) (pll_pallas.py:130-140).
Emits the NCO phase track dt [C, N].  The kernel is ``csrc/pll.cu``.
"""

from __future__ import annotations

import math

import torch

from fm_radio_tpu_torch.kernels import _build
from fm_radio_tpu_torch.models.pilot_pll import (
    PilotPLLState,
    pll_consts_from_cfg,
)
from fm_radio_tpu_torch.ops.cmath import f32, wrap_cycles

# kernel launches since the counter was last set to 0
launches = 0

_ARGTYPES = [_build.P] * 4 + [_build.I] * 2 + [_build.F] * 7 + [_build.P]


def pll_plain(cfg, state: PilotPLLState, theta: torch.Tensor):
    """The loop in plain PyTorch, one time step after the other, op by op
    in float32 (the order ``csrc/pll.cu`` evaluates).  Returns
    (state', dt)."""
    k = pll_consts_from_cfg(cfg)
    ts, fc, fg = k["ts"], k["f_center"], k["f_gain"]
    ki, kp, b0, a1 = k["ki_ts"], k["kp"], k["lpf_b0"], k["lpf_a1"]
    two_pi = f32(2.0 * math.pi)
    x1, y1, integ, t, pe = state
    out = []
    for th in theta.t().unbind(0):
        lpf_pe = b0 * (pe + x1) - a1 * y1
        integ = torch.clamp(integ + ki * pe, -1.0, 1.0)
        control = torch.clamp(lpf_pe * kp + integ, -1.0, 1.0)
        t = wrap_cycles(t + ts * (fc + control * fg))
        x1, y1, pe = pe, lpf_pe, two_pi * wrap_cycles(th + t)
        out.append(t)
    dt = torch.stack(out, dim=1) if out else torch.empty_like(theta)
    return PilotPLLState(x1, y1, integ, t, pe), dt


def pilot_pll_theta(cfg, state: PilotPLLState, theta: torch.Tensor):
    """theta [C, N] float32 (cycles) -> (state', dt [C, N]).  CPU tensors
    run :func:`pll_plain`; CUDA tensors launch the kernel."""
    if _build.on_cpu("pll", theta.device):
        return pll_plain(cfg, state, theta)
    global launches
    c, n = theta.shape
    st = torch.stack(list(state))  # [5, C]
    _build.require("pll", theta.device, torch.float32, theta=theta, state=st)
    if st.shape != (5, c):
        raise ValueError(f"pll: state rows {tuple(st.shape)} != (5, {c})")
    dt = torch.empty_like(theta)
    st_out = torch.empty_like(st)
    k = pll_consts_from_cfg(cfg)
    fn = _build.function("pll", "fmt_pll", _ARGTYPES)
    err = fn(theta.data_ptr(), dt.data_ptr(), st.data_ptr(),
             st_out.data_ptr(), c, n, k["ts"], k["f_center"], k["f_gain"],
             k["ki_ts"], k["kp"], k["lpf_b0"], k["lpf_a1"],
             _build.stream_ptr(theta.device))
    _build.check("pll", err)
    launches += 1
    return PilotPLLState(*st_out.unbind(0)), dt
