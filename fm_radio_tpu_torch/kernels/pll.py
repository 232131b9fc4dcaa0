"""19 kHz pilot PLL over the precomputed pilot phase: CUDA kernels and plain
versions, sequential and chunked.

Counterpart of ``fm_radio_tpu/kernels/pll_pallas.py::pilot_pll_pallas_theta``
and the two runs it dispatches to.  Sequential (``_pilot_pll_run``): per
channel, one serial loop over theta [C, N] (cycles): 1-pole loop filter,
clipped PI controller, NCO, and the phase error pe = 2*pi*wrap(theta + t)
(pll_pallas.py:130-140); emits the NCO phase track dt [C, N].  Chunked
(``_pilot_pll_chunked``, ``cfg.pll_time_chunks = G > 1``): the block cut
into G chunks that run at once on C*G lanes, each chunk warmed up over the
W = ``cfg.pll_chunk_warmup`` samples before it (pll_pallas.py:297-423),
taken only where :func:`chunk_gate` holds.  The kernels are ``csrc/pll.cu``
(``fmt_pll``, ``fmt_pll_chunked``), which share one step
(``csrc/pll_step.cuh``).
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

# kernel launches since the counter was last set to 0 (fmt_pll, and the
# chunked fmt_pll_chunked)
launches = 0
launches_chunked = 0

_P, _I, _F = _build.P, _build.I, _build.F
_ARGTYPES = [_P] * 4 + [_I] * 2 + [_F] * 7 + [_P]
_ARGTYPES_CHUNKED = [_P] * 4 + [_I] * 4 + [_F] * 8 + [_P]


def pll_plain(cfg, state: PilotPLLState, theta: torch.Tensor):
    """The loop in plain PyTorch, one time step after the other, op by op
    in float32 (the order ``csrc/pll_step.cuh`` evaluates).  Returns
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


def chunk_gate(cfg, n: int) -> bool:
    """Whether a block of n steps takes the chunked PLL: G > 1 chunks that
    divide n, each longer than the warm-up (pll_pallas.py:204)."""
    g = int(cfg.pll_time_chunks)
    return g > 1 and n % g == 0 and n // g > int(cfg.pll_chunk_warmup)


def seed_offset(cfg) -> float:
    """float32(ts * f_center), the product formed in double as the JAX
    wrapper forms it (pll_pallas.py:356): a locked loop has nco_t =
    -theta - ts * f_center (mod 1), the chunks' seed."""
    return f32((1.0 / float(cfg.rates.fs_fm_out))
               * -float(cfg.analog.f_pilot))


def pll_chunked_plain(cfg, state: PilotPLLState, theta: torch.Tensor):
    """The chunked PLL in plain PyTorch, as ``_pilot_pll_chunked`` builds
    it: the G windows theta[:, s_g : s_g + L + W] (s_g = max(gL - W, 0)) on
    C*G chunk-major lanes, each from the carried state with its NCO phase
    wrapped, chunks g >= 1 seeded from the signal; :func:`pll_plain` over
    the windows; the last L outputs of each kept as dt[:, gL : gL + L]; the
    last chunk's state carried out.  Requires :func:`chunk_gate`."""
    c, n = theta.shape
    if not chunk_gate(cfg, n):
        raise ValueError(f"pll_chunked: {n} steps fail the chunk gate")
    g, w = int(cfg.pll_time_chunks), int(cfg.pll_chunk_warmup)
    l = n // g
    starts = [max(gg * l - w, 0) for gg in range(g)]
    windows = torch.cat([theta[:, s : s + l + w] for s in starts])
    seed = torch.cat([state.nco_t]
                     + [-theta[:, s] - seed_offset(cfg) for s in starts[1:]])
    lanes = PilotPLLState(*(torch.cat([r] * g) for r in state))
    lanes = lanes._replace(nco_t=wrap_cycles(seed))
    out, dt_all = pll_plain(cfg, lanes, windows)
    dt = torch.cat([dt_all[gg * c : (gg + 1) * c, gg * l - s : gg * l - s + l]
                    for gg, s in enumerate(starts)], dim=1)
    return PilotPLLState(*(r[(g - 1) * c :] for r in out)), dt


def _args(name: str, state: PilotPLLState, theta: torch.Tensor):
    c, _ = theta.shape
    st = torch.stack(list(state))  # [5, C]
    _build.require(name, theta.device, torch.float32, theta=theta, state=st)
    if st.shape != (5, c):
        raise ValueError(f"{name}: state rows {tuple(st.shape)} != (5, {c})")
    return st, torch.empty_like(theta), torch.empty_like(st)


def pilot_pll_chunked(cfg, state: PilotPLLState, theta: torch.Tensor):
    """theta [C, N] float32 (cycles) -> (state', dt [C, N]) by the chunked
    PLL; requires :func:`chunk_gate`.  CPU tensors run
    :func:`pll_chunked_plain`; CUDA tensors launch the kernel."""
    if not chunk_gate(cfg, theta.shape[-1]):
        raise ValueError(f"pll_chunked: {theta.shape[-1]} steps fail the "
                         "chunk gate")
    if _build.on_cpu("pll_chunked", theta.device):
        return pll_chunked_plain(cfg, state, theta)
    global launches_chunked
    c, n = theta.shape
    st, dt, st_out = _args("pll_chunked", state, theta)
    k = pll_consts_from_cfg(cfg)
    fn = _build.function("pll", "fmt_pll_chunked", _ARGTYPES_CHUNKED)
    err = fn(theta.data_ptr(), dt.data_ptr(), st.data_ptr(),
             st_out.data_ptr(), c, n, int(cfg.pll_time_chunks),
             int(cfg.pll_chunk_warmup), seed_offset(cfg), *k.values(),
             _build.stream_ptr(theta.device))
    _build.check("pll", err)
    launches_chunked += 1
    return PilotPLLState(*st_out.unbind(0)), dt


def pilot_pll_theta(cfg, state: PilotPLLState, theta: torch.Tensor):
    """theta [C, N] float32 (cycles) -> (state', dt [C, N]), as
    ``pilot_pll_pallas_theta``: the chunked PLL where :func:`chunk_gate`
    holds, else the sequential loop.  CPU tensors run the plain versions;
    CUDA tensors launch the kernels."""
    if chunk_gate(cfg, theta.shape[-1]):
        return pilot_pll_chunked(cfg, state, theta)
    if _build.on_cpu("pll", theta.device):
        return pll_plain(cfg, state, theta)
    global launches
    c, n = theta.shape
    st, dt, st_out = _args("pll", state, theta)
    k = pll_consts_from_cfg(cfg)
    fn = _build.function("pll", "fmt_pll", _ARGTYPES)
    err = fn(theta.data_ptr(), dt.data_ptr(), st.data_ptr(),
             st_out.data_ptr(), c, n, *k.values(),
             _build.stream_ptr(theta.device))
    _build.check("pll", err)
    launches += 1
    return PilotPLLState(*st_out.unbind(0)), dt
