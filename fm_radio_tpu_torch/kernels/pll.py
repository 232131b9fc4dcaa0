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
(``csrc/pll_step.cuh``).  Both run 8 lanes a block with three batches of
:data:`BATCH` steps in flight; the chunked lanes walk the flat theta's
grid of :data:`BATCH` steps from the batch that holds each window's first
step, their first and last batch masked, so every shape the gate admits
runs (``tests/test_torch_pll_chunk_lanes.py`` models the schedule).

The int16 inter-stage format (``kernels/qformat.py``, PH_SCALE): theta may
arrive as int16.  :func:`pilot_pll_theta` takes the branches of
``pilot_pll_pallas_theta`` in its order: where the chunk gate holds, theta
is dequantised and the chunked PLL runs (pll_pallas.py:204-211); else where
the channel tile is channel-major (:func:`channel_major`) the sequential
kernel takes int16 theta and emits int16 dt (``launches_i16``); else theta
is dequantised and the float32 kernel runs (pll_pallas.py:231-238).
"""

from __future__ import annotations

import math

import torch

from fm_radio_tpu_torch.kernels import _build
from fm_radio_tpu_torch.kernels.qformat import (
    PH_SCALE,
    dq_i16,
    dq_if_i16,
    q_i16,
)
from fm_radio_tpu_torch.models.pilot_pll import (
    PilotPLLState,
    pll_consts_from_cfg,
)
from fm_radio_tpu_torch.ops.cmath import f32, wrap_cycles

# kernel launches since the counter was last set to 0 (fmt_pll, the
# chunked fmt_pll_chunked, and fmt_pll on int16 theta and dt)
launches = 0
launches_chunked = 0
launches_i16 = 0

_P, _I, _F = _build.P, _build.I, _build.F
_ARGTYPES = [_P] * 4 + [_I] * 2 + [_F] * 7 + [_I, _P]
_ARGTYPES_CHUNKED = [_P] * 4 + [_I] * 4 + [_F] * 8 + [_P]

# steps the kernels (csrc/pll.cu) load and store at once: the sequential
# kernel's N must be a multiple (fmt_pll refuses others too); the chunked
# kernel's batches lie on the flat array's grid of BATCH steps
BATCH = 16


def channel_major(c: int) -> bool:
    """Whether the JAX kernel runs C channels in its channel-major layout,
    the only one that takes the int16 format: a host-only copy of
    pll_pallas.py:227-230 (channel tile ct = C up to 2048, else gcd(C,
    2048); ct % 8 == 0)."""
    ct = c if c <= 2048 else math.gcd(c, 2048)
    return ct % 8 == 0


def pll_plain(cfg, state: PilotPLLState, theta: torch.Tensor):
    """The loop in plain PyTorch, one time step after the other, op by op
    in float32 (the order ``csrc/pll_step.cuh`` evaluates).  Returns
    (state', dt); on int16 theta (PH_SCALE) the loop runs on its
    ``dq_i16`` and dt is ``q_i16`` of the float32 track, as the kernel
    loads and stores them."""
    if theta.dtype == torch.int16:
        state, dt = pll_plain(cfg, state, dq_i16(theta, PH_SCALE))
        return state, q_i16(dt, PH_SCALE)
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
    _build.require(name, theta.device, theta.dtype, theta=theta)
    _build.require(name, theta.device, torch.float32, state=st)
    if st.shape != (5, c):
        raise ValueError(f"{name}: state rows {tuple(st.shape)} != (5, {c})")
    return st, torch.empty_like(theta), torch.empty_like(st)


def pilot_pll_chunked(cfg, state: PilotPLLState, theta: torch.Tensor):
    """theta [C, N] float32 (cycles) -> (state', dt [C, N]) by the chunked
    PLL; requires :func:`chunk_gate`.  CPU tensors run
    :func:`pll_chunked_plain`; CUDA tensors launch the kernel."""
    if theta.dtype != torch.float32:
        raise ValueError(f"pll_chunked takes float32 theta, got {theta.dtype}")
    if not chunk_gate(cfg, theta.shape[-1]):
        raise ValueError(f"pll_chunked: {theta.shape[-1]} steps fail the "
                         "chunk gate")
    if _build.on_cpu("pll_chunked", theta.device):
        return pll_chunked_plain(cfg, state, theta)
    global launches_chunked
    c, n = theta.shape
    st, dt, st_out = _args("pll_chunked", state, theta)
    if theta.data_ptr() % 16:
        raise ValueError("pll_chunked: theta is not 16-byte aligned")
    k = pll_consts_from_cfg(cfg)
    fn = _build.function("pll", "fmt_pll_chunked", _ARGTYPES_CHUNKED)
    err = fn(theta.data_ptr(), dt.data_ptr(), st.data_ptr(),
             st_out.data_ptr(), c, n, int(cfg.pll_time_chunks),
             int(cfg.pll_chunk_warmup), seed_offset(cfg), *k.values(),
             _build.stream_ptr(theta.device))
    _build.check("pll", err)
    launches_chunked += 1
    return PilotPLLState(*st_out.unbind(0)), dt


def pilot_pll_theta_plain(cfg, state: PilotPLLState, theta: torch.Tensor):
    """:func:`pilot_pll_theta`'s branches with the plain versions, on any
    device."""
    if chunk_gate(cfg, theta.shape[-1]):
        return pll_chunked_plain(cfg, state, dq_if_i16(theta, PH_SCALE))
    if not channel_major(theta.shape[0]):
        theta = dq_if_i16(theta, PH_SCALE)
    return pll_plain(cfg, state, theta)


def pilot_pll_theta(cfg, state: PilotPLLState, theta: torch.Tensor):
    """theta [C, N] float32 or int16 (cycles; PH_SCALE) -> (state', dt
    [C, N]), as ``pilot_pll_pallas_theta``: the chunked PLL where
    :func:`chunk_gate` holds, else the sequential loop (module docstring:
    dt is int16 exactly where theta is int16 and :func:`channel_major`
    holds).  CPU tensors run the plain versions; CUDA tensors launch the
    kernels."""
    if theta.dtype not in (torch.float32, torch.int16):
        raise ValueError(f"pll takes float32 or int16 theta, got "
                         f"{theta.dtype}")
    c, n = theta.shape
    if chunk_gate(cfg, n):
        return pilot_pll_chunked(cfg, state, dq_if_i16(theta, PH_SCALE))
    if _build.on_cpu("pll", theta.device):
        return pilot_pll_theta_plain(cfg, state, theta)
    if not channel_major(c):
        theta = dq_if_i16(theta, PH_SCALE)
    return pilot_pll_seq(cfg, state, theta)


def pilot_pll_seq(cfg, state: PilotPLLState, theta: torch.Tensor):
    """The sequential loop on theta [C, N] as it is, float32 or int16
    (PH_SCALE; dt then int16 too), whatever its channel tile: the launch
    :func:`pilot_pll_theta` makes after its route.  CPU tensors run
    :func:`pll_plain`; CUDA tensors launch the kernel.  On either device
    N must be a multiple of :data:`BATCH`."""
    if theta.dtype not in (torch.float32, torch.int16):
        raise ValueError(f"pll takes float32 or int16 theta, got "
                         f"{theta.dtype}")
    c, n = theta.shape
    if n % BATCH:
        raise ValueError(f"pll: N = {n} is not a multiple of {BATCH}")
    if _build.on_cpu("pll", theta.device):
        return pll_plain(cfg, state, theta)
    global launches, launches_i16
    io_i16 = theta.dtype == torch.int16
    st, dt, st_out = _args("pll", state, theta)
    if theta.data_ptr() % 16:
        raise ValueError("pll: theta is not 16-byte aligned")
    k = pll_consts_from_cfg(cfg)
    fn = _build.function("pll", "fmt_pll", _ARGTYPES)
    err = fn(theta.data_ptr(), dt.data_ptr(), st.data_ptr(),
             st_out.data_ptr(), c, n, *k.values(), int(io_i16),
             _build.stream_ptr(theta.device))
    _build.check("pll", err)
    if io_i16:
        launches_i16 += 1
    else:
        launches += 1
    return PilotPLLState(*st_out.unbind(0)), dt
