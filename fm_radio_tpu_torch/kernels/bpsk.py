"""BPSK symbol synchroniser for the RDS subcarrier — CUDA kernel and plain
version.

Counterpart of ``fm_radio_tpu/kernels/bpsk_pallas.py::bpsk_sync_pallas``,
with ``gain=`` (the fused RDS AGC of the split path: the RDS baseband is
scaled by the per-channel gain at ingest) or without it (the megakernel's
route, whose RDS AGC scales the planes before: no multiply).  Then one
serial loop per channel runs the
carrier PLL, the zero-crossing detector with cooldown, the TED ramp clock
and the integrate-and-dump (bpsk_pallas.py:98-160).  Outputs per sample:
sym = complex(sym_re, pred), pred, and valid (where the TED clock fired).
The kernel is ``csrc/bpsk.cu``: one warp of four channels a block, the
dump's phase error computed under a branch only where some lane of the
warp fires.
"""

from __future__ import annotations

import math

import torch

from fm_radio_tpu_torch.kernels import _build
from fm_radio_tpu_torch.models.bpsk import BPSKState, bpsk_consts_from_cfg
from fm_radio_tpu_torch.ops.cmath import (
    atan2_poly,
    chebyshev_sine,
    div_scalar,
    f32,
    wrap_cycles,
)

# kernel launches since the counter was last set to 0
launches = 0

# steps a launch must be a multiple of (csrc/bpsk.cu takes 16 a batch)
STEP_MULTIPLE = 16

_ARGTYPES = ([_build.P] * 8 + [_build.I] * 2 + [_build.F] * 14
             + [_build.P])


def pack_state(s: BPSKState) -> torch.Tensor:
    """[14, C] float32 rows in ``bpsk_pallas._pack_state`` order."""
    return torch.stack([
        s.pll_lpf_x1, s.pll_lpf_y1, s.pll_integ, s.pll_nco_t, s.pll_prev_pe,
        s.zcd_prev_q, s.cooldown.to(torch.float32),
        s.ted_lpf_x1, s.ted_lpf_y1, s.ted_integ, s.ted_prev_pe, s.ted_ramp,
        s.int_dump.real, s.int_dump.imag,
    ])


def unpack_state(st) -> BPSKState:
    """Inverse of :func:`pack_state` (rows as a tensor or a sequence)."""
    return BPSKState(*st[:6], st[6].to(torch.int32), *st[7:12],
                     torch.complex(st[12], st[13]))


def _outs(pred, sym_re, valid):
    return {"sym": torch.complex(sym_re, pred), "pred": pred,
            "valid": valid > 0.5}


def bpsk_plain(cfg, state: BPSKState, x_p, gain: torch.Tensor | None = None):
    """The loop in plain PyTorch, one step after the other, op by op in
    float32 (the order ``csrc/bpsk.cu`` evaluates).  x_p = (re, im) [C, N];
    gain [C] or None (no multiply).  Returns (state', outs)."""
    k = bpsk_consts_from_cfg(cfg)
    ts = k["ts"]
    half_pi = f32(math.pi / 2.0)
    xr_all, xi_all = x_p
    if gain is not None:
        xr_all = xr_all * gain[:, None]
        xi_all = xi_all * gain[:, None]
    (p_x1, p_y1, p_int, p_t, p_pe, zq, cool,
     t_x1, t_y1, t_int, t_pe, ramp, id_re, id_im) = pack_state(state).unbind(0)
    pred, sym_re, valid = [], [], []
    for xr, xi in zip(xr_all.t().unbind(0), xi_all.t().unbind(0)):
        # carrier PLL PI + NCO
        p_lpf = k["pll_lpf_b0"] * (p_pe + p_x1) - k["pll_lpf_a1"] * p_y1
        p_int2 = torch.clamp(p_int + k["pll_ki_ts"] * p_pe, -1.0, 1.0)
        control = torch.clamp(p_lpf * k["pll_kp"] + p_int2, -1.0, 1.0)
        t = wrap_cycles(p_t + ts * (control * k["pll_f_gain"]))
        cs = chebyshev_sine(wrap_cycles(t + 0.25))
        sn = chebyshev_sine(t)
        iq_re = xr * cs - xi * sn
        iq_im = xr * sn + xi * cs

        # zero-crossing detector + cooldown
        fire_zcd = ((iq_im * zq) < 0.0) & (cool == 0.0)
        cool2 = torch.where(fire_zcd, k["zcd_cooldown"],
                            torch.clamp(cool - 1.0, min=0.0))
        timing = 2.0 * ramp
        timing_err = torch.where(timing > 1.0, timing - 2.0, timing)
        t_pe2 = torch.where(fire_zcd, timing_err, t_pe)

        # TED PI
        t_lpf = k["ted_lpf_b0"] * (t_pe2 + t_x1) - k["ted_lpf_a1"] * t_y1
        t_int2 = torch.clamp(t_int + k["ted_ki_ts"] * t_pe2, -1.0, 1.0)
        pi_ted = k["ted_kp"] * t_lpf + t_int2

        # integrate & dump
        id_re2 = id_re + k["int_dump_kts"] * iq_re
        id_im2 = id_im + k["int_dump_kts"] * iq_im

        # TED ramp clock
        tctl = torch.clamp(-pi_ted, -1.0, 1.0)
        tfreq = k["ted_f_center"] + tctl * k["ted_f_gain"]
        v = ramp + ts * tfreq
        offset = ts * tfreq * 0.5
        fire_ted = v >= (1.0 - offset)
        ramp2 = torch.where(fire_ted, 0.0, v)

        # dump
        sym_phase = atan2_poly(id_im2, id_re2)
        est_pe = torch.where(sym_phase > 0.0, half_pi - sym_phase,
                             -half_pi - sym_phase)
        p_pe2 = torch.where(fire_ted, div_scalar(est_pe, half_pi), p_pe)

        fire_f = fire_ted.to(torch.float32)
        pred.append(id_im2 * fire_f)
        sym_re.append(id_re2 * fire_f)
        valid.append(fire_f)

        p_x1, p_y1, p_int, p_t, p_pe = p_pe, p_lpf, p_int2, t, p_pe2
        zq, cool = iq_im, cool2
        t_x1, t_y1, t_int, t_pe, ramp = t_pe2, t_lpf, t_int2, t_pe2, ramp2
        id_re = torch.where(fire_ted, 0.0, id_re2)
        id_im = torch.where(fire_ted, 0.0, id_im2)
    st = unpack_state([p_x1, p_y1, p_int, p_t, p_pe, zq, cool,
                       t_x1, t_y1, t_int, t_pe, ramp, id_re, id_im])
    return st, _outs(torch.stack(pred, 1), torch.stack(sym_re, 1),
                     torch.stack(valid, 1))


def bpsk_sync(cfg, state: BPSKState, x_p, gain: torch.Tensor | None = None):
    """x_p = (re, im) [C, N] float32, gain [C] or None -> (state', outs
    with sym, pred, valid [C, N]).  CPU tensors run :func:`bpsk_plain`;
    CUDA tensors launch the kernel.  N must be a multiple of 16 on every
    device (the kernel's batch), else ValueError before any launch."""
    xr, xi = x_p
    dev = xr.device
    c, n = xr.shape
    if n % STEP_MULTIPLE:
        raise ValueError(f"bpsk: the kernel takes N a multiple of "
                         f"{STEP_MULTIPLE}, not N = {n}")
    if _build.on_cpu("bpsk", dev):
        return bpsk_plain(cfg, state, x_p, gain)
    global launches
    st = pack_state(state)
    gains = {} if gain is None else {"gain": gain}
    _build.require("bpsk", dev, torch.float32, x_re=xr, x_im=xi, state=st,
                   **gains)
    if xi.shape != (c, n) or st.shape != (14, c) or (
            gain is not None and gain.shape != (c,)):
        raise ValueError("bpsk: shapes of x, gain and state disagree")
    if (xr.data_ptr() | xi.data_ptr()) % 16:
        raise ValueError("bpsk: the kernel takes 16-byte aligned rows")
    f = dict(device=dev, dtype=torch.float32)
    pred, sym_re, valid = (torch.empty((c, n), **f) for _ in range(3))
    st_out = torch.empty_like(st)
    k = bpsk_consts_from_cfg(cfg)
    fn = _build.function("bpsk", "fmt_bpsk", _ARGTYPES)
    err = fn(xr.data_ptr(), xi.data_ptr(),
             None if gain is None else gain.data_ptr(), st.data_ptr(),
             st_out.data_ptr(), pred.data_ptr(), sym_re.data_ptr(),
             valid.data_ptr(), c, n, *k.values(), _build.stream_ptr(dev))
    _build.check("bpsk", err)
    launches += 1
    return unpack_state(st_out), _outs(pred, sym_re, valid)
