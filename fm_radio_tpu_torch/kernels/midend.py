"""K2: the mid end of the demodulator — CUDA kernel and plain version.

Counterpart of ``fm_radio_tpu/kernels/midend_pallas.py::midend_pallas``:

    fm_demod [C, B/4] float32 -> ds x2 LPF (64 taps)
    -> optional 1-pole de-emphasis -> 65-tap Hilbert -> (re, im) [C, B/8]
    -> order-2 19 kHz peak IIR on both planes -> theta = angle / 2pi
    -> pilot power sum -> agc_pilot gain update

State keys read and written: ``ds_fm_out``, ``deemph``, ``hilbert``,
``peak_pilot``, ``agc_pilot`` (midend_pallas.py:448-460).  The kernel is
``csrc/midend.cu``, which runs K12's mid end (the device code is shared
through ``csrc/k12_stages.cuh``); the helpers that pass this state to the
card and back serve ``kernels/k12.py`` too.  :func:`midend_route` picks
its launches: with de-emphasis off, in float32 and in every int16 form,
the fused route (ds x2 and Hilbert in one tiled kernel); else ds x2, the
de-emphasis and Hilbert each a launch.  Both end with the peak IIR's
recurrence and a parallel theta pass, and compute the same values.

The int16 inter-stage format (``kernels/qformat.py``): fm_demod may be
int16 at FM_SCALE, dequantised by the ds x2's loads, and with ``out_i16``
re/im leave as int16 at IQ_SCALE and theta at PH_SCALE; everything between
runs on float32 values, and the carried ds x2 tail is the dequantised
fm_demod (midend_pallas.py:449-454).  Launches with any int16 tensor count
in ``launches_i16`` (and on the fused route in ``launches_fused`` too).
:func:`pick_tiles_mid` is the JAX kernel's shape gate.
"""

from __future__ import annotations

import math

import torch

from fm_radio_tpu_torch.kernels import _build
from fm_radio_tpu_torch.kernels.qformat import (
    FM_SCALE,
    IQ_SCALE,
    PH_SCALE,
    dq_if_i16,
    q_i16,
)
from fm_radio_tpu_torch.ops.agc import _agc_gain
from fm_radio_tpu_torch.ops.cmath import atan2_poly, div_scalar, f32
from fm_radio_tpu_torch.ops.fir import decimate_core, hilbert_fir_p
from fm_radio_tpu_torch.ops.iir import iir_filter, iir_filter_planes

# kernel launches since the counter was last set to 0 (float32 in and
# out; then any with an int16 input or output); and the fused route's
# launches, by K2 or by K12 (kernels/k12.py), beside their own counts
launches = 0
launches_i16 = 0
launches_fused = 0

_NO = 128  # the TPU kernel's band width

_P, _I, _F = _build.P, _build.I, _build.F
_ARGTYPES = ([_P, _I, _P, _I, _P, _I, _F, _F, _F, _P, _P, _P, _I, _P]
             + [_F] * 5 + [_P, _P, _I, _I] + [_P] * 11)
ROUTE_ARGTYPES = [_I] * 4

# the filter orders the fused route is built for (csrc/k12_stages.cuh:
# kFusedNn2, kFusedNh: the receiver's ds x2 and Hilbert filters)
FUSED_TAPS = (64, 65)
# channels a block of the fused route's peak IIR (csrc/k12_stages.cuh:
# kPeakLanes, a measured choice, PERF.md)
PEAK_LANES = 8


# re/im outputs a CTA of the fused kernel (csrc/k12_stages.cuh: kMidTile)
MID_TILE = 1024


def midend_plan(coeffs, cfg, c: int, n4: int) -> list[tuple[str, tuple]]:
    """The launches of the mid end after fm_demod (K2, and K12 after its
    discriminator), each as (kernel, grid): a host copy of
    ``csrc/k12_stages.cuh::launch_midend``'s plan for :func:`midend_route`.
    Fused: one CTA per (tile of :data:`MID_TILE` outputs, channel);
    launches: ds x2, the de-emphasis where it is on, Hilbert.  Then on
    both the peak IIR's recurrence, one block per :data:`PEAK_LANES`
    channels, and the theta pass, four outputs a thread (storing int16
    theta where the outputs are int16)."""
    n8 = n4 // 2
    if midend_route(coeffs, cfg, n4) == "fused":
        plan = [("k12_mid_fused_kernel", (-(-n8 // MID_TILE), c))]
    else:
        plan = [("fir_decimate_kernel", (-(-c * n8 // 256),))]
        if cfg.use_deemphasis_filter:
            plan.append(("k12_deemph_kernel", (-(-c // 32),)))
        plan.append(("k12_hilbert_kernel", (-(-c * n8 // 256),)))
    return plan + [("k12_peak_rec_kernel", (-(-c // PEAK_LANES),)),
                   ("k12_theta_kernel", (-(-c * n8 // (4 * 256)),))]


def midend_route(coeffs, cfg, n4: int) -> str:
    """"fused" or "launches": the route ``fmt_midend`` and ``fmt_k12``
    take (a host copy of ``csrc/k12_stages.cuh::midend_route``, by which
    the wrappers allocate).  Fused where de-emphasis is off, the filters
    have the fused kernel's orders and the block holds both carried tails
    (B/4 >= ds x2 taps - 2, B/8 >= Hilbert taps - 1), in float32 and in
    every int16 form alike."""
    nn2, nh = coeffs.taps_fm_out.shape[0], coeffs.taps_hilbert.shape[0]
    if (cfg.use_deemphasis_filter or (nn2, nh) != FUSED_TAPS
            or n4 < nn2 - 2 or n4 // 2 < nh - 1):
        return "launches"
    return "fused"


def pick_tiles_mid(c: int, b4: int) -> tuple[int, int] | None:
    """(c_blk, t_blk) of the JAX kernel's grid over the fm_demod axis, or
    None where shapes fail its contract: a host-only integer copy of
    ``midend_pallas.py::pick_tiles_mid`` (:270-280), the gate that decides
    whether K2 takes (and emits) the int16 format (demod.py:427-463)."""
    if b4 % (_NO * 2) != 0:
        return None
    t_blk = _NO * 2
    while t_blk * 2 <= 1024 and b4 % (t_blk * 2) == 0:
        t_blk *= 2
    c_blk = c if c <= 128 else 128
    if c % c_blk != 0:
        return None
    return c_blk, t_blk


def mid_new_state(state: dict, fmd, fm_out, deemph, peak, power,
                  n8: int | None = None) -> dict:
    """Carried state after the mid end (midend_pallas.py:448-460): the
    ds x2 input tail, the Hilbert input tail (the last samples of ``fmd``
    and ``fm_out``, which may be those tails already), the IIR histories
    and the pilot AGC gain from the block's power sum over its ``n8``
    (default: ``fm_out``'s length) outputs."""
    new = dict(state)
    new["ds_fm_out"] = fmd[:, fmd.shape[-1] - state["ds_fm_out"].shape[-1] :]
    new["hilbert"] = fm_out[:, fm_out.shape[-1] - state["hilbert"].shape[-1] :]
    new["deemph"] = deemph
    new["peak_pilot"] = peak
    n8 = fm_out.shape[-1] if n8 is None else n8
    new["agc_pilot"] = _agc_gain(state["agc_pilot"], div_scalar(power, n8),
                                 1.0, 0.2)
    return new


def midend_plain(coeffs, cfg, state: dict, fmd: torch.Tensor,
                 out_i16: bool = False):
    """K2 in plain PyTorch, op by op in float32 in the kernel's order, on
    fm_demod dequantised first if it is int16.  Returns (state', (re, im)
    [C, B/8], theta [C, B/8] cycles), with ``out_i16`` each ``q_i16``."""
    fmd = dq_if_i16(fmd, FM_SCALE)
    _, fm_out = decimate_core(coeffs.taps_fm_out, state["ds_fm_out"], fmd, 2)
    deemph = state["deemph"]
    if cfg.use_deemphasis_filter:
        deemph, fm_out = iir_filter(coeffs.deemph_b, coeffs.deemph_a,
                                    deemph, fm_out)
    _, (re, im) = hilbert_fir_p(coeffs.taps_hilbert, state["hilbert"], fm_out)
    peak, (pr, pi) = iir_filter_planes(coeffs.peak_b, coeffs.peak_a,
                                       state["peak_pilot"], (re, im))
    theta = atan2_poly(pi, pr) * f32(1.0 / (2.0 * math.pi))
    power = torch.sum(pr * pr + pi * pi, dim=-1)
    new = mid_new_state(state, fmd, fm_out, deemph, peak, power)
    if out_i16:
        re, im = q_i16(re, IQ_SCALE), q_i16(im, IQ_SCALE)
        theta = q_i16(theta, PH_SCALE)
    return new, (re, im), theta


def mid_args(name: str, coeffs, cfg, state: dict, c: int, dev) -> dict:
    """The mid end's taps, carried state and IIR coefficients as the C
    entries take them (``fmt_k12``, ``fmt_midend``), checked: every tensor
    on ``dev``, contiguous float32, the tails matching the filter orders
    and every state of ``c`` channels."""
    x = state["deemph"]["x_hist"]
    de_in = torch.stack([x[:, 0], state["deemph"]["y_hist"][:, 0]], dim=-1)
    px, py = state["peak_pilot"]["x_hist"], state["peak_pilot"]["y_hist"]
    peak_rows = {px.shape[0], py.shape[0]}
    if peak_rows != {2 * c}:
        raise ValueError(f"{name}: peak IIR state rows {peak_rows} do not "
                         f"match the {c} channels (2 C rows)")
    pk_in = torch.stack([px[:c, 0], px[:c, 1], py[:c, 0], py[:c, 1],
                         px[c:, 0], px[c:, 1], py[c:, 0], py[c:, 1]], dim=-1)
    a = {
        "w2_rev": coeffs.taps_fm_out.flip(0).contiguous(),
        "tail2": state["ds_fm_out"].contiguous(),
        "wh_rev": coeffs.taps_hilbert.flip(0).contiguous(),
        "htail": state["hilbert"].contiguous(),
        "de_in": de_in,
        "pk_in": pk_in,
    }
    if a["tail2"].shape[-1] != a["w2_rev"].shape[0] - 2 \
            or a["htail"].shape[-1] != a["wh_rev"].shape[0] - 1:
        raise ValueError(f"{name}: carried tails do not match the filter "
                         "orders")
    if any(a[k].shape[0] != c for k in ("tail2", "htail", "de_in", "pk_in")):
        raise ValueError(f"{name}: state rows do not match the {c} channels")
    _build.require(name, dev, torch.float32, **a)
    a["de_out"] = torch.empty_like(de_in)
    a["pk_out"] = torch.empty_like(pk_in)
    return a


def mid_c_args(coeffs, cfg, a: dict) -> list:
    """The C arguments from ``w2_rev`` up to ``pk_st_out`` (``fmt_k12``'s
    and ``fmt_midend``'s shared run of them)."""
    db = [f32(v) for v in coeffs.deemph_b]
    da = [f32(v) for v in coeffs.deemph_a]
    pb = [f32(v) for v in coeffs.peak_b]
    pa = [f32(v) for v in coeffs.peak_a]
    return [a["w2_rev"].data_ptr(), a["w2_rev"].shape[0],
            a["tail2"].data_ptr(), int(bool(cfg.use_deemphasis_filter)),
            db[0], db[1], da[1], a["de_in"].data_ptr(),
            a["de_out"].data_ptr(), a["wh_rev"].data_ptr(),
            a["wh_rev"].shape[0], a["htail"].data_ptr(), pb[0], pb[1], pb[2],
            pa[1], pa[2], a["pk_in"].data_ptr(), a["pk_out"].data_ptr()]


def mid_iir_state(state: dict, cfg, a: dict):
    """(deemph, peak_pilot) after a launch, from its IIR state outputs
    (the de-emphasis state unchanged where the filter is off)."""
    deemph = state["deemph"]
    if cfg.use_deemphasis_filter:
        de = a["de_out"]
        deemph = {"x_hist": de[:, 0:1], "y_hist": de[:, 1:2]}
    pk = a["pk_out"]
    peak = {
        "x_hist": torch.cat([pk[:, 0:2], pk[:, 4:6]], dim=0),
        "y_hist": torch.cat([pk[:, 2:4], pk[:, 6:8]], dim=0),
    }
    return deemph, peak


def mid_outputs(state: dict, cfg, a: dict, fmd, fm_out, power,
                n8: int | None = None) -> dict:
    """State after a launch, from its IIR state outputs and power sum."""
    return mid_new_state(state, fmd, fm_out, *mid_iir_state(state, cfg, a),
                         power, n8)


def mid_buffers(route: str, a: dict, c: int, n8: int, dev) -> dict:
    """The mid end's scratch by ``route``: ``yi`` [C, n8] on both (the
    peak IIR's recurrence writes its filtered im plane there); on the
    launches route ``fm_out`` [C, n8] (whose last samples become the
    carried Hilbert tail), on the fused route ``tails`` [C, (ds x2 taps -
    2) + (Hilbert taps - 1)], where the kernel writes the new carried
    tails."""
    f = dict(device=dev, dtype=torch.float32)
    if route == "launches":
        return {"fm_out": torch.empty((c, n8), **f),
                "yi": torch.empty((c, n8), **f), "tails": None}
    h = a["tail2"].shape[-1] + a["htail"].shape[-1]
    return {"fm_out": None, "yi": torch.empty((c, n8), **f),
            "tails": torch.empty((c, h), **f)}


def buf_ptrs(buf: dict) -> list:
    """``fm_out``'s, ``yi``'s and ``tails``' pointers (None where unused)."""
    return [None if buf[k] is None else buf[k].data_ptr()
            for k in ("fm_out", "yi", "tails")]


def mid_tails(route: str, a: dict, buf: dict, fmd):
    """(fmd, fm_out) for :func:`mid_outputs`: on the fused route the two
    carried tails the kernel wrote, else ``fmd`` and the ``fm_out``
    scratch."""
    if route == "launches":
        return fmd, buf["fm_out"]
    h2 = a["tail2"].shape[-1]
    return buf["tails"][:, :h2], buf["tails"][:, h2:]


def _launch(coeffs, cfg, state: dict, fmd: torch.Tensor,
            out_i16: bool = False):
    dev = fmd.device
    c, n4 = fmd.shape
    a = mid_args("midend", coeffs, cfg, state, c, dev)
    _build.require("midend", dev, fmd.dtype, fmd=fmd)
    f = dict(device=dev, dtype=torch.float32)
    n8 = n4 // 2
    in_i16 = fmd.dtype == torch.int16
    route = midend_route(coeffs, cfg, n4)
    buf = mid_buffers(route, a, c, n8, dev)
    # float32 re, im, theta: the outputs, or with out_i16 the scratch that
    # the int16 outputs are quantised from
    re, im, theta = (torch.empty((c, n8), **f) for _ in range(3))
    out16 = tuple(torch.empty((c, n8), device=dev, dtype=torch.int16)
                  for _ in range(3)) if out_i16 else (None,) * 3
    power = torch.empty((c,), **f)
    fm_out_p, yi_p, tails_p = buf_ptrs(buf)
    fn = _build.function("midend", "fmt_midend", _ARGTYPES)
    err = fn(fmd.data_ptr(), int(in_i16), *mid_c_args(coeffs, cfg, a), c, n4,
             fm_out_p, re.data_ptr(), im.data_ptr(), theta.data_ptr(),
             *(t.data_ptr() if out_i16 else None for t in out16),
             power.data_ptr(), yi_p, tails_p, _build.stream_ptr(dev))
    _build.check("midend", err)
    if route == "fused":
        global launches_fused
        launches_fused += 1
    # the carried tail, dequantised: only its last samples, not the planes
    fmd_t, fm_out_t = mid_tails(route, a, buf,
                                fmd[:, n4 - a["tail2"].shape[-1] :])
    new = mid_outputs(state, cfg, a, dq_if_i16(fmd_t, FM_SCALE), fm_out_t,
                      power, n8)
    if out_i16:
        re, im, theta = out16
    return new, (re, im), theta


def midend(coeffs, cfg, state: dict, fmd: torch.Tensor,
           out_i16: bool = False):
    """fm_demod [C, B/4] float32 or int16 (FM_SCALE) -> (state', (re, im)
    [C, B/8], theta [C, B/8] cycles), float32 or with ``out_i16`` int16.
    CPU tensors run :func:`midend_plain`; CUDA tensors launch the
    kernel."""
    if fmd.ndim != 2 or fmd.dtype not in (torch.float32, torch.int16) \
            or fmd.shape[-1] % 32:
        raise ValueError(f"midend takes [C, B/4] float32 or int16 with "
                         f"B/4 % 32 == 0, got {fmd.dtype} "
                         f"{tuple(fmd.shape)}")
    if _build.on_cpu("midend", fmd.device):
        return midend_plain(coeffs, cfg, state, fmd, out_i16)
    global launches, launches_i16
    out = _launch(coeffs, cfg, state, fmd, out_i16)
    if out_i16 or fmd.dtype == torch.int16:
        launches_i16 += 1
    else:
        launches += 1
    return out
