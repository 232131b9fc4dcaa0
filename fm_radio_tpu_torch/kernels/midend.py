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
its launches, in float32 and in every int16 form alike: at every filter
order within the 128-sample halo the split route (:func:`mid_ds2`'s and
:func:`mid_hilb`'s tiled kernels, built for the receiver's 64 / 65 taps,
or their any-order forms at other orders, with the serial de-emphasis
between them where it is on); on a block shorter than a carried tail ds
x2, the de-emphasis and Hilbert each a launch of one output a thread;
orders past the halo are refused.  Every route ends with the peak IIR's
recurrence and a parallel theta pass, and computes the same values.

The int16 inter-stage format (``kernels/qformat.py``): fm_demod may be
int16 at FM_SCALE, dequantised by the ds x2's loads, and with ``out_i16``
re/im leave as int16 at IQ_SCALE and theta at PH_SCALE; everything between
runs on float32 values, and the carried ds x2 tail is the dequantised
fm_demod (midend_pallas.py:449-454).  Launches with any int16 tensor count
in ``launches_i16`` (and on the split route in ``launches_split`` too).
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
from fm_radio_tpu_torch.ops.discriminator import discriminate_theta
from fm_radio_tpu_torch.ops.fir import decimate_core, hilbert_fir_p
from fm_radio_tpu_torch.ops.iir import iir_filter, iir_filter_planes

# kernel launches since the counter was last set to 0 (float32 in and
# out; then any with an int16 input or output); the split route's
# launches, by K2 or by K12 (kernels/k12.py), beside their own counts
# (each runs k12_mid_ds2_kernel and k12_mid_hilb_kernel once, and
# k12_deemph_kernel where the de-emphasis is on); the launches of those
# three kernels alone (mid_ds2, deemph, mid_hilb); and every launch of the
# split route's any-order kernels (k12_mid_ds2_any_kernel,
# k12_mid_hilb_any_kernel), by K2, K12 or mid_ds2 / mid_hilb alone
launches = 0
launches_i16 = 0
launches_split = 0
launches_ds2 = 0
launches_de = 0
launches_hilb = 0
launches_ds2_any = 0
launches_hilb_any = 0

_NO = 128  # the TPU kernel's band width

_P, _I, _F = _build.P, _build.I, _build.F
_ARGTYPES = ([_P, _I, _P, _I, _P, _I, _F, _F, _F, _P, _P, _P, _I, _P]
             + [_F] * 5 + [_P, _P, _I, _I] + [_P] * 11)
ROUTE_ARGTYPES = [_I] * 3
DS2_ARGTYPES = [_P, _I, _P, _F, _P, _I, _P, _I, _I, _P, _P, _P]
HILB_ARGTYPES = [_P, _P, _I, _P, _I, _I] + [_P] * 5
DEEMPH_ARGTYPES = [_P, _P, _I, _I, _F, _F, _F, _P, _P, _P]

# the filter orders the split route's tiled kernels are built for
# (csrc/k12_stages.cuh: kTiledNn2, kTiledNh: the receiver's ds x2 and
# Hilbert filters); every other order takes their any-order forms
TILED_TAPS = (64, 65)
# the longest carried tail the tiles hold (csrc/k12_stages.cuh: kMidHalo),
# and the orders it admits (ds x2 tail nn2 - 2, Hilbert tail nh - 1)
HALO = 128
ORDERS = ((2, HALO + 2), (1, HALO + 1))
# channels a block of the peak IIR's recurrence (csrc/k12_stages.cuh:
# kPeakLanes, a measured choice, PERF.md)
PEAK_LANES = 8
# channels a block of the de-emphasis recurrence (csrc/k12_stages.cuh:
# kDeemphLanes, a measured choice, PERF.md)
DEEMPH_LANES = 16


# re/im outputs a CTA of the tiled kernels (csrc/k12_stages.cuh: kMidTile)
MID_TILE = 1024
# threads a CTA of the split route's ds x2 kernel (kDs2Threads: one run
# of 8 outputs each) and of its Hilbert kernel (kMidThreads)
DS2_THREADS = 128
HILB_THREADS = 256


def midend_plan(coeffs, cfg, c: int, n4: int) -> list[tuple[str, tuple]]:
    """The launches of the mid end after fm_demod (K2, and K12 after its
    discriminator), each as (kernel, grid): a host copy of
    ``csrc/k12_stages.cuh::launch_midend``'s plan for :func:`midend_route`.
    Split: the ds x2 kernel (built for the filter's order, or its
    any-order form), one CTA per (tile of :data:`MID_TILE` outputs,
    channel), the de-emphasis where it is on (one thread a channel,
    :data:`DEEMPH_LANES` a block), the Hilbert kernel (the same choice)
    on the ds x2 kernel's grid; launches: ds x2,
    the de-emphasis where it is on, Hilbert.  Then on every route the peak
    IIR's recurrence, one block per :data:`PEAK_LANES` channels, and the
    theta pass, four outputs a thread (storing int16 theta where the
    outputs are int16).  Orders past the halo raise ValueError."""
    n8 = n4 // 2
    split = check_route("midend_plan", coeffs, n4) == "split"
    nn2, nh = coeffs.taps_fm_out.shape[0], coeffs.taps_hilbert.shape[0]
    tiles = (-(-n8 // MID_TILE), c)
    flat = (-(-c * n8 // 256),)
    ds2 = "k12_mid_ds2" + ("" if nn2 == TILED_TAPS[0] else "_any")
    hilb = "k12_mid_hilb" + ("" if nh == TILED_TAPS[1] else "_any")
    plan = [(f"{ds2}_kernel", tiles) if split
            else ("fir_decimate_kernel", flat)]
    if cfg.use_deemphasis_filter:
        plan.append(("k12_deemph_kernel", (-(-c // DEEMPH_LANES),)))
    plan.append((f"{hilb}_kernel", tiles) if split
                else ("k12_hilbert_kernel", flat))
    return plan + [("k12_peak_rec_kernel", (-(-c // PEAK_LANES),)),
                   ("k12_theta_kernel", (-(-c * n8 // (4 * 256)),))]


def midend_route(coeffs, n4: int) -> str:
    """"split", "launches" or "refused": the route ``fmt_midend`` and
    ``fmt_k12`` take (a host copy of ``csrc/k12_stages.cuh::midend_route``,
    by which the wrappers allocate).  Where both filters fit the halo
    (:data:`ORDERS`: 2 <= ds x2 taps <= 130, 1 <= Hilbert taps <= 129) and
    the block holds both carried tails (B/4 >= ds x2 taps - 2, B/8 >=
    Hilbert taps - 1), "split", with de-emphasis on or off and in float32
    and in every int16 form alike; on a block shorter than a tail
    "launches" (``demod_block`` never sends one: its blocks are multiples
    of 8,192 samples); other orders "refused".  The de-emphasis decides
    only whether its launch runs."""
    nn2, nh = coeffs.taps_fm_out.shape[0], coeffs.taps_hilbert.shape[0]
    (lo2, hi2), (loh, hih) = ORDERS
    if not (lo2 <= nn2 <= hi2 and loh <= nh <= hih):
        return "refused"
    if n4 < nn2 - 2 or n4 // 2 < nh - 1:
        return "launches"
    return "split"


def check_route(name: str, coeffs, n4: int) -> str:
    """:func:`midend_route`, raising ValueError (on every device, before
    any launch) where it refuses the filters."""
    route = midend_route(coeffs, n4)
    if route == "refused":
        nn2, nh = coeffs.taps_fm_out.shape[0], coeffs.taps_hilbert.shape[0]
        raise ValueError(f"{name}: ds x2 taps {nn2} / Hilbert taps {nh} "
                         f"reach past the mid end's {HALO}-sample halo "
                         f"(orders {ORDERS})")
    return route


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


def carried(hist: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The tail a FIR carries past the block ``x``: the last
    ``hist.shape[-1]`` samples of concat(``hist``, ``x``), which are
    ``x``'s own where the block is at least that long (JAX
    ``ops/fir.py::_decimate_core``)."""
    h = hist.shape[-1]
    if x.shape[-1] < h:
        x = torch.cat([hist.to(x.dtype), x], dim=-1)
    return x[:, x.shape[-1] - h :]


def mid_new_state(state: dict, fmd, fm_out, deemph, peak, power,
                  n8: int | None = None) -> dict:
    """Carried state after the mid end (midend_pallas.py:448-460): the
    ds x2 input tail and the Hilbert input tail (:func:`carried` past
    ``fmd`` and ``fm_out``: the block's inputs of the two FIRs, their last
    samples, or the new tails themselves; a block shorter than a tail
    keeps the old tail's last samples before its own), the IIR histories
    and the pilot AGC gain from the block's power sum over its ``n8``
    (default: ``fm_out``'s length) outputs."""
    new = dict(state)
    new["ds_fm_out"] = carried(state["ds_fm_out"], fmd)
    new["hilbert"] = carried(state["hilbert"], fm_out)
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
    tail2, fm_out = decimate_core(coeffs.taps_fm_out, state["ds_fm_out"],
                                  fmd, 2)
    deemph = state["deemph"]
    if cfg.use_deemphasis_filter:
        deemph, fm_out = iir_filter(coeffs.deemph_b, coeffs.deemph_a,
                                    deemph, fm_out)
    htail, (re, im) = hilbert_fir_p(coeffs.taps_hilbert, state["hilbert"],
                                    fm_out)
    peak, (pr, pi) = iir_filter_planes(coeffs.peak_b, coeffs.peak_a,
                                       state["peak_pilot"], (re, im))
    theta = atan2_poly(pi, pr) * f32(1.0 / (2.0 * math.pi))
    power = torch.sum(pr * pr + pi * pi, dim=-1)
    new = mid_new_state(state, tail2, htail, deemph, peak, power,
                        fm_out.shape[-1])
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
    """The mid end's scratch by ``route``: ``yi`` [C, n8] (the peak IIR's
    recurrence writes its filtered im plane there) and ``fm_out`` [C, n8]
    (whose last samples become the carried Hilbert tail) on every route;
    on the split route ``tails`` [C, ds x2 taps - 2], where its ds x2
    kernel writes the new ds x2 tail."""
    f = dict(device=dev, dtype=torch.float32)
    h2 = a["tail2"].shape[-1]
    return {"fm_out": torch.empty((c, n8), **f),
            "yi": torch.empty((c, n8), **f),
            "tails": (None if route == "launches"
                      else torch.empty((c, h2), **f))}


def buf_ptrs(buf: dict) -> list:
    """``fm_out``'s, ``yi``'s and ``tails``' pointers (None where unused)."""
    return [None if buf[k] is None else buf[k].data_ptr()
            for k in ("fm_out", "yi", "tails")]


def count_route(route: str, coeffs) -> None:
    """Count a launch of K2 or K12 on the split route
    (``launches_split``, and each any-order kernel it ran)."""
    global launches_split
    if route == "split":
        launches_split += 1
        count_any(coeffs.taps_fm_out.shape[0], coeffs.taps_hilbert.shape[0])


def count_any(nn2: int | None, nh: int | None) -> None:
    """Count the any-order kernels a launch ran: ds x2 at ``nn2`` taps and
    Hilbert at ``nh`` (None: not launched) off :data:`TILED_TAPS`."""
    global launches_ds2_any, launches_hilb_any
    launches_ds2_any += int(nn2 is not None and nn2 != TILED_TAPS[0])
    launches_hilb_any += int(nh is not None and nh != TILED_TAPS[1])


def mid_tails(route: str, buf: dict, fmd):
    """(fmd, fm_out) for :func:`mid_outputs`: on the split route the ds x2
    tail its ds x2 kernel wrote and the ``fm_out`` scratch, whose last
    samples are the Hilbert tail; else ``fmd`` and the ``fm_out``
    scratch."""
    if route == "launches":
        return fmd, buf["fm_out"]
    return buf["tails"], buf["fm_out"]


def _launch(coeffs, cfg, state: dict, fmd: torch.Tensor,
            out_i16: bool = False):
    dev = fmd.device
    c, n4 = fmd.shape
    a = mid_args("midend", coeffs, cfg, state, c, dev)
    _build.require("midend", dev, fmd.dtype, fmd=fmd)
    f = dict(device=dev, dtype=torch.float32)
    n8 = n4 // 2
    in_i16 = fmd.dtype == torch.int16
    route = midend_route(coeffs, n4)
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
    count_route(route, coeffs)
    # the carried tail, dequantised: only its last samples, not the planes
    fmd_t, fm_out_t = mid_tails(route, buf,
                                fmd[:, max(n4 - a["tail2"].shape[-1], 0) :])
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
    kernel.  Filters past the halo (:func:`midend_route`) raise on every
    device."""
    if fmd.ndim != 2 or fmd.dtype not in (torch.float32, torch.int16) \
            or fmd.shape[-1] % 32:
        raise ValueError(f"midend takes [C, B/4] float32 or int16 with "
                         f"B/4 % 32 == 0, got {fmd.dtype} "
                         f"{tuple(fmd.shape)}")
    check_route("midend", coeffs, fmd.shape[-1])
    if _build.on_cpu("midend", fmd.device):
        return midend_plain(coeffs, cfg, state, fmd, out_i16)
    global launches, launches_i16
    out = _launch(coeffs, cfg, state, fmd, out_i16)
    if out_i16 or fmd.dtype == torch.int16:
        launches_i16 += 1
    else:
        launches += 1
    return out


def _tiled_check(name: str, taps: torch.Tensor, orders: tuple[int, int],
                 x: torch.Tensor, dtypes, mult: int,
                 least: int) -> tuple[int, int]:
    """[C, n] of ``x`` after checking what the split route's tiled
    kernel ``name`` takes (on every device): a filter order within
    ``orders`` (the halo's, :data:`ORDERS`), ``x``'s dtype and rank,
    n % mult == 0 and n >= least."""
    lo, hi = orders
    if taps.ndim != 1 or not lo <= taps.shape[0] <= hi:
        raise ValueError(f"{name}: the tiled kernels take {lo} to {hi} "
                         f"taps, got {tuple(taps.shape)}")
    if x.ndim != 2 or x.dtype not in dtypes or x.shape[1] % mult \
            or x.shape[1] < least:
        raise ValueError(f"{name} takes [C, n] {dtypes} with n % {mult} == 0 "
                         f"and n >= {least}, got {x.dtype} {tuple(x.shape)}")
    return x.shape[0], x.shape[1]


def _outs(name: str, out, shapes, dtypes, dev):
    """``out`` checked against ``shapes`` and ``dtypes`` (the card only),
    or new tensors of them."""
    if out is None:
        return [torch.empty(s, device=dev, dtype=d)
                for s, d in zip(shapes, dtypes)]
    if len(out) != len(shapes) or any(
            o.shape != s or o.dtype != d or o.device != dev
            or not o.is_contiguous() for o, s, d in zip(out, shapes, dtypes)):
        raise ValueError(f"{name}: out must be {shapes} {dtypes} on {dev}")
    return list(out)


def mid_ds2_plain(w2_rev, tail2, src, prev_theta=None, scale: float = 1.0):
    """:func:`mid_ds2` in plain PyTorch: the discriminator (given
    ``prev_theta``) or the int16 dequantisation, then ds x2 as
    :func:`midend_plain` runs it."""
    if prev_theta is not None:
        _, fmd = discriminate_theta(prev_theta, src, scale)
    else:
        fmd = dq_if_i16(src, FM_SCALE)
    new_tail, fm_out = decimate_core(w2_rev.flip(0), tail2, fmd, 2)
    return fm_out, new_tail


def mid_ds2(w2_rev, tail2, src, prev_theta=None, scale: float = 1.0,
            out=None):
    """The split route's ds x2 kernel alone
    (``csrc/k12_stages.cuh::k12_mid_ds2_kernel``): fm_demod ``src`` [C, n4]
    float32 or int16 (FM_SCALE) or, given ``prev_theta`` [C] and the
    discriminator's ``scale``, theta1 [C, n4] (K12's form: the
    discriminator runs in the kernel), the reversed taps ``w2_rev`` [nn2]
    and the carried tail ``tail2`` [C, nn2 - 2] -> (fm_out [C, n4/2], the
    new ds x2 tail [C, nn2 - 2]); at 64 taps ``k12_mid_ds2_kernel``, at
    any other 2 <= nn2 <= 130 ``k12_mid_ds2_any_kernel``.  n4 % 16 == 0
    and n4 >= nn2 - 2.  CPU tensors run :func:`mid_ds2_plain`; CUDA
    tensors launch the kernel, into ``out`` where it is given."""
    nn2 = w2_rev.shape[0]
    dtypes = ((torch.float32,) if prev_theta is not None
              else (torch.float32, torch.int16))
    c, n4 = _tiled_check("mid_ds2", w2_rev, ORDERS[0], src, dtypes, 16,
                         nn2 - 2)
    if tail2.shape != (c, nn2 - 2) or (prev_theta is not None
                                       and prev_theta.shape != (c,)):
        raise ValueError(f"mid_ds2: tail2 must be [C, {nn2 - 2}] and "
                         "prev_theta [C]")
    if _build.on_cpu("mid_ds2", src.device):
        if out is not None:
            raise ValueError("mid_ds2: out= is for the card's kernel")
        return mid_ds2_plain(w2_rev, tail2, src, prev_theta, scale)
    global launches_ds2
    dev = src.device
    _build.require("mid_ds2", dev, src.dtype, src=src)
    extra = {} if prev_theta is None else {"prev_theta": prev_theta}
    _build.require("mid_ds2", dev, torch.float32, w2_rev=w2_rev, tail2=tail2,
                   **extra)
    fm_out, tails = _outs("mid_ds2", out, ((c, n4 // 2), (c, nn2 - 2)),
                          (torch.float32,) * 2, dev)
    form = 2 if prev_theta is not None else int(src.dtype == torch.int16)
    fn = _build.function("midend", "fmt_mid_ds2", DS2_ARGTYPES)
    _build.check("midend", fn(
        src.data_ptr(), form,
        None if prev_theta is None else prev_theta.data_ptr(), f32(scale),
        w2_rev.data_ptr(), nn2, tail2.data_ptr(), c, n4, fm_out.data_ptr(),
        tails.data_ptr(), _build.stream_ptr(dev)))
    launches_ds2 += 1
    count_any(nn2, None)
    return fm_out, tails


def mid_hilb_plain(wh_rev, htail, fm_out, out_i16: bool = False):
    """:func:`mid_hilb` in plain PyTorch: Hilbert as :func:`midend_plain`
    runs it."""
    _, (re, im) = hilbert_fir_p(wh_rev.flip(0), htail, fm_out)
    if out_i16:
        return re, im, q_i16(re, IQ_SCALE), q_i16(im, IQ_SCALE)
    return re, im


def mid_hilb(wh_rev, htail, fm_out, out_i16: bool = False, out=None):
    """The split route's Hilbert kernel alone
    (``csrc/k12_stages.cuh::k12_mid_hilb_kernel``): fm_out [C, n8]
    float32, the reversed taps ``wh_rev`` [nh] and the carried tail
    ``htail`` [C, nh - 1] -> (re, im) [C, n8] float32, with ``out_i16``
    also (re, im) as int16 at IQ_SCALE; at 65 taps
    ``k12_mid_hilb_kernel``, at any other 1 <= nh <= 129
    ``k12_mid_hilb_any_kernel``.  n8 % 8 == 0 and n8 >= nh - 1.  CPU
    tensors run :func:`mid_hilb_plain`; CUDA tensors launch the kernel,
    into ``out`` where it is given."""
    nh = wh_rev.shape[0]
    c, n8 = _tiled_check("mid_hilb", wh_rev, ORDERS[1], fm_out,
                         (torch.float32,), 8, nh - 1)
    if htail.shape != (c, nh - 1):
        raise ValueError(f"mid_hilb: htail must be [C, {nh - 1}]")
    if _build.on_cpu("mid_hilb", fm_out.device):
        if out is not None:
            raise ValueError("mid_hilb: out= is for the card's kernel")
        return mid_hilb_plain(wh_rev, htail, fm_out, out_i16)
    global launches_hilb
    dev = fm_out.device
    _build.require("mid_hilb", dev, torch.float32, fm_out=fm_out,
                   wh_rev=wh_rev, htail=htail)
    dts = (torch.float32,) * 2 + ((torch.int16,) * 2 if out_i16 else ())
    outs = _outs("mid_hilb", out, ((c, n8),) * len(dts), dts, dev)
    fn = _build.function("midend", "fmt_mid_hilb", HILB_ARGTYPES)
    _build.check("midend", fn(
        fm_out.data_ptr(), wh_rev.data_ptr(), nh, htail.data_ptr(), c, n8,
        *(o.data_ptr() for o in outs),
        *((None, None) if not out_i16 else ()), _build.stream_ptr(dev)))
    launches_hilb += 1
    count_any(None, nh)
    return tuple(outs)


def deemph_plain(b, a, state: dict, x):
    """:func:`deemph` in plain PyTorch: ``ops/iir.py::iir_filter``, the
    serial recurrence :func:`midend_plain` runs."""
    return iir_filter(b, a, state, x)


def deemph(b, a, state: dict, x, out=None):
    """The de-emphasis kernel alone (``csrc/k12_stages.cuh::
    k12_deemph_kernel``, which the split route and the launches route run
    in place over fm_out): the 1-pole IIR (b, a) over x [C, n] float32 from
    ``state`` (``x_hist``, ``y_hist`` [C, 1]) -> (new state, y [C, n]), as
    :func:`deemph_plain`.  n % 16 == 0.  CPU tensors run the plain
    version; CUDA tensors launch the kernel into ``out`` (``out=x``: in
    place, as the routes run it) or a new tensor."""
    if len(b) != 2 or len(a) != 2 or x.dim() != 2:
        raise ValueError("deemph: a 1-pole filter over x [C, n]")
    c, n = x.shape
    if n % 16 or c < 1:
        raise ValueError(f"deemph: n = {n} is not a positive multiple of "
                         "16 steps")
    if _build.on_cpu("deemph", x.device):
        if out is not None:
            raise ValueError("deemph: out= is for the card's kernel")
        return deemph_plain(b, a, state, x)
    global launches_de
    dev = x.device
    xh, yh = state["x_hist"], state["y_hist"]
    if xh.shape != (c, 1) or yh.shape != (c, 1):
        raise ValueError("deemph: state rows must be [C, 1]")
    de_in = torch.cat([xh, yh], dim=-1).contiguous()
    _build.require("deemph", dev, torch.float32, x=x, de_in=de_in)
    (y,) = _outs("deemph", None if out is None else (out,), ((c, n),),
                 (torch.float32,), dev)
    de_out = torch.empty_like(de_in)
    db = [f32(v) for v in b]
    da = [f32(v) for v in a]
    fn = _build.function("midend", "fmt_deemph", DEEMPH_ARGTYPES)
    _build.check("midend", fn(
        x.data_ptr(), y.data_ptr(), n, c, db[0], db[1], da[1],
        de_in.data_ptr(), de_out.data_ptr(), _build.stream_ptr(dev)))
    launches_de += 1
    return {"x_hist": de_out[:, 0:1], "y_hist": de_out[:, 1:2]}, y

