"""K1: the split front end of the demodulator — CUDA kernel and plain
version, on every ingest form.

Counterpart of ``fm_radio_tpu/kernels/frontend_pallas.py::ds4_disc_pallas``
(and its int8-direct form ``_ds4_disc_i8_direct``):

    baseband [C, B] -> ds x4 LPF (64 taps) -> polynomial atan2
    -> discriminator -> fm_demod [C, B/4] float32 (or, with ``out_i16``,
       the int16 inter-stage format at FM_SCALE, ``kernels/qformat.py``)

State keys read and written: ``ds_fm_in`` (the last 60 input samples,
complex64 of u8 - 127 values) and ``disc_prev_theta``.

Ingest forms (:func:`input_form`): "planes", (re, im) float32 [2, C, B];
"complex", complex64 [C, B] (the kernel reads its interleaved float pairs
in place; the JAX package splits it into planes first, the same samples);
"words", packed u8 words [C, B] float32 (w = I * 256 + Q, ``pack_iq_u8``);
"i8", int8 planes [2, C, B] of (I - 128, Q - 128) (``split_iq_i8``).

Taps (``int8_taps``): float32, summed from the oldest sample in one fixed
order; or ``quantize_band_int8``'s two int8 planes accumulated exactly as
integers, for integer input (the TPU kernel's ``int8_dots``).  The two
entries count apart: :func:`frontend` (``launches``, ``csrc/frontend.cu::
fmt_frontend``) takes planes, complex64 and words with either taps and
int8 planes with float taps; :func:`frontend_i8` (``launches_i8``,
``fmt_frontend_i8``) is the int8-direct form, int8 planes with int8 taps,
whose device code is K12's first launch with the discriminator's store.
Each is one launch (ds x4, atan2 and the discriminator;
``csrc/frontend.cu``) and counts its int16-format launches apart too
(``launches_i16``, ``launches_i8_i16``); the float taps' tile at other
orders than :data:`TILE_TAPS` (``k1_tile_any_kernel``) counts in
``launches_any`` too.  :func:`pick_tiles` is the JAX kernel's shape gate,
which decides whether ``demod_block`` asks for it.
"""

from __future__ import annotations

import torch

from fm_radio_tpu_torch.kernels import _build
from fm_radio_tpu_torch.kernels.qformat import FM_SCALE, q_i16
from fm_radio_tpu_torch.ops.cmath import atan2_poly, f32
from fm_radio_tpu_torch.ops.discriminator import disc_scale, discriminate_theta
from fm_radio_tpu_torch.ops.fir import correlate
from fm_radio_tpu_torch.utils.transfer import i8_planes_to_f32, unpack_iq_words

# kernel launches since the counter was last set to 0 (fmt_frontend, and
# the int8-direct fmt_frontend_i8; then each of them with the int16
# output); and every launch of fmt_frontend's float-tap tile at another
# order than TILE_TAPS (k1_tile_any_kernel), each counted by its form too
launches = 0
launches_i8 = 0
launches_i16 = 0
launches_i8_i16 = 0
launches_any = 0

# the order the float-tap tile is built for (csrc/frontend.cu: kK1Taps,
# k1_tile_kernel); every other takes k1_tile_any_kernel
TILE_TAPS = 64

_M, _NO = 4, 128  # the TPU kernel's decimation and default band width

FORMS = {"planes": 0, "words": 1, "i8": 2, "complex": 3}

_P, _I, _F = _build.P, _build.I, _build.F
_ARGTYPES = [_P, _I, _I, _P, _P, _P, _P, _P, _I, _F, _P, _F, _I, _I, _P, _P,
             _I, _P]
_ARGTYPES_I8 = [_P, _P, _P, _P, _I, _F, _P, _F, _I, _I, _P, _P, _I, _P]


def pick_tiles(c: int, b: int, no: int = _NO,
               max_t: int = 2048) -> tuple[int, int] | None:
    """(c_blk, t_blk) of the JAX kernel's grid, or None where shapes fail
    its contract: a host-only integer copy of
    ``frontend_pallas.py::pick_tiles`` (:569-595), which gates K1 and so
    the int16 format (demod.py:377-389).  The copy leaves out the
    ``FMTPU_FE_TILES`` override, a TPU tile-geometry lens that changes no
    output.  At the port's block multiple only the channel condition can
    fail (C <= 128 or C % 128 == 0)."""
    if b % (no * _M) != 0:
        return None
    t_blk = no * _M
    while t_blk * 2 <= max_t and b % (t_blk * 2) == 0:
        t_blk *= 2
    c_blk = c if c <= 128 else 128
    if c % c_blk != 0:
        return None
    return c_blk, t_blk


def input_form(x: torch.Tensor) -> str:
    """"planes", "complex", "words" or "i8" for a tensor that K1 takes;
    raises for any other dtype or shape."""
    if x.dtype == torch.float32 and x.ndim == 3 and x.shape[0] == 2:
        return "planes"
    if x.dtype == torch.complex64 and x.ndim == 2:
        return "complex"
    if x.dtype == torch.float32 and x.ndim == 2:
        return "words"
    if x.dtype == torch.int8 and x.ndim == 3 and x.shape[0] == 2:
        return "i8"
    raise ValueError(f"K1 takes [2, C, B] float32 or int8 planes, [C, B] "
                     f"complex64 or [C, B] float32 words, got {x.dtype} "
                     f"{tuple(x.shape)}")


def input_planes(x: torch.Tensor):
    """The centred (re, im) float32 planes (u8 - 127 for integer input)
    that the kernel loads, exactly."""
    form = input_form(x)
    if form == "planes":
        return x[0], x[1]
    if form == "complex":
        return x.real, x.imag
    if form == "words":
        return unpack_iq_words(x)
    return i8_planes_to_f32(x)


def _scale(cfg) -> float:
    return f32(disc_scale(cfg.analog.f_wbfm_deviation,
                          float(cfg.rates.fs_fm_in)))


def _front_state(state: dict, tail_re, tail_im, prev_theta) -> dict:
    new = dict(state)
    new["ds_fm_in"] = torch.complex(tail_re, tail_im)
    new["disc_prev_theta"] = prev_theta
    return new


def ds4_theta_plain(coeffs, state: dict, x: torch.Tensor,
                    int8_taps: bool):
    """The ds x4 + atan2 of K1 (and of K12's first launch) in plain
    PyTorch: (theta1 [C, B/4], the carried tail and block as planes
    [2, C, halo + B])."""
    xr, xi = input_planes(x)
    tail = state["ds_fm_in"]
    xf = torch.cat([torch.stack([tail.real, tail.imag]),
                    torch.stack([xr, xi])], dim=-1)
    n4 = xr.shape[-1] // 4
    if int8_taps:
        b1, b2, s_row = coeffs.k1_i8
        # shifted by -1 into int8 and truncated, as the kernel converts;
        # the integer sums are exact in float32 (|y| <= 127 * 128 * 64)
        x8 = torch.trunc(xf - 1.0)
        y1 = correlate(b1.tolist(), x8, 4, n4)
        y2 = correlate(b2.tolist(), x8, 4, n4)
        fm = (y1 + y2 * f32(1.0 / 128.0)) + s_row
    else:
        fm = correlate(coeffs.taps_fm_in.flip(0).tolist(), xf, 4, n4)
    return atan2_poly(fm[1], fm[0]), xf


def frontend_plain(coeffs, cfg, state: dict, x: torch.Tensor,
                   int8_taps: bool, out_i16: bool = False):
    """K1 in plain PyTorch, op by op in float32 in the kernel's order.
    Returns (state', fm_demod [C, B/4]), float32 or, with ``out_i16``, its
    ``q_i16`` at FM_SCALE."""
    theta1, xf = ds4_theta_plain(coeffs, state, x, int8_taps)
    prev_theta, fmd = discriminate_theta(state["disc_prev_theta"], theta1,
                                         _scale(cfg))
    halo = state["ds_fm_in"].shape[-1]
    t = xf[..., xf.shape[-1] - halo :]
    if out_i16:
        fmd = q_i16(fmd, FM_SCALE)
    return _front_state(state, t[0], t[1], prev_theta), fmd


def frontend_i8_plain(coeffs, cfg, state: dict, x8: torch.Tensor,
                      out_i16: bool = False):
    """The int8-direct K1 in plain PyTorch: :func:`frontend_plain` on int8
    planes with int8 taps."""
    return frontend_plain(coeffs, cfg, state, x8, True, out_i16)


def check_state(name: str, coeffs, state: dict, c: int) -> int:
    """The ds x4 order nn, after checking the carried state against it and
    the channel count."""
    nn = coeffs.taps_fm_in.shape[0]
    tail, prev = state["ds_fm_in"], state["disc_prev_theta"]
    if nn % 4 or tail.shape != (c, nn - 4) or prev.shape != (c,):
        raise ValueError(f"{name}: carried ds x4 state rows "
                         f"{tuple(tail.shape)}, {tuple(prev.shape)} do not "
                         f"match {nn} taps and {c} channels")
    return nn


def readable(x: torch.Tensor) -> torch.Tensor:
    """x itself where the kernel can read it in place: contiguous, and
    aligned as it loads it (the int8 forms as 4-byte words, the others in
    16-byte vectors of four samples); else a contiguous copy in a new
    allocation (a strided view, or a slice that starts between
    vectors)."""
    align = 4 if input_form(x) == "i8" else 16
    if x.is_contiguous() and x.data_ptr() % align == 0:
        return x
    return torch.empty(x.shape, dtype=x.dtype, device=x.device).copy_(x)


def _launch(coeffs, cfg, state: dict, x: torch.Tensor, int8_taps: bool,
            direct: bool, out_i16: bool = False):
    dev = x.device
    form = input_form(x)
    x = readable(x)
    c, b = x.shape[-2], x.shape[-1]
    name = "frontend_i8" if direct else "frontend"
    nn = check_state(name, coeffs, state, c)
    if b < nn - 4:
        raise ValueError(f"{name}: block {b} shorter than the tail")
    b1, b2, s_row = coeffs.k1_i8
    prev = state["disc_prev_theta"].contiguous()
    tail = state["ds_fm_in"]
    tail_f = torch.stack([tail.real, tail.imag]).contiguous()
    # the int8 taps read the tail as int8 words (u8 - 128, truncated as the
    # kernel shifts its samples)
    tail8 = (tail_f - 1.0).to(torch.int8) if int8_taps else None
    theta_last = torch.empty((c,), device=dev, dtype=torch.float32)
    fmd = torch.empty((c, b // 4), device=dev,
                      dtype=torch.int16 if out_i16 else torch.float32)
    _build.require(name, dev, torch.int8, b1=b1, b2=b2)
    _build.require(name, dev, torch.float32, prev=prev, tail=tail_f)
    if tail8 is not None:
        _build.require(name, dev, torch.int8, tail8=tail8)
    if any(t.data_ptr() % 4 for t in (b1, b2)) or (
            tail8 is not None and tail8.data_ptr() % 4):
        raise ValueError(f"{name}: the int8 taps and tail must be 4-byte "
                         f"aligned")
    if direct:
        _build.require(name, dev, torch.int8, x8=x)
        fn = _build.function("frontend", "fmt_frontend_i8", _ARGTYPES_I8)
        err = fn(x.data_ptr(), tail8.data_ptr(), b1.data_ptr(), b2.data_ptr(),
                 nn, s_row, prev.data_ptr(), _scale(cfg), c, b,
                 fmd.data_ptr(), theta_last.data_ptr(), int(out_i16),
                 _build.stream_ptr(dev))
    else:
        w_rev = coeffs.taps_fm_in.flip(0).contiguous()
        _build.require(name, dev, x.dtype, x=x)
        _build.require(name, dev, torch.float32, w_rev=w_rev)
        fn = _build.function("frontend", "fmt_frontend", _ARGTYPES)
        err = fn(x.data_ptr(), FORMS[form], int(int8_taps), tail_f.data_ptr(),
                 None if tail8 is None else tail8.data_ptr(),
                 w_rev.data_ptr(), b1.data_ptr(), b2.data_ptr(), nn, s_row,
                 prev.data_ptr(), _scale(cfg), c, b, fmd.data_ptr(),
                 theta_last.data_ptr(), int(out_i16), _build.stream_ptr(dev))
    _build.check("frontend", err)
    t_re, t_im = input_planes(x[..., b - (nn - 4) :])
    return _front_state(state, t_re, t_im, theta_last), fmd


def frontend(coeffs, cfg, state: dict, x: torch.Tensor, int8_taps: bool,
             out_i16: bool = False):
    """x: float32 planes [2, C, B], complex64 [C, B], packed words [C, B]
    or int8 planes [2, C, B] (int8 planes with float taps only; with int8
    taps they take :func:`frontend_i8`) -> (state', fm_demod [C, B/4],
    float32 or with
    ``out_i16`` int16).  CPU tensors run :func:`frontend_plain`; CUDA
    tensors launch the kernel."""
    form = input_form(x)
    if x.shape[-1] % 4:
        raise ValueError(f"frontend: block {x.shape[-1]} % 4 != 0")
    if form == "i8" and int8_taps:
        raise ValueError("frontend: int8 planes with int8 taps are the "
                         "int8-direct form (frontend_i8)")
    if _build.on_cpu("frontend", x.device):
        return frontend_plain(coeffs, cfg, state, x, int8_taps, out_i16)
    global launches, launches_i16, launches_any
    out = _launch(coeffs, cfg, state, x, int8_taps, False, out_i16)
    if out_i16:
        launches_i16 += 1
    else:
        launches += 1
    launches_any += int(not int8_taps
                        and coeffs.taps_fm_in.shape[0] != TILE_TAPS)
    return out


def frontend_i8(coeffs, cfg, state: dict, x8: torch.Tensor,
                out_i16: bool = False):
    """The int8-direct K1: x8 [2, C, B] int8 planes (u8 - 128) with int8
    taps -> (state', fm_demod [C, B/4], float32 or with ``out_i16``
    int16).  CPU tensors run :func:`frontend_i8_plain`; CUDA tensors launch
    the kernel."""
    if input_form(x8) != "i8" or x8.shape[-1] % 4:
        raise ValueError(f"frontend_i8 takes [2, C, B] int8 with B % 4 == 0, "
                         f"got {x8.dtype} {tuple(x8.shape)}")
    if _build.on_cpu("frontend_i8", x8.device):
        return frontend_i8_plain(coeffs, cfg, state, x8, out_i16)
    global launches_i8, launches_i8_i16
    out = _launch(coeffs, cfg, state, x8, True, True, out_i16)
    if out_i16:
        launches_i8_i16 += 1
    else:
        launches_i8 += 1
    return out
