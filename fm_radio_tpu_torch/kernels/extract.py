"""Extract: L+R / L-R / RDS band extraction — CUDA kernel and plain version.

Counterpart of ``fm_radio_tpu/kernels/extract_pallas.py::extract_pallas``:
from the analytic signal (re, im) [C, N] and the pilot NCO track dt [C, N],
build the harmonic phasors from one base phasor per sample
(extract_pallas.py:55-71), mix, and decimate: L+R ds x4 (Re), L-R ds x4
(harmonic 2, rotated by ``lmr_phase_err``), RDS ds x8 (harmonic 3).  Also
returns the RDS power sum for the fused RDS AGC.  ``lmr_phase_err`` is read
here and updated afterwards by the caller.  The kernel is
``csrc/extract.cu``.

The int16 inter-stage format (``kernels/qformat.py``): the planes may be
int16 at IQ_SCALE, and dt int16 at PH_SCALE where the planes are too
(extract_pallas.py:141-146, :244-245); the kernel dequantises them on load
and the carried ``ds_audio_lpr`` tail is the dequantised planes'
(:293-300).  Launches with int16 planes and dt count in ``launches_i16``,
with int16 planes and float32 dt (where the PLL could not take int16) in
``launches_i16_f32dt``.  :func:`pick_tiles_ext` is the JAX kernel's shape
gate.

The kernel has two routes (:func:`extract_route`, a host copy of
``csrc/extract.cu::extract_route``): at the receiver's filter orders (128
taps for L+R, L-R and RDS) the register-blocked kernel, counted also in
``launches_blocked``; at other orders within the 128-sample halos the
tiled kernel, one output a thread.  Both sum every output in the plain
version's tap order.
"""

from __future__ import annotations

import torch

from fm_radio_tpu_torch.kernels import _build
from fm_radio_tpu_torch.kernels.qformat import IQ_SCALE, PH_SCALE, dq_if_i16
from fm_radio_tpu_torch.ops.cmath import chebyshev_sine, wrap_cycles
from fm_radio_tpu_torch.ops.fir import polyphase_decimate_p

# kernel launches since the counter was last set to 0: float32 planes and
# dt; int16 planes and dt; int16 planes and float32 dt
launches = 0
launches_i16 = 0
launches_i16_f32dt = 0
# launches of any form on the blocked route (each also counted above)
launches_blocked = 0

TILE = 1024  # fm_out samples per CUDA block (csrc/extract.cu kExtTile)
_NO = 128    # the TPU kernel's band width

_P, _I = _build.P, _build.I
_ARGTYPES = ([_P] * 3 + [_I] * 2 + [_P] * 4 + [_I] + [_P] * 2 + [_I]
             + [_P] * 2 + [_I, _P] + [_I] * 3 + [_P] * 11 + [_P])
ROUTE_ARGTYPES = [_I] * 2
# the filter order the blocked kernel is built for (csrc/extract.cu
# kExtTaps): the receiver's L+R, L-R and RDS filters (models/demod.py::
# make_coeffs)
BLOCKED_TAPS = 128


def extract_route(coeffs) -> str:
    """"blocked" or "tiled": the kernel ``fmt_extract`` launches for these
    filters (a host copy of ``csrc/extract.cu::extract_route``): the
    blocked one where the L+R / L-R and the RDS filters both have
    :data:`BLOCKED_TAPS` taps, else the tiled one."""
    nn_a, nn_r = coeffs.taps_audio_lpr.shape[0], coeffs.taps_rds.shape[0]
    return "blocked" if nn_a == nn_r == BLOCKED_TAPS else "tiled"


def pick_tiles_ext(c: int, b8: int) -> tuple[int, int] | None:
    """(c_blk, t_blk) of the JAX kernel's grid, or None where shapes fail
    its contract: a host-only integer copy of
    ``extract_pallas.py::pick_tiles_ext`` (:170-179), which K2's int16
    output predicts (demod.py:450-463)."""
    if b8 % (_NO * 8) != 0:
        return None
    t_blk = _NO * 8
    c_blk = c if c <= 128 else 128
    if c % c_blk != 0:
        return None
    return c_blk, t_blk


def harmonics(cfg) -> None:
    """Raise unless the L-R and RDS carriers are the pilot's 2nd and 3rd
    harmonics (38 kHz and 57 kHz), the only phasor construction ported."""
    a = cfg.analog
    if (a.f_audio_lmr_center / a.f_pilot, a.f_rds_center / a.f_pilot) \
            != (2.0, 3.0):
        raise NotImplementedError(
            "extract: only the standard 2nd/3rd pilot harmonics are ported "
            "(ROADMAP.md, queue 1: other ingest forms and options)")


def mix(xr, xi, dt, off):
    """The mixed L-R and RDS planes ((lmr_re, lmr_im), (rds_re, rds_im))
    for dt [C, N] and the per-channel L-R offset off [C] (cycles)."""
    c1 = chebyshev_sine(wrap_cycles(dt + 0.25))
    s1 = chebyshev_sine(wrap_cycles(dt))
    c2r = c1 * c1 - s1 * s1
    s2r = 2.0 * c1 * s1
    off = off[:, None]
    co = chebyshev_sine(wrap_cycles(off + 0.25))
    so = chebyshev_sine(wrap_cycles(off))
    c2 = c2r * co - s2r * so
    s2 = s2r * co + c2r * so
    c3 = c2r * c1 - s2r * s1
    s3 = s2r * c1 + c2r * s1
    return ((xr * c2 - xi * s2, xr * s2 + xi * c2),
            (xr * c3 - xi * s3, xr * s3 + xi * c3))


def extract_plain(coeffs, cfg, state: dict, iq_p, dt: torch.Tensor):
    """Extraction in plain PyTorch, in the kernel's op order, on the planes
    and dt dequantised first where they are int16.  Returns (state', lpr
    [C, N/4], (lmr_re, lmr_im) [C, N/4], (rds_re, rds_im) [C, N/8],
    rds_pow [C])."""
    harmonics(cfg)
    iq_p = tuple(dq_if_i16(p, IQ_SCALE) for p in iq_p)
    dt = dq_if_i16(dt, PH_SCALE)
    xr, xi = iq_p
    mix_lmr, mix_rds = mix(xr, xi, dt, state["lmr_phase_err"])
    new = dict(state)
    new["ds_audio_lpr"], lpr = polyphase_decimate_p(
        coeffs.taps_audio_lpr, state["ds_audio_lpr"], iq_p, 4, imag_out=False)
    new["ds_audio_lmr"], lmr = polyphase_decimate_p(
        coeffs.taps_audio_lmr, state["ds_audio_lmr"], mix_lmr, 4)
    new["ds_rds"], rds = polyphase_decimate_p(
        coeffs.taps_rds, state["ds_rds"], mix_rds, 8)
    rds_pow = torch.sum(rds[0] * rds[0] + rds[1] * rds[1], dim=-1)
    return new, lpr, lmr, rds, rds_pow


TAILS = ("t_lpr_re", "t_lpr_im", "t_lmr_re", "t_lmr_im", "t_rds_re",
         "t_rds_im")


def ext_args(name: str, coeffs, cfg, state: dict, c: int, dev) -> dict:
    """The extraction's carried tails (``ds_audio_lpr``'s raw re/im,
    ``ds_audio_lmr``'s and ``ds_rds``'s mixed re/im), the L-R offset and
    the reversed taps as the C entries take them (``fmt_extract``,
    ``fmt_chain``), checked: every tensor on ``dev``, contiguous float32,
    the tails matching the filter orders and the ``c`` channels."""
    harmonics(cfg)
    t_lpr, t_lmr, t_rds = (state[k] for k in ("ds_audio_lpr", "ds_audio_lmr",
                                              "ds_rds"))
    a = {"t_lpr_re": t_lpr.real, "t_lpr_im": t_lpr.imag,
         "t_lmr_re": t_lmr.real, "t_lmr_im": t_lmr.imag,
         "t_rds_re": t_rds.real, "t_rds_im": t_rds.imag,
         "off": state["lmr_phase_err"], "wa": coeffs.taps_audio_lpr.flip(0),
         "wm": coeffs.taps_audio_lmr.flip(0), "wr": coeffs.taps_rds.flip(0)}
    a = {k: v.contiguous() for k, v in a.items()}
    halo_a, halo_r = a["wa"].shape[0] - 4, a["wr"].shape[0] - 8
    halos = dict.fromkeys(TAILS[:4], halo_a) | dict.fromkeys(TAILS[4:], halo_r)
    if a["wm"].shape != a["wa"].shape or a["off"].shape != (c,) or any(
            a[k].shape != (c, h) for k, h in halos.items()):
        raise ValueError(f"{name}: carried tails do not match the filters "
                         f"and the {c} channels")
    _build.require(name, dev, torch.float32, **a)
    return a


def extract(coeffs, cfg, state: dict, iq_p, dt: torch.Tensor):
    """(re, im), dt [C, N] -> as :func:`extract_plain`: float32, or the
    planes int16 with dt int16 or float32.  CPU tensors run the plain
    version; CUDA tensors launch the kernel of :func:`extract_route` (N %
    1024 == 0)."""
    xr, xi = iq_p
    iq_i16, dt_i16 = xr.dtype == torch.int16, dt.dtype == torch.int16
    if dt_i16 and not iq_i16:
        raise ValueError("extract: int16 dt needs int16 planes")
    if _build.on_cpu("extract", dt.device):
        return extract_plain(coeffs, cfg, state, iq_p, dt)
    global launches, launches_i16, launches_i16_f32dt, launches_blocked
    dev = dt.device
    c, n = dt.shape
    if n % TILE:
        raise ValueError(f"extract: N = {n} is not a multiple of {TILE}")
    a = ext_args("extract", coeffs, cfg, state, c, dev)
    if xr.shape != (c, n) or xi.shape != (c, n):
        raise ValueError("extract: shapes of the planes, dt and state disagree")
    _build.require("extract", dev, xr.dtype, xr=xr, xi=xi)
    _build.require("extract", dev, dt.dtype, dt=dt)
    halo_a, halo_r = a["t_lpr_re"].shape[-1], a["t_rds_re"].shape[-1]
    f = dict(device=dev, dtype=torch.float32)
    lpr = torch.empty((c, n // 4), **f)
    lmr_re, lmr_im = torch.empty((c, n // 4), **f), torch.empty((c, n // 4), **f)
    rds_re, rds_im = torch.empty((c, n // 8), **f), torch.empty((c, n // 8), **f)
    pow_part = torch.empty((c, n // TILE), **f)
    rds_pow = torch.empty((c,), **f)
    o_lmr_re, o_lmr_im, o_rds_re, o_rds_im = (
        torch.empty_like(a[k]) for k in TAILS[2:])
    fn = _build.function("extract", "fmt_extract", _ARGTYPES)
    err = fn(xr.data_ptr(), xi.data_ptr(), dt.data_ptr(), int(iq_i16),
             int(dt_i16), a["off"].data_ptr(),
             a["t_lpr_re"].data_ptr(), a["t_lmr_re"].data_ptr(),
             a["t_lmr_im"].data_ptr(), halo_a, a["t_rds_re"].data_ptr(),
             a["t_rds_im"].data_ptr(), halo_r, a["wa"].data_ptr(),
             a["wm"].data_ptr(), a["wa"].shape[0], a["wr"].data_ptr(),
             a["wr"].shape[0], c, n, lpr.data_ptr(), lmr_re.data_ptr(),
             lmr_im.data_ptr(), rds_re.data_ptr(), rds_im.data_ptr(),
             pow_part.data_ptr(), rds_pow.data_ptr(), o_lmr_re.data_ptr(),
             o_lmr_im.data_ptr(), o_rds_re.data_ptr(), o_rds_im.data_ptr(),
             _build.stream_ptr(dev))
    _build.check("extract", err)
    if dt_i16:
        launches_i16 += 1
    elif iq_i16:
        launches_i16_f32dt += 1
    else:
        launches += 1
    if extract_route(coeffs) == "blocked":
        launches_blocked += 1
    new = dict(state)
    # the raw L+R tail, dequantised: only its last samples
    new["ds_audio_lpr"] = torch.complex(
        *(dq_if_i16(p[:, n - halo_a :], IQ_SCALE) for p in (xr, xi)))
    new["ds_audio_lmr"] = torch.complex(o_lmr_re, o_lmr_im)
    new["ds_rds"] = torch.complex(o_rds_re, o_rds_im)
    return new, lpr, (lmr_re, lmr_im), (rds_re, rds_im), rds_pow
