"""K12: the int8 front end and mid end of the demodulator — CUDA kernel and
plain version.

Counterpart of ``fm_radio_tpu/kernels/k12_pallas.py::k12_pallas`` on
[2, C, B] int8 planes (u8 - 128):

    ds x4 LPF (64 taps quantised to two int8 planes, int32 accumulation)
    -> polynomial-atan2 discriminator -> ds x2 LPF (64 taps)
    -> optional 1-pole de-emphasis -> 65-tap Hilbert -> (re, im)
    -> order-2 19 kHz peak IIR on both planes -> theta = angle / 2pi
    -> pilot power sum -> agc_pilot gain update

It reproduces the TPU kernel's arithmetic, not its layout (banded
matmuls, Toeplitz tiles, bf16 splits).  The ds x4 taps are exactly
``quantize_band_int8``'s (``frontend_pallas.py:95``): y1 = sum b1*x8 and
y2 = sum b2*x8 are exact integers, combined as y1 + y2/128 + s_row, where
s_row folds in the +1 recentre of the u8 - 128 planes.  The kernel is
``csrc/k12.cu``.

:func:`k12_ps` is the same function on phase-split planes [2, 4, C, B/4]
(x_p[u] = x[4u + p], the wideband channelizer's M = 32 output), the
counterpart of ``k12_pallas.py::_k12_kernel_ps``: bit-identical outputs
and state.  It launches ``fmt_k12`` with ``phase_split`` set (its own
ds x4 kernel; the later stages are shared) and counts apart, in
``launches_ps``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fm_radio_tpu_torch.kernels import _build
from fm_radio_tpu_torch.ops.agc import _agc_gain
from fm_radio_tpu_torch.ops.cmath import atan2_poly, div_scalar, f32
from fm_radio_tpu_torch.ops.discriminator import disc_scale, discriminate_theta
from fm_radio_tpu_torch.ops.fir import correlate, decimate_core, hilbert_fir_p
from fm_radio_tpu_torch.ops.iir import iir_filter, iir_filter_planes

# kernel launches since the counter was last set to 0 (flat entry, and
# the phase-split entry)
launches = 0
launches_ps = 0

_P, _I, _F = _build.P, _build.I, _build.F
_ARGTYPES = (
    [_P] * 4 + [_I, _F, _P, _F, _P, _I, _P, _I, _F, _F, _F, _P, _P, _P, _I, _P]
    + [_F] * 5 + [_P, _P, _I, _I, _I] + [_P] * 7 + [_P]
)


def quantize_ds4_taps(taps: np.ndarray):
    """Two-plane int8 split of the ds x4 taps, as ``quantize_band_int8``
    computes it in float32: taps*q ~ b1 + b2/128 with q the largest power of
    two keeping |taps*q| <= 127.  Returns (b1, b2) as int8 arrays in
    REVERSED tap order (oldest input first) and s_row = sum(b1 + b2/128),
    the +1 recentre correction at the same scale (a float32 value)."""
    w = np.asarray(taps, np.float32)[::-1]
    amax = np.max(np.abs(w))
    q = np.exp2(np.floor(np.log2(np.float32(127.0) / amax)))
    b1 = np.clip(np.round(w * q), -127, 127)
    b2 = np.clip(np.round((w * q - b1) * np.float32(128.0)), -127, 127)
    s_row = np.sum(b1 + b2 * np.float32(1.0 / 128.0), dtype=np.float32)
    return b1.astype(np.int8), b2.astype(np.int8), float(s_row)


def _deemph_rows(st: dict) -> torch.Tensor:
    return torch.stack([st["x_hist"][:, 0], st["y_hist"][:, 0]], dim=-1)


def _peak_rows(st: dict, c: int) -> torch.Tensor:
    x, y = st["x_hist"], st["y_hist"]
    return torch.stack([x[:c, 0], x[:c, 1], y[:c, 0], y[:c, 1],
                        x[c:, 0], x[c:, 1], y[c:, 0], y[c:, 1]], dim=-1)


def _new_state(state, x8, prev_theta, fmd, fm_out, deemph, peak, power):
    """Carried state after one block (the union of the split kernels'
    keys, k12_pallas.py:367-380)."""
    halo1 = state["ds_fm_in"].shape[-1]
    tail = x8[:, :, x8.shape[-1] - halo1 :].to(torch.float32) + 1.0
    new = dict(state)
    new["ds_fm_in"] = torch.complex(tail[0], tail[1])
    new["disc_prev_theta"] = prev_theta
    new["ds_fm_out"] = fmd[:, fmd.shape[-1] - state["ds_fm_out"].shape[-1] :]
    new["hilbert"] = fm_out[:, fm_out.shape[-1] - state["hilbert"].shape[-1] :]
    new["deemph"] = deemph
    new["peak_pilot"] = peak
    new["agc_pilot"] = _agc_gain(state["agc_pilot"],
                                 div_scalar(power, fm_out.shape[-1]), 1.0, 0.2)
    return new


def k12_plain(coeffs, cfg, state: dict, x8: torch.Tensor):
    """K12 in plain PyTorch, op by op in float32 in the kernel's order.
    Returns (state', (re, im) [C, B/8], theta [C, B/8] cycles)."""
    b1, b2, s_row = coeffs.k1_i8
    tail = torch.stack([state["ds_fm_in"].real, state["ds_fm_in"].imag]) - 1.0
    xf = torch.cat([tail, x8.to(torch.float32)], dim=-1)
    n4 = x8.shape[-1] // 4
    # exact integers in float32: |partial sums| <= 127 * 128 * 64 < 2^24
    y1 = correlate(b1.tolist(), xf, 4, n4)
    y2 = correlate(b2.tolist(), xf, 4, n4)
    fm = (y1 + y2 * f32(1.0 / 128.0)) + s_row
    scale = f32(disc_scale(cfg.analog.f_wbfm_deviation,
                           float(cfg.rates.fs_fm_in)))
    prev_theta, fmd = discriminate_theta(state["disc_prev_theta"],
                                         atan2_poly(fm[1], fm[0]), scale)
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
    new = _new_state(state, x8, prev_theta, fmd, fm_out, deemph, peak, power)
    return new, (re, im), theta


def _ps_tail(x4: torch.Tensor, halo: int) -> torch.Tensor:
    """The last ``halo`` samples of each channel, interleaved again, from
    phase planes [2, 4, C, B/4] -> [2, C, halo]."""
    last = x4[..., x4.shape[-1] - halo // 4 :]  # [2, 4, C, halo/4]
    return last.permute(0, 2, 3, 1).reshape(2, x4.shape[2], halo)


def interleave_ps(x4: torch.Tensor) -> torch.Tensor:
    """Phase planes [2, 4, C, B/4] -> flat planes [2, C, B]."""
    return x4.permute(0, 2, 3, 1).reshape(2, x4.shape[2], -1)


def k12_ps_plain(coeffs, cfg, state: dict, x4: torch.Tensor):
    """:func:`k12_plain` on the planes interleaved again: the same integer
    arithmetic, so the same outputs and state as the flat form."""
    return k12_plain(coeffs, cfg, state, interleave_ps(x4))


def _check_x(x: torch.Tensor, ps: bool) -> None:
    if ps:
        ok = x.ndim == 4 and x.shape[:2] == (2, 4) and x.shape[-1] % 2 == 0
        form = "[2, 4, C, B/4] with B % 8 == 0"
    else:
        ok = x.ndim == 3 and x.shape[0] == 2 and x.shape[-1] % 8 == 0
        form = "[2, C, B] with B % 8 == 0"
    if x.dtype != torch.int8 or not ok:
        raise ValueError(f"k12{'_ps' if ps else ''} takes {form} int8, got "
                         f"{x.dtype} {tuple(x.shape)}")


def _launch(coeffs, cfg, state: dict, x: torch.Tensor, ps: bool):
    """Launch fmt_k12 on flat planes [2, C, B] or, with ``ps``, on phase
    planes [2, 4, C, B/4], and assemble (state', (re, im), theta)."""
    dev = x.device
    c = x.shape[-2]
    b = x.shape[-1] * 4 if ps else x.shape[-1]
    n4, n8 = b // 4, b // 8
    b1, b2, s_row = coeffs.k1_i8
    nn1 = b1.shape[0]
    name = "k12_ps" if ps else "k12"
    w2_rev = coeffs.taps_fm_out.flip(0).contiguous()
    wh_rev = coeffs.taps_hilbert.flip(0).contiguous()
    prev = state["disc_prev_theta"].contiguous()
    tail2 = state["ds_fm_out"].contiguous()
    htail = state["hilbert"].contiguous()
    if tail2.shape[-1] != w2_rev.shape[0] - 2 \
            or htail.shape[-1] != wh_rev.shape[0] - 1 \
            or state["ds_fm_in"].shape[-1] != nn1 - 4 or nn1 % 4:
        raise ValueError(f"{name}: carried tails do not match the filter "
                         "orders")
    peak_rows = {v.shape[0] for v in state["peak_pilot"].values()}
    if peak_rows != {2 * c}:
        raise ValueError(f"{name}: peak IIR state rows {peak_rows} do not "
                         f"match the {c} channels (2 C rows)")
    de_in = _deemph_rows(state["deemph"])
    pk_in = _peak_rows(state["peak_pilot"], c)
    if state["ds_fm_in"].shape[0] != c or prev.shape != (c,) or any(
            t.shape[0] != c for t in (tail2, htail, de_in, pk_in)):
        raise ValueError(f"{name}: state rows do not match the {c} channels")
    tail8 = (torch.stack([state["ds_fm_in"].real, state["ds_fm_in"].imag])
             - 1.0).to(torch.int8)
    if ps:
        if nn1 % 16:
            raise ValueError(f"k12_ps: {nn1} ds x4 taps are not 4 words per "
                             "phase (nn % 16 != 0)")
        # per phase: one pad byte, then the last nn/4 - 1 samples
        # (x_p[-(nn/4 - 1) + i] = tail[4i + p]); taps b[4e + p] per phase
        ne = nn1 // 4
        per_phase = tail8.reshape(2, c, ne - 1, 4).permute(0, 3, 1, 2)
        tail8 = torch.nn.functional.pad(per_phase, (1, 0)).contiguous()
        b1 = b1.reshape(ne, 4).t().contiguous()
        b2 = b2.reshape(ne, 4).t().contiguous()
    _build.require(name, dev, torch.int8, x8=x, tail8=tail8, b1=b1, b2=b2)
    _build.require(name, dev, torch.float32, prev=prev, tail2=tail2,
                   w2_rev=w2_rev, wh_rev=wh_rev, htail=htail, de_in=de_in,
                   pk_in=pk_in)
    # the ds x4 stage reads the int8 planes, tail and taps as int32 words
    if any(t.data_ptr() % 4 for t in (x, tail8, b1, b2)):
        raise ValueError(f"{name}: int8 inputs must be 4-byte aligned")
    f = dict(device=dev, dtype=torch.float32)
    theta1 = torch.empty((c, n4), **f)
    fmd = torch.empty((c, n4), **f)
    fm_out = torch.empty((c, n8), **f)
    re = torch.empty((c, n8), **f)
    im = torch.empty((c, n8), **f)
    theta = torch.empty((c, n8), **f)
    power = torch.empty((c,), **f)
    de_out = torch.empty_like(de_in)
    pk_out = torch.empty_like(pk_in)
    db, da = [f32(v) for v in coeffs.deemph_b], [f32(v) for v in coeffs.deemph_a]
    pb, pa = [f32(v) for v in coeffs.peak_b], [f32(v) for v in coeffs.peak_a]
    scale = f32(disc_scale(cfg.analog.f_wbfm_deviation,
                           float(cfg.rates.fs_fm_in)))
    use_de = bool(cfg.use_deemphasis_filter)
    fn = _build.function("k12", "fmt_k12", _ARGTYPES)
    err = fn(x.data_ptr(), tail8.data_ptr(), b1.data_ptr(), b2.data_ptr(),
             nn1, s_row, prev.data_ptr(), scale, w2_rev.data_ptr(),
             w2_rev.shape[0], tail2.data_ptr(), int(use_de), db[0], db[1],
             da[1], de_in.data_ptr(), de_out.data_ptr(), wh_rev.data_ptr(),
             wh_rev.shape[0], htail.data_ptr(), pb[0], pb[1], pb[2], pa[1],
             pa[2], pk_in.data_ptr(), pk_out.data_ptr(), c, b, int(ps),
             theta1.data_ptr(), fmd.data_ptr(), fm_out.data_ptr(),
             re.data_ptr(), im.data_ptr(), theta.data_ptr(), power.data_ptr(),
             _build.stream_ptr(dev))
    _build.check("k12", err)
    deemph = state["deemph"]
    if use_de:
        deemph = {"x_hist": de_out[:, 0:1], "y_hist": de_out[:, 1:2]}
    peak = {
        "x_hist": torch.cat([pk_out[:, 0:2], pk_out[:, 4:6]], dim=0),
        "y_hist": torch.cat([pk_out[:, 2:4], pk_out[:, 6:8]], dim=0),
    }
    x_tail = _ps_tail(x, nn1 - 4) if ps else x
    new = _new_state(state, x_tail, theta1[:, -1], fmd, fm_out, deemph, peak,
                     power)
    return new, (re, im), theta


def k12(coeffs, cfg, state: dict, x8: torch.Tensor):
    """x8 [2, C, B] int8 -> (state', (re, im) [C, B/8], theta [C, B/8]).
    CPU tensors run :func:`k12_plain`; CUDA tensors launch the kernel."""
    _check_x(x8, ps=False)
    if _build.on_cpu("k12", x8.device):
        return k12_plain(coeffs, cfg, state, x8)
    global launches
    out = _launch(coeffs, cfg, state, x8, ps=False)
    launches += 1
    return out


def k12_ps(coeffs, cfg, state: dict, x4: torch.Tensor):
    """Phase planes x4 [2, 4, C, B/4] int8 -> the outputs of :func:`k12` on
    the interleaved [2, C, B].  CPU tensors run :func:`k12_ps_plain`; CUDA
    tensors launch the phase-split kernel (never a re-interleave)."""
    _check_x(x4, ps=True)
    if _build.on_cpu("k12_ps", x4.device):
        return k12_ps_plain(coeffs, cfg, state, x4)
    global launches_ps
    out = _launch(coeffs, cfg, state, x4, ps=True)
    launches_ps += 1
    return out
