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
``csrc/k12.cu``.  It is the split path's int8-direct K1
(``kernels/frontend.py``) followed by K2 (``kernels/midend.py``) in one
call: the plain version composes their plain versions, and the kernel
shares their device code (``csrc/k12_stages.cuh``), so both paths agree
bit for bit.

:func:`k12_ps` is the same function on phase-split planes [2, 4, C, B/4]
(x_p[u] = x[4u + p], the wideband channelizer's M = 32 output), the
counterpart of ``k12_pallas.py::_k12_kernel_ps``: bit-identical outputs
and state.  It launches ``fmt_k12`` with ``phase_split`` set (its own
ds x4 kernel; the later stages are shared) and counts apart, in
``launches_ps``.
"""

from __future__ import annotations

import numpy as np
import torch

from fm_radio_tpu_torch.kernels import _build
from fm_radio_tpu_torch.kernels.frontend import check_state, frontend_i8_plain
from fm_radio_tpu_torch.kernels.midend import (
    buf_ptrs,
    check_route,
    count_route,
    mid_args,
    mid_buffers,
    mid_c_args,
    mid_outputs,
    mid_tails,
    midend_plain,
    midend_route,
)
from fm_radio_tpu_torch.ops.cmath import f32
from fm_radio_tpu_torch.ops.discriminator import disc_scale

# kernel launches since the counter was last set to 0 (flat entry, and
# the phase-split entry)
launches = 0
launches_ps = 0

_P, _I, _F = _build.P, _build.I, _build.F
_ARGTYPES = (
    [_P] * 4 + [_I, _F, _P, _F, _P, _I, _P, _I, _F, _F, _F, _P, _P, _P, _I, _P]
    + [_F] * 5 + [_P, _P, _I, _I, _I] + [_P] * 10
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


def k12_plain(coeffs, cfg, state: dict, x8: torch.Tensor):
    """K12 in plain PyTorch, op by op in float32 in the kernel's order: the
    int8-direct K1 then K2, as the kernel runs their device code.  Returns
    (state', (re, im) [C, B/8], theta [C, B/8] cycles)."""
    st, fmd = frontend_i8_plain(coeffs, cfg, state, x8)
    return midend_plain(coeffs, cfg, st, fmd)


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
    name = "k12_ps" if ps else "k12"
    nn1 = check_state(name, coeffs, state, c)
    prev = state["disc_prev_theta"].contiguous()
    a = mid_args(name, coeffs, cfg, state, c, dev)
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
    _build.require(name, dev, torch.float32, prev=prev)
    # the ds x4 stage reads the int8 planes, tail and taps as int32 words
    if any(t.data_ptr() % 4 for t in (x, tail8, b1, b2)):
        raise ValueError(f"{name}: int8 inputs must be 4-byte aligned")
    f = dict(device=dev, dtype=torch.float32)
    route = midend_route(coeffs, n4)
    buf = mid_buffers(route, a, c, n8, dev)
    theta1 = torch.empty((c, n4), **f)
    fmd = torch.empty((c, n4), **f) if route == "launches" else None
    re, im, theta = (torch.empty((c, n8), **f) for _ in range(3))
    power = torch.empty((c,), **f)
    scale = f32(disc_scale(cfg.analog.f_wbfm_deviation,
                           float(cfg.rates.fs_fm_in)))
    fm_out_p, yi_p, tails_p = buf_ptrs(buf)
    fn = _build.function("k12", "fmt_k12", _ARGTYPES)
    err = fn(x.data_ptr(), tail8.data_ptr(), b1.data_ptr(), b2.data_ptr(),
             nn1, s_row, prev.data_ptr(), scale, *mid_c_args(coeffs, cfg, a),
             c, b, int(ps), theta1.data_ptr(),
             None if fmd is None else fmd.data_ptr(), fm_out_p,
             re.data_ptr(), im.data_ptr(), theta.data_ptr(),
             power.data_ptr(), yi_p, tails_p, _build.stream_ptr(dev))
    _build.check("k12", err)
    count_route(route, coeffs)
    fmd_t, fm_out_t = mid_tails(route, buf, fmd)
    x_tail = _ps_tail(x, nn1 - 4) if ps else x[..., x.shape[-1] - (nn1 - 4):]
    tail = x_tail.to(torch.float32) + 1.0
    new = dict(state)
    new["ds_fm_in"] = torch.complex(tail[0], tail[1])
    new["disc_prev_theta"] = theta1[:, -1]
    return (mid_outputs(new, cfg, a, fmd_t, fm_out_t, power, n8), (re, im),
            theta)


def k12(coeffs, cfg, state: dict, x8: torch.Tensor):
    """x8 [2, C, B] int8 -> (state', (re, im) [C, B/8], theta [C, B/8]).
    CPU tensors run :func:`k12_plain`; CUDA tensors launch the kernel.
    Mid-end filters past the halo (``midend_route``) raise on every
    device."""
    _check_x(x8, ps=False)
    check_route("k12", coeffs, x8.shape[-1] // 4)
    if _build.on_cpu("k12", x8.device):
        return k12_plain(coeffs, cfg, state, x8)
    global launches
    out = _launch(coeffs, cfg, state, x8, ps=False)
    launches += 1
    return out


def k12_ps(coeffs, cfg, state: dict, x4: torch.Tensor):
    """Phase planes x4 [2, 4, C, B/4] int8 -> the outputs of :func:`k12` on
    the interleaved [2, C, B].  CPU tensors run :func:`k12_ps_plain`; CUDA
    tensors launch the phase-split kernel (never a re-interleave).
    Mid-end filters past the halo raise on every device."""
    _check_x(x4, ps=True)
    check_route("k12_ps", coeffs, x4.shape[-1])
    if _build.on_cpu("k12_ps", x4.device):
        return k12_ps_plain(coeffs, cfg, state, x4)
    global launches_ps
    out = _launch(coeffs, cfg, state, x4, ps=True)
    launches_ps += 1
    return out
