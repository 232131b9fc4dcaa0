"""Polyphase FFT channelizer: CUDA kernel and plain version.

Counterpart of ``fm_radio_tpu/kernels/channelizer_pallas.py::
channelize_pallas`` on W wideband captures (the batched form): M-channel
critically sampled DFT filterbank with K taps per phase and a carried
(K - 1) * M sample tail per capture.  It computes the exact float32 math of
``parallel/channelizer.py::_channelize_xla_p``; the TPU kernel's bf16 and
int8 matrix modes ("splits" 1 and 2) are not ported (ROADMAP.md, kernels
still to port, item 9).  The kernel is ``csrc/channelizer.cu``.

Outputs (``out``): "f32" unscaled (y_re, y_im) [W, M, T/M]; "i8" int8
[2, W, M, T/M] of clip(rint(y / M) - 1, -128, 127), the demod's u8 - 128
ingest convention; "i8ps" (M = 32) the same int8 as phase-split planes
[2, 4, W*M, T/(4M)], plane p holding samples 4u + p of each channel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fm_radio_tpu_torch.kernels import _build
from fm_radio_tpu_torch.ops.cmath import f32
from fm_radio_tpu_torch.utils.transfer import unpack_iq_words

# kernel launches since the counter was last set to 0
launches = 0

# the kernel's limits (csrc/channelizer.cu): M a power of two in [2, 128]
# (the Pallas kernel takes m % 8 == 0, m <= 128; the JAX CLI's wideband
# selftest uses M = 4 for two stations), 1 <= K <= 17 (the Pallas kernel's
# K - 1 <= 16), and a wide block T that is a multiple of the kernel's tile
# of 4096 samples
M_RANGE = (2, 128)
MAX_TAPS_PER_PHASE = 17
T_MULTIPLE = 4096
OUTS = ("f32", "i8", "i8ps")

_P, _I = _build.P, _build.I
_ARGTYPES = ([_P, _P, _I] + [_P] * 5 + [_I, _I, _I, _build.I64, _I]
             + [_P] * 5 + [_P])


class ChannelizerTables(NamedTuple):
    """The filterbank's constants on one device: the prototype taps
    reversed as w[r, p] = taps[::-1][r*M + p], and the twiddles
    cos/sin[p, k] of -2 pi p k / M (float64 on the host, cast once to
    float32, shared by the kernel and the plain version)."""

    taps: np.ndarray      # [K*M] float32 prototype, natural order
    w_rev: torch.Tensor   # [K, M]
    cos: torch.Tensor     # [M, M]
    sin: torch.Tensor     # [M, M]


def make_tables(taps, num_channels: int, device="cpu") -> ChannelizerTables:
    """Tables for prototype ``taps`` ([K*M]) split into ``num_channels``."""
    m = num_channels
    taps = np.asarray(taps, np.float32)
    if taps.ndim != 1 or taps.shape[0] % m:
        raise ValueError(f"taps of shape {taps.shape} do not split into "
                         f"{m} phases")
    p = np.arange(m)
    ang = -2.0 * np.pi * np.outer(p, p) / m

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)

    return ChannelizerTables(taps=taps,
                             w_rev=dev(taps[::-1].reshape(-1, m)),
                             cos=dev(np.cos(ang)), sin=dev(np.sin(ang)))


def _q8(y: torch.Tensor, m: int) -> torch.Tensor:
    """u8-grid int8: clip(round(y / m) - 1, -128, 127), half to even."""
    v = torch.round(y * f32(1.0 / m)) - 1.0
    return torch.clamp(v, -128.0, 127.0).to(torch.int8)


def _phase_split(y8: torch.Tensor, m: int) -> torch.Tensor:
    """[2, W, M, F] int8 -> [2, 4, W*M, F/4], plane p = samples p::4."""
    flat = y8.reshape(2, y8.shape[1] * m, -1)
    return torch.stack([flat[:, :, p::4] for p in range(4)], dim=1)


def _flat(words: torch.Tensor) -> torch.Tensor:
    """Packed words as [W, T] (a [W, T/128, 128] view is flattened)."""
    return words.reshape(words.shape[0], -1) if words.ndim == 3 else words


def channelize_plain(tab: ChannelizerTables, state_p, xp, m: int,
                     out: str = "f32"):
    """The filterbank in plain PyTorch, in the kernel's order of operations:
    K shifted multiply-adds (r = 0..K-1) for the phase filter, then four
    sums of M multiply-adds (p = 0..M-1) for the DFT.  Arguments as
    :func:`channelize`."""
    k = tab.w_rev.shape[0]
    if isinstance(xp, (tuple, list)):
        xr, xi = xp
    else:
        xr, xi = unpack_iq_words(_flat(xp))
    sr, si = state_p
    n_w, t = xr.shape
    xr_pad = torch.cat([sr, xr], dim=-1)
    xi_pad = torch.cat([si, xi], dim=-1)
    new_state = (xr_pad[:, t:].contiguous(), xi_pad[:, t:].contiguous())
    n_out = t // m
    fr = xr_pad.reshape(n_w, n_out + k - 1, m)
    fi = xi_pad.reshape(n_w, n_out + k - 1, m)
    zr = fr[:, 0:n_out] * tab.w_rev[0]
    zi = fi[:, 0:n_out] * tab.w_rev[0]
    for r in range(1, k):
        zr = zr + fr[:, r : r + n_out] * tab.w_rev[r]
        zi = zi + fi[:, r : r + n_out] * tab.w_rev[r]
    # [W, p, n] rows against twiddle columns -> channel-major [W, k, n]
    zr, zi = zr.transpose(1, 2), zi.transpose(1, 2)
    a = b = c = d = None
    for p in range(m):
        vr, vi = zr[:, p, None, :], zi[:, p, None, :]
        cs, sn = tab.cos[p][:, None], tab.sin[p][:, None]
        if a is None:
            a, b, c, d = vr * cs, vi * sn, vr * sn, vi * cs
        else:
            a, b = a + vr * cs, b + vi * sn
            c, d = c + vr * sn, d + vi * cs
    y_re, y_im = a - b, c + d
    if out == "f32":
        return new_state, (y_re, y_im)
    y8 = torch.stack([_q8(y_re, m), _q8(y_im, m)])
    return new_state, (_phase_split(y8, m) if out == "i8ps" else y8)


def _check(tab: ChannelizerTables, state_p, xr: torch.Tensor, m: int,
           out: str) -> None:
    """The kernel's limits, for every device (so a CPU run refuses what the
    card would)."""
    k = tab.w_rev.shape[0]
    lo, hi = M_RANGE
    if not lo <= m <= hi or m & (m - 1):
        raise ValueError(f"channelizer: M = {m} is not a power of two in "
                         f"[{lo}, {hi}]")
    if tuple(tab.w_rev.shape) != (k, m) or not 1 <= k <= MAX_TAPS_PER_PHASE:
        raise ValueError(f"channelizer: {k} taps per phase (1..."
                         f"{MAX_TAPS_PER_PHASE}) for M = {m}")
    if out not in OUTS:
        raise ValueError(f"channelizer: out={out!r} is not one of {OUTS}")
    if out == "i8ps" and m != 32:
        raise ValueError("channelizer: out='i8ps' needs M = 32 (the ds x4 "
                         "phases are 128 / M = 4 frame phases)")
    if xr.ndim != 2 or xr.shape[-1] % T_MULTIPLE or xr.shape[-1] == 0:
        raise ValueError(f"channelizer: input {tuple(xr.shape)} is not "
                         f"[W, T] with T a multiple of {T_MULTIPLE}")
    want = (xr.shape[0], (k - 1) * m)
    if any(tuple(s.shape) != want for s in state_p):
        raise ValueError(f"channelizer: state shapes "
                         f"{[tuple(s.shape) for s in state_p]} != {want}")


def channelize(tab: ChannelizerTables, state_p, xp, m: int,
               out: str = "f32"):
    """W captures through the filterbank.

    ``xp``: packed u8 IQ words [W, T] float32 (also as the pre-flattened
    [W, T/128, 128] view), or (re, im) float32 planes [W, T];
    ``state_p``: (sr, si) [W, (K-1)*M].  Returns (state_p', y) with y as the
    module docstring gives per ``out``.  CPU tensors run
    :func:`channelize_plain`; CUDA tensors launch the kernel."""
    packed = not isinstance(xp, (tuple, list))
    if packed:
        xp = _flat(xp)
    x0 = xp if packed else xp[0]
    _check(tab, state_p, x0, m, out)
    if _build.on_cpu("channelizer", x0.device):
        return channelize_plain(tab, state_p, xp, m, out)
    global launches
    dev = x0.device
    sr, si = state_p
    n_w, t = x0.shape
    x1 = x0 if packed else xp[1]
    _build.require("channelizer", dev, torch.float32, x0=x0, x1=x1, sr=sr,
                   si=si, w_rev=tab.w_rev, cos=tab.cos, sin=tab.sin)
    if x1.shape != x0.shape:
        raise ValueError(f"channelizer: planes {tuple(x0.shape)} and "
                         f"{tuple(x1.shape)} differ")
    f = t // m
    sr_out, si_out = torch.empty_like(sr), torch.empty_like(si)
    y_re = y_im = y8 = None
    if out == "f32":
        y_re = torch.empty((n_w, m, f), device=dev, dtype=torch.float32)
        y_im = torch.empty_like(y_re)
    elif out == "i8":
        y8 = torch.empty((2, n_w, m, f), device=dev, dtype=torch.int8)
    else:
        y8 = torch.empty((2, 4, n_w * m, f // 4), device=dev,
                         dtype=torch.int8)

    def ptr(a):
        return None if a is None else a.data_ptr()

    fn = _build.function("channelizer", "fmt_channelize", _ARGTYPES)
    err = fn(x0.data_ptr(), x1.data_ptr(), int(packed), sr.data_ptr(),
             si.data_ptr(), tab.w_rev.data_ptr(), tab.cos.data_ptr(),
             tab.sin.data_ptr(), m, tab.w_rev.shape[0], n_w, t,
             OUTS.index(out), ptr(y_re), ptr(y_im), ptr(y8),
             sr_out.data_ptr(), si_out.data_ptr(), _build.stream_ptr(dev))
    _build.check("channelizer", err)
    launches += 1
    return (sr_out, si_out), ((y_re, y_im) if out == "f32" else y8)
