"""Polyphase FFT channelizer: CUDA kernels and plain versions.

Counterpart of ``fm_radio_tpu/kernels/channelizer_pallas.py::
channelize_pallas`` on W wideband captures (the batched form): M-channel
critically sampled DFT filterbank with K taps per phase and a carried
(K - 1) * M sample tail per capture.  Three modes (``splits``), as the TPU
kernel has them:

- 3: the exact float32 math of ``parallel/channelizer.py::
  _channelize_xla_p``, on packed words or planes (``csrc/channelizer.cu``);
- 1: the int8-matrix mode on packed words: the phase filter and the DFT
  fused into n_c = tl + 1 operator matrices M_c [128 x 128], quantised to
  int8 with one power-of-two scale, applied to the int8 stream (u8 - 128)
  as four exact integer products;
- 2: the single-bf16 mode on packed words: the same operators rounded once
  to bf16, three Karatsuba products with float32 sums.

Both matrix modes run on ``csrc/channelizer_wgmma.cu``: the tensor cores
through wgmma (s8 or bf16), persistent CTAs, the operators streamed into
shared memory by bulk copies in the order :func:`wgmma_order` lays out.

The fused operators (channelizer_pallas.py:361-406): with w[r, p] =
taps[::-1][r*M + p], tl = max(ceil((K-1)*M / 128), 1) carried columns and
base = tl*128 - (K-1)*M, the stream is read as a ring [zeros(base) | state
| x] of 128-sample columns, and output o = q'*M + k (q' < 128/M a frame
phase, k a channel) of column j is

    y[o, j] = sum_{c < n_c, s < 128} M_c[o, s] * ring[128 (j + c) + s]

with M_c[o, s] = w[r, p] * exp(-2 pi i p k / M) where 128 c + s = q'*M + p
+ base + r*M (zero elsewhere); the "i8" and "i8ps" outputs fold the 1/M
descale into M_c.  Column j, phase q' is frame 128/M * j + q'.

Outputs (``out``): "f32" unscaled (y_re, y_im) [W, M, T/M]; "i8" int8
[2, W, M, T/M] of clip(rint(y / M) - 1, -128, 127), the demod's u8 - 128
ingest convention; "i8ps" (M = 32) the same int8 as phase-split planes
[2, 4, W*M, T/(4M)], plane p holding samples 4u + p of each channel.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from fm_radio_tpu_torch.kernels import _build
from fm_radio_tpu_torch.ops.cmath import f32
from fm_radio_tpu_torch.utils.transfer import unpack_iq_words

# kernel launches since the counter was last set to 0: the exact kernel,
# the int8-matrix kernel, the bf16-matrix kernel
launches = 0
launches_i8mat = 0
launches_bf16mat = 0

# the default precision mode, as channelizer_pallas.py:70 reads it: once,
# at import (process-scoped; 3 when unset)
SPLITS_DEFAULT = int(os.environ.get("FMTPU_WB_SPLITS", "3"))
SPLITS = (1, 2, 3)

# the exact kernel's limits (csrc/channelizer.cu): M a power of two in
# [2, 128] (the Pallas kernel takes m % 8 == 0, m <= 128; the JAX CLI's
# wideband selftest uses M = 4 for two stations), 1 <= K <= 17 (the Pallas
# kernel's K - 1 <= 16), and a wide block T that is a multiple of the
# kernel's tile of 4096 samples
M_RANGE = (2, 128)
MAX_TAPS_PER_PHASE = 17
T_MULTIPLE = 4096
OUTS = ("f32", "i8", "i8ps")
# the matrix modes': packed words, M % 8 == 0, and T a multiple of the
# wgmma kernel's tile, 128 columns of 128 samples (csrc/
# channelizer_wgmma.cu; the JAX gate, parallel/channelizer.py::
# pick_tile_chan, only admits such T)
WGMMA_TILE = 128 * 128
MAT_T_MULTIPLE = {1: WGMMA_TILE, 2: WGMMA_TILE}

_P, _I = _build.P, _build.I
_ARGTYPES = ([_P, _P, _I] + [_P] * 5 + [_I, _I, _I, _build.I64, _I]
             + [_P] * 5 + [_P])
_MAT_ARGTYPES = [_P] * 5 + [_I] * 4 + [_build.I64, _I] + [_P] * 5 + [_P]


class ChannelizerTables(NamedTuple):
    """The filterbank's constants on one device: the prototype taps
    reversed as w[r, p] = taps[::-1][r*M + p], and the twiddles
    cos/sin[p, k] of -2 pi p k / M (float64 on the host, cast once to
    float32, shared by the kernel and the plain version).  ``quant`` caches
    the matrix modes' :class:`QuantTables` by (splits, descaled), built on
    first use (:func:`quant_tables`)."""

    taps: np.ndarray      # [K*M] float32 prototype, natural order
    w_rev: torch.Tensor   # [K, M]
    cos: torch.Tensor     # [M, M]
    sin: torch.Tensor     # [M, M]
    quant: dict


class QuantTables(NamedTuple):
    """The fused operator matrices of one matrix mode on one device.

    splits 1: ``mats`` int8 [2, n_c, 128 (o), 128 (s)] (re, im) at scale
    q_M, ``aux`` float32 [3, 128]: 1/q_M in [0, 0], then per output o the
    +1 recentre corrections of y_re and y_im.  splits 2: ``mats`` bf16
    [3, n_c, 128, 128] (re, im, re + im), ``aux`` None.  ``frag``: the
    tables the wgmma kernel streams, in its stage order
    (:func:`wgmma_order`): int8 re, im and -im (integer wgmma has no
    negate), or the three bf16 matrices."""

    mats: torch.Tensor
    aux: torch.Tensor | None
    frag: torch.Tensor


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
                             cos=dev(np.cos(ang)), sin=dev(np.sin(ang)),
                             quant={})


def tail_columns(k: int, m: int) -> int:
    """tl: the 128-sample columns that hold the carried (K-1)*M tail."""
    return max(-(-((k - 1) * m) // 128), 1)


def fused_operators(taps, m: int, descale: bool):
    """(M_re, M_im) float64 [n_c, 128 (s), 128 (o)]: the phase filter and
    the DFT as one operator per column shift, built as
    channelizer_pallas.py:366-383 builds them (each entry is one product,
    so the order of the loop changes nothing)."""
    taps = np.asarray(taps, np.float32)
    k = taps.shape[0] // m
    q = 128 // m
    tl = tail_columns(k, m)
    w = taps[::-1].reshape(k, m)
    p_idx = np.arange(m)
    ang = -2.0 * np.pi * np.outer(p_idx, p_idx) / m
    scale = (1.0 / m) if descale else 1.0
    wd_re = (np.cos(ang) * scale).astype(np.float64)  # [p, ch]
    wd_im = (np.sin(ang) * scale).astype(np.float64)
    m_re = np.zeros((tl + 1, 128, 128))
    m_im = np.zeros((tl + 1, 128, 128))
    base = tl * 128 - (k - 1) * m
    for r in range(k):
        for qp in range(q):
            for p in range(m):
                sf = qp * m + p + base + r * m
                c_ix, s_ix = sf // 128, sf % 128
                o0 = qp * m
                m_re[c_ix, s_ix, o0 : o0 + m] += w[r, p] * wd_re[p]
                m_im[c_ix, s_ix, o0 : o0 + m] += w[r, p] * wd_im[p]
    return m_re, m_im


def int8_operators(taps, m: int, descale: bool):
    """(int8 [2, n_c, 128 (o), 128 (s)], aux float32 [3, 128]) of the int8
    mode: one power-of-two scale q_M = 2^floor(log2(127 / max|M|)) for both
    planes, entries rint(M * q_M) clipped to +-127; aux[0, 0] = 1/q_M and,
    because the stream enters as u8 - 128 (one below the centred value),
    the +1 corrections per output o: S(o) = sum over (c, s) of the int8
    matrix / q_M, corr_re = S_re - S_im, corr_im = S_im + S_re.

    The sum runs over the axes (c, s) of [n_c, o, s]:
    channelizer_pallas.py:395-396 sums axes (0, 1), i.e. over (c, o), which
    gives one value per input column s instead of per output."""
    m_re, m_im = fused_operators(taps, m, descale)
    mats = np.swapaxes(np.stack([m_re, m_im]), 2, 3)
    amax = np.abs(mats).max()
    q_m = 2.0 ** np.floor(np.log2(127.0 / max(amax, 1e-30)))
    m_i8 = np.clip(np.round(mats * q_m), -127, 127).astype(np.int8)
    s_re = m_i8[0].sum(axis=(0, 2)).astype(np.float64) / q_m
    s_im = m_i8[1].sum(axis=(0, 2)).astype(np.float64) / q_m
    aux = np.zeros((3, 128), np.float32)
    aux[0] = 1.0 / q_m
    aux[1] = (s_re - s_im).astype(np.float32)
    aux[2] = (s_im + s_re).astype(np.float32)
    return m_i8, aux


def bf16_operators(taps, m: int, descale: bool) -> torch.Tensor:
    """bf16 [3, n_c, 128 (o), 128 (s)]: M_re, M_im and M_re + M_im (formed
    in float64, cast to float32), each rounded once to bf16, to nearest
    even (the hi plane of ``_split_bf16``, frontend_pallas.py:65-80)."""
    m_re, m_im = fused_operators(taps, m, descale)
    mats = np.swapaxes(np.stack([m_re, m_im, m_re + m_im]), 2, 3)
    return torch.from_numpy(np.ascontiguousarray(mats, np.float32)).to(
        torch.bfloat16)


def wgmma_order(mats: torch.Tensor) -> torch.Tensor:
    """Tables [G, n_c, 128 (o), 128 (s)] of bf16 (or int16 holding bf16)
    or int8 -> [G, n_c, KH, 4 (kc), 128 (o), E]: the stages the wgmma
    kernel streams, in the order it consumes them (table g, then shift c,
    then kh).  A stage is 128 rows x 64 bytes, 8 KB: E = 16 / (bytes an
    input) inputs a 16-byte K-chunk (8 bf16 or 16 int8), KH = 128 / (4 E)
    stages a shift (4 or 2).  Stage (g, c, kh) holds inputs s = 4E kh ..
    4E kh + 4E - 1 of all 128 output rows in wgmma's no-swizzle K-major
    layout: core matrices of 8 rows x 16 bytes, rows 16 bytes apart (so
    the 8-row groups 128 bytes apart) and the K chunks kc 128 x 16 = 2048
    bytes apart; element [g, c, kh, kc, o, e] = mats[g, c, o, 4E kh + E kc
    + e]."""
    g, n_c = mats.shape[:2]
    e = 16 // mats.element_size()
    return mats.reshape(g, n_c, 128, 128 // (4 * e), 4, e) \
        .permute(0, 1, 3, 4, 2, 5).contiguous()


def wgmma_operator_bytes(n_captures: int, t: int, k: int, m: int,
                         splits: int) -> int:
    """Bytes of tables the wgmma kernel moves from L2 into shared memory
    for one call of mode ``splits`` (1 or 2) on W = ``n_captures``
    captures of T = ``t`` samples: every tile of 128 columns streams all
    3 x n_c tables of 128 x 128 inputs once, int8 (1 byte an input) or
    bf16 (2) (csrc/channelizer_wgmma.cu)."""
    n_tiles = n_captures * (t // (128 * 128))
    n_c = tail_columns(k, m) + 1
    return n_tiles * 3 * n_c * 128 * 128 * (1 if splits == 1 else 2)


def make_quant_tables(taps, m: int, splits: int, descale: bool,
                      device="cpu") -> QuantTables:
    """The :class:`QuantTables` of mode ``splits`` (1 or 2) for prototype
    ``taps`` at M = ``m``; ``descale`` folds the 1/M of the int8 outputs
    into the matrices."""
    if splits == 1:
        mats, aux = int8_operators(taps, m, descale)
        mats_t = torch.from_numpy(mats)
        frag = wgmma_order(torch.stack([mats_t[0], mats_t[1], -mats_t[1]]))
    elif splits == 2:
        mats_t = bf16_operators(taps, m, descale)
        aux = None
        frag = wgmma_order(mats_t.view(torch.int16))
    else:
        raise ValueError(f"no matrix tables for splits={splits}")
    return QuantTables(
        mats=mats_t.to(device),
        aux=None if aux is None else torch.from_numpy(aux).to(device),
        frag=frag.to(device))


def quant_tables(tab: ChannelizerTables, splits: int,
                 out: str) -> QuantTables:
    """``tab``'s :class:`QuantTables` for ``splits`` and ``out`` (built once
    on the tables' device, then cached in ``tab.quant``)."""
    m = tab.w_rev.shape[1]
    key = (splits, out != "f32")
    if key not in tab.quant:
        tab.quant[key] = make_quant_tables(tab.taps, m, splits, key[1],
                                           tab.w_rev.device)
    return tab.quant[key]


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
                     out: str = "f32", splits: int = 3):
    """The filterbank in plain PyTorch.  ``splits`` 3: in the exact
    kernel's order of operations, K shifted multiply-adds (r = 0..K-1) for
    the phase filter, then four sums of M multiply-adds (p = 0..M-1) for
    the DFT; 1 and 2: :func:`channelize_i8mat_plain` and
    :func:`channelize_bf16mat_plain` on ``tab``'s matrices.  Arguments as
    :func:`channelize`."""
    if splits == 1:
        return channelize_i8mat_plain(quant_tables(tab, 1, out), state_p,
                                      xp, m, out)
    if splits == 2:
        return channelize_bf16mat_plain(quant_tables(tab, 2, out), state_p,
                                        xp, m, out)
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


def _mat_ring(state_p, words: torch.Tensor, m: int, k: int):
    """The matrix modes' stream per capture as float32 [W, tl + T/128, 128]
    columns: [zeros(base) | state | x], centred (u8 - 127); and the new
    carried state (the last (K-1)*M samples, as the exact mode has it)."""
    xr, xi = unpack_iq_words(_flat(words))
    sr, si = state_p
    n_w, t = xr.shape
    tl = tail_columns(k, m)
    pad = torch.zeros((n_w, tl * 128 - (k - 1) * m), dtype=torch.float32,
                      device=xr.device)
    rings = [torch.cat([pad, s, x], dim=-1).reshape(n_w, -1, 128)
             for s, x in ((sr, xr), (si, xi))]
    n_st = (k - 1) * m
    new_state = (xr[:, t - n_st :].contiguous(), xi[:, t - n_st :].contiguous())
    return rings, new_state


def _shift_sum(x: torch.Tensor, a: torch.Tensor, exact: bool):
    """sum over the shifts c of x[:, c : c + J] @ a[c]^T -> [w, J, 128 (o)]
    for x float64 [w, J + n_c - 1, 128 (s)], a float64 [n_c, 128 (o), 128]:
    exact in float64 (integer operands: every partial sum is an integer
    below 2^53), or each shift's float64 product rounded to float32 and
    summed in float32 from c = 0."""
    n_c = a.shape[0]
    cols = x.shape[1] - (n_c - 1)
    acc = None
    for c in range(n_c):
        t = x[:, c : c + cols] @ a[c].t()
        if not exact:
            t = t.to(torch.float32)
        acc = t if acc is None else acc + t
    return acc


# captures per step of the plain matrix modes (bounds their float64
# temporaries: ~0.3 GB a plane at T = 2^22)
_PLAIN_CHUNK = 8


def _outs(y_re: torch.Tensor, y_im: torch.Tensor, m: int, out: str):
    """Column-major matrix outputs [W, J, 128 (o)] -> the ``out`` form;
    o = q'*M + k is frame 128/M * j + q' of channel k."""
    n_w, cols = y_re.shape[:2]
    q = 128 // m

    def frames(y):  # [W, J, q, M] -> [W, M, J*q]
        return y.reshape(n_w, cols, q, m).permute(0, 3, 1, 2).reshape(
            n_w, m, cols * q)

    if out == "f32":
        return (frames(y_re).contiguous(), frames(y_im).contiguous())
    y8 = [torch.clamp(torch.round(y) - 1.0, -128.0, 127.0).to(torch.int8)
          for y in (y_re, y_im)]
    if out == "i8":
        return torch.stack([frames(y) for y in y8])
    # i8ps (q = 4): plane q' of channel k is column j
    return torch.stack([y.reshape(n_w, cols, 4, m).permute(2, 0, 3, 1)
                        .reshape(4, n_w * m, cols) for y in y8])


def channelize_i8mat_plain(qt: QuantTables, state_p, words: torch.Tensor,
                           m: int, out: str = "f32"):
    """The int8-matrix mode in plain PyTorch, on packed words: the ring
    holds u8 - 128 as int8 (the carried state, u8 - 127 integers, enters
    as state - 1), the four integer products rr, ii, ri, ir are exact (in
    float64), then y_re = float32(rr - ii) * (1/q_M) + corr_re and y_im =
    float32(ri + ir) * (1/q_M) + corr_im in float32, and the ``out`` form
    (int8: clip(rint(y) - 1, -128, 127), the 1/M folded in).  ``qt`` is
    given, so a test can pass other tables."""
    k = state_p[0].shape[-1] // m + 1
    rings, new_state = _mat_ring(state_p, words, m, k)
    a_re, a_im = qt.mats.to(torch.float64)
    inv_q, corr_re, corr_im = qt.aux[0, 0], qt.aux[1], qt.aux[2]
    y_re, y_im = [], []
    for w0 in range(0, rings[0].shape[0], _PLAIN_CHUNK):
        xr, xi = ((r[w0 : w0 + _PLAIN_CHUNK] - 1.0).to(torch.int8)
                  .to(torch.float64) for r in rings)
        rr, ii = _shift_sum(xr, a_re, True), _shift_sum(xi, a_im, True)
        ri, ir = _shift_sum(xr, a_im, True), _shift_sum(xi, a_re, True)
        y_re.append((rr - ii).to(torch.float32) * inv_q + corr_re)
        y_im.append((ri + ir).to(torch.float32) * inv_q + corr_im)
    return new_state, _outs(torch.cat(y_re), torch.cat(y_im), m, out)


def channelize_bf16mat_plain(qt: QuantTables, state_p, words: torch.Tensor,
                             m: int, out: str = "f32"):
    """The single-bf16-matrix mode in plain PyTorch, on packed words: x =
    u8 - 127 in bf16 (exact: |x| <= 128, |x_r + x_i| <= 256), P1 =
    M_re.x_r, P2 = M_im.x_i, P3 = (M_re + M_im).(x_r + x_i), each column
    shift's product in float64 rounded to float32 and summed over the
    shifts c = 0, 1, ... in float32; y_re = P1 - P2, y_im = (P3 - P1) - P2
    (channelizer_pallas.py:151-153), then the ``out`` form."""
    k = state_p[0].shape[-1] // m + 1
    (rr, ri), new_state = _mat_ring(state_p, words, m, k)
    a = qt.mats.to(torch.float64)
    y_re, y_im = [], []
    for w0 in range(0, rr.shape[0], _PLAIN_CHUNK):
        xr, xi = rr[w0 : w0 + _PLAIN_CHUNK], ri[w0 : w0 + _PLAIN_CHUNK]
        planes = (xr, xi, xr + xi)
        p1, p2, p3 = (_shift_sum(x.to(torch.bfloat16).to(torch.float64),
                                 a[g], False)
                      for g, x in enumerate(planes))
        y_re.append(p1 - p2)
        y_im.append((p3 - p1) - p2)
    return new_state, _outs(torch.cat(y_re), torch.cat(y_im), m, out)


def _check(tab: ChannelizerTables, state_p, xr: torch.Tensor, m: int,
           out: str, splits: int, packed: bool) -> None:
    """The kernels' limits, for every device (so a CPU run refuses what the
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
    if splits not in SPLITS:
        raise ValueError(f"channelizer: splits={splits} is not one of "
                         f"{SPLITS}")
    t_mult = T_MULTIPLE if splits == 3 else MAT_T_MULTIPLE[splits]
    if xr.ndim != 2 or xr.shape[-1] % t_mult or xr.shape[-1] == 0:
        raise ValueError(f"channelizer: input {tuple(xr.shape)} is not "
                         f"[W, T] with T a multiple of {t_mult}")
    if splits != 3 and (not packed or m % 8):
        raise ValueError(f"channelizer: splits={splits} takes packed words "
                         f"at M % 8 == 0 (parallel/channelizer.py routes "
                         f"other input to splits=3)")
    want = (xr.shape[0], (k - 1) * m)
    if any(tuple(s.shape) != want for s in state_p):
        raise ValueError(f"channelizer: state shapes "
                         f"{[tuple(s.shape) for s in state_p]} != {want}")


def _empty_outs(out: str, n_w: int, m: int, f: int, dev):
    """(y_re, y_im, y8) buffers of the ``out`` form (the unused ones
    None)."""
    if out == "f32":
        y_re = torch.empty((n_w, m, f), device=dev, dtype=torch.float32)
        return y_re, torch.empty_like(y_re), None
    if out == "i8":
        return None, None, torch.empty((2, n_w, m, f), device=dev,
                                       dtype=torch.int8)
    return None, None, torch.empty((2, 4, n_w * m, f // 4), device=dev,
                                   dtype=torch.int8)


def _ptr(a):
    return None if a is None else a.data_ptr()


def channelize(tab: ChannelizerTables, state_p, xp, m: int,
               out: str = "f32", splits: int = 3):
    """W captures through the filterbank in mode ``splits`` (module
    docstring; 1 and 2 take packed words only).

    ``xp``: packed u8 IQ words [W, T] float32 (also as the pre-flattened
    [W, T/128, 128] view), or (re, im) float32 planes [W, T];
    ``state_p``: (sr, si) [W, (K-1)*M].  Returns (state_p', y) with y as the
    module docstring gives per ``out``.  CPU tensors run
    :func:`channelize_plain`; CUDA tensors launch the mode's kernel (or
    raise)."""
    packed = not isinstance(xp, (tuple, list))
    if packed:
        xp = _flat(xp)
    x0 = xp if packed else xp[0]
    _check(tab, state_p, x0, m, out, splits, packed)
    if _build.on_cpu("channelizer", x0.device):
        return channelize_plain(tab, state_p, xp, m, out, splits)
    if splits != 3:
        return _launch_mat(tab, state_p, xp, m, out, splits)
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
    sr_out, si_out = torch.empty_like(sr), torch.empty_like(si)
    y_re, y_im, y8 = _empty_outs(out, n_w, m, t // m, dev)
    fn = _build.function("channelizer", "fmt_channelize", _ARGTYPES)
    err = fn(x0.data_ptr(), x1.data_ptr(), int(packed), sr.data_ptr(),
             si.data_ptr(), tab.w_rev.data_ptr(), tab.cos.data_ptr(),
             tab.sin.data_ptr(), m, tab.w_rev.shape[0], n_w, t,
             OUTS.index(out), _ptr(y_re), _ptr(y_im), _ptr(y8),
             sr_out.data_ptr(), si_out.data_ptr(), _build.stream_ptr(dev))
    _build.check("channelizer", err)
    launches += 1
    return (sr_out, si_out), ((y_re, y_im) if out == "f32" else y8)


def _launch_mat(tab: ChannelizerTables, state_p, words: torch.Tensor,
                m: int, out: str, splits: int):
    """Launch ``csrc/channelizer_wgmma.cu`` on packed words [W, T]: its
    int8 mode (splits 1) or its bf16 mode (splits 2)."""
    global launches_i8mat, launches_bf16mat
    qt = quant_tables(tab, splits, out)
    dev = words.device
    sr, si = state_p
    n_w, t = words.shape
    lib = "channelizer_wgmma"
    _build.require(lib, dev, torch.float32, words=words, sr=sr, si=si)
    if words.data_ptr() % 16:
        raise ValueError(f"{lib}: words must be 16-byte aligned")
    if splits == 1:
        _build.require(lib, dev, torch.float32, aux=qt.aux)
        _build.require(lib, dev, torch.int8, frag=qt.frag)
    else:
        _build.require(lib, dev, torch.int16, opers=qt.frag)
    sr_out, si_out = torch.empty_like(sr), torch.empty_like(si)
    y_re, y_im, y8 = _empty_outs(out, n_w, m, t // m, dev)
    fn = _build.function(lib, "fmt_channelize_wgmma", _MAT_ARGTYPES)
    err = fn(words.data_ptr(), sr.data_ptr(), si.data_ptr(),
             qt.frag.data_ptr(), _ptr(qt.aux), splits, m, tab.w_rev.shape[0],
             n_w, t, OUTS.index(out), _ptr(y_re), _ptr(y_im), _ptr(y8),
             sr_out.data_ptr(), si_out.data_ptr(), _build.stream_ptr(dev))
    _build.check(lib, err)
    if splits == 2:
        launches_bf16mat += 1
    else:
        launches_i8mat += 1
    return (sr_out, si_out), ((y_re, y_im) if out == "f32" else y8)
