"""Engine decomposition of the K1 front end (ds x4 + discriminator) on the card.

Counterpart of ``tools/frontend_probe.py``: the float K1 split into its
parts by variants that strip one engine at a time, on the port's own K1
design (``csrc/frontend_probe.cu``).  The cells' float K1 is
``csrc/frontend.cu::k1_tile_kernel``: one launch that stages a tile of
1,024 outputs once in shared memory as skewed float32 re and im planes,
sums it register-blocked (``extract_stages.cuh::fir_block``, 64 taps) and
ends in atan2 and the discriminator.  ``dots`` and ``full`` run that
design at the probe's 132 taps:

  stream   read each (c_blk, t_blk) tile, one sum per row and tile
  unpack   + unpack the ingest form: the tile's sum of re - im
  dots     + the ds x4 window sums of re and im (132 taps), the tile
           staged once and summed by ``fir_block<4, 8, 132, 4>`` (its
           last block one step), re and im on separate warps: fr + fi
  full     + polynomial atan2 and the in-tile difference wrapped to
           +-pi, x 0.123, in the same launch (theta in shared memory)

so ``split``'s four rows on words (stream, unpack, dots, full) split K1's
time as K1 spends it, at about twice its taps; on the ingest forms
(``f32w`` packed words w = I*256 + Q; ``i16`` words w - 32768; ``u8`` two
int8 planes; ``f32p`` two float32 planes, the port's own, as K1 takes the
complex cell's planes; planes given as [2, C, B]) with float taps
(float32; the TPU's bf16 hi/lo band) or int8 taps
(``kernels/k12.py::quantize_ds4_taps``, y1 + y2/128 + s_row at the
quantiser's scale, as the TPU's ``quantize_band_int8``; the staged
samples packed into int8 words once and summed by K12's sliding
``__dp4a`` window).  A CTA of ``dots``/``full`` takes up to 1,024 outputs
of a tile (K1's tile: several rows of a short tile, a part of a long one),
so ``c_blk``, ``t_blk``, ``raster`` and tile-major input set which
samples a CTA reads and in what order, as they did on the TPU.  The
alternative designs:

  dbuf      one CTA per c_blk channels walking their time tiles, the
            window carried across tiles: each tile's raw words brought
            into shared memory by cp.async (one buffer: load, then sum;
            two: tile i+1's copy in flight while tile i is unpacked and
            summed, the card's reading of the TPU's parity double buffer),
            unpacked once into the skewed planes a group of up to 2,048
            outputs a plane at a time (``dbuf_layout``), the carried head
            kept as planes; ``tiles`` sweeps its tile with one buffer,
            ``dbuf`` one buffer against two against ``direct`` (the
            one-launch ``full`` above)
  i8direct  int8 planes and taps, windows read from device memory with
            the tail carried; ``noasm``: each tile's first ``no`` outputs
            read the tile from its start (mis-filtered, as the TPU lens)
  i8manual  one CTA per channel block, the time loop inside, tiles in by
            cp.async.bulk into a 2-slot ring and out by bulk stores

Semantics pinned down (the tests hold them against the TPU tool):
``stream``/``unpack`` return the TPU's [C, 128] output, which holds only
the LAST time tile's sums (every grid step wrote the same block), and the
per-tile sums [C, n_tt] beside it, so that a kernel that skipped a tile
shows.  What the TPU kernel never writes reads as zeros of the scratch's
type: every tile's 128-sample head in build (0.0; int8 taps see
int8(0 - 1)), the carried state at a channel block's first tile (dbuf: the
sample (0, 0); i8direct: zero bytes).  The TPU's ``no`` (band width of its
matrix unit) has no card counterpart in the staged kernels; it sets the
default tile and, under ``noasm``/i8manual, the mis-filtered outputs.
``semantics`` maps to the grid's rasterisation: time tiles fastest (the
TPU default) or channel tiles fastest (any semantics marking the channel
axis parallel).

    python -m fm_radio_tpu_torch.probes.frontend_probe [C=1024] [B=262144]
        [--sections engines,tiles,ingest] [--iters 48] [--device cpu]

Sections: ingest, tm, engines, tiles, dbuf, i8d, i8x, man, sem, and the
card's own ``split``: the float K1's time split into stream, unpack, FIR
and atan2 on words and on planes.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from fm_radio_tpu_torch.kernels import _build
from fm_radio_tpu_torch.kernels.k12 import quantize_ds4_taps
from fm_radio_tpu_torch.ops.cmath import atan2_poly, f32, wrap_phase
from fm_radio_tpu_torch.ops.design import create_fir_lpf
from fm_radio_tpu_torch.probes import _probe
from fm_radio_tpu_torch.utils.transfer import unpack_iq_words

M = 4
HEAD = 128                 # the TPU tool's _TB
NN = 128 + M               # create_fir_lpf(128 + _M, 0.25): halo 128
SCALE = f32(0.123)
SMEM_BYTES = _probe.SMEM_BYTES  # shared memory one CTA may use
FORMS = {"f32w": 0, "i16": 1, "u8": 2, "f32p": 3}
BYTES_PER_SAMPLE = {"f32w": 4, "i16": 2, "u8": 2, "f32p": 8}
PLANES = ("u8", "f32p")  # the forms given as [2, C, B] planes

# kernel launches since the counters were last set to 0
launches_sum = 0      # build: stream, unpack (fmt_fp_sum)
launches_fir = 0      # build: dots, full (fmt_fp_fir)
launches_dbuf = 0     # build_dbuf (fmt_fp_dbuf)
launches_i8d = 0      # build_i8direct (fmt_fp_i8d)
launches_i8man = 0    # build_i8manual (fmt_fp_i8man)

_P, _I, _F = _build.P, _build.I, _build.F


def reset_counts() -> None:
    global launches_sum, launches_fir, launches_dbuf, launches_i8d
    global launches_i8man
    launches_sum = launches_fir = launches_dbuf = launches_i8d = 0
    launches_i8man = 0


def counts() -> dict:
    return {"fp_sum": launches_sum, "fp_fir": launches_fir,
            "fp_dbuf": launches_dbuf, "fp_i8d": launches_i8d,
            "fp_i8man": launches_i8man}


# ---- the host tables --------------------------------------------------------

def taps() -> np.ndarray:
    """The probe's ds x4 filter: 132 float32 taps (halo 128)."""
    return np.asarray(create_fir_lpf(NN, 0.25), np.float32)


def tables(device="cpu") -> dict:
    """w_rev (reversed float32 taps), b1, b2 (reversed int8 taps) and s_row
    of the int8 split, on ``device``."""
    b1, b2, s_row = quantize_ds4_taps(taps())
    return {"w_rev": torch.from_numpy(taps()[::-1].copy()).to(device),
            "b1": torch.from_numpy(b1).to(device),
            "b2": torch.from_numpy(b2).to(device), "s_row": s_row,
            "b1_list": b1.tolist(), "b2_list": b2.tolist()}


def band(w_rev: np.ndarray, no: int, m: int = M, head: int = HEAD):
    """The TPU's banded matrix [no*m + head, no] from reversed taps: tap k
    of output j at row head - halo + m*j + k, the window offset the card's
    kernels read (output j from sample m*j - halo of its tile).  The test
    holds it (and the int8 planes laid into it) against the JAX tool's."""
    nn = w_rev.shape[0]
    out = np.zeros((no * m + head, no), w_rev.dtype)
    for j in range(no):
        r0 = head - (nn - m) + m * j
        out[r0:r0 + nn, j] = w_rev
    return out


def default_tiles(c: int, b: int, no: int = 128) -> tuple[int, int]:
    """The TPU tool's default (c_blk, t_blk): t_blk from no*4 doubled up to
    2048 while it divides B, c_blk = min(C, 128)."""
    t_blk = no * M
    while t_blk * 2 <= 2048 and b % (t_blk * 2) == 0:
        t_blk *= 2
    return min(c, 128), t_blk


# ---- plain versions ---------------------------------------------------------

def decode(x: torch.Tensor, form: str):
    """(re, im) float32 [C, B] of an ingest form: the centred u8 - 127
    samples."""
    if form == "f32w":
        return unpack_iq_words(x)
    if form == "i16":
        return unpack_iq_words(x.float() + 32768.0)
    if form == "f32p":
        return x[0], x[1]
    return x[0].float() + 1.0, x[1].float() + 1.0


def tiles_view(t: torch.Tensor, t_blk: int, tile_major: bool) -> torch.Tensor:
    """[C, n_tt, t_blk] view of a [C, B] plane, or of a tile-major
    [n_tt, C, t_blk] one."""
    if tile_major:
        return t.permute(1, 0, 2)
    return t.reshape(t.shape[0], -1, t_blk)


def sum_plain(x: torch.Tensor, form: str, unpack: bool, t_blk: int,
              tile_major: bool = False):
    """(last [C, 128], sums [C, n_tt]) of build's stream (unpack False) or
    unpack variant, in the kernel's order (``_probe.lane_sums``).  x as the
    kernel takes it: [C, B] words, or [2, C, B] int8 planes; tile-major
    [n_tt, C, t_blk] ([2, n_tt, C, t_blk])."""
    planes = (x[0], x[1]) if form in PLANES else (x,)
    tv = [tiles_view(p, t_blk, tile_major) for p in planes]
    vec = {"f32w": 4, "i16": 8, "u8": 16, "f32p": 4}[form]
    if unpack:
        if form == "u8":
            vals = (tv[0].float() + 1.0) - (tv[1].float() + 1.0)
        elif form == "f32p":
            vals = tv[0] - tv[1]
        else:
            w = tv[0] if form == "f32w" else tv[0].float() + 32768.0
            re, im = unpack_iq_words(w)
            vals = re - im
        acc = _probe.lane_sums(vals, vec)
    else:
        acc = _probe.lane_sums(tv[0].float(), vec)
        if form in PLANES:
            acc = acc + _probe.lane_sums(tv[1].float(), vec)
    sums = _probe.butterfly(acc)
    return _probe.last_tile(sums), sums


def _windows(v: torch.Tensor, head_pad, carry: bool, t_blk: int):
    """[C, n_tt, head + t_blk] padded tiles of a [C, B] plane: each tile
    behind HEAD samples of ``head_pad`` (carry False), or behind the
    previous tile's last HEAD samples (carry True: ``head_pad`` only before
    the row)."""
    c, b = v.shape
    pad = torch.full((c, HEAD), head_pad, dtype=v.dtype, device=v.device)
    if carry:
        row = torch.cat([pad, v], dim=-1)
        return row.unfold(-1, HEAD + t_blk, t_blk)
    t = v.reshape(c, b // t_blk, t_blk)
    return torch.cat([pad[:, None].expand(c, b // t_blk, HEAD), t], dim=-1)


def _ds4_float(win: torch.Tensor, w_rev: torch.Tensor, n_out: int):
    """sum_k w_rev[k] * win[..., 4j + k] in float32 from k = 0 up
    (ds4_float's order)."""
    acc = torch.zeros(win.shape[:-1] + (n_out,), dtype=torch.float32,
                      device=win.device)
    for k in range(w_rev.shape[0]):
        acc = acc + w_rev[k] * win[..., k:k + M * n_out:M]
    return acc


def _ds4_i8(win8: torch.Tensor, tb: dict, n_out: int):
    """The int8 sums of int8 windows: exact integers, combined as
    (y1 + y2 / 128) + s_row in float32."""
    y1 = torch.zeros(win8.shape[:-1] + (n_out,), dtype=torch.int32,
                     device=win8.device)
    y2 = torch.zeros_like(y1)
    x = win8.to(torch.int32)
    for k, (w1, w2) in enumerate(zip(tb["b1_list"], tb["b2_list"])):
        s = x[..., k:k + M * n_out:M]
        y1 = y1 + w1 * s
        y2 = y2 + w2 * s
    return (y1.float() + y2.float() * f32(1.0 / 128.0)) + f32(tb["s_row"])


def _to_i8(v: torch.Tensor) -> torch.Tensor:
    """float samples shifted by -1 into int8, truncated (i8_byte)."""
    return (v - 1.0).to(torch.int32).to(torch.int8)


def disc_tiles(theta: torch.Tensor, no: int) -> torch.Tensor:
    """wrap(theta[j] - theta[j - 1]) * 0.123 within tiles of ``no`` outputs
    of [C, N] theta (0 at each tile's first output)."""
    c, n = theta.shape
    t = theta.reshape(c, n // no, no)
    prev = torch.cat([t[..., :1], t[..., :-1]], dim=-1)
    return (wrap_phase(t - prev) * SCALE).reshape(c, n)


def fir_plain(x: torch.Tensor, form: str, int8_taps: bool, full: bool,
              t_blk: int, tile_major: bool = False, carry: bool = False,
              tb: dict | None = None) -> torch.Tensor:
    """build's dots (fr + fi) or full output [C, B/4]; ``carry`` windows
    over the whole row (dbuf), else each tile behind a zero head."""
    tb = tb or tables(x.device)
    if tile_major:
        planes = (x[0], x[1]) if form in PLANES else (x,)
        planes = [p.permute(1, 0, 2).reshape(p.shape[1], -1)
                  for p in planes]
        x = torch.stack(planes) if form in PLANES else planes[0]
    re, im = decode(x, form)
    n_out = t_blk // M
    wr, wi = (_windows(v, 0.0, carry, t_blk) for v in (re, im))
    if int8_taps:
        fr, fi = (_ds4_i8(_to_i8(w), tb, n_out) for w in (wr, wi))
    else:
        w_rev = tb["w_rev"]
        fr, fi = (_ds4_float(w, w_rev, n_out) for w in (wr, wi))
    c = re.shape[0]
    if not full:
        return (fr + fi).reshape(c, -1)
    return disc_tiles(atan2_poly(fi, fr).reshape(c, -1), n_out)


def i8d_plain(x8: torch.Tensor, full: bool, t_blk: int, no: int = 128,
              noasm: bool = False, tb: dict | None = None) -> torch.Tensor:
    """build_i8direct's output [C, B/4] on int8 planes [2, C, B]: windows
    over the row behind zero bytes; with ``noasm`` each tile's first ``no``
    outputs read their tile from its start (output j: samples 4j ..)."""
    tb = tb or tables(x8.device)
    c, b = x8.shape[1:]
    n_out = t_blk // M
    if noasm:
        wins = [_windows(p, 0, False, t_blk) for p in x8]
    else:
        wins = [_windows(p, 0, True, t_blk) for p in x8]
    fr, fi = (_ds4_i8(w, tb, n_out) for w in wins)
    if noasm:
        halo_w = (NN - M) // M
        j = torch.arange(n_out, device=x8.device)
        src = torch.where(j < no, j + halo_w, j)
        fr, fi = fr[..., src], fi[..., src]
    if not full:
        return (fr + fi).reshape(c, -1)
    return disc_tiles(atan2_poly(fi, fr).reshape(c, -1), n_out)


def i8man_plain(x8: torch.Tensor, full: bool, t_blk: int, no: int = 128,
                tb: dict | None = None) -> torch.Tensor:
    """build_i8manual's output: the noasm windows of each tile."""
    return i8d_plain(x8, full, t_blk, no, noasm=True, tb=tb)


def dbuf_plain(xw: torch.Tensor, full: bool, t_blk: int,
               tb: dict | None = None) -> torch.Tensor:
    """build_dbuf's output on packed words: the windows carried over the
    row behind the sample (0, 0); the difference within each tile."""
    return fir_plain(xw, "f32w", False, full, t_blk, carry=True, tb=tb)


# ---- the kernels --------------------------------------------------------------

def _planes_ptrs(x: torch.Tensor, form: str):
    if form in PLANES:
        return x[0].data_ptr(), x[1].data_ptr()
    return x.data_ptr(), None


def _shape(x: torch.Tensor, form: str, t_blk: int, tile_major: bool):
    """(C, B) of an input as the kernels take it."""
    s = x.shape[1:] if form in PLANES else x.shape
    if tile_major:
        return s[1], s[0] * t_blk
    return s[0], s[1]


_DTYPES = {"f32w": torch.float32, "i16": torch.int16, "u8": torch.int8,
           "f32p": torch.float32}


def _check(name: str, x: torch.Tensor, form: str, tile_major: bool = False):
    want = (3 if form in PLANES else 2) + int(tile_major)
    if x.dtype != _DTYPES[form] or x.ndim != want or not x.is_contiguous():
        raise ValueError(f"{name}: {form} input must be contiguous "
                         f"{_DTYPES[form]} of {want} dims, got {x.dtype} "
                         f"{tuple(x.shape)}")


def tile_sum(x: torch.Tensor, form: str, unpack: bool, c_blk: int,
             t_blk: int, tile_major: bool = False, raster: int = 0,
             out: tuple | None = None):
    """build's stream (``unpack`` False) or unpack variant: (last [C, 128],
    sums [C, n_tt]); on the card written into ``out`` (last, sums) where
    given.  The kernel's warps walk the (row, tile) items in ``raster``'s
    order (``_probe.sum_walk``), so ``c_blk`` only has to divide C.  CPU
    tensors run :func:`sum_plain`."""
    _check("tile_sum", x, form, tile_major)
    if _build.on_cpu("tile_sum", x.device):
        return sum_plain(x, form, unpack, t_blk, tile_major)
    global launches_sum
    c, b = _shape(x, form, t_blk, tile_major)
    last, sums = out or (torch.empty((c, 128), device=x.device),
                         torch.empty((c, b // t_blk), device=x.device))
    fn = _build.function("frontend_probe", "fmt_fp_sum",
                         [_P, _P] + [_I] * 8 + [_P, _P, _P])
    _build.check("frontend_probe", fn(
        *_planes_ptrs(x, form), FORMS[form], int(unpack), int(tile_major), c,
        b, c_blk, t_blk, raster, sums.data_ptr(), last.data_ptr(),
        _build.stream_ptr(x.device)))
    launches_sum += 1
    return last, sums


def fir(x: torch.Tensor, form: str, int8_taps: bool, full: bool, c_blk: int,
        t_blk: int, tile_major: bool = False, raster: int = 0,
        tb: dict | None = None) -> torch.Tensor:
    """build's dots (``full`` False) or full variant: [C, B/4] float32,
    one launch.  CPU tensors run :func:`fir_plain`."""
    _check("fir", x, form, tile_major)
    tb = tb or tables(x.device)
    if _build.on_cpu("fir", x.device):
        return fir_plain(x, form, int8_taps, full, t_blk, tile_major, tb=tb)
    global launches_fir
    c, b = _shape(x, form, t_blk, tile_major)
    out = torch.empty((c, b // M), device=x.device)
    fn = _build.function("frontend_probe", "fmt_fp_fir",
                         [_P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _F]
                         + [_I] * 5 + [_P, _P])
    _build.check("frontend_probe", fn(
        *_planes_ptrs(x, form), FORMS[form], int(int8_taps), int(tile_major),
        int(full), tb["w_rev"].data_ptr(), tb["b1"].data_ptr(),
        tb["b2"].data_ptr(), NN, tb["s_row"], c, b, c_blk, t_blk, raster,
        out.data_ptr(), _build.stream_ptr(x.device)))
    launches_fir += 1
    return out


# fp_dbuf_kernel's shared memory.  The formula is the C side's
# (csrc/frontend_probe.cu::fp_dbuf_layout, exported as fmt_fp_dbuf_layout),
# which dbuf_layout reads on the card; below is its host copy, for the CPU
# (the plain path's refusal and the tests' models), held equal to the C
# side by chip_smoke.compare_fp_edges.
RUN = 8             # outputs a thread
DBUF_GROUP = 2048   # outputs a plane a group sums at most
DBUF_MAX_SEGS = DBUF_GROUP // 128


def _mid_skew(x: int) -> int:
    return x + (x >> 5)


def _seg_stride(ns: int) -> int:
    """Floats between two segments' skewed planes (fp_stride)."""
    return (_mid_skew(NN + 4 * ns - 1) + 1 + 31) // 32 * 32 + (ns // RUN) % 32


def _group_floats(ns: int, p: int) -> int:
    """fp_group_floats: the re and im planes of p segments of ns outputs,
    the taps, the im sums, the runs' last and the segments' extra theta."""
    return (2 * p * _seg_stride(ns) + NN + p * ns + p * ns // RUN
            + DBUF_MAX_SEGS)


def dbuf_layout(c_blk: int, t_blk: int, nbuf: int, device="cpu") -> dict:
    """fp_dbuf_kernel's launch: the raw ring (nbuf tiles of c_blk x t_blk
    words), the carried heads (2 x HEAD floats a channel), and a group of
    ``segs`` segments of ``seg_outs`` outputs (the most, up to 2,048 a
    plane, that fit), summed by ``threads`` threads; ``smem`` bytes in all
    (fits when <= SMEM_BYTES).  On a CUDA device the C side computes it
    (fmt_fp_dbuf_layout); on the CPU the host copy."""
    if not _build.on_cpu("dbuf_layout", torch.device(device)):
        out = (ctypes.c_int64 * 4)()
        fn = _build.function("frontend_probe", "fmt_fp_dbuf_layout",
                             [_I, _I, _I, _P])
        _build.check("frontend_probe",
                     fn(c_blk, t_blk, nbuf, ctypes.addressof(out)))
        return {"segs": out[1], "seg_outs": out[0], "threads": out[2],
                "smem": out[3]}
    no = t_blk // M
    ns = min(no, DBUF_GROUP)
    own = nbuf * c_blk * t_blk + 2 * HEAD * c_blk
    p = min(c_blk * (no // ns), DBUF_GROUP // ns)
    while p > 1 and 4 * (own + _group_floats(ns, p)) > SMEM_BYTES:
        p //= 2
    return {"segs": p, "seg_outs": ns, "threads": p * ns // 4,
            "smem": 4 * (own + _group_floats(ns, p))}


def dbuf(xw: torch.Tensor, full: bool, c_blk: int, t_blk: int, nbuf: int,
         tb: dict | None = None) -> torch.Tensor:
    """build_dbuf on packed words [C, B]: [C, B/4].  CPU tensors run
    :func:`dbuf_plain`."""
    _check("dbuf", xw, "f32w")
    tb = tb or tables(xw.device)
    if dbuf_layout(c_blk, t_blk, nbuf, xw.device)["smem"] > SMEM_BYTES:
        raise ValueError(f"dbuf: tile {c_blk}x{t_blk} x {nbuf} exceeds "
                         "shared memory")
    if _build.on_cpu("dbuf", xw.device):
        return dbuf_plain(xw, full, t_blk, tb)
    global launches_dbuf
    c, b = xw.shape
    out = torch.empty((c, b // M), device=xw.device)
    fn = _build.function("frontend_probe", "fmt_fp_dbuf",
                         [_P, _I, _P] + [_I] * 6 + [_P, _P])
    _build.check("frontend_probe", fn(
        xw.data_ptr(), int(full), tb["w_rev"].data_ptr(), NN, c, b, c_blk,
        t_blk, nbuf, out.data_ptr(), _build.stream_ptr(xw.device)))
    launches_dbuf += 1
    return out


def i8direct(x8: torch.Tensor, full: bool, t_blk: int, no: int = 128,
             noasm: bool = False, tb: dict | None = None) -> torch.Tensor:
    """build_i8direct on int8 planes [2, C, B]: [C, B/4].  CPU tensors run
    :func:`i8d_plain`."""
    _check("i8direct", x8, "u8")
    tb = tb or tables(x8.device)
    if _build.on_cpu("i8direct", x8.device):
        return i8d_plain(x8, full, t_blk, no, noasm, tb)
    global launches_i8d
    c, b = x8.shape[1:]
    out = torch.empty((c, b // M), device=x8.device)
    theta = torch.empty_like(out) if full else out
    tail = torch.zeros((2, c, NN - M), dtype=torch.int8, device=x8.device)
    fn = _build.function("frontend_probe", "fmt_fp_i8d",
                         [_P, _P, _P, _P, _I, _F] + [_I] * 6 + [_P, _P, _P])
    _build.check("frontend_probe", fn(
        x8.data_ptr(), tail.data_ptr(), tb["b1"].data_ptr(),
        tb["b2"].data_ptr(), NN, tb["s_row"], c, b, t_blk, no, int(noasm),
        int(full), theta.data_ptr(), out.data_ptr(),
        _build.stream_ptr(x8.device)))
    launches_i8d += 1
    return out


def i8man_smem(c_blk: int, t_blk: int, full: bool) -> int:
    return 6 * c_blk * t_blk + (c_blk * t_blk if full else 0)


def i8manual(x8: torch.Tensor, full: bool, c_blk: int, t_blk: int,
             no: int = 128, tb: dict | None = None) -> torch.Tensor:
    """build_i8manual on int8 planes [2, C, B]: [C, B/4].  CPU tensors run
    :func:`i8man_plain`."""
    _check("i8manual", x8, "u8")
    tb = tb or tables(x8.device)
    if i8man_smem(c_blk, t_blk, full) > SMEM_BYTES - 64:
        raise ValueError(f"i8manual: tile {c_blk}x{t_blk} exceeds shared "
                         "memory")
    if _build.on_cpu("i8manual", x8.device):
        return i8man_plain(x8, full, t_blk, no, tb)
    global launches_i8man
    c, b = x8.shape[1:]
    out = torch.empty((c, b // M), device=x8.device)
    fn = _build.function("frontend_probe", "fmt_fp_i8man",
                         [_P, _P, _P, _I, _F] + [_I] * 6 + [_P, _P])
    _build.check("frontend_probe", fn(
        x8.data_ptr(), tb["b1"].data_ptr(), tb["b2"].data_ptr(), NN,
        tb["s_row"], c, b, c_blk, t_blk, no, int(full), out.data_ptr(),
        _build.stream_ptr(x8.device)))
    launches_i8man += 1
    return out


# ---- inputs -------------------------------------------------------------------

def make_inputs(c: int, b: int, device, seed: int = 0) -> dict:
    """The TPU tool's input (uniform random u8 IQ, numpy seed) in every
    form: f32w words [C, B], i16 words [C, B], u8 int8 planes [2, C, B]."""
    rng = np.random.default_rng(seed)
    iq = rng.integers(0, 256, size=(c, b, 2), dtype=np.uint8)
    i = iq[..., 0].astype(np.int32)
    q = iq[..., 1].astype(np.int32)
    x = {"f32w": (i * 256 + q).astype(np.float32),
         "i16": (i * 256 + q - 32768).astype(np.int16),
         "u8": np.stack([i - 128, q - 128]).astype(np.int8),
         "f32p": np.stack([i - 127, q - 127]).astype(np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in x.items()}


def tile_major(x: torch.Tensor, form: str, t_blk: int) -> torch.Tensor:
    """An input re-laid tile-major: [n_tt, C, t_blk] per plane."""
    def tm(p):
        c, b = p.shape
        return p.reshape(c, b // t_blk, t_blk).permute(1, 0, 2).contiguous()

    if form in PLANES:
        return torch.stack([tm(x[0]), tm(x[1])])
    return tm(x)


# ---- the sections ---------------------------------------------------------------

# the tiles section's (c_blk, t_blk): dbuf with one buffer, beside stream
TILES = ((1, 2048), (2, 2048), (4, 1024), (4, 2048), (4, 4096), (8, 2048),
         (8, 4096), (16, 1024))

def variant_fn(mode: str, x, form: str, int8_taps: bool, c_blk: int,
               t_blk: int, tm: bool = False, raster: int = 0, tb=None):
    """(kernel call, plain call, kernel name) of one build variant."""
    if mode in ("stream", "unpack"):
        unpack = mode == "unpack"
        return (lambda: tile_sum(x, form, unpack, c_blk, t_blk, tm, raster),
                lambda: sum_plain(x, form, unpack, t_blk, tm), "fp_sum")
    full = mode == "full"
    return (lambda: fir(x, form, int8_taps, full, c_blk, t_blk, tm, raster,
                        tb),
            lambda: fir_plain(x, form, int8_taps, full, t_blk, tm, tb=tb),
            "fp_fir")


def run(c: int, b: int, sections: set, iters: int, device,
        check: bool = True, emit=_probe.emit) -> list[dict]:
    """Every row of ``sections`` at [C, B]; each kernel against its plain
    version where ``check``.  Returns the rows (also passed to ``emit``)."""
    inp = make_inputs(c, b, device)
    tb = tables(device)
    rows = []

    def go(tag, fns, nbytes, **extra):
        kern, plain, kernel = fns
        ms, out = _probe.time_ms(kern, iters, device)
        err = _probe.max_err(out, plain()) if check else None
        r = _probe.row(tag, kernel, ms, nbytes, err, **extra)
        rows.append(r)
        emit(r)
        return r

    def nb(form):
        return c * b * BYTES_PER_SAMPLE[form]

    def tiles_ok(c_blk, t_blk):
        return c % c_blk == 0 and b % t_blk == 0 and t_blk % 512 == 0

    if "ingest" in sections:
        for form in ("f32w", "i16", "u8"):
            for mode in ("stream", "full"):
                for c_blk, t_blk in ((128, 2048), (512, 1024), (128, 4096)):
                    if tiles_ok(c_blk, t_blk):
                        go(f"{mode}:{form}:tile={c_blk}x{t_blk}",
                           variant_fn(mode, inp[form], form, False, c_blk,
                                       t_blk, tb=tb), nb(form))
    if "tm" in sections:
        for form in ("f32w", "u8"):
            for mode in ("stream", "full"):
                for c_blk, t_blk in ((128, 2048), (512, 1024), (128, 4096),
                                     (512, 2048), (1024, 1024)):
                    if tiles_ok(c_blk, t_blk):
                        xt = tile_major(inp[form], form, t_blk)
                        go(f"{mode}:{form}:TM:tile={c_blk}x{t_blk}",
                           variant_fn(mode, xt, form, False, c_blk, t_blk,
                                       tm=True, tb=tb), nb(form))
    if "engines" in sections:
        c_blk, t_blk = default_tiles(c, b)
        for mode in ("stream", "unpack", "dots", "full"):
            for int8 in (False, True):
                if mode in ("stream", "unpack") and int8:
                    continue
                go(f"{mode}:no=128:{'int8' if int8 else 'f32'}",
                   variant_fn(mode, inp["f32w"], "f32w", int8, c_blk, t_blk,
                               tb=tb), nb("f32w"))
    if "split" in sections:
        # the float K1's parts on its two float-tap forms of the cells:
        # packed words (f32w) and float32 planes (complex, after the split)
        c_blk, t_blk = default_tiles(c, b)
        for form in ("f32w", "f32p"):
            for mode in ("stream", "unpack", "dots", "full"):
                go(f"split:{form}:{mode}",
                   variant_fn(mode, inp[form], form, False, c_blk, t_blk,
                               tb=tb), nb(form))
    if "tiles" in sections:
        for c_blk, t_blk in TILES:
            if not tiles_ok(c_blk, t_blk):
                continue
            smem = dbuf_layout(c_blk, t_blk, 1, device)["smem"]
            if smem > SMEM_BYTES:
                continue
            go(f"stream:tile={c_blk}x{t_blk}",
               variant_fn("stream", inp["f32w"], "f32w", False, c_blk,
                           t_blk, tb=tb), nb("f32w"), smem_bytes=0)
            go(f"full:staged:tile={c_blk}x{t_blk}",
               (lambda c_blk=c_blk, t_blk=t_blk: dbuf(inp["f32w"], True,
                                                      c_blk, t_blk, 1, tb),
                lambda t_blk=t_blk: dbuf_plain(inp["f32w"], True, t_blk, tb),
                "fp_dbuf"), nb("f32w"), smem_bytes=smem)
    if "dbuf" in sections:
        c_blk, t_blk = default_tiles(c, b)
        for mode in ("dots", "full"):
            full = mode == "full"
            go(f"{mode}:direct", variant_fn(mode, inp["f32w"], "f32w", False,
                                            c_blk, t_blk, tb=tb), nb("f32w"))
            for nbuf in (1, 2):
                go(f"{mode}:{'single' if nbuf == 1 else 'double'}-buf:"
                   f"tile=8x2048",
                   (lambda full=full, nbuf=nbuf: dbuf(inp["f32w"], full, 8,
                                                      2048, nbuf, tb),
                    lambda full=full: dbuf_plain(inp["f32w"], full, 2048, tb),
                    "fp_dbuf"), nb("f32w"))
    x8 = inp["u8"]
    if "i8d" in sections:
        _, t_blk = default_tiles(c, b)
        for mode in ("dots", "full"):
            full = mode == "full"
            go(f"{mode}:i8direct",
               (lambda full=full: i8direct(x8, full, t_blk, tb=tb),
                lambda full=full: i8d_plain(x8, full, t_blk, tb=tb),
                "fp_i8d"), nb("u8"))
    if "i8x" in sections:
        c_blk, t_blk = default_tiles(c, b)
        go("stream:i8", variant_fn("stream", x8, "u8", False, c_blk, t_blk,
                                    tb=tb), nb("u8"))
        for tag, t, noasm, full in (
                ("dots:i8d:noasm", t_blk, True, False),
                ("dots:i8d:t4096", 4096, False, False),
                ("dots:i8d:t4096:noasm", 4096, True, False),
                ("full:i8d:noasm", t_blk, True, True)):
            if b % t:
                continue
            go(tag, (lambda t=t, noasm=noasm, full=full: i8direct(
                x8, full, t, noasm=noasm, tb=tb),
                     lambda t=t, noasm=noasm, full=full: i8d_plain(
                         x8, full, t, noasm=noasm, tb=tb), "fp_i8d"),
               nb("u8"))
        # the TPU's semP / semPP rows: one thread per output here, so no
        # grid order to change; the rasterised form is build's (sem)
    if "man" in sections:
        for mode in ("dots", "full"):
            full = mode == "full"
            for t_blk in (2048, 4096):
                if b % t_blk or c % 8:
                    continue
                go(f"{mode}:i8man:tile=8x{t_blk}",
                   (lambda full=full, t_blk=t_blk: i8manual(
                       x8, full, 8, t_blk, tb=tb),
                    lambda full=full, t_blk=t_blk: i8man_plain(
                        x8, full, t_blk, tb=tb), "fp_i8man"),
                   nb("u8"))
    if "sem" in sections:
        c_blk, t_blk = default_tiles(c, b)
        for raster, sem in ((0, "default: time tiles fastest"),
                            (1, "P,A: channel tiles fastest")):
            for mode in ("stream", "dots", "full"):
                go(f"{mode}:sem={'default' if raster == 0 else 'P,A'}",
                   variant_fn(mode, inp["f32w"], "f32w", False, c_blk,
                               t_blk, raster=raster, tb=tb), nb("f32w"),
                   raster=sem)
    return rows


def main(argv=None) -> int:
    args = _probe.parse(argv, __doc__, [("channels", 1024),
                                        ("block", 262144)],
                        "engines,tiles,ingest", 48)
    dev = _probe.device_of(args.device)
    cpu = dev.type == "cpu"
    c = args.channels or (8 if cpu else 1024)
    b = args.block or (8192 if cpu else 262144)
    _probe.header("frontend_probe", dev, channels=c, block=b,
                  in_gb=c * b * 4 / 1e9, iters=args.iters)
    rows = run(c, b, set(args.sections.split(",")), args.iters, dev)
    return 0 if all(r["max_abs_err"] in (None, 0.0) for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
