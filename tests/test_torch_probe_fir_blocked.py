"""The K1 engine probe's staged FIR kernels, on the host.

``csrc/frontend_probe.cu``'s fp_fir_kernel, fp_fir_i8_kernel and
fp_dbuf_kernel run only on the card.  Here numpy models of their schedules
are held bit for bit against the plain versions they must equal
(``probes/frontend_probe.py::fir_plain`` and ``dbuf_plain``): the CTAs'
segments and passes, the skewed index of each staged sample, the zero
head before every build tile, the tile-major offsets, the dbuf head
carried from tile to tile as planes, ``extract_stages.cuh::fir_block``'s
slots with its partial last block (132 taps: 33 steps a phase), K12's
sliding int8 window on the i8_byte words, the theta before a segment, and
the in-tile difference.  Staged memory that the kernel never writes is NaN
(or a word of 0x7f bytes) in the models, so a read of it shows; every
output must be written exactly once.  Also: the host copy of fp_dbuf's
shared-memory layout (``dbuf_layout`` on the CPU; the C side's
``fp_dbuf_layout`` on the card) against the buffers the model stages and
the C side's constants, and the card's run of
every variant at the edge shapes (``chip_smoke.compare_fp_edges``; marked
``gpu``, it skips here).

The float models round every product and sum to float32 in numpy, as
``-fmad=false`` makes the kernels do, so equality is exact (max abs error
0), as the card must show.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fm_radio_tpu_torch.ops.cmath import atan2_poly
from fm_radio_tpu_torch.probes import frontend_probe as fp

F = np.float32
C, B = 16, 8192
# (c_blk, t_blk): the shortest tile (eight rows a CTA, two a warp), the
# longest the sections take, and a row's tile in two CTAs (the second's
# difference from the theta before it)
TILES = ((1, 512), (16, 512), (1, 4096), (16, 4096), (2, 8192))
RUN, PASS = 8, 1024
PI, TWO_PI = F(np.pi), F(2 * np.pi)


def ms(x):
    return x + (x >> 5)


@pytest.fixture(scope="module")
def inputs():
    return fp.make_inputs(C, B, "cpu", seed=3)


@pytest.fixture(scope="module")
def tb():
    return fp.tables()


def _tile_base(row, ti, rows, n, t_blk, tm):
    return (ti * rows + row) * t_blk if tm else row * n + ti * t_blk


def _mem(x, form):
    """(re, im) float32 of an input in memory order (its unpack), flat."""
    re, im = fp.decode(x, form)
    return re.numpy().reshape(-1), im.numpy().reshape(-1)


def _fir_block(flat, bases, w, nn):
    """fir_block<4, 8, NN, 4> step for step for lanes whose first sample
    (skewed) is flat[bases]: the window slots, each block's loads at a
    constant offset, a last partial block of NQ % 8 steps."""
    m, r_outs, b0 = 4, RUN, 4
    nq = nn // m
    npart = nq % r_outs
    v = [[flat[bases + ms(b0 + m * r + p)] for r in range(r_outs)]
         for p in range(m)]
    acc = np.zeros((len(bases), r_outs), F)

    def steps(qb, n_steps, last):
        xq = bases + 33 * (qb // r_outs)
        for qq in range(n_steps):
            wk = w[m * (qb + qq): m * (qb + qq) + m]
            for p in range(m):
                for r in range(r_outs):
                    acc[:, r] = acc[:, r] + F(wk[p]) * v[p][(r + qq) % r_outs]
                if not last or qq + 1 < n_steps:
                    v[p][qq] = flat[xq + ms(b0 + m * (r_outs + qq) + p)]

    if npart == 0:
        for qb in range(0, nq - r_outs, r_outs):
            steps(qb, r_outs, False)
        steps(nq - r_outs, r_outs, True)
    else:
        for qb in range(0, nq - npart, r_outs):
            steps(qb, r_outs, False)
        steps(nq - npart, npart, True)
    return acc


def _disc(th, prev):
    """disc_value over a run: wrap(theta - prev) * 0.123 in float32."""
    out = np.empty_like(th)
    for r in range(th.shape[1]):
        d = th[:, r] - prev
        d = np.where(d >= PI, d - TWO_PI, d)
        d = np.where(d <= -PI, d + TWO_PI, d)
        out[:, r] = d * F(0.123)
        prev = th[:, r]
    return out


def _atan2(y, x):
    return atan2_poly(torch.from_numpy(y), torch.from_numpy(x)).numpy()


def _geom(c_blk, t_blk, cap):
    no = t_blk // 4
    ns = min(no, cap)
    return no, ns, no // ns


def _finish(full, fr, fi, seg_of_run, q, j0, extra):
    """The re threads' values of their runs [lanes, 8]: fr + fi, or theta
    and the difference (prev: the run before in its segment, the theta
    before the segment, or its own first)."""
    if not full:
        return fr + fi
    th = _atan2(fi, fr)
    prev = np.where(q > 0, np.roll(th[:, -1], 1),
                    np.where(j0 > 0, extra[seg_of_run], th[:, 0]))
    return _disc(th, prev)


def fir_model(x, form, full, c_blk, t_blk, tm, raster, w):
    """fp_fir_kernel's schedule: CTA b is pass b % passes of tile b //
    passes (tile_of's raster), each pass p segments staged skewed behind
    the zero head, summed by _fir_block, the im sums to the re lanes."""
    n_ct, n_tt = C // c_blk, B // t_blk
    no, ns, sigma = _geom(c_blk, t_blk, PASS)
    segs = c_blk * sigma
    p = min(segs, PASS // ns)
    passes = -(-segs // p)
    nn, stride, rps = fp.NN, fp._seg_stride(ns), ns // RUN
    re, im = _mem(x, form)
    n_cta = n_ct * n_tt * passes
    planes = np.full((n_cta, 2, p * stride), np.nan, F)
    lanes = []  # (cta, s, q, row, ti, j0)
    for cta in range(n_cta):
        tile = cta // passes
        ci, ti = ((tile // n_tt, tile % n_tt) if raster == 0
                  else (tile % n_ct, tile // n_ct))
        for s in range(p):
            z = (cta % passes) * p + s
            if z // sigma >= c_blk:
                continue
            row, j0 = ci * c_blk + z // sigma, (z % sigma) * ns
            e = np.arange(nn + 4 * ns)
            m = 4 * j0 - nn + e
            at = _tile_base(row, ti, C, B, t_blk, tm) + np.maximum(m, 0)
            for pl, src in enumerate((re, im)):
                planes[cta, pl, s * stride + ms(e)] = np.where(
                    m >= 0, src[at], F(0))
            lanes += [(cta, s, q, row, ti, j0) for q in range(rps)]
    ln = np.array(lanes)
    cta, s, q, row, ti, j0 = ln.T
    flat = planes.reshape(-1)
    base = (cta * 2 * p * stride) + s * stride + 33 * q
    fr = _fir_block(flat, base, w, nn)
    fi = _fir_block(flat, base + p * stride, w, nn)
    extra = np.zeros(len(ln), F)
    if full:  # theta of output j0 - 1, e = k, from 0.0 in k order
        first = np.nonzero((q == 0) & (j0 > 0))[0]
        a = np.zeros(len(first), F)
        b = np.zeros(len(first), F)
        sb = cta[first] * 2 * p * stride + s[first] * stride
        for k in range(nn):
            a = a + F(w[k]) * flat[sb + ms(k)]
            b = b + F(w[k]) * flat[sb + p * stride + ms(k)]
        if len(first):  # each run's segment's, read at its first run
            extra = _atan2(b, a)[np.searchsorted(first, np.arange(len(ln)),
                                                 side="right") - 1]
    v = _finish(full, fr, fi, np.arange(len(ln)), q, j0, extra)
    return _scatter(v, row, ti * no + j0 + RUN * q)


def _scatter(v, row, j):
    out = np.full((C, B // 4), np.nan, F)
    seen = np.zeros((C, B // 4), np.int32)
    for r in range(RUN):
        np.add.at(seen, (row, j + r), 1)
        out[row, j + r] = v[:, r]
    assert (seen == 1).all(), "an output not written exactly once"
    return out


def _words_of(re, im, at):
    """i8_byte of four samples from ``at``: [n, 4] int8 bytes of re, im."""
    def pack(src):
        v = np.stack([src[at + u] for u in range(4)], -1)
        return (v - F(1)).astype(np.int32).astype(np.int8)
    return pack(re), pack(im)


def fir_i8_model(x, form, full, c_blk, t_blk, tm, raster, tb):
    """fp_fir_i8_kernel's schedule: the staged words (0xff bytes before
    the tile; 0x7f, never summed, past it), the taps padded at the oldest
    end to whole blocks of 8 words, each thread's run from the sliding
    window of 8 words, the int32 sums combined as y1 + y2 / 128 + s_row."""
    n_ct, n_tt = C // c_blk, B // t_blk
    no, ns, sigma = _geom(c_blk, t_blk, PASS)
    segs = c_blk * sigma
    p = min(segs, PASS // ns)
    passes = -(-segs // p)
    rps, nw = ns // RUN, fp.NN // 4
    nwp = -(-nw // RUN) * RUN
    h = -(-nwp // 4) * 4
    n_e = h + ns + 1
    stride = (ms(h + ns) + 1 + 31) // 32 * 32 + (4 if rps < 32 else 0)
    taps = np.zeros((nwp, 2, 4), np.int32)
    taps[nwp - nw:, 0] = np.asarray(tb["b1_list"], np.int32).reshape(nw, 4)
    taps[nwp - nw:, 1] = np.asarray(tb["b2_list"], np.int32).reshape(nw, 4)
    re, im = _mem(x, form)
    n_cta = n_ct * n_tt * passes
    words = np.full((n_cta, 2, p * stride, 4), 0x7f, np.int8)
    lanes = []
    for cta in range(n_cta):
        tile = cta // passes
        ci, ti = ((tile // n_tt, tile % n_tt) if raster == 0
                  else (tile % n_ct, tile // n_ct))
        for s in range(p):
            z = (cta % passes) * p + s
            if z // sigma >= c_blk:
                continue
            row, j0 = ci * c_blk + z // sigma, (z % sigma) * ns
            e = np.arange(n_e)
            qw = j0 - h + e
            ok = (qw >= 0) & (qw < no)
            at = _tile_base(row, ti, C, B, t_blk, tm) + 4 * np.where(ok, qw, 0)
            wr, wi = _words_of(re, im, at)
            for pl, wv in enumerate((wr, wi)):
                wv = np.where(ok[:, None], wv, np.int8(-1))
                wv[qw >= no] = 0x7f
                words[cta, pl, s * stride + ms(e)] = wv
            lanes += [(cta, s, q, row, ti, j0) for q in range(rps)]
    ln = np.array(lanes)
    cta, s, q, row, ti, j0 = ln.T
    flat = words.reshape(-1, 4).astype(np.int32)
    plane = p * stride
    base = cta * 2 * plane + s * stride
    eb = h - nwp + 1 + RUN * q

    def window(off):
        v = [flat[off + ms(eb + r)] for r in range(RUN)]
        y = np.zeros((2, len(ln), RUN), np.int64)
        for qb in range(0, nwp, RUN):
            for qq in range(RUN):
                for r in range(RUN):
                    for t in range(2):
                        y[t, :, r] += (v[(r + qq) % RUN]
                                       * taps[qb + qq, t]).sum(-1)
                v[qq] = flat[off + ms(eb + RUN + qb + qq)]
        return y

    def comb(y):
        return (y[0].astype(F) + y[1].astype(F) * F(1 / 128)) + F(tb["s_row"])

    fr, fi = comb(window(base)), comb(window(base + plane))
    extra = np.zeros(len(ln), F)
    if full:
        first = np.nonzero((q == 0) & (j0 > 0))[0]
        if len(first):
            ya = np.zeros((2, 2, len(first)), np.int64)
            for w_ in range(nwp):
                for pl in range(2):
                    wv = flat[base[first] + pl * plane + ms(h - nwp + w_)]
                    for t in range(2):
                        ya[pl, t] += (wv * taps[w_, t]).sum(-1)
            ex = _atan2(comb(ya[1])[:, None], comb(ya[0])[:, None])[:, 0]
            extra = ex[np.searchsorted(first, np.arange(len(ln)),
                                       side="right") - 1]
    v = _finish(full, fr, fi, np.arange(len(ln)), q, j0, extra)
    return _scatter(v, row, ti * no + j0 + RUN * q)


def dbuf_model(xw, full, c_blk, t_blk, nbuf, w):
    """fp_dbuf_kernel's schedule: every CTA (c_blk channels) walks its
    tiles; a group of p segments (dbuf_layout) at a time is unpacked into
    skewed planes behind the carried head (planes [c_blk, 2, HEAD], zero
    before a row's first tile), the row's last segment hands its last
    HEAD samples on, the group is summed by _fir_block."""
    lay = fp.dbuf_layout(c_blk, t_blk, nbuf)
    p, ns = lay["segs"], lay["seg_outs"]
    assert lay["smem"] <= fp.SMEM_BYTES
    no, _, sigma = _geom(c_blk, t_blk, fp.DBUF_GROUP)
    n_tt, n_cta, head = B // t_blk, C // c_blk, fp.HEAD
    nn, stride, rps = fp.NN, fp._seg_stride(ns), ns // RUN
    re, im = (v.numpy() for v in fp.decode(xw, "f32w"))
    carry = np.zeros((n_cta, c_blk, 2, head), F)
    out = np.full((C, B // 4), np.nan, F)
    seen = np.zeros((C, B // 4), np.int32)
    groups = -(-c_blk * sigma // p)
    for i in range(n_tt):
        for gi in range(groups):
            planes = np.full((n_cta, 2, p * stride), np.nan, F)
            lanes = []
            for s in range(p):
                z = gi * p + s
                if z // sigma >= c_blk:
                    continue
                r_blk, j0 = z // sigma, (z % sigma) * ns
                e = np.arange(nn + 4 * ns)
                m = 4 * j0 - nn + e
                for cta in range(n_cta):
                    row = cta * c_blk + r_blk
                    for pl, src in enumerate((re, im)):
                        tile = src[row, i * t_blk: (i + 1) * t_blk]
                        hd = carry[cta, r_blk, pl]
                        planes[cta, pl, s * stride + ms(e)] = np.where(
                            m >= 0, tile[np.maximum(m, 0)],
                            np.where(m >= -head, hd[np.clip(m + head, 0,
                                                            head - 1)],
                                     F(0)))
                    lanes += [(cta, s, q, row, j0) for q in range(rps)]
                if j0 + ns == no:  # the next tile's head, from the planes
                    k = np.arange(head)
                    carry[:, r_blk] = planes[:, :, s * stride + ms(
                        4 * ns + nn - head + k)]
            ln = np.array(lanes)
            cta, s, q, row, j0 = ln.T
            flat = planes.reshape(-1)
            base = cta * 2 * p * stride + s * stride + 33 * q
            fr = _fir_block(flat, base, w, nn)
            fi = _fir_block(flat, base + p * stride, w, nn)
            extra = np.zeros(len(ln), F)
            if full and (j0 > 0).any():
                first = np.nonzero((q == 0) & (j0 > 0))[0]
                sb = cta[first] * 2 * p * stride + s[first] * stride
                a = np.zeros(len(first), F)
                b = np.zeros(len(first), F)
                for k in range(nn):
                    a = a + F(w[k]) * flat[sb + ms(k)]
                    b = b + F(w[k]) * flat[sb + p * stride + ms(k)]
                ex = _atan2(b, a)
                extra = ex[np.searchsorted(first, np.arange(len(ln)),
                                           side="right") - 1]
            v = _finish(full, fr, fi, np.arange(len(ln)), q, j0, extra)
            for r in range(RUN):
                jj = i * no + j0 + RUN * q + r
                np.add.at(seen, (row, jj), 1)
                out[row, jj] = v[:, r]
    assert (seen == 1).all(), "an output not written exactly once"
    return out


# ---- the fir_block partial last block ---------------------------------------

class _Loads:
    """A plane that records the index arrays it is read at."""

    def __init__(self, plane):
        self.plane, self.seen = plane, []

    def __getitem__(self, idx):
        self.seen.append(np.asarray(idx))
        return self.plane[idx]


@pytest.mark.parametrize("nn", [132, 64])
def test_fir_block_partial_block_is_the_ascending_sum(nn):
    """fir_block<4, 8, NN, 4>'s schedule (132 taps: four blocks of 8 steps
    and one of 1; 64: two whole blocks, the receiver's code) over a skewed
    plane gives each lane's 8 outputs bit for bit as ds4_float sums them
    (from 0.0, k ascending, every product and sum rounded), reads only the
    samples the lanes' windows hold (the rest is NaN), and at every load
    its 32 lanes read 32 distinct banks."""
    rng = np.random.default_rng(nn)
    n_x = 4 + 4 * 256 + nn - 4  # outputs 0 .. 255: samples 4 + 4 j + k
    x = rng.normal(0, 1, n_x).astype(F)
    plane = np.full(ms(n_x) + 40, np.nan, F)
    plane[ms(np.arange(n_x))] = x
    w = rng.normal(0, 0.1, nn).astype(F)
    loads = _Loads(plane)
    got = _fir_block(loads, 33 * np.arange(32), w, nn).reshape(-1)
    want = np.zeros(256, F)
    for k in range(nn):
        want = want + w[k] * x[4 + k: 4 + k + 4 * 256: 4]
    assert np.array_equal(got, want)
    # every load but the block's refills of the last step; no NaN read
    assert len(loads.seen) == 4 * 8 + 4 * (nn // 4 - 1)
    for idx in loads.seen:
        assert len({int(i) % 32 for i in idx}) == 32
        assert np.isfinite(plane[idx]).all()


# ---- fp_fir -------------------------------------------------------------------

@pytest.mark.parametrize("form", list(fp.FORMS))
@pytest.mark.parametrize("c_blk,t_blk", TILES)
def test_fir_float_taps_schedule_equals_plain(inputs, tb, form, c_blk,
                                              t_blk):
    """fp_fir_kernel (float taps) on every form: dots and full, row-major
    in time-first order and tile-major in channel-first order, equal to
    fir_plain bit for bit."""
    w = tb["w_rev"].numpy()
    for tm, raster in ((False, 0), (True, 1)):
        x = fp.tile_major(inputs[form], form, t_blk) if tm else inputs[form]
        for full in (False, True):
            got = fir_model(x, form, full, c_blk, t_blk, tm, raster, w)
            want = fp.fir_plain(x, form, False, full, t_blk, tm, tb=tb)
            np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("form", list(fp.FORMS))
@pytest.mark.parametrize("c_blk,t_blk", TILES)
def test_fir_int8_taps_schedule_equals_plain(inputs, tb, form, c_blk, t_blk):
    """fp_fir_i8_kernel (int8 taps) on every form: dots and full, both
    layouts and orders, equal to fir_plain bit for bit."""
    for tm, raster in ((False, 1), (True, 0)):
        x = fp.tile_major(inputs[form], form, t_blk) if tm else inputs[form]
        for full in (False, True):
            got = fir_i8_model(x, form, full, c_blk, t_blk, tm, raster, tb)
            want = fp.fir_plain(x, form, True, full, t_blk, tm, tb=tb)
            np.testing.assert_array_equal(got, want.numpy())


# ---- fp_dbuf ------------------------------------------------------------------

@pytest.mark.parametrize("nbuf", [1, 2])
@pytest.mark.parametrize("c_blk,t_blk", TILES + ((4, 2048), (16, 1024)))
def test_dbuf_schedule_equals_plain(inputs, tb, c_blk, t_blk, nbuf):
    """fp_dbuf_kernel's groups, the head carried as planes: dots and full
    equal to dbuf_plain bit for bit (a tile over the shared memory is
    refused instead)."""
    xw = inputs["f32w"]
    if fp.dbuf_layout(c_blk, t_blk, nbuf)["smem"] > fp.SMEM_BYTES:
        with pytest.raises(ValueError, match="shared memory"):
            fp.dbuf(xw, True, c_blk, t_blk, nbuf)
        return
    w = tb["w_rev"].numpy()
    for full in (False, True):
        got = dbuf_model(xw, full, c_blk, t_blk, nbuf, w)
        want = fp.dbuf_plain(xw, full, t_blk, tb)
        np.testing.assert_array_equal(got, want.numpy())


def test_dbuf_layout_counts_the_staged_buffers():
    """dbuf_layout's host copy (the models') is the C side's formula on
    the C side's constants, and its bytes hold what the kernel stages: the
    raw ring, the carried heads, and a group (fp_group_floats) whose
    planes each hold their skewed segment, beside the taps and the im
    sums; the group holds at most 2,048 outputs a plane and is halved
    until it fits; a layout whose one segment does not fit is over the
    limit.  The C side's own numbers are held equal to this copy on the
    card (test_fp_edges_on_card)."""
    src = (Path(fp.__file__).parent.parent / "csrc"
           / "frontend_probe.cu").read_text()
    for name, value in (("kFpSmemMax", fp.SMEM_BYTES),
                        ("kFpGroup", fp.DBUF_GROUP), ("kFpTaps", fp.NN),
                        ("kFpRun", RUN)):
        assert re.search(rf"{name} = (\d+);", src).group(1) == str(value)
    for c_blk in (1, 2, 3, 4, 8, 16, 32):
        for t_blk in (512, 1024, 2048, 4096, 8192, 16384, 32768):
            for nbuf in (1, 2):
                lay = fp.dbuf_layout(c_blk, t_blk, nbuf)
                p, ns = lay["segs"], lay["seg_outs"]
                no = t_blk // 4
                assert ns == min(no, 2048) and no % ns == 0
                assert p * ns <= 2048 and lay["threads"] == p * ns // 4
                stride = fp._seg_stride(ns)
                assert ms(fp.NN + 4 * ns - 1) < stride and stride % 16 == 0
                # the raw ring and the carried heads, then the group
                own = 4 * (nbuf * c_blk * t_blk + 2 * fp.HEAD * c_blk)
                assert lay["smem"] == own + 4 * fp._group_floats(ns, p)
                assert fp._group_floats(ns, p) >= (2 * p * stride + fp.NN
                                                   + p * ns)
                # p: the first of more, more // 2, ... that fits (or 1)
                seq = [min(c_blk * (no // ns), 2048 // ns)]
                while seq[-1] > 1:
                    seq.append(seq[-1] // 2)
                for tried in seq[:seq.index(p)]:
                    assert own + 4 * fp._group_floats(ns, tried) \
                        > fp.SMEM_BYTES
                assert lay["smem"] <= fp.SMEM_BYTES or p == 1
    # the sections' tiles (one buffer) and dbuf's 8 x 2048 (both) all fit
    for c_blk, t_blk in fp.TILES:
        assert fp.dbuf_layout(c_blk, t_blk, 1)["smem"] <= fp.SMEM_BYTES
    for nbuf in (1, 2):
        assert fp.dbuf_layout(8, 2048, nbuf)["smem"] <= fp.SMEM_BYTES


# ---- on the card --------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_fp_edges_on_card():
    """Every fp_fir and fp_dbuf variant equals its plain version bit for
    bit at the edge shapes (chip_smoke.compare_fp_edges: C = 16, B =
    16,384; fp_fir on every form, both taps, dots and full, both layouts
    and rasters at tiles 1 x 512, 16 x 512, 1 x 4096, 16 x 4096, 2 x 8192;
    fp_dbuf with one and two buffers, a tile over the shared memory
    refused), and the dbuf layout's C side equals its host copy."""
    _need_card()
    import chip_smoke

    rows = chip_smoke.compare_fp_edges()
    assert len(rows) == 5 * 4 * 2 * 2 * 2 * 2 + 8 * 2 * 2 + 7 * 7 * 2
    assert all(r["ok"] for r in rows), [r for r in rows if not r["ok"]]


@pytest.mark.gpu
def test_fp_edges_on_checked_build():
    """The same on the bounds-checked build: every global index of the
    two kernels is checked (a trap fails the test)."""
    _need_card()
    import chip_smoke
    from fm_radio_tpu_torch.kernels import _build

    with _build.checked_build():
        rows = chip_smoke.compare_fp_edges(seed=6)
    assert all(r["ok"] for r in rows), [r for r in rows if not r["ok"]]
