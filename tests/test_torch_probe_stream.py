"""The streaming probe kernels' work partitions, on the CPU: host models
of the C formulas (``csrc/hbm_sweep.cu::dma_plan`` and the copy's chunk
walk, ``csrc/probe_sum.cuh``'s item walk and lane batches; their host
copies in ``probes/hbm_sweep.py`` and ``probes/_probe.py``).

- The staged copy: every chunk copied exactly once, by one issuer, for
  grids smaller and larger than the work and a partial last round; each
  issuer's buffers reused only after the store that read them (a model
  of the kernel's issue order); the plan of every dma variant.
- The tile sums: every (row, tile) summed exactly once for the launch's
  grid (its last CTA partial) and for grids smaller and larger than the
  work, in both rasters; the lane's batches at each compiled tile length
  and at lengths that are not compiled; the kernel's walk, batch by batch, bit for bit
  equal to the plain versions (``frontend_probe.sum_plain``,
  ``k3_probe.sum_plain``), which the probe tests hold against the TPU
  tools.
- The byte rate a bound divides by: the read rate for the read-only
  kernels, the copy rate for every other, from a stub sweep.

On the card ``chip_smoke.compare_stream_edges`` runs both kernels at
these edges against their plain versions (marked ``gpu``: they skip here).
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from fm_radio_tpu_torch.probes import _probe
from fm_radio_tpu_torch.probes import frontend_probe as fp
from fm_radio_tpu_torch.probes import hbm_sweep as hs
from fm_radio_tpu_torch.probes import k3_probe as k3
from fm_radio_tpu_torch.utils.transfer import unpack_iq_words

SMS = 132  # the H100's SMs


# ---- the staged copy --------------------------------------------------------

@pytest.mark.parametrize("n_chunks, issuers", [
    (5, 396),              # fewer chunks than issuers: most idle
    (396, 396),            # one whole round
    (2 * 396 + 198 + 1, 396),  # the last round partial
    (1000, 7), (1, 1), (7, 1)])
def test_dma_walk_takes_every_chunk_once(n_chunks, issuers):
    walk = hs.dma_walk(n_chunks, issuers)
    assert len(walk) == issuers
    assert sorted(c for w in walk for c in w) == list(range(n_chunks))
    lens = [len(w) for w in walk]
    assert max(lens) - min(lens) <= 1
    for q, w in enumerate(walk):
        assert w == list(range(q, n_chunks, issuers))


# (KiB, buffers) -> issuers a CTA: as many as 227 KB of shared memory hold
@pytest.mark.parametrize("kib, nbuf, per_cta", [
    (16, 1, 14), (16, 2, 7), (32, 1, 7), (32, 2, 3), (64, 1, 3), (64, 2, 1),
    (128, 1, 1)])
def test_dma_plan_fills_shared_memory(kib, nbuf, per_cta):
    chunk = kib * 1024
    ctas, per = hs.dma_plan(256 << 20, chunk, nbuf, SMS)
    assert (ctas, per) == (SMS, per_cta)
    assert per * nbuf * chunk <= hs.DMA_SMEM < (per + 1) * nbuf * chunk
    # few chunks: no more CTAs than they need, and enough issuers for all
    for n in (1, 5, 3 * per + 1, SMS * per + 1):
        ctas, _ = hs.dma_plan(n * chunk, chunk, nbuf, SMS)
        assert ctas == min(SMS, math.ceil(n / per))
        assert ctas * per >= min(n, SMS * per)


def dma_issue(chunks: list, nbuf: int) -> list:
    """One issuer's operations in the kernel's order (csrc/hbm_sweep.cu::
    hbm_dma_copy_kernel): (op, chunk, slot) for load, wait (its load's
    barrier), store, read (wait_group.read 0: every store issued so far
    has read its buffer) and, last, all (wait_group 0)."""
    ops = [("load", c, s) for s, c in enumerate(chunks[:nbuf])]
    for k, c in enumerate(chunks):
        s = k % nbuf
        ops += [("wait", c, s), ("store", c, s)]
        if k + nbuf < len(chunks):
            ops += [("read", None, None), ("load", chunks[k + nbuf], s)]
    return ops + [("all", None, None)]


@pytest.mark.parametrize("nbuf", [1, 2])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_dma_issue_order_reuses_a_buffer_only_after_its_store_read_it(nbuf,
                                                                      n):
    chunks = list(range(3, 3 + 7 * n, 7))  # an issuer's stride of 7
    ops = dma_issue(chunks, nbuf)
    loaded, stored = {}, []
    pending = []  # stores issued and not yet known to have read the buffer
    for op, c, s in ops:
        if op == "load":
            assert all(ps != s for ps in pending), "buffer still being read"
            assert loaded.get(s) is None, "buffer holds an unstored chunk"
            loaded[s] = c
        elif op == "wait":
            assert loaded[s] == c
        elif op == "store":
            assert loaded[s] == c
            stored.append(c)
            loaded[s] = None
            pending.append(s)
        elif op == "read":
            pending = []
    assert stored == chunks and ops[-1][0] == "all"
    if nbuf == 2 and n > 1:
        # the next chunk's load is in flight while this one is stored
        assert ops.index(("load", chunks[1], 1)) < ops.index(
            ("store", chunks[0], 0))


# ---- the tile sums ------------------------------------------------------------

@pytest.mark.parametrize("rows, n_tt, warps", [
    (8, 2, 64),    # a grid larger than the work: most warps idle
    (8, 2, 16),    # one item a warp, the launch's grid
    (7, 3, 24),    # the launch's grid, its last CTA partial
    (40, 16, 9),   # a grid smaller than the work: many rounds, the last
                   # partial
    (1, 1, 1), (5, 1, 2), (1000, 2, 2048)])
@pytest.mark.parametrize("raster", [0, 1])
def test_sum_walk_takes_every_item_once(rows, n_tt, warps, raster):
    walk = _probe.sum_walk(rows, n_tt, raster, warps)
    flat = [it for w in walk for it in w]
    assert sorted(flat) == [(r, t) for r in range(rows) for t in range(n_tt)]
    assert len(set(flat)) == len(flat)
    lens = [len(w) for w in walk]
    assert max(lens) - min(lens) <= 1
    # the walk's order: raster 0 each row's tiles in turn, raster 1 every
    # row's tile, tile after tile
    order = [_probe.sum_item(i, rows, n_tt, raster)
             for i in range(rows * n_tt)]
    if raster == 0:
        assert order == [(r, t) for r in range(rows) for t in range(n_tt)]
    else:
        assert order == [(r, t) for t in range(n_tt) for r in range(rows)]


@pytest.mark.parametrize("rows, n_tt", [(1, 1), (7, 3), (8, 2), (1024, 128),
                                        (3072, 32)])
def test_sum_grid_gives_every_item_a_warp(rows, n_tt):
    warps = _probe.sum_grid(rows, n_tt)
    assert warps % _probe.SUM_WARPS == 0
    assert rows * n_tt <= warps < rows * n_tt + _probe.SUM_WARPS
    walk = _probe.sum_walk(rows, n_tt, 0, warps)
    assert all(len(w) == (1 if p < rows * n_tt else 0)
               for p, w in enumerate(walk))


# (t_blk, 16-byte vector's elements, planes)
ORDERS = [(t, vec, planes) for t in (512, 1024, 2048, 4096, 8192)
          for vec, planes in ((4, 1), (8, 1), (16, 2), (4, 2), (4, 3))]


@pytest.mark.parametrize("t_blk, vec, planes", ORDERS)
def test_lane_order_covers_every_vector_in_order(t_blk, vec, planes):
    batches = _probe.lane_order(t_blk, vec, planes)
    k = t_blk // (32 * vec)
    assert [v for b in batches for v in b] == list(range(k))
    if t_blk in _probe.SUM_T_BLKS:
        size = len(batches[0])
        assert all(len(b) == size for b in batches)
        assert size * planes <= _probe.SUM_LOADS or size == 1
        assert size == _probe.sum_batch(k, planes)
    else:  # the run-time loop: a vector of each row at a time
        assert all(len(b) == 1 for b in batches)


def walk_sums(planes: list, combine, vec: int, t_blk: int, raster: int,
              warps: int):
    """The kernel's sums by its walk: each warp's items in order, each
    lane's vectors in lane_order's batches, element by element into one
    float32 accumulator a plane, the planes combined, then the butterfly.
    planes: per-element values [rows, n_tt, t_blk] each.  Returns (sums
    [rows, n_tt], times each (row, tile) was written)."""
    rows, n_tt, _ = planes[0].shape
    sums = torch.full((rows, n_tt), float("nan"))
    writes = np.zeros((rows, n_tt), np.int64)
    batches = _probe.lane_order(t_blk, vec, len(planes))
    lane = torch.arange(32)
    for items in _probe.sum_walk(rows, n_tt, raster, warps):
        for r, ti in items:
            acc = [torch.zeros(32) for _ in planes]
            for batch in batches:
                for k in batch:
                    for q, p in enumerate(planes):
                        v = p[r, ti].reshape(-1, 32, vec)[k]  # [lane, e]
                        for e in range(vec):
                            acc[q] = acc[q] + v[lane, e]
            sums[r, ti] = _probe.butterfly(combine(acc))
            writes[r, ti] += 1
    return sums, writes


def fp_values(x, form: str, unpack: bool, t_blk: int, tm: bool):
    """The per-element values a K1-probe tile sum adds, per plane."""
    planes = (x[0], x[1]) if form in fp.PLANES else (x,)
    tv = [fp.tiles_view(p, t_blk, tm) for p in planes]
    if not unpack:
        return [t.float() for t in tv]
    if form == "u8":
        return [(tv[0].float() + 1.0) - (tv[1].float() + 1.0)]
    if form == "f32p":
        return [tv[0] - tv[1]]
    w = tv[0] if form == "f32w" else tv[0].float() + 32768.0
    re, im = unpack_iq_words(w)
    return [re - im]


VEC = {"f32w": 4, "i16": 8, "u8": 16, "f32p": 4}


@pytest.mark.parametrize("t_blk", [512, 1024, 2048, 8192])
@pytest.mark.parametrize("form", list(fp.FORMS))
@pytest.mark.parametrize("unpack", [False, True], ids=["stream", "unpack"])
def test_fp_walk_equals_plain(form, unpack, t_blk):
    c, b = 3, 16384
    inp = fp.make_inputs(c, b, "cpu", seed=3)
    for tm, raster, warps in ((False, 0, 5), (True, 1, 64),
                              (False, 1, _probe.sum_grid(c, b // t_blk))):
        x = fp.tile_major(inp[form], form, t_blk) if tm else inp[form]
        vals = fp_values(x, form, unpack, t_blk, tm)
        sums, writes = walk_sums(vals, lambda a: a[0] if len(a) == 1
                                 else a[0] + a[1], VEC[form], t_blk, raster,
                                 warps)
        last, want = fp.sum_plain(x, form, unpack, t_blk, tm)
        assert (writes == 1).all()
        assert torch.equal(sums, want)
        assert torch.equal(last, _probe.last_tile(sums))


@pytest.mark.parametrize("t_blk", [512, 1024, 4096])
@pytest.mark.parametrize("mode", ["stream1", "stream", "phasor", "stream31"])
def test_k3_walk_equals_plain(mode, t_blk):
    c, b8, c_blk = 4, 8192, 2
    xs = k3.make_inputs(c, b8, "cpu", seed=4)

    def tiles(p):
        return p.reshape(p.shape[0], -1, t_blk)

    if mode == "stream31":
        x3 = k3.stack31(xs, c_blk)
        planes, combine, args = [tiles(x3)], (lambda a: a[0]), (x3,)
    elif mode == "stream1":
        planes, combine, args = [tiles(xs[0])], (lambda a: a[0]), xs
    elif mode == "stream":
        planes = [tiles(p) for p in xs]
        combine, args = (lambda a: (a[0] + a[1]) + a[2]), xs
    else:
        off = torch.zeros((c,))
        (mr, mi), (rr, ri) = k3._extract.mix(*xs, off)
        planes = [tiles(((mr + mi) + rr) + ri)]
        combine, args = (lambda a: a[0]), xs
    sums, writes = walk_sums(planes, combine, 4, t_blk, 0, 3)
    last, want = k3.sum_plain(mode, args, t_blk, c_blk)
    assert (writes == 1).all()
    assert torch.equal(sums, want)
    if mode == "stream31":  # the first c_blk rows of each row group
        keep = sums.reshape(-1, 3 * c_blk, sums.shape[1])[:, :c_blk]
        assert torch.equal(last, _probe.last_tile(keep.reshape(c, -1)))


# ---- the bounds' byte rates ------------------------------------------------------

def test_read_only_kernels_are_bound_by_the_read_rate(monkeypatch):
    """A stub sweep: its best copy (a kernel row) and best read (the
    library's torch.sum row) become the two rates; a read-only kernel's
    bytes go over the read rate, every other kernel's over the copy rate;
    a faster read measured later raises the read rate."""
    def row(variant, route, kind, gbps):
        return {"variant": variant, "route": route, "kind": kind,
                "gbps": gbps}

    rows = [row("copy:8x1024", "cuda", "copy", 2900.0),
            row("dma2:32KiB", "cuda", "copy", 3000.0),
            row("dma2:32KiB:load", "cuda", "read", 3150.0),
            row("dma2:32KiB:store", "cuda", "write", 3300.0),
            row("Tensor.copy_", "library", "copy", 2990.0),
            row("read:512x1024", "cuda", "read", 3100.0),
            row("torch.sum", "library", "read", 3200.0),
            row("Tensor.zero_", "library", "write", 3400.0)]
    sweep = hs.best(rows)
    assert sweep["best_copy"]["variant"] == "dma2:32KiB"
    assert sweep["best_read"]["variant"] == "torch.sum"
    for name in ("HBM_BYTES_S", "HBM_RATE_FROM", "HBM_READ_BYTES_S",
                 "HBM_READ_RATE_FROM"):
        monkeypatch.setattr(chip_smoke, name, getattr(chip_smoke, name))
    chip_smoke.set_rates(sweep)
    gb = 3.2e9
    for name in ("fp_sum", "k3_sum", "k3_stream31", "hbm_read"):
        assert name in chip_smoke.READ_ONLY
        b = chip_smoke.bound_of(gb, 1e6, read_only=True)
        assert b["bound_ms"] == pytest.approx(1.0)
        assert b["hbm_rate"] == "read" and "torch.sum" in b["hbm_rate_from"]
    for name in ("hbm_dma_copy", "hbm_copy", "fp_fir", "k12"):
        assert name not in chip_smoke.READ_ONLY
    b = chip_smoke.bound_of(3.0e9)
    assert b["bound_ms"] == pytest.approx(1.0) and b["hbm_rate"] == "copy"
    assert "dma2:32KiB" in b["hbm_rate_from"]
    # a read-only kernel that reads faster than the sweep's best read
    # raises the read rate to its own; a slower one leaves it
    chip_smoke.note_read(3.1e12, "fp_sum stream")
    assert chip_smoke.HBM_READ_BYTES_S == 3.2e12
    chip_smoke.note_read(3.3e12, "fp_sum stream")
    b = chip_smoke.bound_of(3.3e9, read_only=True)
    assert b["bound_ms"] == pytest.approx(1.0)
    assert b["hbm_rate_from"].startswith("fp_sum stream")
    assert chip_smoke.bound_of(3.0e9)["bound_ms"] == pytest.approx(1.0)


# ---- on the card ------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_stream_edges_on_card():
    """Both kernels against their plain versions at their edges, max abs
    error 0 (chip_smoke.compare_stream_edges)."""
    _need_card()
    rows = chip_smoke.compare_stream_edges()
    bad = [r for r in rows if not r["ok"]]
    assert rows and not bad, bad


@pytest.mark.gpu
def test_stream_edges_on_checked_build():
    _need_card()
    from fm_radio_tpu_torch.kernels import _build

    with _build.checked_build():
        rows = chip_smoke.compare_stream_edges(seed=9)
    bad = [r for r in rows if not r["ok"]]
    assert rows and not bad, bad
