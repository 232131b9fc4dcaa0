"""The K2 probe's block-parallel recurrences (restruct:li[:stk]) on the host:
the shared-memory layout of ``csrc/k2_probe.cu`` (its host copy
``k2_probe.block_layout``), the kernels' walk of a channel in units
(``unit_rows``, a ragged last chunk included), the wrapper's refusal of an
li the kernels are not compiled for, and a model of the kernels' schedule
(the rows of each unit gathered, every block's in-block sums at once, the
carries walked block by block, each output finished from its block's
carries, the power summed by the owner of each j) held bit for bit against
the plain versions ``block_iir_plain`` and ``power_of``, each output
written once and the rows past the last block (NaN here) never read into
one.

On the card ``chip_smoke.compare_k2_edges`` holds both kernels against
the plain versions at the edge shapes on NaN-filled outputs (marked
``gpu``: they skip here).
"""

import math

import pytest
import torch

import chip_smoke
from fm_radio_tpu_torch.ops.cmath import atan2_poly, f32
from fm_radio_tpu_torch.probes import k2_probe as k2

KINDS = k2.BLOCK_KINDS


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("li", k2.LI)
def test_block_layout_fits_the_card(li, kind):
    """Every compiled li and kind fits one CTA: shared memory within the
    card's 232,448 bytes, 2 li threads (a pair of 8-output ranges a warp,
    at most 1,024), 32 rows a unit."""
    g = k2.block_layout(li, kind)
    assert g["smem"] <= k2.SMEM_BYTES
    assert g["threads"] == 2 * li <= 1024 and g["threads"] % 32 == 0
    assert (li // k2.BLOCK_R) % 2 == 0  # ranges pair up
    assert (g["nb"], g["units"]) == {"deemph": (32, 1), "peak": (16, 1),
                                     "peak:stk": (32, 2)}[kind]
    # two units of 32 skewed rows, h, hm and pm, the chains' small arrays
    ord_ = 1 if kind == "deemph" else 2
    assert g["smem"] == 4 * (64 * (li + 4) + (1 + 2 * ord_) * li + 512)


@pytest.mark.parametrize("li", [1, 32, 96, 100, 1024])
def test_block_layout_refuses_an_uncompiled_li(li):
    for kind in KINDS:
        with pytest.raises(ValueError, match="li"):
            k2.block_layout(li, kind)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nblk", [1, 3, 15, 16, 17, 31, 32, 33, 35, 64, 67])
def test_units_walk_every_block_once(kind, nblk):
    """Over the channel's units every (plane, block) is loaded exactly
    once, in block order within a plane; rows past the last block are
    None; the last chunk is ragged where nb does not divide nblk."""
    li = 128
    g = k2.block_layout(li, kind)
    units = k2.block_units(li, kind, nblk)
    planes = 1 if kind == "deemph" else 2
    seen = []
    for u in range(units):
        rows = k2.unit_rows(li, kind, nblk, u)
        assert len(rows) == k2.BLOCK_ROWS
        seen += [r for r in rows if r is not None]
        live = [r for r in rows if r is not None]
        assert live, f"unit {u} loads nothing"
    assert sorted(seen) == [(p, b) for p in range(planes)
                            for b in range(nblk)]
    assert len(seen) == len(set(seen))
    for p in range(planes):
        order = [b for (q, b) in seen if q == p]
        assert order == sorted(order)
    # the last chunk's live blocks: nblk - (chunks - 1) nb, each plane
    last = k2.unit_rows(li, kind, nblk, units - 1)
    per_plane = sum(1 for r in last if r is not None and r[0] == last[0][0])
    assert per_plane == nblk - (units // g["units"] - 1) * g["nb"]


def test_ragged_last_chunk_rows():
    """35 blocks of li = 64: the de-emphasis walks 32 + 3 blocks, the peak
    16 + 16 + 3 of each plane (lanes 3-15 and 19-31 idle in the last),
    stk 32 + 3 of re then of im."""
    assert k2.block_units(64, "deemph", 35) == 2
    assert k2.unit_rows(64, "deemph", 35, 1)[:4] == [
        (0, 32), (0, 33), (0, 34), None]
    assert k2.block_units(64, "peak", 35) == 3
    rows = k2.unit_rows(64, "peak", 35, 2)
    assert rows[:4] == [(0, 32), (0, 33), (0, 34), None]
    assert rows[16:20] == [(1, 32), (1, 33), (1, 34), None]
    assert k2.block_units(64, "peak:stk", 35) == 4
    assert k2.unit_rows(64, "peak:stk", 35, 3)[:4] == [
        (1, 32), (1, 33), (1, 34), None]


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("mode", ["restruct:32", "restruct:96:stk",
                                  "restruct:1024", "restruct:100"])
def test_wrapper_refuses_an_uncompiled_li(device, mode):
    """An li the kernels are not compiled for raises before any launch, on
    every device (the C entry refuses it too: cudaErrorInvalidValue)."""
    x = torch.zeros((2, 4096), device=device)
    with pytest.raises(ValueError, match="li one of"):
        k2.variant(mode, x)


def test_wrapper_refuses_li_not_dividing_the_block():
    x = torch.zeros((2, 2 * 64 * 3))
    with pytest.raises(ValueError, match="dividing"):
        k2.variant("restruct:128", x)
    assert k2.variant("restruct:64", x)[0].shape == (2, 64 * 3)


# ---- a model of the kernels' schedule ------------------------------------------

def _gather(planes, li, kind, nblk, u):
    """Unit u's rows [C, 32, li] (NaN past the last block) and their
    (plane, block) list."""
    rows = k2.unit_rows(li, kind, nblk, u)
    c = planes[0].shape[0]
    out = torch.full((c, k2.BLOCK_ROWS, li), math.nan)
    for r, pb in enumerate(rows):
        if pb is not None:
            p, b = pb
            out[:, r] = planes[p][:, b * li:(b + 1) * li]
    return out, rows


def _sums(xs, h):
    """Every row's zero-state in-block sums at once: each output from i = 0
    up (the kernels' ranges keep this order)."""
    li = h.shape[0]
    acc = torch.zeros_like(xs)
    for i in range(li):
        acc[..., i:] = acc[..., i:] + h[: li - i] * xs[..., i:i + 1]
    return acc


def _carried(t, cx, cy, hm, pm):
    """t + the carries in the plain order (x1 hm0 [, x2 hm1], y1 pm0 [, y2
    pm1])."""
    y = t
    for q in range(hm.shape[0]):
        y = y + cx[q] * hm[q]
    for q in range(pm.shape[0]):
        y = y + cy[q] * pm[q]
    return y


def model_deemph(x, li):
    """The de-emphasis kernel's walk on x [C, n]: the output and how often
    each output was written."""
    h, hm, pm = k2.block_mats(li)["de"]
    c, n = x.shape
    nblk = n // li
    y = torch.full_like(x, math.nan)
    writes = torch.zeros_like(x, dtype=torch.int32)
    cx = [torch.zeros((c, 1))]
    cy = [torch.zeros((c, 1))]
    for u in range(k2.block_units(li, "deemph", nblk)):
        xs, rows = _gather((x,), li, "deemph", nblk, u)
        t = _sums(xs, h)
        carries = {}
        for r, pb in enumerate(rows):  # the walker, block by block
            if pb is None:
                break
            carries[r] = (cx, cy)
            last = _carried(t[:, r, li - 1:], cx, cy, hm[:, li - 1:],
                            pm[:, li - 1:])
            cx, cy = [xs[:, r, li - 1:]], [last]
        for r, (kx, ky) in carries.items():  # every thread adds its own
            b = rows[r][1]
            y[:, b * li:(b + 1) * li] = _carried(t[:, r], kx, ky, hm, pm)
            writes[:, b * li:(b + 1) * li] += 1
    return y, writes


def model_peak(re, im, li, kind):
    """The peak kernel's walk (kind "peak" or "peak:stk"): theta, the
    power and the write counts of theta."""
    h, hm, pm = k2.block_mats(li)["pk"]
    c, n = re.shape
    nblk = n // li
    g = k2.block_layout(li, kind)
    theta = torch.full_like(re, math.nan)
    writes = torch.zeros_like(re, dtype=torch.int32)
    zero = torch.zeros((c, 1))
    state = {p: ([zero, zero], [zero, zero]) for p in (0, 1)}
    pw = torch.zeros((c, li), dtype=torch.float64)
    units = k2.block_units(li, kind, nblk)
    for k in range(units // g["units"]):
        fin = {}  # (plane, block) -> finished outputs [C, li]
        for q in range(g["units"]):
            xs, rows = _gather((re, im), li, kind, nblk, k * g["units"] + q)
            t = _sums(xs, h)
            walked = {}
            for r, pb in enumerate(rows):
                if pb is not None:
                    walked[pb] = (t[:, r], xs[:, r])
            for p in (0, 1):  # the walkers: one a plane, blocks in order
                for b in sorted(b for (pp, b) in walked if pp == p):
                    tr, xr = walked[(p, b)]
                    cx, cy = state[p]
                    fin[(p, b)] = _carried(tr, cx, cy, hm, pm)
                    ya = _carried(tr[:, li - 1:], cx, cy, hm[:, li - 1:],
                                  pm[:, li - 1:])
                    yb = _carried(tr[:, li - 2:li - 1], cx, cy,
                                  hm[:, li - 2:li - 1], pm[:, li - 2:li - 1])
                    state[p] = ([xr[:, li - 1:], xr[:, li - 2:li - 1]],
                                [ya, yb])
        blocks = sorted({b for (_, b) in fin})
        for b in blocks:
            yr, yi = fin[(0, b)], fin[(1, b)]
            theta[:, b * li:(b + 1) * li] = (atan2_poly(yi, yr)
                                             * f32(1.0 / (2.0 * math.pi)))
            writes[:, b * li:(b + 1) * li] += 1
        for b in blocks:  # the owner of each j, the chunk's blocks in order
            yr, yi = fin[(0, b)], fin[(1, b)]
            pw = pw + (yr * yr + yi * yi).double()
    tot = torch.zeros((c,), dtype=torch.float64)
    for j in range(li):
        tot = tot + pw[:, j]
    return theta, tot.float(), writes


SHAPES = [(3, 1), (3, 35), (1, 17), (2, 64)]  # (C, blocks)


@pytest.mark.parametrize("c,nblk", SHAPES)
@pytest.mark.parametrize("li", k2.LI)
def test_deemph_model_equals_plain(li, c, nblk):
    x = k2.make_input(c, 2 * li * nblk, "cpu", seed=li + nblk)[:, ::2]
    x = x.contiguous()
    y, writes = model_deemph(x, li)
    assert (writes == 1).all()
    ref = k2.block_iir_plain(x, *k2.block_mats(li)["de"])
    assert torch.equal(y, ref)


@pytest.mark.parametrize("kind", ["peak", "peak:stk"])
@pytest.mark.parametrize("c,nblk", SHAPES)
@pytest.mark.parametrize("li", [64, 512])
def test_peak_model_equals_plain(li, c, nblk, kind):
    x = k2.make_input(c, 2 * li * nblk, "cpu", seed=li + nblk)
    re, im = x[:, ::2].contiguous(), x[:, 1::2].contiguous()
    theta, power, writes = model_peak(re, im, li, kind)
    assert (writes == 1).all()
    mats = k2.block_mats(li)["pk"]
    pr, pi = k2.block_iir_plain(re, *mats), k2.block_iir_plain(im, *mats)
    ref = atan2_poly(pi, pr) * f32(1.0 / (2.0 * math.pi))
    assert torch.equal(theta, ref)
    assert torch.equal(power, k2.power_of(pr, pi, li))


def test_restruct_floor_counts():
    """The computed FMUL+FADD floor of restruct:li (chip_smoke): li + 1 an
    output for each chain's in-block sum, 4 for the de-emphasis carries
    and 8 for each peak chain's, atan2 + 3 for theta and the power; ~0.44
    ms at li = 128 on 132 SMs at 1.98 GHz."""
    f = chip_smoke.restruct_floor(1024, 32768, 128, sms=132, hz=1.98e9)
    assert f["instructions_an_output"] == {
        "deemph": 129 + 4, "peak": 2 * (129 + 8) + chip_smoke.ATAN2_FLOPS + 3}
    assert f["fmul_fadd_floor_ms"] == pytest.approx(
        f["deemph_ms"] + f["peak_ms"])
    assert 0.40 < f["fmul_fadd_floor_ms"] < 0.48
    assert 0.12 < f["deemph_ms"] < 0.14 and 0.29 < f["peak_ms"] < 0.33
    big = chip_smoke.restruct_floor(1024, 32768, 512, sms=132, hz=1.98e9)
    assert 1.5 < big["fmul_fadd_floor_ms"] < 1.7


# ---- on the card ------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_k2_edges_on_card():
    """Both block kernels against the plain versions at their edge shapes,
    on NaN-filled outputs, max abs error 0 (chip_smoke.compare_k2_edges)."""
    _need_card()
    rows = chip_smoke.compare_k2_edges()
    bad = [r for r in rows if not r["ok"]]
    assert rows and not bad, bad


@pytest.mark.gpu
def test_k2_edges_on_checked_build():
    _need_card()
    from fm_radio_tpu_torch.kernels import _build

    with _build.checked_build():
        rows = chip_smoke.compare_k2_edges(seed=4)
    bad = [r for r in rows if not r["ok"]]
    assert rows and not bad, bad
