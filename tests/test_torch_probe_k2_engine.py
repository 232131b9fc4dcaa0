"""The K2 probe's engine kernels (ds2, hilb) on the host: numpy models of
``csrc/k2_probe.cu``'s tiles bit for bit against the plain versions
``k2_probe.ds2_plain`` and ``hilb_plain``, the refused shapes, and the
computed issue floors.

The ds2 model walks ``k2_ds2_kernel``: one CTA per (tile of MID_TILE
outputs, channel), the tile's window of fm_demod staged with the zero ds
x2 tail before the block, each run of DS2_RUN outputs summed tap by tap
from the oldest sample and stored to re, im and theta.  The hilb model
runs that ds x2 (the route's ``k12_mid_ds2_kernel`` sums the same way),
then walks ``k2_hilb_kernel``: the tile's window of fm_out with the zero
Hilbert halo, each run of HILB_RUN outputs summed tap by tap into im and
theta, and re from ``re_src`` (the host copy of ``k2_re_src``): from the
staged window where the source ends inside the CTA's tile, else from
fm_out in device memory, as the kernel decides.  Every output is written
once (NaN first).  The t_blk cover tiles shorter than the delay (16, 48),
tiles dividing the CTA's (512, 1,024, 2,048), tiles that straddle it (48,
768) and longer ones (4,096), at C = 1 and 5 and at B4 that are not a
multiple of 2 MID_TILE (a partial last CTA tile).

On the card ``chip_smoke.compare_k2_edges`` holds both kernels against the
plain versions at these shapes on NaN-filled outputs, on the default and
the checked build (``tests/test_torch_probe_k2_blocked.py``'s ``gpu``
tests; they skip here).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from fm_radio_tpu_torch.probes import k2_probe as k2

F = np.float32
CO = k2.coeffs()
W2 = CO.taps_fm_out.flip(0).numpy()
WH = CO.taps_hilbert.flip(0).numpy()
NN2, NH = W2.size, WH.size
H2, HH, D = NN2 - 2, NH - 1, (NH - 1) // 2
TILE = k2.MID_TILE


def _tiles(n8: int):
    """(i0, nt) of each CTA's tile of a channel's n8 outputs."""
    for i0 in range(0, n8, TILE):
        yield i0, min(TILE, n8 - i0)


def ds2_model(x: np.ndarray):
    """``k2_ds2_kernel``: (re, im, theta) [C, n4/2] and the write counts."""
    c, n4 = x.shape
    n8 = n4 // 2
    outs = [np.full((c, n8), np.nan, F) for _ in range(3)]
    writes = np.zeros((c, n8), np.int32)
    for i0, nt in _tiles(n8):
        j = 2 * i0 - H2 + np.arange(2 * nt + H2)  # the staged window
        s_u = np.zeros((c, j.size), F)
        s_u[:, j >= 0] = x[:, j[j >= 0]]
        assert nt % k2.DS2_RUN == 0  # whole runs: two float4 stores a plane
        for a0 in range(0, nt, k2.DS2_RUN):
            a = a0 + np.arange(k2.DS2_RUN)
            acc = np.zeros((c, a.size), F)
            for k in range(NN2):
                acc = acc + W2[k] * s_u[:, 2 * a + k]
            for o in outs:
                o[:, i0 + a] = acc
            writes[:, i0 + a] += 1
    return outs, writes


def hilb_launch_model(fm_out: np.ndarray, t_blk: int):
    """``k2_hilb_kernel`` on fm_out [C, n8]: (re, im, theta), the write
    counts and the number of runs whose re came from device memory."""
    c, n8 = fm_out.shape
    lt = t_blk // 2
    re, im, th = (np.full((c, n8), np.nan, F) for _ in range(3))
    writes = np.zeros((c, n8), np.int32)
    from_memory = 0
    for i0, nt in _tiles(n8):
        i = i0 - HH + np.arange(nt + HH)  # the staged window
        s_f = np.zeros((c, i.size), F)
        s_f[:, i >= 0] = fm_out[:, i[i >= 0]]
        assert nt % k2.HILB_RUN == 0
        for a0 in range(0, nt, k2.HILB_RUN):
            a = a0 + np.arange(k2.HILB_RUN)
            acc = np.zeros((c, a.size), F)
            for k in range(NH):
                acc = acc + WH[k] * s_f[:, a + k]
            src = k2.re_src(i0 + a0, lt)
            assert src >= i0 - HH
            if src + k2.HILB_RUN <= i0 + nt:
                v = s_f[:, src - (i0 - HH) + np.arange(k2.HILB_RUN)]
            else:
                v = fm_out[:, src + np.arange(k2.HILB_RUN)]
                from_memory += 1
            im[:, i0 + a], th[:, i0 + a], re[:, i0 + a] = acc, acc, v
            writes[:, i0 + a] += 1
    return (re, im, th), writes, from_memory


def _hold(outs, ref, writes):
    assert (writes == 1).all()
    for m, p in zip(outs, ref):
        np.testing.assert_array_equal(m, p.numpy())


@pytest.mark.parametrize("c", [1, 5])
@pytest.mark.parametrize("b4", chip_smoke.K2_ENGINE_DS2_B4)
def test_ds2_model_equals_plain(b4, c):
    x = k2.make_input(c, b4, "cpu", seed=b4 + c)
    outs, writes = ds2_model(x.numpy())
    _hold(outs, k2.ds2_plain(x, CO), writes)


@pytest.mark.parametrize("c", [1, 5])
@pytest.mark.parametrize("t_blk", chip_smoke.K2_ENGINE_TBLK)
def test_hilb_model_equals_plain(t_blk, c):
    """At each of the t_blk's B4 (the fewest samples, a partial CTA tile
    where t_blk <= 1,024, several CTAs): re, im and theta bit for bit
    against hilb_plain; re's rotated part comes from device memory only
    where a tile of t_blk/2 straddles the CTA's tile."""
    b4s = chip_smoke.k2_engine_b4(t_blk)
    if t_blk <= TILE:
        assert any((b4 // 2) % TILE for b4 in b4s)
    used = []
    for b4 in b4s:
        x = k2.make_input(c, b4, "cpu", seed=b4 + t_blk + c)
        fm_out, writes = ds2_model(x.numpy())
        assert (writes == 1).all()
        outs, writes, from_memory = hilb_launch_model(fm_out[0], t_blk)
        _hold(outs, k2.hilb_plain(x, t_blk, CO), writes)
        used.append(from_memory)
    # at the most CTAs: tiles of 24 and 384 outputs straddle the CTA's
    # 1,024, tiles of 2,048 span two; 8 (rotated by 32 % 8 = 0), 256, 512
    # and 1,024 end inside it
    assert (used[-1] > 0) == (t_blk in (48, 768, 4096))


@pytest.mark.parametrize("t_blk", [16, 1024, 4096])
def test_hilb_launch_model_equals_plain(t_blk):
    """The Hilbert launch alone on a given fm_out (vs_library's case)."""
    fm = k2.make_input(5, 4096, "cpu", seed=t_blk)
    outs, writes, _ = hilb_launch_model(fm.numpy(), t_blk)
    _hold(outs, k2.hilb_launch_plain(fm, t_blk, CO), writes)


def test_re_src_rotates_each_tile():
    """re_src is torch.roll by the delay within each tile of lt outputs
    (d % lt where lt < d) and never reaches before i - d."""
    for lt in (8, 16, 24, 40, 256, 384, 2048):
        n = 3 * lt
        rolled = np.roll(np.arange(n).reshape(3, lt), D, axis=1).ravel()
        for i in range(0, n, k2.HILB_RUN):
            src = k2.re_src(i, lt)
            assert list(range(src, src + k2.HILB_RUN)) == list(
                rolled[i:i + k2.HILB_RUN])
            assert src >= i - D


BAD = [("ds2", 4104, 1024), ("ds2", 8, 1024), ("hilb", 4104, 1024),
       ("hilb", 4096, 24), ("hilb", 4096, 3072), ("hilb", 4096, 0),
       ("hilb", 96, 16), ("hilb", 4096, 8192)]


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("mode,b4,t_blk", BAD)
def test_wrapper_refuses_what_the_kernels_refuse(device, mode, b4, t_blk):
    """B4 % 16, t_blk % 16, t_blk not dividing B4, B4/2 < 64: ValueError
    before any launch on every device (fmt_k2_engine refuses them too)."""
    x = torch.zeros((2, b4), device=device)
    with pytest.raises(ValueError, match="k2_probe: "):
        k2.variant(mode, x, t_blk)
    if mode == "hilb":
        with pytest.raises(ValueError, match="k2_probe: "):
            k2.hilb_launch(torch.zeros((2, b4 // 2), device=device), t_blk)


def test_wrapper_refuses_other_filter_orders():
    """The tiled kernels are built for the orders 64 (ds x2) and 65
    (Hilbert): hilb refuses another of either, ds2 another ds x2 order."""
    co = k2.coeffs()
    co.taps_hilbert = co.taps_hilbert[:63]
    x = k2.make_input(2, 4096, "cpu")
    with pytest.raises(ValueError, match="filter orders"):
        k2.variant("hilb", x, 1024, co)
    assert k2.variant("ds2", x, 1024, co)[0].shape == (2, 2048)
    co.taps_fm_out = co.taps_fm_out[:62]
    with pytest.raises(ValueError, match="filter orders"):
        k2.variant("ds2", x, 1024, co)
    assert k2.variant("stream", x, 1024, co)[0].shape == (2, 2048)


def test_engine_counters_are_the_kernels_line_names():
    """Each engine variant's kernel has its own counter, named as on
    chip_smoke.py's kernels line, each representative row its variant."""
    names = {n for n, _, _ in chip_smoke.ENGINE_KERNELS if n.startswith("k2")}
    assert set(k2.counts()) == names
    for mode, name in k2.ENGINE.items():
        assert chip_smoke.PROBE_REP[name] == mode
    rows = k2.run(2, 4096, 1, torch.device("cpu"), modes=tuple(k2.ENGINE),
                  emit=lambda r: None)
    assert [r["kernel"] for r in rows] == list(k2.ENGINE.values())
    assert all(r["max_abs_err"] == 0.0 for r in rows)


def test_engine_floor_counts():
    """ds2: 128 FMUL+FADD an output (0.128 ms at C = 1,024 x B4 = 65,536
    on 132 SMs at 1.98 GHz); hilb: the ds x2 launch's and the Hilbert
    launch's 130 (0.130), 0.259 together."""
    ds2 = chip_smoke.engine_floor("ds2", 1024, 65536, sms=132, hz=1.98e9)
    hilb = chip_smoke.engine_floor("hilb", 1024, 65536, sms=132, hz=1.98e9)
    assert ds2["instructions_an_output"] == 128
    assert hilb["instructions_an_output"] == 128 + 130
    assert ds2["fmul_fadd_floor_ms"] == pytest.approx(0.1284, abs=1e-4)
    assert hilb["launch_floors_ms"]["hilbert"] == pytest.approx(0.1304,
                                                               abs=1e-4)
    assert hilb["fmul_fadd_floor_ms"] == pytest.approx(0.2588, abs=1e-4)
