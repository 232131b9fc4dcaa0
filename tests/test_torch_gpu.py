"""The port's CUDA kernels on the card.

This file imports neither jax nor the JAX package, so it also runs on a
machine without them; tests/conftest.py imports jax, hence:

    python -m pytest tests/test_torch_gpu.py -q -m gpu --noconftest

Where there is no CUDA device every test skips.
"""

import pytest
import torch


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_cuda_kernels_match_plain_on_card():
    """Each CUDA kernel against its plain version on the card, two blocks
    with carried state, at a small shape (chip_smoke.py runs the same at
    C=256, B=131072)."""
    _need_card()
    import chip_smoke

    rows = chip_smoke.compare_kernels(channels=8, block=16384, blocks=2)
    # a kernel off its plain version has its case saved under chiprun_out/
    # (python -m fm_radio_tpu_torch.probes.replay replays it)
    assert all(r["ok"] for r in rows) and not chip_smoke.DUMPS, (
        rows, chip_smoke.DUMPS)


@pytest.mark.gpu
def test_cli_selftest_on_card(capsys):
    """The user entry point runs the kernels and passes its gates (at its
    default 2 s: the station name needs about that long to arrive)."""
    _need_card()
    from fm_radio_tpu_torch.apps.cli import main

    assert main(["selftest"]) == 0, capsys.readouterr().out


@pytest.mark.gpu
def test_wideband_kernels_match_plain_on_card():
    """The channelizer and K12 on phase-split planes against their plain
    versions on the card, on the arguments wideband_demod_block recorded
    from captures loud enough to cross the int8 bridge, two blocks with
    carried state (chip_smoke.py runs the same at K12's C=256 and the
    channelizer's W=4, B=131072); K12 also on full-range phase planes; the
    phase-split K12 kernel bit for bit against the flat K12 kernel; and no
    compared int8 planes constant."""
    _need_card()
    import chip_smoke

    rows, flat_err = chip_smoke.compare_wideband(block=16384, blocks=2,
                                                 k12_channels=64,
                                                 chan_captures=2)
    assert all(r["ok"] for r in rows) and flat_err == 0.0, (rows, flat_err)
    assert all(v["centre_share"] < 1.0
               for r in rows for v in r["planes"].values()), rows


@pytest.mark.gpu
def test_cli_stations_on_card(tmp_path, capsys):
    """``stations`` on a two-station capture (M=8) and ``selftest
    --stations 2`` run the kernels and pass their per-station gates."""
    _need_card()
    import json

    from fm_radio_tpu_torch.apps.cli import main, wideband_capture

    pcm = tmp_path / "wide.pcm"
    wideband_capture(2, 8, 32 * 65536).tofile(pcm)
    assert main(["stations", "-i", str(pcm), "-o", str(tmp_path / "out"),
                 "-m", "8", "--select", "1,2"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert [s["pi_code"] for s in summary] == ["1234", "1235"], summary
    assert [s["service_name"] for s in summary] == ["ST 01   ", "ST 02   "]
    assert main(["selftest", "--stations", "2"]) == 0, capsys.readouterr().out


@pytest.mark.gpu
def test_split_kernels_match_plain_on_card():
    """K1 on each of its six forms and K2 (de-emphasis off and on) against
    their plain versions on the card, on the arguments demod_block
    recorded, two blocks with carried state (chip_smoke.py runs the same
    at C=256, B=131072); the split int8 path (k12_fusion="off") bit for
    bit against the fused K12; and the float32 wideband bridge."""
    _need_card()
    import chip_smoke

    rows, k12_diff = chip_smoke.compare_split(channels=8, block=16384,
                                              blocks=2)
    assert all(r["ok"] for r in rows) and k12_diff == 0.0, (rows, k12_diff)
    assert not any(v["constant"] for v in rows[0]["inputs"].values())
    frows = chip_smoke.compare_wideband_f32(block=16384, blocks=2,
                                            n_captures=1)
    assert all(r["ok"] for r in frows), frows


@pytest.mark.gpu
def test_cli_demod_f32w_on_card(tmp_path, capsys):
    """``demod --ingest f32w`` on the selftest station runs K1 on packed
    words and K2 on the card (launches counted) and decodes its PI."""
    _need_card()
    import json

    from fm_radio_tpu_torch.apps.cli import main, selftest_u8
    from fm_radio_tpu_torch.kernels import frontend, midend

    pcm = tmp_path / "station.pcm"
    selftest_u8(1.0, 65536).tofile(pcm)
    frontend.launches = midend.launches = 0
    assert main(["demod", "-i", str(pcm), "-o", str(tmp_path / "out.wav"),
                 "--ingest", "f32w"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["pi_code"] == "1234", summary
    assert frontend.launches == midend.launches > 0


@pytest.mark.gpu
def test_chain_and_chunked_pll_match_plain_on_card():
    """The megakernel (packed words, float32 planes with de-emphasis off
    and on, complex64) with BPSK without a gain after it, and the chunked
    PLL (after K12, at 8 channels and at an odd 5, G = 8) against their
    plain versions on the card, on the arguments demod_block recorded, two
    blocks with carried state (chip_smoke.py runs the same at C = 256,
    B = 131,072 and B = 1,048,576); no input constant."""
    _need_card()
    import chip_smoke

    rows = chip_smoke.compare_chain(channels=8, block=16384, blocks=2)
    rows += chip_smoke.compare_pll_chunked(channels=8, block=524288,
                                           chunks=8, blocks=2,
                                           odd_channels=5)
    assert all(r["ok"] for r in rows), rows
    assert not any(v["constant"] for r in rows
                   for v in r.get("inputs", {}).values()), rows


@pytest.mark.gpu
def test_chain_equals_split_path_on_card():
    """On the card, demod_block through the megakernel and through the
    f32w split path on the same packed words: audio and every state leaf
    before the RDS AGC bit for bit, the RDS AGC within its summation-order
    tolerance (chip_smoke.py's chain cell at C = 2048)."""
    _need_card()
    import chip_smoke

    res = chip_smoke.chain_path(channels=16, block=16384, blocks=2,
                                vs_split_blocks=2)
    vs = res["vs_split_f32w"]
    assert vs["audio"] == 0.0 and vs["state_before_rds_agc"] == 0.0, vs
    assert vs["agc_rds_rel"] <= chip_smoke.POWER_RTOL, vs
    assert all(r["ok"] for r in res["compare"]), res["compare"]


@pytest.mark.gpu
def test_channelizer_mat_kernels_match_plain_on_card():
    """The channelizer's int8-matrix kernel (splits=1) equals its plain
    version bit for bit, and the bf16-matrix kernel (splits=2) is within
    chip_smoke.py's stated tolerances, on the arguments
    wideband_demod_block recorded from loud captures, two blocks with
    carried state (M = 32 words -> i8ps and -> f32, M = 16 -> i8;
    chip_smoke.py runs the same at W = 4, B = 131,072); no compared int8
    planes constant."""
    _need_card()
    import chip_smoke

    rows = chip_smoke.compare_channelizer_mat(block=16384, blocks=2,
                                              n_captures=2)
    assert all(r["ok"] for r in rows), rows
    assert rows[0]["max_abs_err"] == 0.0, rows[0]
    assert all(v["centre_share"] < 1.0
               for r in rows for v in r["planes"].values()), rows


@pytest.mark.gpu
def test_wgmma_channelizer_edges_on_card():
    """The matrix kernel (wgmma, operator stages by bulk copy) in both
    modes against its plain version at the edge shapes (T = 16,384, one
    tile of 128 columns, on W = 1 and 3 captures; all three output forms):
    int8 bit for bit, bf16 within chip_smoke.py's tolerances; its SASS
    holds the float (HGMMA) and integer (IGMMA) warpgroup MMA and bulk
    copies, and no mma.sync (IMMA)."""
    _need_card()
    import chip_smoke

    rows = chip_smoke.compare_wgmma_edges()
    assert len(rows) == 4 and all(r["ok"] for r in rows), rows
    assert all(r["max_abs_err"] == 0.0 for r in rows
               if r["name"].startswith("channelizer_i8mat")), rows
    sass = chip_smoke.sass_counts()
    if "error" not in sass:
        assert sass["HGMMA"] > 0 and sass["IGMMA"] > 0, sass
        assert sass["IMMA"] == 0, sass
        assert sass["UTMALDG"] + sass["UBLKCP"] > 0, sass


@pytest.mark.gpu
def test_fused_midend_edges_on_card():
    """K12 (flat and phase-split) and K2 on the fused route equal their
    plain versions (max abs error 0) at C = 40 and B = 512, 8,192 and
    8,320 (a partial tile, one whole tile, a whole and a partial one), two
    blocks with carried state, K2 in its four formats (float32 or int16
    fm_demod, float32 or int16 outputs), every K2 call counted as a fused
    launch; the C entry's route equals its host copy."""
    _need_card()
    import chip_smoke

    res = chip_smoke.compare_mid_edges()
    assert len(res["rows"]) == 2 + 4, res
    assert all(r["ok"] and r["max_abs_err"] == 0.0 for r in res["rows"]), res
    assert not res["route_mismatch"] and not res["not_fused"], res
    assert not chip_smoke.DUMPS, chip_smoke.DUMPS


@pytest.mark.gpu
def test_fused_midend_edges_on_checked_build():
    """The same edge shapes and formats on the bounds-checked build: every
    global index of the fused kernel, the peak IIR's recurrence and the
    theta pass is checked (a trap fails the test)."""
    _need_card()
    import chip_smoke
    from fm_radio_tpu_torch.kernels import _build

    with _build.checked_build():
        res = chip_smoke.compare_mid_edges()
    assert all(r["ok"] and r["max_abs_err"] == 0.0 for r in res["rows"]), res
    assert not res["route_mismatch"] and not res["not_fused"], res


@pytest.mark.gpu
def test_pll_chunked_edges_on_card():
    """The redesigned chunked PLL equals its plain version (max abs error
    0) at C = 5 and 40, G = 2, 4 and 8, W = 0, 7 and 4,096 with chunk
    lengths a multiple of its 16-step batch and not (windows off the batch
    grid, flat arrays whose length is not a multiple of it), two blocks
    with carried state each."""
    _need_card()
    import chip_smoke

    rows = chip_smoke.compare_pll_chunked_edges()
    assert len(rows) == 2 * 3 * 3 * 2, rows
    assert all(r["ok"] and r["max_abs_err"] == 0.0 for r in rows), rows
    assert not chip_smoke.DUMPS, chip_smoke.DUMPS


@pytest.mark.gpu
def test_pll_chunked_edges_on_checked_build():
    """The same edge shapes on the bounds-checked build: every load and
    store of the chunked lanes is checked (a trap fails the test)."""
    _need_card()
    import chip_smoke
    from fm_radio_tpu_torch.kernels import _build

    with _build.checked_build():
        rows = chip_smoke.compare_pll_chunked_edges()
    assert all(r["ok"] and r["max_abs_err"] == 0.0 for r in rows), rows


@pytest.mark.gpu
def test_pll_extract_edges_on_card():
    """The redesigned sequential PLL and extract equal their plain versions
    (max abs error 0) at their edge shapes: the PLL at C = 40 and 5 and N
    = 16, 32, 48 and 16,384 on float32 and int16 theta; extract at C = 40
    and N = 1,024 and 2,048 on its three forms, on the receiver's filters
    (the blocked kernel) and on other orders (the tiled kernel), two
    blocks with carried state each; the C entry's extract route equals
    its host copy."""
    _need_card()
    import chip_smoke

    rows = chip_smoke.compare_pll_edges()
    res = chip_smoke.compare_extract_edges()
    rows += res["rows"]
    assert len(rows) == 16 + 12, rows
    assert all(r["ok"] and r["max_abs_err"] == 0.0 for r in rows), rows
    assert not res["route_mismatch"] and not chip_smoke.DUMPS, res


@pytest.mark.gpu
def test_pll_extract_edges_on_checked_build():
    """The same edge shapes on the bounds-checked build: every global index
    of the PLL and extract kernels is checked (a trap fails the test)."""
    _need_card()
    import chip_smoke
    from fm_radio_tpu_torch.kernels import _build

    with _build.checked_build():
        rows = chip_smoke.compare_pll_edges(steps=(16, 32, 48))
        rows += chip_smoke.compare_extract_edges()["rows"]
    assert all(r["ok"] and r["max_abs_err"] == 0.0 for r in rows), rows


@pytest.mark.gpu
def test_bpsk_edges_on_card():
    """BPSK (one warp of a few channels a block, the phase error under a
    branch) equals its plain version bit for bit at C = 40 and 5, N = 16,
    32, 48 and 2,048, with a gain and without, on random input and on
    zeros, two blocks with carried state each; and on the bounds-checked
    build at the short blocks (a trap fails the test)."""
    _need_card()
    import chip_smoke
    from fm_radio_tpu_torch.kernels import _build

    rows = chip_smoke.compare_bpsk_edges()
    with _build.checked_build():
        rows += chip_smoke.compare_bpsk_edges(steps=(16, 32, 48))
    assert len(rows) == 32 + 24, rows
    assert all(r["ok"] and r["max_abs_err"] == 0.0
               and not r["valid_mismatch"] for r in rows), rows
    assert not chip_smoke.DUMPS, chip_smoke.DUMPS


@pytest.mark.gpu
def test_ds4_edges_on_card():
    """The redesigned ds x4 kernels equal their plain versions bit for bit
    at their edge shapes (C = 1, 5, 40; B = 8,192, 8,320, 16,384, K1 also
    8,324), two blocks with carried state each: K12 and K12 phase-split
    whole, K1 on every load form (float32 planes, off the u8 grid, packed
    words, complex64, int8 planes) with float and int8 taps and float32 and
    int16 stores, the int8-direct K1; and their SASS has no FFMA in the
    float K1 and no spills."""
    _need_card()
    import chip_smoke

    rows = chip_smoke.compare_ds4_edges()
    assert len(rows) == 4 * 22 + 20, len(rows)
    assert all(r["ok"] and r["max_abs_err"] == 0.0 for r in rows), [
        r for r in rows if not r["ok"]]
    assert not chip_smoke.DUMPS, chip_smoke.DUMPS
    assert not chip_smoke.ds4_sass_faults(chip_smoke.ds4_sass())


@pytest.mark.gpu
def test_ds4_edges_on_checked_build():
    """The same edge shapes on the bounds-checked build: every global index
    of the ds x4 kernels is checked (a trap fails the test)."""
    _need_card()
    import chip_smoke
    from fm_radio_tpu_torch.kernels import _build

    with _build.checked_build():
        rows = chip_smoke.compare_ds4_edges()
    assert all(r["ok"] and r["max_abs_err"] == 0.0 for r in rows), [
        r for r in rows if not r["ok"]]


@pytest.mark.gpu
def test_chan_edges_on_card():
    """The redesigned exact channelizer equals channelize_plain bit for bit
    at every M it is instantiated for (2 ... 128), K = 1 and 17, T = 4,096,
    12,288 and 1,572,864 (more tiles than the grid holds CTAs, so each CTA
    walks several), in every out form (phase-split at M = 32), on packed
    words and on float planes, two blocks with carried state each."""
    _need_card()
    import chip_smoke

    rows = chip_smoke.compare_chan_edges()
    assert len(rows) == 7 * 2 * 3 * 2 * 2 + 2 * 3 * 2, len(rows)
    assert all(r["ok"] and r["max_abs_err"] == 0.0 for r in rows), [
        r for r in rows if not r["ok"]]
    assert not chip_smoke.DUMPS, chip_smoke.DUMPS


@pytest.mark.gpu
def test_chan_edges_on_checked_build():
    """The same cases on the bounds-checked build: every global index of
    the channelizer's loads and stores is checked (a trap fails the
    test)."""
    _need_card()
    import chip_smoke
    from fm_radio_tpu_torch.kernels import _build

    with _build.checked_build():
        rows = chip_smoke.compare_chan_edges(seed=1)
    assert all(r["ok"] and r["max_abs_err"] == 0.0 for r in rows), [
        r for r in rows if not r["ok"]]


@pytest.mark.gpu
@pytest.mark.parametrize("checked", [False, True], ids=["default",
                                                         "checked"])
def test_chain_small_on_poisoned_memory(checked):
    """The redesigned megakernel equals its plain version and the f32w
    split path bit for bit at C = 8 and 40 (B = 16,384, two blocks), at the
    receiver's filter orders (its blocked stages) and at other orders (one
    output a thread), on poisoned memory, on the default and the
    bounds-checked build."""
    _need_card()
    import contextlib

    import chip_smoke
    from fm_radio_tpu_torch.kernels import _build

    ctx = _build.checked_build() if checked else contextlib.nullcontext()
    rows = []
    with ctx:
        for c in (8, 40):
            for orders in (None, chip_smoke.CHAIN_OTHER_ORDERS):
                chip_smoke.poison_free_memory("cuda")
                rows.append(chip_smoke.compare_chain_small(
                    c, c, 16384, orders=orders))
    assert all(r["ok"] and r["max_abs_err"] == 0.0
               and r["vs_split_f32w"] == 0.0 for r in rows), rows


@pytest.mark.gpu
def test_k12_small_repeats_on_poisoned_memory():
    """K12, the PLL, extract, BPSK and the megakernel against their plain
    versions at the shape where K12 once disagreed (C = 8, B = 16,384), and
    the int8-matrix channelizer at W = 2, T = 32,768, on three fresh seeds,
    the
    allocator's free memory filled with 0xFF bytes before each: a kernel
    that read an output or scratch element it never wrote would see NaN
    there."""
    _need_card()
    import chip_smoke

    rows = chip_smoke.k12_repeats(repeats=3)
    assert all(k["ok"] for r in rows for k in r["kernels"]), rows


@pytest.mark.gpu
def test_channelizer_mat_kernels_other_shapes_on_card():
    """Both matrix modes against their plain versions at the other channel
    counts the TPU gate admits (M = 8, 64, 128; K = 16, and K = 17 at M =
    128: 17 column shifts), on random packed words (every u8 value), W =
    2, two blocks with carried state, the float32 and int8 outputs.  The
    int8 matrices are exact.  The bf16 matrices' float32 sums round once
    per k-step of the tensor cores' accumulator, 8 per column shift n_c,
    so their error grows with the depth: the float32 output within
    2e-6 * n_c of its rms (chip_smoke.py's 1e-5 at the cell's n_c = 5;
    measured 1.7e-5 at n_c = 16), the int8 output within 1 LSB on at most
    1e-3 of the samples; the state exact."""
    _need_card()
    import numpy as np

    import chip_smoke
    from fm_radio_tpu_torch.kernels import channelizer as kch
    from fm_radio_tpu_torch.parallel.channelizer import make_channelizer_taps

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(5)
    for m, k in ((8, 16), (64, 16), (128, 16), (128, 17)):
        n_c = kch.tail_columns(k, m) + 1
        tab = kch.make_tables(make_channelizer_taps(m, k), m, dev)
        t = 8192 * m
        words = torch.from_numpy(
            rng.integers(0, 256, (2, 2 * t)).astype(np.float32) * 256.0
            + rng.integers(0, 256, (2, 2 * t)).astype(np.float32)).to(dev)
        for splits in (1, 2):
            name = chip_smoke.CHANNELIZER_BY_SPLITS[splits]
            for out in ("f32", "i8"):
                st = (torch.zeros((2, (k - 1) * m), device=dev),) * 2
                for blk in range(2):
                    xb = words[:, blk * t : (blk + 1) * t].contiguous()
                    args = (tab, st, xb, m, out, splits)
                    kout = kch.channelize(*args)
                    e = chip_smoke.stage_errors(name, kout,
                                                kch.channelize_plain(*args))
                    where = (m, k, out, blk, e)
                    assert e["state_err"] == 0.0, where
                    if splits == 1:
                        assert e["err"] == 0.0, where
                    elif out == "f32":
                        assert e["f32_rel_rms"] <= 2e-6 * n_c, where
                    else:
                        assert e["err"] <= 1.0, where
                        assert e["i8_share"] <= 1e-3, where
                    st = kout[0]


@pytest.mark.gpu
def test_i16_kernels_match_plain_on_card():
    """The int16 format's kernels against their plain versions on the card,
    bit for bit, on the arguments demod_block(interstage_i16=True) recorded
    (chip_smoke.py runs the same at C = 256, B = 131,072): K1 on its six
    forms, K2 (de-emphasis off and on), the PLL and extract on their int16
    and dequantised combinations at C = 8, and the C = 5 route, where the
    PLL dequantises and extract takes int16 planes with float32 dt."""
    _need_card()
    import chip_smoke

    rows, routes, _ = chip_smoke.compare_i16(channels=8, block=16384,
                                             blocks=2, odd_channels=5)
    assert all(r["ok"] and r["max_abs_err"] == 0.0 for r in rows), rows
    assert {r["name"] for r in rows} >= {n for n, _, _ in
                                         chip_smoke.I16_KERNELS}, rows
    assert routes["i8_direct_c5"]["kernels"][2:4] == ["pll",
                                                      "extract_i16_f32dt"]
    assert not chip_smoke.DUMPS, chip_smoke.DUMPS


@pytest.mark.gpu
def test_hbm_probes_on_card():
    """The device-memory probes on a 64 MiB array: every copy equals its
    input, the read equals its plain version bit for bit, each counts its
    launches, and the best copy rate is a rate a card can reach (between
    100 GB/s and the data sheet's 3.35 TB/s)."""
    _need_card()
    from fm_radio_tpu_torch.probes import hbm_sweep as hs

    hs.reset_counts()
    res = hs.sweep(mib=64, iters=5, copy_blocks=((8, 1024), (512, 512)),
                   dma_chunks_kib=(32,), read_rows=(512,))
    assert all(r["ok"] for r in res["rows"]), res["rows"]
    assert hs.launches_copy and hs.launches_dma and hs.launches_read
    assert 100.0 < res["best_copy"]["gbps"] < 3350.0, res["best_copy"]


@pytest.mark.gpu
def test_engine_probes_on_card():
    """The engine probes' kernels (frontend, K2, K3 and the chain probe's
    stream kernel) on the card at small shapes where every section's tiles
    apply (C = 1024 for the K1 probe's tile-major 1024 x 1024 tile): each
    variant equals its plain version bit for bit (the same float32
    operations in the same order, -fmad=false), and each wrapper counts
    its launches."""
    _need_card()
    from fm_radio_tpu_torch.probes import chain_probe as cp
    from fm_radio_tpu_torch.probes import frontend_probe as fp
    from fm_radio_tpu_torch.probes import k2_probe as k2
    from fm_radio_tpu_torch.probes import k3_probe as k3

    dev = torch.device("cuda")
    for m in (fp, k2, k3):
        m.reset_counts()
    rows = fp.run(1024, 16384, {"ingest", "tm", "engines", "split", "tiles",
                                "dbuf", "i8d", "i8x", "man", "sem"}, 1, dev,
                  emit=lambda r: None)
    # every tile of the ingest (3 forms x 2 modes x 3) and tile-major
    # (2 x 2 x 5) sections ran
    assert sum(":TM:" not in r["variant"] and ":tile=" in r["variant"]
               and r["variant"].split(":")[1] in ("f32w", "i16", "u8")
               for r in rows) == 18
    assert sum(":TM:" in r["variant"] for r in rows) == 20
    rows += k2.run(8, 4096, 1, dev, emit=lambda r: None)
    rows += k3.run(16, 8192, 1, dev, emit=lambda r: None)
    planes = k3.make_inputs(16, 4096, dev)
    n_sum = k3.launches_sum
    y = cp.stream3(planes[:2], planes[2])
    assert k3.launches_sum == n_sum + 1
    assert torch.equal(y, k3.sum_plain("stream", planes, 1024, 16)[0])
    bad = [r for r in rows if r["max_abs_err"] != 0.0]
    assert not bad, bad
    counts = {**fp.counts(), **k2.counts(), **k3.counts()}
    assert all(counts.values()), counts
    assert {r["kernel"] for r in rows} == set(counts) | {"k3_full"}
