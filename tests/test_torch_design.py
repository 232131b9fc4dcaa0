"""The port's host-side design, state layout and package hygiene against
the JAX package: coefficients bit for bit, the int8 ds x4 taps, the state
keys/shapes/dtypes and their numpy round trip, TF32 off, no jax import,
and NotImplementedError for everything outside the ported slice."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from fm_radio_tpu.config import DemodConfig as JDemodConfig
from fm_radio_tpu.models import demod as jdemod
from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.models import demod as tdemod
from fm_radio_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

CFG_KW = {"frontend_int8": True}
CFG, JCFG = DemodConfig(**CFG_KW), JDemodConfig(**CFG_KW)


def cfgs(**changes):
    """The port's and the JAX package's DemodConfig from the same keyword
    arguments (CFG's and ``changes``)."""
    kw = {**CFG_KW, **changes}
    return DemodConfig(**kw), JDemodConfig(**kw)
REPO = Path(__file__).resolve().parent.parent


def _leaves(tree):
    """(path, leaf) pairs of a nested dict / NamedTuple state."""
    out = []

    def walk(p, v):
        if isinstance(v, dict):
            for k in v:
                walk(f"{p}/{k}", v[k])
        elif isinstance(v, tuple):
            for k, w in zip(v._fields, v):
                walk(f"{p}/{k}", w)
        else:
            out.append((p, v))

    walk("", tree)
    return out


@pytest.mark.parametrize("changes", [
    {},
    {"use_deemphasis_filter": True, "deemphasis_cutoff_us": 50},
    {"audio_lpr_cutoff_hz": 12000, "audio_lmr_cutoff_hz": 9000},
])
def test_make_coeffs_bit_identical(changes):
    cfg, jcfg = cfgs(**changes)
    cj, ct = jdemod.make_coeffs(jcfg), tdemod.make_coeffs(cfg)
    for name in ("taps_fm_in", "taps_fm_out", "taps_hilbert",
                 "taps_audio_lpr", "taps_audio_lmr", "taps_rds"):
        a, b = getattr(ct, name).numpy(), np.asarray(getattr(cj, name))
        assert a.dtype == b.dtype == np.float32, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("peak_b", "peak_a", "deemph_b", "deemph_a"):
        np.testing.assert_array_equal(
            np.asarray(getattr(ct, name), np.float32),
            np.asarray(getattr(cj, name)), err_msg=name)


def test_k12_quantised_taps_match_quantize_band_int8():
    """The port's int8 split of the ds x4 taps is the JAX kernel's, column
    for column of the banded matrix (every column holds every tap)."""
    from fm_radio_tpu.kernels.frontend_pallas import (
        _TB,
        _band_matrix,
        quantize_band_int8,
    )

    cj, ct = jdemod.make_coeffs(JCFG), tdemod.make_coeffs(CFG)
    b1j, b2j, srow_j = (np.asarray(a) for a in
                        quantize_band_int8(_band_matrix(cj.taps_fm_in)))
    b1t, b2t, srow_t = ct.k1_i8
    nn = b1t.shape[0]
    halo = nn - 4
    for col in (0, 1, 127):
        rows = slice(_TB - halo + 4 * col, _TB - halo + 4 * col + nn)
        np.testing.assert_array_equal(b1t.numpy(), b1j[rows, col])
        np.testing.assert_array_equal(b2t.numpy(), b2j[rows, col])
    np.testing.assert_array_equal(srow_j, np.full_like(srow_j, srow_t))


def test_init_state_layout_matches_jax():
    c = 3
    sj = jax.tree.map(np.asarray, jdemod.demod_init_state(JCFG, c))
    st = state_to_numpy(tdemod.demod_init_state(CFG, c))
    assert sj.keys() == st.keys()
    lj, lt = dict(_leaves(sj)), dict(_leaves(st))
    assert lj.keys() == lt.keys()
    for p, a in lj.items():
        b = lt[p]
        assert a.shape == b.shape and a.dtype == b.dtype, p
        np.testing.assert_array_equal(a, b, err_msg=p)


def test_state_numpy_round_trip():
    """state_from_numpy(state_to_numpy(s)) == s, leaf for leaf and dtype
    for dtype, on a state carried through one block; and a JAX state
    converts to the port's layout."""
    c, b = 2, 8192
    co = tdemod.make_coeffs(CFG)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(-128, 128, (2, c, b), dtype=np.int8))
    s, _ = tdemod.demod_block(CFG, co, tdemod.demod_init_state(CFG, c), x)
    back = state_from_numpy(state_to_numpy(s))
    for (p, u), (q, v) in zip(_leaves(s), _leaves(back)):
        assert p == q and u.dtype == v.dtype, p
        assert torch.equal(u, v), p
    from_jax = state_from_numpy(
        jax.tree.map(np.asarray, jdemod.demod_init_state(JCFG, c)))
    assert dict(_leaves(from_jax)).keys() == dict(_leaves(s)).keys()
    assert type(from_jax["pll"]).__module__.startswith("fm_radio_tpu_torch")


def test_tf32_off():
    import fm_radio_tpu_torch  # noqa: F401

    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, imports without jax
    and without any module of the JAX package ``fm_radio_tpu`` (top-level
    package exactly that name; the port's own ``fm_radio_tpu_torch`` is
    another package), not even one that imports no jax.  The build
    directory (fm_radio_tpu_torch/_build/) holds no modules."""
    paths = (p.relative_to(REPO)
             for p in (REPO / "fm_radio_tpu_torch").rglob("*.py"))
    mods = sorted(".".join(p.with_suffix("").parts) for p in paths
                  if "_build" not in p.parts)
    mods = [m.removesuffix(".__init__") for m in mods] + ["chip_smoke"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'fm_radio_tpu'))\n"
            "assert not bad, bad\n"
            f"print(len({mods!r}))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) == len(mods) >= 20


# interstage_i16 is ported: its two cases, on int8 planes and on the split
# path's float32 ingest, now hold the route demod_block records (on int8
# planes K12 refuses the flag and the int8-direct K1 takes them)
I16_ROUTES = {
    "interstage_i16": ({"frontend_int8": True},
                       ["frontend_i8", "midend", "pll", "extract", "bpsk"]),
    "interstage_f32": ({}, ["frontend", "midend", "pll", "extract", "bpsk"]),
}


@pytest.mark.parametrize("what", [
    "phase_split", "include_taps", "interstage_i16", "interstage_f32",
    "long_order", "rds_native",
])
def test_outside_the_slice_raises(what):
    """Each option outside the ported slice raises NotImplementedError
    naming its ROADMAP.md item; the interstage_i16 cases, ported, route at
    C = 1, B = 8192 in the int16 format instead (the PLL's tile of one
    channel is not channel-major, so dt stays float32;
    tests/test_torch_interstage_i16.py holds the format against the JAX
    package)."""
    c, b = 1, 8192
    cfg = CFG
    x = torch.zeros((2, c, b), dtype=torch.int8)
    kw = {}
    match = "ROADMAP.md"
    if what in I16_ROUTES:
        extra, route = I16_ROUTES[what]
        cfg = DemodConfig(interstage_i16=True, **extra)
        if what == "interstage_f32":
            x = torch.zeros((2, c, b))
        calls = {}
        tdemod.demod_block(cfg, tdemod.make_coeffs(cfg),
                           tdemod.demod_init_state(cfg, c), x, record=calls)
        assert list(calls) == route
        assert calls["midend"][3].dtype == torch.int16
        assert calls["extract"][4].dtype == torch.float32
        return
    if what == "rds_native":
        from fm_radio_tpu_torch.rds.chain import make_rds_chain

        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            make_rds_chain("native")
        return
    if what == "phase_split":
        # phase planes are taken as the ds x4's four phases only
        x = torch.zeros((2, 2, c, b // 2), dtype=torch.int8)
    elif what == "include_taps":
        kw["include_taps"] = True
    else:
        # an RDS filter whose window reaches 192 samples back: past the
        # kernels' 128-sample halo, on every device, before any launch
        cfg = dataclasses.replace(CFG, order_poly_ds_lpf_rds=200)
        match = "taps_rds: 192.*modules still to port, item 1"
    co = tdemod.make_coeffs(cfg)
    st = tdemod.demod_init_state(cfg, c)
    with pytest.raises(NotImplementedError, match=match):
        tdemod.demod_block(cfg, co, st, x, **kw)


@pytest.mark.parametrize("case", [
    # (DemodConfig field, an order past the halo, the longest order within)
    ("order_poly_ds_lpf_fm_out", 132, 128),  # ds x2 halo 130 (x4: 128)
    ("order_fir_hilbert", 131, 129),         # Hilbert halo 130
    ("order_poly_ds_lpf_audio", 136, 132),   # L+R and L-R halo 132
    ("order_poly_ds_lpf_rds", 140, 136),     # RDS halo 132
], ids=["fm", "hilbert", "audio", "rds"])
def test_long_orders_raise_before_any_launch(case):
    """A filter whose window reaches past the kernels' 128-sample halo
    raises NotImplementedError naming the filter and modules item 1 on the
    card's device type too, before any kernel is reached (the wrappers
    would refuse a meta tensor with a ValueError); the longest order
    within the halo runs."""
    field, over, within = case
    cfg = dataclasses.replace(CFG, **{field: over})
    co = tdemod.make_coeffs(cfg)
    x = torch.zeros((2, 1, 8192), dtype=torch.int8, device="meta")
    with pytest.raises(NotImplementedError,
                       match="128-sample halo.*modules still to port, item 1"):
        tdemod.demod_block(cfg, co, tdemod.demod_init_state(cfg, 1, "meta"), x)
    cfg = dataclasses.replace(CFG, **{field: within})
    assert max(tdemod.filter_halos(tdemod.make_coeffs(cfg)).values()) <= 128
    tdemod.demod_block(cfg, tdemod.make_coeffs(cfg),
                       tdemod.demod_init_state(cfg, 1),
                       torch.zeros((2, 1, 8192), dtype=torch.int8))


@pytest.mark.parametrize("i16", [False, True], ids=["f32", "i16"])
def test_mismatch_dump_and_replay(monkeypatch, tmp_path, i16):
    """A kernel that disagrees with its plain version has its recorded
    arguments, state and both outputs saved as one .npz (chip_smoke.py's
    dump_mismatch, here with a stub kernel that is off by one on the CPU),
    and probes/replay.py loads the case back leaf for leaf and reruns it:
    the saved outputs differ, the rerun (the plain version twice on the
    CPU) does not, and the rerun differs from the saved kernel output as
    the stub did.  Under interstage_i16 at C = 8 the case is saved under
    the int16 variant's name (pll_i16: dt off by one LSB), which replay
    knows as chip_smoke.py does."""
    import chip_smoke
    from fm_radio_tpu_torch.kernels import pll as tpll
    from fm_radio_tpu_torch.probes import replay

    assert chip_smoke.I16_BASE == replay.I16_VARIANTS
    monkeypatch.setattr(chip_smoke, "DUMP_DIR", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "DUMPS", [])
    cfg = dataclasses.replace(CFG, interstage_i16=i16)
    c, b = (8 if i16 else 2), 8192
    co = tdemod.make_coeffs(cfg)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(-128, 128, (2, c, b), dtype=np.int8))
    calls = {}
    tdemod.demod_block(cfg, co, tdemod.demod_init_state(cfg, c), x,
                       record=calls)
    name = chip_smoke.variant("pll", calls["pll"])
    assert name == ("pll_i16" if i16 else "pll")

    def off_by_one(cfg, state, theta):
        st, dt = tpll.pilot_pll_theta(cfg, state, theta)
        return st, torch.where(dt < 32767, dt + 1, dt - 1)  # int16: no wrap

    stages = dict(chip_smoke._stages())
    stages[name] = (off_by_one, tpll.pilot_pll_theta_plain)
    acc = {}
    chip_smoke.compare_stage(acc, name, calls["pll"], stages)
    one = pytest.approx(1.0, abs=1e-6)  # dt + 1 rounded in float32
    assert acc[name]["err"] == one and len(chip_smoke.DUMPS) == 1
    path = chip_smoke.DUMPS[0]
    case = replay.load_case(path)
    assert case["name"] == name and case["errors"]["err"] == one
    for (p, u), (q, v) in zip(replay.leaves(case["args"]),
                              replay.leaves(calls["pll"])):
        assert p == q and u.dtype == v.dtype and torch.equal(u, v), p
    assert case["args"][0] == cfg
    res = replay.replay(path, "cpu")
    assert max(res["saved_kernel_vs_plain"].values()) == one
    assert max(res["rerun_kernel_vs_plain"].values()) == 0.0
    assert res["rerun_vs_saved_kernel"]["/1"] == one
    exact = dict(chip_smoke._stages())
    chip_smoke.compare_stage(acc, chip_smoke.variant(
        "extract", calls["extract"]), calls["extract"], exact)
    assert len(chip_smoke.DUMPS) == 1  # no difference, nothing saved


@pytest.mark.parametrize("case", [
    # (DemodConfig changes, the route demod_block records)
    ({"chain_fusion": "auto"}, ["k12", "pll", "extract", "bpsk"]),
    ({"pll_time_chunks": 4}, ["k12", "pll", "extract", "bpsk"]),
    ({"chain_fusion": "auto", "pll_time_chunks": 4},
     ["k12", "pll", "extract", "bpsk"]),
], ids=["chain_fusion", "pll_chunks", "both"])
def test_chain_and_chunk_options_route_without_raising(case):
    """``chain_fusion`` and ``pll_time_chunks`` are ported: on int8 planes
    at C = 1, B = 8192 neither raises, and each keeps the route the JAX
    gates give that shape (the megakernel takes no int8 planes and needs
    C % 8 == 0; N / G = 256 steps fail the chunk gate, so the sequential
    PLL runs)."""
    changes, route = case
    cfg = dataclasses.replace(CFG, **changes)
    calls = {}
    tdemod.demod_block(cfg, tdemod.make_coeffs(cfg),
                       tdemod.demod_init_state(cfg, 1),
                       torch.zeros((2, 1, 8192), dtype=torch.int8),
                       record=calls)
    assert list(calls) == route


@pytest.mark.parametrize("case", [
    # (M, splits asked, the mode that runs)
    (8, 1, 1), (8, 2, 2), (8, 3, 3), (32, 1, 1), (16, 2, 2), (4, 1, 3),
], ids=["m8_s1", "m8_s2", "m8_s3", "m32_s1", "m16_s2", "m4_s1_gate"])
def test_channelizer_splits_route_without_raising(case):
    """The channelizer's precision modes are ported: ``splits`` 1 and 2
    run on packed words where the JAX TPU route draws them (M % 8 == 0;
    the demod's block of 8192 per channel always makes whole frame tiles
    of the TPU kernel), and the exact mode elsewhere (M = 4);
    ``wideband_demod_block`` records the mode that ran, and the M silent
    channels stay silent."""
    from fm_radio_tpu_torch.models import wideband

    m, splits, mode = case
    st = wideband.wideband_init_state(CFG, m, 1)
    words = torch.full((1, 8192 * m), 127.0 * 256 + 127.0)
    calls = {}
    _, outs = wideband.wideband_demod_block(CFG, tdemod.make_coeffs(CFG), None,
                                            st, words, m, splits=splits,
                                            record=calls)
    assert calls["channelizer"][5] == mode
    assert not outs["audio"].any()


def test_phase_split_without_k12_raises_on_the_card():
    """Phase-split planes without the fused K12 (k12_fusion="off") are
    re-interleaved only by the plain version: on a device tensor
    demod_block raises instead of copying them back into flat planes."""
    cfg = DemodConfig(frontend_int8=True, k12_fusion="off")
    x4 = torch.zeros((2, 4, 1, 2048), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="phase-split planes need the fused "
                                         "K12"):
        tdemod.demod_block(cfg, tdemod.make_coeffs(cfg),
                           tdemod.demod_init_state(cfg, 1), x4)
