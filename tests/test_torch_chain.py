"""The full-chain megakernel (``chain_fusion="auto"``), run here as its
plain PyTorch version (CPU tensors), against the JAX package and against
the port's own split path.

``kernels/chain.py::chain`` against ``demod_chain_pallas`` (interpret
mode) on packed words and float32 planes, de-emphasis off and on;
``demod_block(chain_fusion="auto")`` on words, planes and complex64
against JAX ``demod_block(loop_impl="pallas")``; the route (``record``
names ``chain`` exactly where the JAX gate takes the megakernel); and the
chain against the port's split path with float taps on the same words.
Each test streams two blocks from one start state, each package carrying
its own.  The kernel itself is held against this plain version on the
card (``chip_smoke.py``, ``tests/test_torch_gpu.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_radio_tpu.config import DemodConfig as JDemodConfig
from fm_radio_tpu.io.synth import FMModulator, ModulatorConfig
from fm_radio_tpu.kernels import chain_pallas, frontend_pallas, k12_pallas
from fm_radio_tpu.kernels.chain_pallas import demod_chain_pallas
from fm_radio_tpu.models import demod as jdemod
from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.io.pcm import c64_to_u8
from fm_radio_tpu_torch.kernels import chain as tchain
from fm_radio_tpu_torch.models import demod as tdemod
from fm_radio_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
from fm_radio_tpu_torch.utils.transfer import pack_iq_u8, split_iq_i8

GROUPS = [
    (0x1234, (0 << 12) | (1 << 10) | 0b00000, 0xE101, 0x4142),  # 0A
    (0x1234, (2 << 12) | 0b00000, 0x4845, 0x4C4C),              # 2A
]

# State leaf tolerances against the JAX megakernel.  Its K1 reaches
# float32 through bf16 splits (the port's is exact float32: fm_demod within
# 1e-4, tests/test_torch_split.py), so the split tests' K2 tolerances hold
# on K2's state (2e-5), and the keys downstream of the pilot PLL hold the
# block-level 1e-4 (tests/test_torch_demod.py), the loop's phase errors
# and the phase-mixed tails 2*pi times that (radians).  ds_fm_in is the
# input itself.  Measured on the CPU, C = 8 stations, B = 16,384, two
# blocks: K2 state <= 1.5e-6, disc_prev_theta 1.3e-6, ds_audio_lpr 3.4e-6,
# ds_audio_lmr 7.9e-5, ds_rds 1.2e-4, pll 1.1e-4, agc_pilot 2.3e-5
# relative; the output planes <= 3.7e-5.
STATE_ATOL = {"ds_fm_in": 0.0, "disc_prev_theta": 1e-5, "ds_fm_out": 2e-5,
              "hilbert": 2e-5, "deemph": 2e-5, "peak_pilot": 2e-5,
              "ds_audio_lpr": 1e-4, "ds_audio_lmr": 2 * np.pi * 1e-4,
              "ds_rds": 2 * np.pi * 1e-4, "pll": 2 * np.pi * 1e-4,
              "lmr_phase_err": 1e-4, "bpsk": 1e-4}
OUT_ATOL = 1e-4
AGC_RTOL = 2e-4  # summed in another order (ROADMAP.md section 4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain loops run many small tensor ops; with pytest-xdist
    workers sharing the cores, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(**kw):
    """The port's and the JAX package's DemodConfig from the same keyword
    arguments."""
    return DemodConfig(**kw), JDemodConfig(**kw)


def _stations(c, n, seed):
    """(complex64 [C, n] baseband off the u8 grid, u8 [C, n, 2] of it): a
    stereo+RDS station per channel with its own tones, plus noise."""
    rng = np.random.default_rng(seed)
    mod = FMModulator(ModulatorConfig())
    cf = np.stack([
        mod.generate(n, left_hz=700.0 + 300 * ch, right_hz=2500.0,
                     rds_groups=GROUPS)
        + 2.0 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        for ch in range(c)]).astype(np.complex64)
    return cf, c64_to_u8(cf)


def _inputs(form, cf, u8):
    """The numpy input of an ingest form."""
    return {"words": lambda: pack_iq_u8(u8),
            "planes": lambda: np.stack([cf.real, cf.imag]),
            "complex": lambda: cf,
            "i8": lambda: split_iq_i8(u8)}[form]()


def _leaf_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.complex128)
                               - np.asarray(b, np.complex128))))


def _check_state(st_t, st_j, keys):
    """Every leaf of ``keys`` within STATE_ATOL, agc_* within AGC_RTOL."""
    stn, sj = state_to_numpy(st_t), jax.tree.map(np.asarray, st_j)
    for key in keys:
        if key.startswith("agc_"):
            np.testing.assert_allclose(stn[key], sj[key], rtol=AGC_RTOL,
                                       err_msg=key)
            continue
        a, b = stn[key], sj[key]
        pairs = (zip(a.values(), b.values()) if isinstance(a, dict)
                 else zip(a, b) if isinstance(a, tuple) else [(a, b)])
        err = max(_leaf_err(u, v) for u, v in pairs)
        assert err <= STATE_ATOL[key], (key, err)


@pytest.mark.parametrize("use_deemph", [False, True], ids=["de_off", "de_on"])
@pytest.mark.parametrize("form", ["words", "planes"])
def test_chain_plain_matches_pallas(form, use_deemph):
    """``chain`` (plain) against ``demod_chain_pallas`` (interpret) at C = 8,
    B = 16,384, two blocks: the five output planes within 1e-4 and every
    state key the megakernel owns within STATE_ATOL."""
    c, b = 8, 16384
    tcfg, jcfg = cfgs(use_deemphasis_filter=use_deemph,
                      deemphasis_cutoff_us=50)
    co_j, co_t = jdemod.make_coeffs(jcfg), tdemod.make_coeffs(tcfg)
    cf, u8 = _stations(c, 2 * b, seed=2)
    x = np.ascontiguousarray(_inputs(form, cf, u8), np.float32)
    st_j = jdemod.demod_init_state(jcfg, c)
    st_t = state_from_numpy(jax.tree.map(np.asarray, st_j))
    for blk in range(2):
        xb = np.ascontiguousarray(x[..., blk * b : (blk + 1) * b])
        xj = (jnp.asarray(xb) if form == "words"
              else (jnp.asarray(xb[0]), jnp.asarray(xb[1])))
        st_j, lpr_j, lmr_j, rds_j = demod_chain_pallas(
            co_j, jcfg, st_j, xj, interpret=True, int_input=form == "words")
        st_t, lpr_t, lmr_t, rds_t = tchain.chain(co_t, tcfg, st_t,
                                                 torch.from_numpy(xb))
        for a, bb in [(lpr_t, lpr_j), *zip(lmr_t, lmr_j), *zip(rds_t, rds_j)]:
            np.testing.assert_allclose(a.numpy(), np.asarray(bb),
                                       atol=OUT_ATOL, rtol=0)
        _check_state(st_t, st_j, [k for k in STATE_ATOL
                                  if k not in ("lmr_phase_err", "bpsk")]
                     + ["agc_pilot"])


@pytest.mark.parametrize("form", ["words", "planes", "complex"])
def test_demod_block_chain_matches_jax(form):
    """``demod_block(chain_fusion="auto")`` at C = 8, B = 8,192 against JAX
    ``demod_block(loop_impl="pallas")``, which takes its megakernel there
    too (interpret): two blocks; ``rds_valid`` identical, audio and
    ``rds_pred`` within 1e-4 (tests/test_torch_split_e2e.py's block
    tolerance), every state leaf
    compared (STATE_ATOL; agc_* rtol 2e-4)."""
    c, b = 8, 8192
    kw = {"chain_fusion": "auto",
          "assume_integer_input": form == "words"}
    tcfg, _ = cfgs(**kw)
    jcfg = JDemodConfig(loop_impl="pallas", **kw)
    co_j, co_t = jdemod.make_coeffs(jcfg), tdemod.make_coeffs(tcfg)
    cf, u8 = _stations(c, 2 * b, seed=4)
    x = np.ascontiguousarray(_inputs(form, cf, u8))
    st_j = jdemod.demod_init_state(jcfg, c)
    st_t = state_from_numpy(jax.tree.map(np.asarray, st_j))
    for blk in range(2):
        xb = np.ascontiguousarray(x[..., blk * b : (blk + 1) * b])
        calls = {}
        st_j, oj = jdemod.demod_block(jcfg, co_j, st_j, jnp.asarray(xb))
        st_t, ot = tdemod.demod_block(tcfg, co_t, st_t, torch.from_numpy(xb),
                                      record=calls)
        assert list(calls) == ["chain", "bpsk"] and calls["bpsk"][3] is None
        valid = np.asarray(oj["rds_valid"])
        np.testing.assert_array_equal(ot["rds_valid"].numpy(), valid)
        np.testing.assert_allclose(ot["audio"].numpy(), np.asarray(oj["audio"]),
                                   atol=OUT_ATOL, rtol=0)
        np.testing.assert_allclose(ot["rds_pred"].numpy()[valid],
                                   np.asarray(oj["rds_pred"])[valid],
                                   atol=OUT_ATOL, rtol=0)
        _check_state(st_t, st_j, list(STATE_ATOL) + ["agc_pilot", "agc_rds"])


class _Took(Exception):
    """Raised by a stubbed JAX kernel entry: which route the gate took."""


@pytest.mark.parametrize("case", [
    # (ingest form, C, B, DemodConfig kwargs, the route both take)
    ("words", 8, 8192, {}, "chain"),
    ("planes", 8, 8192, {}, "chain"),
    ("complex", 8, 8192, {}, "chain"),
    ("words", 136, 8192, {}, "chain"),      # <= 256 word channels: one tile
    ("planes", 136, 8192, {}, "split"),     # > 128 plane channels, 128 ∤ 136
    ("i8", 8, 8192, {"frontend_int8": True}, "split"),   # K12
    ("i8", 8, 8192, {}, "split"),           # K1 -> K2 on int8 planes
    ("words", 1, 8192, {}, "split"),        # C = 1
    ("words", 12, 8192, {}, "split"),       # C % 8 != 0
    ("words", 8, 8192, {"chain_fusion": "split"}, "split"),
], ids=["words_c8", "planes_c8", "complex_c8", "words_c136", "planes_c136",
        "i8_k12", "i8_k1", "words_c1", "words_c12", "chain_off"])
def test_chain_route_matches_the_jax_gate(case, monkeypatch):
    """The port's ``record`` names ``chain`` exactly where JAX
    ``demod_block(loop_impl="pallas")`` calls ``demod_chain_pallas``
    (demod.py:307-331), on the same config and shape.  The JAX kernel
    entries are stubbed to report the route and stop, so only its gate
    runs (outside jit, so no compiled trace stands in for it)."""
    form, c, b, extra, route = case
    kw = {"chain_fusion": "auto", **extra}
    tcfg, _ = cfgs(**kw)
    jcfg = JDemodConfig(loop_impl="pallas", **kw)

    def took(name):
        def stub(*args, **kwargs):
            raise _Took(name)
        return stub

    monkeypatch.setattr(chain_pallas, "demod_chain_pallas", took("chain"))
    monkeypatch.setattr(k12_pallas, "k12_pallas", took("split"))
    monkeypatch.setattr(frontend_pallas, "ds4_disc_pallas", took("split"))
    monkeypatch.setattr(jdemod, "polyphase_decimate_p", took("split"))
    cf, u8 = _stations(1, b, seed=1)
    cf, u8 = np.repeat(cf, c, 0), np.repeat(u8, c, 0)
    x = np.ascontiguousarray(_inputs(form, cf, u8))
    with pytest.raises(_Took) as jax_route, jax.disable_jit():
        jdemod.demod_block(jcfg, jdemod.make_coeffs(jcfg),
                           jdemod.demod_init_state(jcfg, c), jnp.asarray(x))
    assert str(jax_route.value) == route
    calls = {}
    tdemod.demod_block(tcfg, tdemod.make_coeffs(tcfg),
                       tdemod.demod_init_state(tcfg, c), torch.from_numpy(x),
                       record=calls)
    assert ("chain" in calls) == (route == "chain"), list(calls)


def test_chain_block_size_must_be_a_multiple_of_8192():
    """A block that is not a multiple of 8192 raises the existing
    ValueError, with or without the megakernel."""
    cfg = DemodConfig(chain_fusion="auto")
    x = torch.full((8, 12288), 127.0 * 256 + 127.0)
    with pytest.raises(ValueError, match="not a multiple of 8192"):
        tdemod.demod_block(cfg, tdemod.make_coeffs(cfg),
                           tdemod.demod_init_state(cfg, 8), x)


@pytest.mark.parametrize("use_deemph", [False, True], ids=["de_off", "de_on"])
def test_chain_equals_split_path_with_float_taps(use_deemph):
    """On the same packed words, ``demod_block`` through the megakernel and
    through the split path with float taps (``assume_integer_input=True``,
    the f32w cell): audio and every state leaf before the RDS AGC equal
    bit for bit, two blocks.  The RDS AGC differs by route: the split path
    sums the RDS power in the extract kernel and applies the gain at the
    BPSK kernel's ingest, the chain scales the planes by the unfused AGC
    first (demod.py:576-609); agc_rds held to rtol 2e-4, the BPSK outputs
    to 1e-4 with ``rds_valid`` identical (on the CPU both sums are the same
    torch.sum, measured equal; on the card the extract kernel's per-tile
    sum differs by its summation order)."""
    c, b = 8, 8192
    base = {"assume_integer_input": True, "use_deemphasis_filter": use_deemph,
            "deemphasis_cutoff_us": 50}
    cfg_c = DemodConfig(chain_fusion="auto", **base)
    cfg_s = DemodConfig(**base)
    co = tdemod.make_coeffs(cfg_c)
    _, u8 = _stations(c, 2 * b, seed=6)
    w = torch.from_numpy(pack_iq_u8(u8))
    st_c = st_s = tdemod.demod_init_state(cfg_c, c)
    for blk in range(2):
        xb = w[:, blk * b : (blk + 1) * b].contiguous()
        calls_c, calls_s = {}, {}
        st_c, o_c = tdemod.demod_block(cfg_c, co, st_c, xb, record=calls_c)
        st_s, o_s = tdemod.demod_block(cfg_s, co, st_s, xb, record=calls_s)
        assert list(calls_c) == ["chain", "bpsk"]
        assert list(calls_s) == ["frontend", "midend", "pll", "extract",
                                 "bpsk"] and calls_s["frontend"][4] is False
        assert torch.equal(o_c["audio"], o_s["audio"])
        sc, ss = state_to_numpy(st_c), state_to_numpy(st_s)
        for key in sc:
            if key in ("agc_rds", "bpsk"):
                continue
            for u, v in zip(jax.tree.leaves(sc[key]), jax.tree.leaves(ss[key])):
                np.testing.assert_array_equal(u, v, err_msg=key)
        np.testing.assert_allclose(sc["agc_rds"], ss["agc_rds"], rtol=AGC_RTOL)
        np.testing.assert_array_equal(o_c["rds_valid"].numpy(),
                                      o_s["rds_valid"].numpy())
        np.testing.assert_allclose(o_c["rds_pred"].numpy(),
                                   o_s["rds_pred"].numpy(), atol=OUT_ATOL)


def test_new_entries_never_fall_back(monkeypatch, tmp_path):
    """The megakernel, the chunked PLL and BPSK without a gain take their
    plain versions only for CPU tensors: a tensor on another device is
    refused, a state of another channel count never reaches the chain's
    launch, and a kernel that fails to build raises."""
    from fm_radio_tpu_torch.kernels import _build
    from fm_radio_tpu_torch.kernels import bpsk as tbpsk
    from fm_radio_tpu_torch.kernels import pll as tpll

    cfg = DemodConfig(chain_fusion="auto", pll_time_chunks=4)
    co, st = tdemod.make_coeffs(cfg), tdemod.demod_init_state(cfg, 8)
    for x in (torch.zeros((8, 8192), device="meta"),
              torch.zeros((2, 8, 8192), device="meta")):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            tchain.chain(co, cfg, st, x)
    theta = torch.zeros((8, 32768), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tpll.pilot_pll_chunked(cfg, st["pll"], theta)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tpll.pilot_pll_theta(cfg, st["pll"], theta)
    rds = torch.zeros((8, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tbpsk.bpsk_sync(cfg, st["bpsk"], (rds, rds))
    with pytest.raises(ValueError, match="fail the chunk gate"):
        tpll.pilot_pll_chunked(cfg, st["pll"], torch.zeros((8, 4096)))
    with pytest.raises(ValueError, match="words .* or float32 planes"):
        tchain.chain(co, cfg, st, torch.zeros((2, 8, 8192), dtype=torch.int8))
    bad = dict(st, ds_fm_in=tdemod.demod_init_state(cfg, 16)["ds_fm_in"])
    with pytest.raises(ValueError, match="channels"):
        tchain._launch(co, cfg, bad, torch.zeros((8, 8192), device="meta"))
    with pytest.raises(ValueError, match="multiple of 8"):
        tchain._launch(co, cfg, st, torch.zeros((12, 8192), device="meta"))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "nvcc", lambda: "false")
    monkeypatch.setattr(_build, "_libs", {})
    for name, symbol in (("chain", "fmt_chain"), ("pll", "fmt_pll_chunked")):
        with pytest.raises(RuntimeError, match=f"nvcc failed on {name}.cu"):
            _build.function(name, symbol, [])
