"""The port's kernels, run here as their plain PyTorch versions (CPU
tensors), against the JAX package's Pallas kernels in interpret mode.

Each test streams two blocks from one shared start state, each package
carrying its own state, and compares outputs and carried state.  The
tolerances start from the JAX package's own kernel tests
(tests/test_kernels.py) and are tightened to ~3-10x the measured error
where it allowed; the remaining differences are float32 rounding (bf16x3 /
bf16x4 matmul splits and XLA's op fusion on the JAX side, and sums in
another order for the AGC power).
The CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py and tests/test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_radio_tpu.config import DemodConfig as JDemodConfig
from fm_radio_tpu.io.synth import FMModulator, ModulatorConfig
from fm_radio_tpu.kernels.bpsk_pallas import bpsk_sync_pallas
from fm_radio_tpu.kernels.extract_pallas import extract_pallas
from fm_radio_tpu.kernels.k12_pallas import k12_pallas
from fm_radio_tpu.kernels.pll_pallas import pilot_pll_pallas_theta
from fm_radio_tpu.models import demod as jdemod
from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.kernels import bpsk as tbpsk
from fm_radio_tpu_torch.kernels import extract as textract
from fm_radio_tpu_torch.kernels import k12 as tk12
from fm_radio_tpu_torch.kernels import pll as tpll
from fm_radio_tpu_torch.models import demod as tdemod
from fm_radio_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
from fm_radio_tpu_torch.utils.transfer import split_iq_i8

CFG_KW = {"frontend_int8": True}
CFG, JCFG = DemodConfig(**CFG_KW), JDemodConfig(**CFG_KW)


def cfgs(**changes):
    """The port's and the JAX package's DemodConfig from the same keyword
    arguments (CFG's and ``changes``)."""
    kw = {**CFG_KW, **changes}
    return DemodConfig(**kw), JDemodConfig(**kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _start(jcfg, c):
    """One start state for both packages: (JAX state, port state)."""
    st_j = jdemod.demod_init_state(jcfg, c)
    return st_j, state_from_numpy(_np(st_j))


def _close(a, b, atol=0.0, rtol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol, err_msg=what)


def _phase_close(a, b, atol, what=""):
    """Phases in cycles: compare the difference wrapped to [-0.5, 0.5), so
    a value on the +-0.5 branch cut in one package and just across it in
    the other counts as equal."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    d = d - np.round(d)
    assert np.max(np.abs(d)) <= atol, f"{what}: max |d| {np.max(np.abs(d))}"


def _station_planes(c, n, seed):
    """[2, C, n] int8 planes: channel 0 a synthetic stereo+RDS station,
    the others random bytes (as tests/test_kernels.py uses)."""
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, size=(c, n, 2), dtype=np.uint8)
    iq = FMModulator(ModulatorConfig()).generate(n, left_hz=1000.0,
                                                 right_hz=3000.0)
    u8[0, :, 0] = np.clip(np.round(iq.real + 127.0), 0, 255)
    u8[0, :, 1] = np.clip(np.round(iq.imag + 127.0), 0, 255)
    return split_iq_i8(u8)


@pytest.mark.parametrize("use_deemph", [False, True])
def test_k12_plain_matches_pallas(use_deemph):
    cfg, jcfg = cfgs(use_deemphasis_filter=use_deemph)
    co_j, co_t = jdemod.make_coeffs(jcfg), tdemod.make_coeffs(cfg)
    c, b = 4, 8192
    x = _station_planes(c, 2 * b, seed=7)
    st_j, st_t = _start(jcfg, c)
    for blk in range(2):
        xb = x[:, :, blk * b : (blk + 1) * b]
        st_j, (re_j, im_j), th_j = k12_pallas(co_j, jcfg, st_j, jnp.asarray(xb),
                                               interpret=True)
        st_t, (re_t, im_t), th_t = tk12.k12(co_t, cfg, st_t,
                                             torch.from_numpy(xb))
        _close(re_t, re_j, atol=2e-5, what="re")
        _close(im_t, im_j, atol=2e-5, what="im")
        _phase_close(th_t, th_j, atol=1e-4, what="theta")
        sj, stn = _np(st_j), state_to_numpy(st_t)
        np.testing.assert_array_equal(stn["ds_fm_in"], sj["ds_fm_in"])
        _close(stn["disc_prev_theta"], sj["disc_prev_theta"], atol=1e-6,
               what="disc_prev_theta")
        _close(stn["ds_fm_out"], sj["ds_fm_out"], atol=1e-6, what="ds_fm_out")
        _close(stn["hilbert"], sj["hilbert"], atol=2e-5, what="hilbert")
        for key in ("peak_pilot", "deemph"):
            for h in ("x_hist", "y_hist"):
                _close(stn[key][h], sj[key][h], atol=2e-5, what=f"{key} {h}")
        _close(stn["agc_pilot"], sj["agc_pilot"], rtol=2e-4, what="agc_pilot")


def _pilot_theta(c, n, seed):
    """Pilot phase (cycles) of a noisy 19,015 Hz tone at 128 kHz, so the
    loop locks (tests/test_kernels.py::_pilot_signal)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / CFG.rates.fs_fm_out
    x = np.exp(1j * (2 * np.pi * 19015.0 * t + 0.7))[None, :] + 0.01 * (
        rng.standard_normal((c, n)) + 1j * rng.standard_normal((c, n)))
    return (np.angle(x) / (2 * np.pi)).astype(np.float32)


def test_pll_plain_matches_pallas():
    c, n = 4, 1024
    theta = _pilot_theta(c, 2 * n, seed=3)
    st_j, st_t = _start(JCFG, c)
    pj, pt = st_j["pll"], st_t["pll"]
    for blk in range(2):
        th = theta[:, blk * n : (blk + 1) * n]
        pj, dt_j = pilot_pll_pallas_theta(JCFG, pj, jnp.asarray(th),
                                          interpret=True)
        pt, dt_t = tpll.pilot_pll_theta(CFG, pt, torch.from_numpy(th))
        _close(dt_t, dt_j, atol=2e-6, what="dt")
        for name, a, b in zip(pj._fields, pt, pj):
            _close(a, b, atol=1e-5, what=name)


def test_extract_plain_matches_pallas():
    co_j, co_t = jdemod.make_coeffs(JCFG), tdemod.make_coeffs(CFG)
    c, n = 3, 2048
    rng = np.random.default_rng(13)
    xr = rng.standard_normal((c, 2 * n)).astype(np.float32) * 0.4
    xi = rng.standard_normal((c, 2 * n)).astype(np.float32) * 0.4
    dt = rng.random((c, 2 * n)).astype(np.float32) - 0.5
    off = rng.standard_normal((c,)).astype(np.float32) * 0.1
    st_j, st_t = _start(JCFG, c)
    st_j = dict(st_j, lmr_phase_err=jnp.asarray(off))
    st_t = dict(st_t, lmr_phase_err=torch.from_numpy(off))
    for blk in range(2):
        sl = slice(blk * n, (blk + 1) * n)
        st_j, lpr_j, lmr_j, rds_j, pow_j = extract_pallas(
            co_j, JCFG, st_j, (jnp.asarray(xr[:, sl]), jnp.asarray(xi[:, sl])),
            jnp.asarray(dt[:, sl]), interpret=True)
        st_t, lpr_t, lmr_t, rds_t, pow_t = textract.extract(
            co_t, CFG, st_t,
            (torch.from_numpy(xr[:, sl]), torch.from_numpy(xi[:, sl])),
            torch.from_numpy(dt[:, sl]))
        _close(lpr_t, lpr_j, atol=1e-5, what="lpr")
        for k in range(2):
            _close(lmr_t[k], lmr_j[k], atol=1e-5, what="lmr")
            _close(rds_t[k], rds_j[k], atol=1e-5, what="rds")
        _close(pow_t, pow_j, rtol=2e-4, what="rds_pow")
        sj, stn = _np(st_j), state_to_numpy(st_t)
        for key in ("ds_audio_lpr", "ds_audio_lmr", "ds_rds"):
            _close(stn[key], sj[key], atol=1e-5, what=key)


def _rds_signal(c, n, seed):
    """BPSK-like signal at 16 kHz: 2 kHz symbols on the Q axis
    (tests/test_kernels.py::_rds_signal)."""
    rng = np.random.default_rng(seed)
    syms = rng.choice([-1.0, 1.0], size=(c, n // 8 + 1))
    d = np.repeat(syms, 8, axis=1)[:, :n]
    x = 0.7j * d + 0.05 * (rng.standard_normal((c, n))
                           + 1j * rng.standard_normal((c, n)))
    return x.real.astype(np.float32), x.imag.astype(np.float32)


def test_bpsk_plain_matches_pallas():
    c, n = 4, 512
    xr, xi = _rds_signal(c, 2 * n, seed=5)
    gain = np.array([0.9, 1.1, 1.3, 0.7], np.float32)
    st_j, st_t = _start(JCFG, c)
    bj, bt = st_j["bpsk"], st_t["bpsk"]
    n_valid = 0
    for blk in range(2):
        sl = slice(blk * n, (blk + 1) * n)
        bj, oj = bpsk_sync_pallas(
            JCFG, bj, (jnp.asarray(xr[:, sl]), jnp.asarray(xi[:, sl])),
            gain=jnp.asarray(gain), interpret=True)
        bt, ot = tbpsk.bpsk_sync(
            CFG, bt, (torch.from_numpy(xr[:, sl]), torch.from_numpy(xi[:, sl])),
            torch.from_numpy(gain))
        v = np.asarray(oj["valid"])
        np.testing.assert_array_equal(ot["valid"].numpy(), v)
        n_valid += int(v.sum())
        _close(ot["pred"].numpy()[v], np.asarray(oj["pred"])[v], atol=1e-6,
               what="pred")
        _close(ot["sym"].numpy()[v], np.asarray(oj["sym"])[v], atol=1e-6,
               what="sym")
        for name in bj._fields:
            _close(getattr(bt, name).numpy(), np.asarray(getattr(bj, name)),
                   atol=1e-6, what=name)
    assert n_valid > 100  # the TED clock fires about once per 8 samples


def test_dispatch_never_falls_back(monkeypatch, tmp_path):
    """Only CPU tensors take the plain version: a tensor on another device
    is refused (K12 flat and phase-split, the channelizer, K1 on each
    ingest form and its int8-direct entry, K2), and a kernel that fails to
    build raises instead of running anything else."""
    from fm_radio_tpu_torch.kernels import _build
    from fm_radio_tpu_torch.kernels import channelizer as tchan
    from fm_radio_tpu_torch.kernels import frontend as tfront
    from fm_radio_tpu_torch.kernels import midend as tmid

    co, st = tdemod.make_coeffs(CFG), tdemod.demod_init_state(CFG, 1)
    x = torch.zeros((2, 1, 8192), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tk12.k12(co, CFG, st, x)
    x4 = torch.zeros((2, 4, 1, 2048), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tk12.k12_ps(co, CFG, st, x4)
    m = 32
    tab = tchan.make_tables(np.ones(16 * m, np.float32), m)
    zeros = torch.zeros((1, 15 * m), device="meta")
    words = torch.zeros((1, 4096 * m), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tchan.channelize(tab, (zeros, zeros), words, m, out="i8ps")
    for xk, int8_taps in ((torch.zeros((2, 1, 8192), device="meta"), False),
                          (torch.zeros((2, 1, 8192), device="meta"), True),
                          (torch.zeros((1, 8192), device="meta"), True),
                          (x, False)):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            tfront.frontend(co, CFG, st, xk, int8_taps)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tfront.frontend_i8(co, CFG, st, x)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tmid.midend(co, CFG, st, torch.zeros((1, 2048), device="meta"))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "nvcc", lambda: "false")
    monkeypatch.setattr(_build, "_libs", {})
    for name, symbol in (("k12", "fmt_k12"),
                         ("channelizer", "fmt_channelize"),
                         ("frontend", "fmt_frontend"),
                         ("frontend", "fmt_frontend_i8"),
                         ("midend", "fmt_midend")):
        with pytest.raises(RuntimeError, match=f"nvcc failed on {name}.cu"):
            _build.function(name, symbol, [])


@pytest.mark.parametrize("ps", [False, True], ids=["flat", "phase_split"])
@pytest.mark.parametrize("key", ["deemph", "peak_pilot"])
def test_k12_launch_refuses_state_rows(key, ps):
    """A carried state of another channel count never reaches the kernel:
    the launch path checks the rows of every state it passes (here a
    de-emphasis or peak IIR state of 3 channels against 2)."""
    co = tdemod.make_coeffs(CFG)
    st = dict(tdemod.demod_init_state(CFG, 2))
    st[key] = tdemod.demod_init_state(CFG, 3)[key]
    shape = (2, 4, 2, 2048) if ps else (2, 2, 8192)
    x = torch.zeros(shape, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="rows"):
        tk12._launch(co, CFG, st, x, ps=ps)


@pytest.mark.parametrize("entry", ["frontend", "frontend_i8", "midend"])
def test_split_launch_refuses_state_rows(entry):
    """As K12's: a carried state of another channel count (3 against 2)
    never reaches K1 or K2 on the card; their launch paths check it."""
    from fm_radio_tpu_torch.kernels import frontend as tfront
    from fm_radio_tpu_torch.kernels import midend as tmid

    co = tdemod.make_coeffs(CFG)
    st = dict(tdemod.demod_init_state(CFG, 2))
    st3 = tdemod.demod_init_state(CFG, 3)
    with pytest.raises(ValueError, match="channels"):
        if entry == "midend":
            st["peak_pilot"] = st3["peak_pilot"]
            tmid._launch(co, CFG, st,
                         torch.zeros((2, 2048), device="meta"))
        else:
            st["ds_fm_in"] = st3["ds_fm_in"]
            x = torch.zeros((2, 2, 8192), dtype=torch.int8, device="meta")
            tfront._launch(co, CFG, st, x, True, direct=entry != "frontend")
