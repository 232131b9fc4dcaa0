"""The ported slice end to end against the JAX package.

Block level: the port's ``demod_block`` (plain versions on CPU tensors)
against JAX ``demod_block`` with ``loop_impl="pallas"``, which on the CPU
runs the same four Pallas kernels in interpret mode, from one start state.

Station level: the tests/test_e2e.py recipe, quantized to u8 and split
into int8 planes, through the port's App and the JAX App: identical RDS
bytes, audio within 75 dB SNR (the golden bar of docs/PERF.md:554-565),
and the selftest gates on the port alone.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_radio_tpu.config import DemodConfig as JDemodConfig
from fm_radio_tpu.io.pcm import c64_to_u8
from fm_radio_tpu.io.synth import FMModulator, ModulatorConfig
from fm_radio_tpu.models import demod as jdemod
from fm_radio_tpu.models.app import App as JaxApp
from fm_radio_tpu_torch.config import AudioOut, DemodConfig
from fm_radio_tpu_torch.models import demod as tdemod
from fm_radio_tpu_torch.models.app import App
from fm_radio_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
from fm_radio_tpu_torch.utils.transfer import split_iq_i8

CFG = DemodConfig(frontend_int8=True)
JCFG = JDemodConfig(frontend_int8=True)
BLOCK = 32768
GROUPS = [
    (0x1234, (0 << 12) | (1 << 10) | 0b00000, 0xE101, 0x4142),  # 0A
    (0x1234, (2 << 12) | 0b00000, 0x4845, 0x4C4C),              # 2A
]
SNR_MIN_DB = 75.0


def snr_db(sig, ref):
    sig, ref = np.asarray(sig, np.float64), np.asarray(ref, np.float64)
    return 10 * np.log10(np.sum(ref ** 2) / (np.sum((sig - ref) ** 2) + 1e-30))


def _planes(c, n, seed):
    """[2, C, n] int8: a stereo+RDS station per channel, each with its own
    tones and added noise, quantized to u8 as a radio delivers it."""
    rng = np.random.default_rng(seed)
    mod = FMModulator(ModulatorConfig())
    u8 = []
    for ch in range(c):
        iq = mod.generate(n, left_hz=700.0 + 300 * ch, right_hz=2500.0,
                          rds_groups=GROUPS)
        iq = iq + 2.0 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        u8.append(c64_to_u8(iq.astype(np.complex64)))
    return split_iq_i8(np.stack(u8))


def _leaf_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.complex128)
                               - np.asarray(b, np.complex128))))


def test_demod_block_matches_jax_pallas():
    cfg_j = dataclasses.replace(JCFG, loop_impl="pallas")
    c, b, blocks = 4, 8192, 3
    x = _planes(c, b * blocks, seed=2)
    co_j, co_t = jdemod.make_coeffs(cfg_j), tdemod.make_coeffs(CFG)
    st_j = jdemod.demod_init_state(cfg_j, c)
    st_t = state_from_numpy(jax.tree.map(np.asarray, st_j))
    n_valid = 0
    for blk in range(blocks):
        xb = x[:, :, blk * b : (blk + 1) * b]
        st_j, oj = jdemod.demod_block(cfg_j, co_j, st_j, jnp.asarray(xb))
        st_t, ot = tdemod.demod_block(CFG, co_t, st_t, torch.from_numpy(xb))
        valid = np.asarray(oj["rds_valid"])
        np.testing.assert_array_equal(ot["rds_valid"].numpy(), valid)
        n_valid += int(valid.sum())
        np.testing.assert_allclose(ot["audio"].numpy(), np.asarray(oj["audio"]),
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(ot["rds_pred"].numpy()[valid],
                                   np.asarray(oj["rds_pred"])[valid],
                                   atol=1e-4, rtol=0)
        sj = jax.tree.map(np.asarray, st_j)
        stn = state_to_numpy(st_t)
        # K12 is the first stage, fed the same input as the JAX kernel: its
        # state keys hold the K12 tolerances of the kernel tests.  The keys
        # downstream of the pilot PLL see inputs that already differ (K12's
        # theta by up to 1e-4 cycles), so they hold the block-level output
        # tolerance, 1e-4, and the loops' phase errors (radians) 2*pi times
        # that.
        assert _leaf_err(stn["ds_fm_in"], sj["ds_fm_in"]) == 0
        for key, tol in (("disc_prev_theta", 1e-6), ("ds_fm_out", 2e-5),
                         ("hilbert", 2e-5), ("ds_audio_lpr", 1e-4),
                         ("ds_audio_lmr", 1e-4), ("ds_rds", 1e-4),
                         ("lmr_phase_err", 1e-4)):
            assert _leaf_err(stn[key], sj[key]) <= tol, key
        for key in ("peak_pilot", "deemph"):
            for h in ("x_hist", "y_hist"):
                assert _leaf_err(stn[key][h], sj[key][h]) <= 2e-4, (key, h)
        for name in sj["pll"]._fields:
            assert _leaf_err(getattr(stn["pll"], name),
                             getattr(sj["pll"], name)) <= 2 * np.pi * 1e-4, name
        for name in sj["bpsk"]._fields:
            assert _leaf_err(getattr(stn["bpsk"], name),
                             getattr(sj["bpsk"], name)) <= 1e-4, name
        for key in ("agc_pilot", "agc_rds"):
            np.testing.assert_allclose(stn[key], sj[key], rtol=2e-4,
                                       err_msg=key)
    # the TED clock fires about once per 8 samples (2 kHz at 16 kHz)
    assert n_valid > blocks * c * (b // 64) // 16


def test_demod_block_records_kernel_arguments():
    """``record`` keeps each kernel wrapper's arguments as demod_block
    passed them: replaying them reproduces the block's outputs, and later
    stages' state updates do not reach the recorded dicts."""
    from fm_radio_tpu_torch.kernels.bpsk import bpsk_sync
    from fm_radio_tpu_torch.kernels.k12 import k12

    c, b = 2, 8192
    co = tdemod.make_coeffs(CFG)
    st0 = tdemod.demod_init_state(CFG, c)
    st0, _ = tdemod.demod_block(CFG, co, st0,
                                torch.from_numpy(_planes(c, b, seed=5)))
    calls = {}
    _, outs = tdemod.demod_block(CFG, co, st0,
                                 torch.from_numpy(_planes(c, b, seed=6)),
                                 record=calls)
    assert list(calls) == ["k12", "pll", "extract", "bpsk"]
    k12_state = calls["k12"][2]
    assert k12_state is not st0 and k12_state["pll"] is st0["pll"]
    assert calls["extract"][2]["lmr_phase_err"] is st0["lmr_phase_err"]
    _, _, theta = k12(*calls["k12"])
    torch.testing.assert_close(theta, calls["pll"][2], atol=0, rtol=0)
    _, bouts = bpsk_sync(*calls["bpsk"])
    torch.testing.assert_close(bouts["pred"], outs["rds_pred"], atol=0,
                               rtol=0)


def test_demod_controls_and_reset_match_jax():
    """BroadcastFMDemod: a block, then update_controls (audio mode,
    de-emphasis, L+R cutoff: coefficients redesigned, state kept), then
    reset, each against the JAX demodulator on its default path."""
    b = 8192
    x = _planes(1, 3 * b, seed=4)
    jd = jdemod.BroadcastFMDemod(JCFG)
    td = tdemod.BroadcastFMDemod(CFG, device="cpu")
    for blk in range(3):
        if blk == 1:
            for d in (jd, td):
                d.update_controls(audio_out=AudioOut.LPR,
                                  use_deemphasis_filter=True,
                                  deemphasis_cutoff_us=50,
                                  audio_lpr_cutoff_hz=12000)
        if blk == 2:
            jd.reset()
            td.reset()
        xb = x[:, :, blk * b : (blk + 1) * b]
        oj, ot = jd.process(xb), td.process(xb[:, 0])
        np.testing.assert_array_equal(ot["rds_valid"], oj["rds_valid"])
        np.testing.assert_allclose(ot["audio"], oj["audio"], atol=1e-4,
                                   rtol=0, err_msg=f"block {blk}")
    np.testing.assert_array_equal(ot["audio"][..., 0], ot["audio"][..., 1])


@pytest.fixture(scope="module")
def station():
    """The test_e2e.py station (0.75 s, L = 1 kHz, R = 3 kHz, 0A + 2A
    groups), u8-quantized, through the port's App on the CPU."""
    iq = FMModulator(ModulatorConfig()).generate(
        BLOCK * 24, left_hz=1000.0, right_hz=3000.0, rds_groups=GROUPS)
    x8 = split_iq_i8(c64_to_u8(iq.astype(np.complex64)))[:, None, :]
    app = App(block_size=BLOCK, cfg=CFG, channels=1, device="cpu")
    app.process(x8)
    return x8, app


@pytest.mark.parametrize("loop_impl", ["auto", "pallas"])
def test_station_matches_jax_app(station, loop_impl):
    """RDS bytes bit-identical and audio >= 75 dB SNR against the JAX App,
    on its default CPU path (XLA scans) and on its Pallas kernels."""
    x8, app = station
    ja = JaxApp(block_size=BLOCK, channels=1,
                cfg=dataclasses.replace(JCFG, loop_impl=loop_impl))
    ja.process(x8)
    assert app.rds_bytes(0).size > 0
    np.testing.assert_array_equal(app.rds_bytes(0), ja.rds_bytes(0))
    settle = int(0.15 * app.demod.fs_audio)
    snr = snr_db(app.audio[0, settle:], ja.audio[0, settle:])
    assert snr >= SNR_MIN_DB, f"audio SNR {snr:.1f} dB vs JAX ({loop_impl})"


def test_station_passes_selftest_gates(station):
    from fm_radio_tpu_torch.apps.cli import selftest_checks

    _, app = station
    checks = selftest_checks(app)
    for name in ("left_tone_db", "right_tone_db", "stereo_separation_db",
                 "rds_pi"):
        assert checks[name]["pass"], (name, checks[name])
    decoded = [tuple(blk.data for blk in g)
               for g in app.rds_chains[0].chain.groups
               if all(blk.is_valid for blk in g)]
    for g in GROUPS:
        assert g in decoded, f"group {g} not recovered"


def test_app_reblocking_and_drain(station):
    """Arbitrary chunking gives the same output as whole blocks; drain
    detaches what accumulated and keeps the stream state."""
    x8, app = station
    n = 3 * BLOCK
    a1 = App(block_size=BLOCK, cfg=CFG, channels=1, device="cpu")
    a1.process(x8[..., :n])
    a2 = App(block_size=BLOCK, cfg=CFG, channels=1, device="cpu")
    for lo in range(0, n, 20000):
        a2.process(x8[:, 0, lo : min(lo + 20000, n)])  # [2, N] one channel
    np.testing.assert_array_equal(a1.audio, a2.audio)
    np.testing.assert_array_equal(a1.audio, app.audio[:, : n // 32])
    out = a2.drain()
    assert out["audio"].shape == (1, n // 32, 2) and a2.audio.shape[1] == 0
    assert len(out["rds_bytes"]) == 1 and len(out["log_lines"]) == 1


def test_cli_selftest(capsys, monkeypatch):
    """The CLI runs the station on the requested device and prints its JSON
    verdict; without a CUDA device the default (cuda) refuses with exit
    code 2 instead of falling back to the CPU.  (The gates themselves are
    held above on the 0.75 s station; chip_smoke.py runs the CLI's 2 s
    default on the card.)"""
    from fm_radio_tpu_torch.apps.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["selftest"]) == 2
    rc = main(["selftest", "--device", "cpu", "--seconds", "0.2", "-b", "8192"])
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == (0 if verdict["pass"] else 1)
    assert verdict["device"] == "cpu" and verdict["seconds_audio"] == 0.2
    assert set(verdict["checks"]) == {
        "left_tone_db", "right_tone_db", "stereo_separation_db",
        "rds_groups", "rds_pi", "rds_service_name"}
