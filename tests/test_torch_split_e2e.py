"""The default configuration's split path end to end, port (plain versions,
CPU tensors) against the JAX package.

Block level: ``demod_block`` on complex64, float32 planes, packed words
and int8 planes under ``DemodConfig()`` and its int8 variants, against JAX
``demod_block(loop_impl="pallas")`` (its Pallas kernels in interpret mode).
Station level: a 0.75 s station through both ``App``s on complex64
(``process_u8``) and on packed words (``integer_input=True``); the
wideband float32 bridge; the ``demod`` and ``bench`` commands.
"""

import json
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_radio_tpu.config import DemodConfig as JDemodConfig
from fm_radio_tpu.io.synth import (
    FMModulator,
    ModulatorConfig,
    make_wideband,
    station_group_schedule,
)
from fm_radio_tpu.models import demod as jdemod
from fm_radio_tpu.models import wideband as jwide
from fm_radio_tpu.models.app import App as JaxApp
from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.io.pcm import c64_to_u8
from fm_radio_tpu_torch.models import demod as tdemod
from fm_radio_tpu_torch.models import wideband as twide
from fm_radio_tpu_torch.models.app import App
from fm_radio_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
from fm_radio_tpu_torch.utils.transfer import pack_iq_u8, split_iq_i8

GROUPS = [
    (0x1234, (0 << 12) | (1 << 10) | 0b00000, 0xE101, 0x4142),  # 0A
    (0x1234, (2 << 12) | 0b00000, 0x4845, 0x4C4C),              # 2A
]
SNR_MIN_DB = 75.0
BLOCK = 32768


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small tensor ops; with pytest-xdist
    workers sharing the cores, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(**kw):
    """The port's and the JAX package's DemodConfig from the same keyword
    arguments."""
    return DemodConfig(**kw), JDemodConfig(**kw)


def snr_db(sig, ref):
    sig, ref = np.asarray(sig, np.float64), np.asarray(ref, np.float64)
    return 10 * np.log10(np.sum(ref ** 2) / (np.sum((sig - ref) ** 2) + 1e-30))


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


# case -> (input from (cf, u8) as numpy, DemodConfig kwargs)
CASES = {
    "complex": (lambda cf, u8: cf, {}),
    "f32_planes": (lambda cf, u8: np.stack([cf.real, cf.imag]), {}),
    "packed_words": (lambda cf, u8: pack_iq_u8(u8),
                     {"assume_integer_input": True}),
    "packed_words_int8": (lambda cf, u8: pack_iq_u8(u8),
                          {"frontend_int8": True}),
    "i8_frontend_f32": (lambda cf, u8: split_iq_i8(u8), {}),
    "i8_k12_off": (lambda cf, u8: split_iq_i8(u8),
                   {"frontend_int8": True, "k12_fusion": "off"}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_demod_block_split_matches_jax_pallas(case):
    """Two blocks from one start state: ``rds_valid`` exact, audio and
    pred within 1e-4 (test_torch_demod.py's block tolerances), the carried
    input tail exact."""
    make, kw = CASES[case]
    tcfg = DemodConfig(**kw)
    jcfg = JDemodConfig(loop_impl="pallas", **kw)
    c, b, blocks = 2, 8192, 2
    cf, u8 = _stations(c, b * blocks, seed=2)
    x = np.ascontiguousarray(make(cf, u8))
    co_j, co_t = jdemod.make_coeffs(jcfg), tdemod.make_coeffs(tcfg)
    st_j = jdemod.demod_init_state(jcfg, c)
    st_t = state_from_numpy(jax.tree.map(np.asarray, st_j))
    for blk in range(blocks):
        xb = np.ascontiguousarray(x[..., blk * b : (blk + 1) * b])
        st_j, oj = jdemod.demod_block(jcfg, co_j, st_j, jnp.asarray(xb))
        st_t, ot = tdemod.demod_block(tcfg, co_t, st_t, torch.from_numpy(xb))
        valid = np.asarray(oj["rds_valid"])
        np.testing.assert_array_equal(ot["rds_valid"].numpy(), valid)
        np.testing.assert_allclose(ot["audio"].numpy(),
                                   np.asarray(oj["audio"]), atol=1e-4, rtol=0)
        np.testing.assert_allclose(ot["rds_pred"].numpy()[valid],
                                   np.asarray(oj["rds_pred"])[valid],
                                   atol=1e-4, rtol=0)
        np.testing.assert_array_equal(state_to_numpy(st_t)["ds_fm_in"],
                                      np.asarray(st_j["ds_fm_in"]))


@pytest.fixture(scope="module")
def station_u8():
    """The test_e2e.py station (0.75 s, L = 1 kHz, R = 3 kHz, 0A + 2A
    groups) as u8 IQ [N, 2]."""
    iq = FMModulator(ModulatorConfig()).generate(
        BLOCK * 24, left_hz=1000.0, right_hz=3000.0, rds_groups=GROUPS)
    return c64_to_u8(iq.astype(np.complex64))


@pytest.mark.parametrize("ingest", ["complex64", "packed_words"])
def test_station_split_path_matches_jax_app(station_u8, ingest):
    """The station through the port's App and the JAX App under their
    default ``DemodConfig()``: on complex64 through ``process_u8``, and on
    packed words with ``integer_input=True`` (``demod --ingest f32w``).
    RDS bytes identical, audio >= 75 dB SNR against JAX."""
    kw = {"integer_input": ingest == "packed_words"}
    app = App(block_size=BLOCK, channels=1, device="cpu", **kw)
    ja = JaxApp(block_size=BLOCK, channels=1, **kw)
    for a in (app, ja):
        if ingest == "complex64":
            a.process_u8(station_u8)
        else:
            a.process(pack_iq_u8(station_u8))
    assert app.cfg.frontend_int8 is False and app.cfg.k12_fusion == "auto"
    assert app.rds_bytes(0).size > 0
    np.testing.assert_array_equal(app.rds_bytes(0), ja.rds_bytes(0))
    settle = int(0.15 * app.demod.fs_audio)
    snr = snr_db(app.audio[0, settle:], ja.audio[0, settle:])
    assert snr >= SNR_MIN_DB, f"audio SNR {snr:.1f} dB vs JAX ({ingest})"


def test_app_keeps_one_format_per_stream(station_u8):
    """A stream keeps one format: switching with samples pending raises
    (app.py:68-83); after a whole block, with nothing pending, it may."""
    app = App(block_size=8192, channels=1, device="cpu", decode_rds=False)
    app.process_u8(station_u8[:1000])
    with pytest.raises(ValueError, match="format changed mid-stream"):
        app.process(pack_iq_u8(station_u8[1000:2000]))
    app.process_u8(station_u8[1000:8192])
    assert app._pending.shape == (1, 0)
    app.process(pack_iq_u8(station_u8[8192:16384]))
    assert app.audio.shape == (1, 2 * 8192 // 32, 2)
    assert app.rds_chains == []


def test_wideband_f32_bridge_matches_jax():
    """``wideband_demod_block(bridge="f32")`` at M = 8 against JAX's
    (loop_impl="pallas"): exact channel planes into K1 on float32 planes,
    then K2, under ``DemodConfig()``; 5 blocks of 32,768 per channel.  The
    station's audio >= 75 dB SNR over all blocks, the filterbank state
    exact, and in the first block ``rds_valid`` exact and pred within
    1e-4.  (Later blocks are not compared symbol for symbol, nor are the
    RDS bytes: over 160 ms the BPSK clock is still acquiring — neither
    package decodes a group yet — and acquisition turns float32
    differences into decisions a sample apart; measured on the CPU: 0 of
    the first block's decisions differ, 50 of the second's.)"""
    m, b, blocks, channel = 8, 32768, 5, 3
    tcfg, _ = cfgs()
    jcfg = JDemodConfig(loop_impl="pallas")
    co_j, co_t = jdemod.make_coeffs(jcfg), tdemod.make_coeffs(tcfg)
    groups = station_group_schedule(0xBEEF, ps="WIDEBAND")
    iq = FMModulator(ModulatorConfig()).generate(
        b * blocks, left_hz=800.0, right_hz=1600.0, rds_groups=groups)
    wide = make_wideband({channel: iq}, m)
    wide *= 100.0 / np.abs(wide).max()
    words = pack_iq_u8(c64_to_u8(wide.astype(np.complex64)))[None]
    st_j = jwide.wideband_init_state(jcfg, m, 1)
    st_t = state_from_numpy(jax.tree.map(np.asarray, st_j))
    t = m * b
    audio = ([], [])
    for blk in range(blocks):
        xb = np.ascontiguousarray(words[:, blk * t : (blk + 1) * t])
        calls = {}
        st_j, oj = jwide.wideband_demod_block(jcfg, co_j, None, st_j,
                                              jnp.asarray(xb), m,
                                              bridge="f32")
        st_t, ot = twide.wideband_demod_block(tcfg, co_t, None, st_t,
                                              torch.from_numpy(xb), m,
                                              bridge="f32", record=calls)
        assert calls["channelizer"][4:] == ("f32", 3) and "frontend" in calls
        audio[0].append(np.asarray(oj["audio"])[channel])
        audio[1].append(ot["audio"].numpy()[channel])
        if blk == 0:
            valid = np.asarray(oj["rds_valid"])
            np.testing.assert_array_equal(ot["rds_valid"].numpy(), valid)
            np.testing.assert_allclose(ot["rds_pred"].numpy()[valid],
                                       np.asarray(oj["rds_pred"])[valid],
                                       atol=1e-4, rtol=0)
    a_j, a_t = (np.concatenate(a) for a in audio)
    assert np.sqrt(np.mean(a_t ** 2)) > 1e-3
    assert snr_db(a_t, a_j) >= SNR_MIN_DB
    for a, b_ in zip(state_to_numpy(st_t)["chan"],
                     jax.tree.map(np.asarray, st_j)["chan"]):
        np.testing.assert_array_equal(a, b_)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """0.5 s of the selftest station as a u8 IQ capture on disk."""
    from fm_radio_tpu_torch.apps.cli import selftest_u8

    path = tmp_path_factory.mktemp("cap") / "station.pcm"
    selftest_u8(0.5, 8192).tofile(path)
    return path


def test_cli_demod_f32w(capture, tmp_path, capsys):
    """``demod --ingest f32w --device cpu``: the WAV and the RDS summary,
    and the audio the App gives on the same packed words under
    ``DemodConfig()`` with integer input."""
    from fm_radio_tpu_torch.apps.cli import main
    from fm_radio_tpu_torch.io.pcm import packed_input

    wav = tmp_path / "out.wav"
    assert main(["demod", "-i", str(capture), "-o", str(wav), "--ingest",
                 "f32w", "-b", "8192", "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["pi_code"] == "1234"
    with wave.open(str(wav)) as w:
        assert (w.getnchannels(), w.getframerate()) == (2, 32000)
        frames = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    app = App(block_size=8192, channels=1, integer_input=True, device="cpu",
              decode_rds=False)
    app.process(packed_input(str(capture))[0:len(packed_input(str(capture)))])
    assert frames.size == app.audio[0].size
    assert app.cfg.assume_integer_input and not app.cfg.frontend_int8


def test_cli_demod_unported_flags_and_no_card(capture, monkeypatch, capsys):
    """The flags that need unported modules exit 2 naming the ROADMAP
    item; without a CUDA device the default (cuda) refuses instead of
    falling back to the CPU."""
    from fm_radio_tpu_torch.apps.cli import main

    for flags, item in ((["--taps", "out"], "item 2"),
                        (["--save-state", "s.npz"], "item 4"),
                        (["--rate", "48000"], "item 7"),
                        (["--play", "-"], "item 7"),
                        (["--play-format", "s16"], "item 7")):
        assert main(["demod", "-i", str(capture), *flags]) == 2
        assert f"ROADMAP.md, modules still to port, {item}" in \
            capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["demod", "-i", str(capture)]) == 2
    assert main(["bench", "-c", "1"]) == 2


def test_cli_bench_cpu(capture, capsys):
    """``bench --device cpu`` on the capture (its two 8192-sample blocks):
    complex64 under ``DemodConfig()``, the JAX command's JSON keys and the
    device."""
    from fm_radio_tpu_torch.apps.cli import main

    assert main(["bench", "-i", str(capture), "-b", "8192", "-c", "2",
                 "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"channels", "block_size", "seconds",
                        "aggregate_msps", "per_channel_realtime_x",
                        "device"}
    assert (out["channels"], out["block_size"], out["device"]) == (
        2, 8192, "cpu")
    assert out["aggregate_msps"] > 0
