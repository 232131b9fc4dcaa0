"""The port's wideband commands against the JAX package's, in the same
process, on the CPU (the port's plain versions): ``stations`` (also with
``--rds-native``) and ``selftest --stations`` on the JAX commands'
pipeline (the channelizer streamed chunk by chunk, the selected rows as
complex64 into one ``App``), ``scan`` and ``channelize``; and
``stream_selected`` at lengths the channelizer kernel's block does not
divide.

The JAX commands run through their own parser (``build_parser()``, the
function ``main`` calls after it switches on the XLA compilation cache).
Each command's ``App`` is caught by a subclass put in place of the
module's ``App`` while the command runs, so that its RDS bytes can be
compared; audio is held to ``SNR_MIN_DB`` (the golden bar,
``tests/test_torch_split_e2e.py``).
"""

import contextlib
import dataclasses
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_radio_tpu.apps import cli as jcli
from fm_radio_tpu.io.wav import read_wav_int16
from fm_radio_tpu.models import app as japp
from fm_radio_tpu.parallel import channelizer as jch
from fm_radio_tpu_torch.apps import cli as tcli
from fm_radio_tpu_torch.io.pcm import c64_to_u8
from fm_radio_tpu_torch.io.synth import FMModulator, ModulatorConfig
from fm_radio_tpu_torch.kernels.channelizer import T_MULTIPLE
from fm_radio_tpu_torch.models import app as tapp
from fm_radio_tpu_torch.parallel import channelizer as tch

SNR_MIN_DB = 75.0
# RDS bytes of the BPSK's lock acquisition, 32 bytes = 0.22 s of RDS at
# 1,187.5 bit/s, where the port is held to either of the JAX package's two
# routes (XLA, which its command runs on the CPU, and its Pallas kernels in
# interpret mode, ``loop_impl="pallas"``): on the channelizer's output (a
# station at ~8 of the u8 grid's 127 after the 1/M descale) the symbol
# clock's first decisions follow rounding, and the two routes give
# different bytes there on the stations capture below
# (:func:`assert_rds_match` shows it); every byte after it, every decoded
# group and the database are the XLA route's.  (On the selftest's capture
# the port gives the JAX command's bytes, all of them.)
ACQ_BYTES = 32
# the Motivation capture: stations 1 and 2 of an M = 8 grid, 48 blocks
M, BLOCK = 8, 16384
N_CH = 48 * BLOCK


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small tensor ops; with pytest-xdist
    workers sharing the cores, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def snr_db(sig, ref) -> float:
    sig, ref = np.asarray(sig, np.float64), np.asarray(ref, np.float64)
    return 10 * np.log10(np.sum(ref ** 2) / (np.sum((sig - ref) ** 2) + 1e-30))


def run_cli(which: str, argv: list, monkeypatch, route: str | None = None):
    """Run one package's command; returns (exit code, stdout, the Apps it
    made).  ``route``: the JAX Apps' ``loop_impl`` ("pallas": its Pallas
    kernels, in interpret mode on the CPU)."""
    mod = tapp if which == "port" else japp
    apps = []

    class Caught(mod.App):
        def __init__(self, *a, **kw):
            if route is not None:
                kw["cfg"] = dataclasses.replace(
                    kw.get("cfg", mod.DemodConfig()), loop_impl=route)
            super().__init__(*a, **kw)
            apps.append(self)

    monkeypatch.setattr(mod, "App", Caught)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if which == "port":
            rc = tcli.main(argv + ["--device", "cpu"])
        else:
            args = jcli.build_parser().parse_args(argv)
            rc = args.fn(args)
    monkeypatch.setattr(mod, "App", mod.App.__mro__[1])
    return rc or 0, out.getvalue(), apps


@pytest.fixture(scope="module")
def wide_pcm(tmp_path_factory):
    path = tmp_path_factory.mktemp("wide") / "wide.pcm"
    tcli.wideband_capture(2, M, N_CH).tofile(path)
    return str(path)


@pytest.fixture(scope="module")
def jax_stations(wide_pcm, tmp_path_factory):
    """The JAX command on the capture: its JSON and App, and the App of
    the same command on JAX's Pallas route."""
    apps = {}
    for route in (None, "pallas"):
        out = str(tmp_path_factory.mktemp("jax_stations"))
        with pytest.MonkeyPatch.context() as mp:
            rc, stdout, (apps[route],) = run_cli(
                "jax", ["stations", "-i", wide_pcm, "-o", out, "-m", str(M),
                        "-b", str(BLOCK), "--select", "1,2"], mp, route)
        assert rc == 0
        if route is None:
            summary = json.loads(stdout)
    return summary, apps[None], apps["pallas"]


def assert_rds_match(t_app, j_app, p_app, channels: int) -> None:
    """Each channel's RDS: the same byte count, every byte past the lock
    acquisition (ACQ_BYTES) the JAX command's, and the same group log
    lines; every byte that of one of JAX's two routes (``j_app`` XLA,
    ``p_app`` Pallas), which agree past ACQ_BYTES and differ within it on
    some channel."""
    apart = []
    for i in range(channels):
        a, b, c = t_app.rds_bytes(i), j_app.rds_bytes(i), p_app.rds_bytes(i)
        assert a.size == b.size == c.size > ACQ_BYTES
        np.testing.assert_array_equal(a[ACQ_BYTES:], b[ACQ_BYTES:])
        np.testing.assert_array_equal(c[ACQ_BYTES:], b[ACQ_BYTES:])
        assert np.array_equal(a, b) or np.array_equal(a, c), i
        assert t_app.rds_log_lines(i) == j_app.rds_log_lines(i)
        apart.append(not np.array_equal(b, c))
    assert any(apart)


def _without_wav(summary: list) -> list:
    return [{k: v for k, v in s.items() if k != "wav"} for s in summary]


@pytest.mark.parametrize("rds", ["python", "native"])
def test_stations_matches_jax(rds, wide_pcm, jax_stations, tmp_path,
                              monkeypatch):
    """The capture and command of the fault the port's ``stations`` had
    (it ran every channel through the int8 bridge: channel 1 decoded as PI
    36B3 without a name, audio 33-34 dB against JAX's): the JSON summary
    equal to the JAX command's but for the WAV paths (JAX: PI 1234 "ST
    01", 1235 "ST 02"), each WAV >= SNR_MIN_DB against JAX's.  With the
    Python chain the RDS bytes match (:func:`assert_rds_match`);
    ``--rds-native`` decodes on the C++ runtime (no byte artifact) to the
    same summary and group log lines (and at most one more group at the
    end: the native loops also take the last bytes short of 16)."""
    if rds == "native":
        from fm_radio_tpu_torch import runtime

        if not runtime.available():
            pytest.skip("no C++ compiler: the native runtime cannot build")
    j_summary, j_app, p_app = jax_stations
    out = tmp_path / "port"
    rc, stdout, apps = run_cli(
        "port", ["stations", "-i", wide_pcm, "-o", str(out), "-m", str(M),
                 "-b", str(BLOCK), "--select", "1,2"]
        + (["--rds-native"] if rds == "native" else []), monkeypatch)
    assert rc == 0
    summary = json.loads(stdout)
    assert _without_wav(summary) == _without_wav(j_summary)
    assert [(s["pi_code"], s["service_name"]) for s in summary] == [
        ("1234", "ST 01   "), ("1235", "ST 02   ")]
    (app,) = apps
    for i, (s, js) in enumerate(zip(summary, j_summary)):
        a, fs = read_wav_int16(s["wav"])
        b, jfs = read_wav_int16(js["wav"])
        assert fs == jfs == 32000 and a.shape == b.shape
        assert snr_db(a, b) >= SNR_MIN_DB
        if rds == "native":
            # the native loops take every whole byte, the Python chain
            # bytes in 16s (app.cpp:16): trailing groups may be extra
            lines, j_lines = app.rds_log_lines(i), j_app.rds_log_lines(i)
            assert lines[: len(j_lines)] == j_lines
            assert len(lines) <= len(j_lines) + 1
    if rds == "python":
        assert_rds_match(app, j_app, p_app, 2)


def test_selftest_stations_matches_jax(monkeypatch):
    """``selftest --stations 2 --seconds 1 -b 16384`` (2 stations, M = 4,
    62 blocks) in both packages: the port's verdict passes its gates, and
    its App gives the JAX selftest App's RDS bytes, every one of them, and
    group log lines, and >= SNR_MIN_DB audio per station."""
    argv = ["selftest", "--stations", "2", "--seconds", "1.0", "-b", "16384"]
    rc, stdout, (t_app,) = run_cli("port", argv, monkeypatch)
    verdict = json.loads(stdout.strip().splitlines()[-1])
    assert rc == 0 and verdict["pass"], verdict
    assert verdict["mode"] == "wideband x2 (m=4)"
    rc, stdout, (j_app,) = run_cli("jax", argv, monkeypatch)
    assert json.loads(stdout.strip().splitlines()[-1])["pass"]
    for i in range(2):
        assert t_app.rds_bytes(i).size > 0
        np.testing.assert_array_equal(t_app.rds_bytes(i), j_app.rds_bytes(i))
        assert t_app.rds_log_lines(i) == j_app.rds_log_lines(i)
        assert snr_db(t_app.audio[i], j_app.audio[i]) >= SNR_MIN_DB


def _words(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, n) * 256
            + rng.integers(0, 256, n)).astype(np.float32)


@pytest.mark.parametrize("m,k,chunk_min,extra", [
    (8, 16, 1 << 22, 5),        # one chunk, 5 frames past the kernel's block
    (8, 16, 5000, 5),           # chunks of 625 frames: every chunk padded
    (32, 16, 3 * 4096 + 96, 3),  # chunks that split a 4,096-sample block
    (4, 1, 4096 * 4 + 12, 7),   # no carried tail (K = 1)
    (16, 17, 2048, 1),          # chunks shorter than the carried tail
])
def test_stream_selected_matches_jax(m, k, chunk_min, extra):
    """Lengths of 3 * 4,096 * M + extra * M words (+ 3 words past the last
    whole frame, dropped by both), chunk sizes that split the kernel's
    block: the rows handed to ``consume`` within 8 float32 ulp of their
    max |y| of JAX's (the bound of test_channelize_plain_matches_xla_oracle:
    only the DFT's summation order differs), the returned state equal."""
    n = 3 * T_MULTIPLE * m + extra * m + 3
    w = _words(n, seed=m + k)
    taps = tch.make_channelizer_taps(m, k)
    sel = [1, m - 1, 0]
    got_j, got_t = [], []
    st_j = jch.stream_selected(taps, jch.channelizer_init_state(m, k), w, m,
                               sel, got_j.append, chunk_min=chunk_min)
    st_t = tch.stream_selected(taps, tch.channelizer_init_state(m, k), w, m,
                               sel, got_t.append, chunk_min=chunk_min)
    assert [a.shape for a in got_t] == [a.shape for a in got_j]
    a, b = np.concatenate(got_t, 1), np.concatenate(got_j, 1)
    assert a.dtype == b.dtype == np.complex64
    assert a.shape == (3, (n - 3) // m)
    bound = 8 * np.finfo(np.float32).eps * np.abs(b).max()
    np.testing.assert_allclose(a, b, atol=bound, rtol=0)
    np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))


def test_channelize_frames_keeps_real_frames():
    """A stream cut at lengths that are not multiples of the kernel's
    block gives the one-shot stream's outputs and state exactly (the
    padding reaches no real frame), and an empty cut keeps the state."""
    m, k = 8, 16
    w = torch.from_numpy(_words(5 * T_MULTIPLE + 40 * m, seed=2))
    taps = tch.make_channelizer_taps(m, k)
    st0 = tch.channelizer_init_state(m, k)
    st_one, y_one = tch.channelize_frames(taps, st0, w, m)
    st, parts = st0, []
    for lo, hi in ((0, 8), (8, 8), (8, 4096 + 72), (4096 + 72, w.numel())):
        st, y = tch.channelize_frames(taps, st, w[lo:hi], m)
        parts.append(y)
    torch.testing.assert_close(torch.cat(parts, 1), y_one, rtol=0, atol=0)
    torch.testing.assert_close(st, st_one, rtol=0, atol=0)
    with pytest.raises(ValueError, match="whole frames"):
        tch.channelize_frames(taps, st0, w[:12], m)


@pytest.fixture(scope="module")
def scan_pcm(tmp_path_factory):
    """JAX tests/test_cli.py:148-168's capture: a stereo + RDS station
    (PI CAFE) at +1.024 MHz of a 4-channel capture, 40 blocks of 16,384."""
    m, fs_ch, n_ch = 4, 1_024_000, 16384 * 40
    n_wide = n_ch * m
    groups = [(0xCAFE, (0 << 12) | (1 << 10), 0xE101, 0x5A5A)]
    iq = FMModulator(ModulatorConfig()).generate(
        n_ch, left_hz=800.0, right_hz=1600.0, rds_groups=groups)
    t = np.arange(n_wide) / (fs_ch * m)
    wide = (np.repeat(iq, m)[:n_wide]
            * np.exp(2j * np.pi * fs_ch * t)).astype(np.complex64)
    wide /= np.abs(wide).max() / 100.0
    path = tmp_path_factory.mktemp("scan") / "wide.pcm"
    c64_to_u8(wide).tofile(path)
    return str(path)


def test_scan_matches_jax(scan_pcm, monkeypatch):
    """``scan -m 4 -b 32768 --seconds 0.6``: the same JSON as the JAX
    command's, the powers within 0.1 dB (they are rounded to 0.1 dB from
    sums in another order), the same ``select`` ("1") and station
    (stereo, PI CAFE)."""
    argv = ["scan", "-i", scan_pcm, "-m", "4", "-b", "32768", "--seconds",
            "0.6"]
    rc_t, out_t, _ = run_cli("port", argv, monkeypatch)
    rc_j, out_j, _ = run_cli("jax", argv, monkeypatch)
    assert rc_t == 0 and rc_j in (0, None)
    t, j = json.loads(out_t), json.loads(out_j)
    db_keys = ("power_db", "above_floor_db")
    assert abs(t.pop("noise_floor_db") - j.pop("noise_floor_db")) <= 0.1 + 1e-9
    for st, sj in zip(t["active"], j["active"]):
        for key in db_keys:
            assert abs(st.pop(key) - sj.pop(key)) <= 0.1 + 1e-9
    assert t == j
    assert t["select"] == "1"
    assert t["active"] == [{"channel": 1, "offset_hz": 1_024_000,
                            "stereo": True, "pi": "CAFE", "ps": "ZZ"}]


def test_channelize_matches_jax(scan_pcm, tmp_path, monkeypatch):
    """``channelize -m 4``: the same files, of the same lengths, every
    byte within 1 of the JAX command's (one common scale; the DFT's
    summation order may move a sample across a rounding boundary)."""
    outs = {}
    for which in ("port", "jax"):
        out = tmp_path / which
        rc, stdout, _ = run_cli(
            which, ["channelize", "-i", scan_pcm, "-o", str(out), "-m", "4"],
            monkeypatch)
        assert rc in (0, None)
        assert stdout.strip() == f"wrote 4 channel files to {out}"
        outs[which] = out
    names = sorted(os.listdir(outs["jax"]))
    assert sorted(os.listdir(outs["port"])) == names == [
        f"channel_{k:02d}.pcm" for k in range(4)]
    for name in names:
        a = np.fromfile(outs["port"] / name, np.uint8).astype(int)
        b = np.fromfile(outs["jax"] / name, np.uint8).astype(int)
        assert a.size == b.size == 2 * 16384 * 40
        assert np.abs(a - b).max() <= 1


def test_channel_powers_window_in_whole_frames():
    """The scan window is cut to whole frames of M, as the JAX package
    cuts it (not to the kernel's 4,096-sample block): powers within 0.01
    dB of JAX's ``_channel_powers_db`` at a window of 3 * 4,096 + 24
    samples."""
    m, k = 8, 16
    w = _words(4 * T_MULTIPLE, seed=9)
    window = 3 * T_MULTIPLE + 3 * m + 5
    t = tcli.channel_powers_db(w, m, k, window, "cpu")
    j = jcli._channel_powers_db(w, m, k, window)
    np.testing.assert_allclose(t, j, atol=0.01, rtol=0)
    assert jnp.asarray(j).shape == (m,)
