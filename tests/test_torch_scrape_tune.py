"""The port's ``scrape`` and ``tune`` against the JAX package's commands,
in the same process, on the CPU (the port's plain versions), and the
tuner's mix-down ``ops/mixer.py::freq_shift_p`` against JAX's.

``scrape`` on JAX tests/test_cli.py's 32-block station (PI BEEF, name
"FT", L = R), both ingests: the RDS ``.bin`` byte for byte, the WAV's
L + R >= ``SNR_MIN_DB`` (the golden bar) and its stereo >=
``STEREO_MIN_DB`` against JAX's after the loops' 0.15 s lock-in;
``--stream`` (the native runtime's reader and WAV writer) against batch:
the same ``.bin`` and the same WAV after its 44-byte header (JAX
tests/test_cli.py:314-338).
``tune`` on JAX tests/test_cli.py:217-250's capture (a station at +1.024
MHz of a 4.096 Msps capture): the JSON line equal, the RDS bytes
identical, the WAV >= SNR_MIN_DB, its tone at 1,500 +- 20 Hz.  The JAX
commands run through their own parser (``build_parser()``, the function
``main`` calls after it switches on the XLA compilation cache).
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
from fm_radio_tpu.ops import mixer as jmixer
from fm_radio_tpu_torch.apps import cli as tcli
from fm_radio_tpu_torch.io.pcm import c64_to_u8
from fm_radio_tpu_torch.io.synth import FMModulator, ModulatorConfig
from fm_radio_tpu_torch.ops import mixer as tmixer

SNR_MIN_DB = 75.0
# scrape's station has L = R: its L-R carries no tone, and the L-R phase
# estimate (a sign test on the phase of what is left, JAX
# models/demod.py:557-565) follows rounding, so the stereo WAV is held to
# this against the JAX command's and its L + R mix to SNR_MIN_DB.  JAX's
# own two routes (XLA, which its command runs on the CPU, and its Pallas
# kernels in interpret mode, ``loop_impl="pallas"``) are 68.5 dB apart in
# stereo there on both ingests; the port's stereo is held to SNR_MIN_DB
# against the nearer of the two (95.0 dB from the Pallas route on i8,
# 101.7 from XLA on f32w), and the test shows the routes < SNR_MIN_DB apart
STEREO_MIN_DB = 65.0
BLOCK = 16384


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


def run_cli(which: str, argv: list, route: str | None = None) -> tuple:
    """(exit code, stdout lines) of one package's command; ``route``: the
    JAX command's ``loop_impl`` ("pallas": its Pallas kernels, in
    interpret mode on the CPU)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.MonkeyPatch.context() as mp:
        if route is not None:
            class Routed(japp.App):
                def __init__(self, *a, **kw):
                    kw["cfg"] = dataclasses.replace(
                        kw.get("cfg", japp.DemodConfig()), loop_impl=route)
                    super().__init__(*a, **kw)

            mp.setattr(japp, "App", Routed)
        if which == "port":
            rc = tcli.main(argv + ["--device", "cpu"])
        else:
            args = jcli.build_parser().parse_args(argv)
            rc = args.fn(args)
    return rc or 0, out.getvalue().strip().splitlines()


def artifacts(d) -> tuple:
    """(WAV bytes, RDS .bin bytes) of a scraper directory."""
    (wav,) = [f for f in os.listdir(d) if f.endswith(".wav")]
    (bin_,) = [f for f in os.listdir(d) if f.endswith(".bin")]
    return (open(os.path.join(d, wav), "rb").read(),
            open(os.path.join(d, bin_), "rb").read())


def wav_frames(blob: bytes) -> np.ndarray:
    return np.frombuffer(blob[44:], "<i2").reshape(-1, 2)


def wav_snr_db(port: bytes, jax: bytes, mix: str = "stereo") -> float:
    """SNR of the port's WAV against JAX's after the loops' lock-in, 0.15 s
    (as tests/test_torch_demod.py holds a station's audio): both channels,
    or their sum (``mix="mid"``, L + R)."""
    a, b = wav_frames(port), wav_frames(jax)
    assert a.shape == b.shape
    a, b = (x[int(0.15 * 32000):].astype(np.float64) for x in (a, b))
    if mix == "mid":
        a, b = a.sum(1), b.sum(1)
    return snr_db(a, b)


@pytest.fixture(scope="module")
def station_pcm(tmp_path_factory):
    """JAX tests/test_cli.py's station: 32 blocks of 16,384 (0.5 s),
    1 kHz both sides, one 0A group (PI BEEF, name "FT")."""
    groups = [(0xBEEF, (0 << 12) | 0b00000, 0x0000, 0x4654)]
    iq = FMModulator(ModulatorConfig()).generate(
        BLOCK * 32, left_hz=1000.0, right_hz=1000.0, rds_groups=groups)
    path = tmp_path_factory.mktemp("pcm") / "test.pcm"
    c64_to_u8(iq).tofile(path)
    return str(path)


@pytest.fixture(scope="module")
def port_scrape(station_pcm, tmp_path_factory):
    """The port's batch ``scrape -b 16384 --ingest {ingest}`` on the
    station, run once an ingest: ingest -> (output directory, stdout
    lines)."""
    runs = {}

    def run(ingest: str):
        if ingest not in runs:
            d = tmp_path_factory.mktemp(f"port_{ingest}")
            rc, lines = run_cli("port", [
                "scrape", "-i", station_pcm, "-b", str(BLOCK), "--ingest",
                ingest, "-o", str(d)])
            assert rc == 0
            runs[ingest] = (d, lines)
        return runs[ingest]

    return run


@pytest.mark.parametrize("ingest", ["i8", "f32w"])
def test_scrape_matches_jax(ingest, station_pcm, port_scrape, tmp_path):
    """``scrape -b 16384 --ingest {i8, f32w}``: one WAV and one RDS file
    each, the RDS bytes identical to the JAX command's, the WAV's header
    equal, its L + R >= SNR_MIN_DB and its stereo >= STEREO_MIN_DB against
    JAX's (:func:`wav_snr_db`; the station has L = R, see STEREO_MIN_DB);
    its stereo >= SNR_MIN_DB against one of JAX's two routes, which are
    less than that apart."""
    dirs, lines = {"jax": tmp_path / "jax", "pallas": tmp_path / "pallas"}, {}
    dirs["port"], lines["port"] = port_scrape(ingest)
    for which, route in (("jax", None), ("pallas", "pallas")):
        rc, lines[which] = run_cli("jax", [
            "scrape", "-i", station_pcm, "-b", str(BLOCK), "--ingest",
            ingest, "-o", str(dirs[which])], route)
        assert rc == 0
    for which, d in dirs.items():
        (wav,) = [f for f in os.listdir(d) if f.endswith(".wav")]
        (bin_,) = [f for f in os.listdir(d) if f.endswith(".bin")]
        assert lines[which] == [f"wrote {d / wav} and {d / bin_}"]
    (w_t, b_t), (w_j, b_j), (w_p, b_p) = (
        artifacts(dirs[w]) for w in ("port", "jax", "pallas"))
    assert len(b_t) > 0 and b_t == b_j == b_p
    assert len(w_t) == len(w_j) and w_t[:44] == w_j[:44]
    assert wav_snr_db(w_t, w_j, "mid") >= SNR_MIN_DB
    assert wav_snr_db(w_t, w_j) >= STEREO_MIN_DB
    assert max(wav_snr_db(w_t, w) for w in (w_j, w_p)) >= SNR_MIN_DB
    assert wav_snr_db(w_p, w_j) < SNR_MIN_DB


@pytest.mark.parametrize("ingest", ["i8", "f32w"])
def test_scrape_stream_matches_batch(ingest, station_pcm, port_scrape,
                                     tmp_path):
    """``scrape --stream`` (the native runtime's prefetching reader and
    WAV writer, a block at a time) against batch mode: the same RDS
    bytes and the same WAV after its header (the header's size fields
    may differ), the same length."""
    from fm_radio_tpu_torch import runtime

    if not runtime.available():
        pytest.skip("no C++ compiler: the native runtime cannot build")
    d1, d2 = port_scrape(ingest)[0], tmp_path / "stream"
    rc, lines = run_cli("port", [
        "scrape", "-i", station_pcm, "-b", str(BLOCK), "--ingest", ingest,
        "-o", str(d2), "--stream"])
    assert rc == 0 and lines[-1].endswith("(streamed)")
    (w1, b1), (w2, b2) = artifacts(d1), artifacts(d2)
    assert len(b1) > 0 and b1 == b2
    assert len(w1) == len(w2) and w1[44:] == w2[44:]


def test_scrape_stream_without_runtime(station_pcm, tmp_path, monkeypatch,
                                       capsys):
    """Where the native runtime cannot be built, ``--stream`` exits 1 with
    the build's error (the JAX command's exit), writing nothing, and does
    not fall back to batch mode; stdin is refused the same way."""
    from fm_radio_tpu_torch import runtime

    def no_runtime():
        raise runtime.NativeRuntimeUnavailable("no C++ compiler found")

    monkeypatch.setattr(runtime, "load", no_runtime)
    out = tmp_path / "out"
    assert tcli.main(["scrape", "-i", station_pcm, "-o", str(out),
                      "--stream", "--device", "cpu"]) == 1
    assert "needs the native runtime: no C++ compiler found" in \
        capsys.readouterr().err
    assert not out.exists()
    assert tcli.main(["scrape", "-o", str(out), "--stream", "--device",
                      "cpu"]) == 1
    assert "--stream needs a file input" in capsys.readouterr().err


@pytest.fixture(scope="module")
def tune_pcm(tmp_path_factory):
    """JAX tests/test_cli.py:217-250's capture: a station (PI CAFE, 1.5
    kHz both sides) held 4 samples a sample at 4.096 Msps and moved to
    +1.024 MHz, 32 blocks of 16,384 per channel, halved for headroom."""
    m, fs_ch, n_ch = 4, 1_024_000, BLOCK * 32
    groups = [(0xCAFE, (0 << 12) | 0b00000, 0x0000, 0x4654)]
    iq = FMModulator(ModulatorConfig()).generate(
        n_ch, left_hz=1500.0, right_hz=1500.0, rds_groups=groups)
    n_wide = n_ch * m
    t = np.arange(n_wide) / (fs_ch * m)
    wide = (np.repeat(iq, m)[:n_wide]
            * np.exp(2j * np.pi * fs_ch * t)).astype(np.complex64)
    path = tmp_path_factory.mktemp("tune") / "wide.pcm"
    c64_to_u8(wide / 2.0).tofile(path)
    return str(path)


def test_tune_matches_jax(tune_pcm, tmp_path):
    """``tune -r 4096000 -f 1024000 -b 16384``: the JSON line (the
    database, second to last, where JAX's test reads it) equal to the JAX
    command's, the RDS bytes identical, the WAV >= SNR_MIN_DB against
    JAX's (:func:`wav_snr_db`) and its tone at 1,500 +- 20 Hz."""
    lines, arts = {}, {}
    for which in ("port", "jax"):
        d = tmp_path / which
        rc, lines[which] = run_cli(which, [
            "tune", "-i", tune_pcm, "-r", "4096000", "-f", "1024000", "-b",
            str(BLOCK), "-o", str(d)])
        assert rc == 0
        arts[which] = artifacts(d)
        (wav,) = [f for f in os.listdir(d) if f.endswith(".wav")]
        (bin_,) = [f for f in os.listdir(d) if f.endswith(".bin")]
        assert lines[which][-1] == f"wrote {d / wav} and {d / bin_}"
    info = json.loads(lines["port"][-2])
    assert info == json.loads(lines["jax"][-2])
    assert info["pi_code"] == "CAFE"
    (w_t, b_t), (w_j, b_j) = arts["port"], arts["jax"]
    assert len(b_t) > 0 and b_t == b_j
    assert wav_snr_db(w_t, w_j) >= SNR_MIN_DB
    a, fs = wav_frames(w_t), 32000
    mono = a[int(0.1 * fs):, 0].astype(np.float64)
    spec = np.abs(np.fft.rfft(mono * np.hanning(len(mono))))
    freqs = np.fft.rfftfreq(len(mono), 1 / fs)
    assert abs(freqs[np.argmax(spec)] - 1500.0) < 20.0


def test_tune_refusals(tune_pcm, tmp_path, capsys):
    """A rate that is not a multiple of 1.024 MHz and a frequency outside
    the capture exit 1 with the JAX command's messages."""
    out = str(tmp_path / "o")
    assert tcli.main(["tune", "-i", tune_pcm, "-r", "3000000", "-f", "0",
                      "-o", out, "--device", "cpu"]) == 1
    assert "--rate must be an integer multiple of 1024000" in \
        capsys.readouterr().err
    assert tcli.main(["tune", "-i", tune_pcm, "-r", "2048000", "-f",
                      "1100000", "-o", out, "--device", "cpu"]) == 1
    assert "outside the capture bandwidth" in capsys.readouterr().err


@pytest.mark.parametrize("f_norm", [0.5, -0.5, 0.25, -1 / 3, 0.123456,
                                    0.4999, 1e-4])
def test_freq_shift_matches_jax(f_norm):
    """Three calls with the phase carried (lengths 4,096, 777 and 10,000,
    two channels, random phases to start): the outputs and the carried
    phase bit for bit JAX's (the same float32 operations on the same
    float64 ramp)."""
    rng = np.random.default_rng(7)
    p0 = rng.uniform(-0.5, 0.5, 2).astype(np.float32)
    pj, pt = jnp.asarray(p0), torch.from_numpy(p0)
    for n in (4096, 777, 10000):
        xr = rng.standard_normal((2, n)).astype(np.float32)
        xi = rng.standard_normal((2, n)).astype(np.float32)
        pj, (yrj, yij) = jmixer.freq_shift_p(
            pj, (jnp.asarray(xr), jnp.asarray(xi)), f_norm)
        pt, (yrt, yit) = tmixer.freq_shift_p(
            pt, (torch.from_numpy(xr), torch.from_numpy(xi)), f_norm)
        np.testing.assert_array_equal(yrt.numpy(), np.asarray(yrj))
        np.testing.assert_array_equal(yit.numpy(), np.asarray(yij))
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
