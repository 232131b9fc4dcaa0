"""The port's stream path on the host, and its host subcommands.

``App.process_all`` runs every whole block of a call through
``models/app.py::demod_stream``: on the card one CUDA graph replay
(``tests/test_torch_gpu.py::test_stream_on_card``, ``chip_smoke.py``'s
stream phase), on the CPU a loop of ``demod_block``'s plain versions.
Here, on a synthesized stereo + RDS station (BLOCK = 8,192, its noise
from a seed), on complex64, packed words and int8 planes (the fused K12):
``process_all`` against ``process`` in the port, bit for bit (audio, RDS
bytes, the pending tail), over calls of 6 blocks and a tail; the runtime
controls between calls; the port's ``demod_stream`` against the JAX
package's (RDS bytes identical, audio >= 75 dB SNR, as the port's e2e
tests hold the two packages); and ``rds-decode`` and ``synth``.
"""

import json

import numpy as np
import pytest
import torch

from fm_radio_tpu.config import DemodConfig as JDemodConfig
from fm_radio_tpu.models import app as japp
from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.io.pcm import c64_to_u8
from fm_radio_tpu_torch.io.synth import (
    FMModulator,
    ModulatorConfig,
    station_group_schedule,
)
from fm_radio_tpu_torch.models import app as tapp
from fm_radio_tpu_torch.rds.chain import make_rds_chain
from fm_radio_tpu_torch.utils.transfer import pack_iq_u8, split_iq_i8

BLOCK = 8192
SNR_MIN_DB = 75.0  # tests/test_torch_split_e2e.py
PI, PS = 0x5A5A, "STREAMPT"
CALLS, CALL = 4, 6 * BLOCK + 1500  # 24 blocks a run, each call a tail


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small tensor ops; with pytest-xdist
    workers sharing the cores, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def station(n: int, seed: int = 0) -> np.ndarray:
    """u8 IQ [n, 2] of a stereo + RDS station with noise from ``seed``."""
    rng = np.random.default_rng(seed)
    groups = station_group_schedule(PI, ps=PS, rt="STREAM PATH")
    iq = FMModulator(ModulatorConfig()).generate(
        n, left_hz=1000.0, right_hz=3000.0, rds_groups=groups)
    iq = iq + 1.5 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return c64_to_u8(iq.astype(np.complex64)).reshape(-1, 2)


# ingest form -> (numpy input of u8 [N, 2], DemodConfig keyword arguments)
FORMS = {
    "complex": (lambda u8: ((u8[:, 0].astype(np.float32) - 127.0)
                            + 1j * (u8[:, 1].astype(np.float32) - 127.0)
                            ).astype(np.complex64)[None], {}),
    "f32w": (lambda u8: pack_iq_u8(u8)[None],
             {"assume_integer_input": True}),
    "i8": (lambda u8: split_iq_i8(u8)[:, None, :], {"frontend_int8": True}),
}


def cfgs(**kw):
    """The port's and the JAX package's DemodConfig from the same keyword
    arguments."""
    return DemodConfig(**kw), JDemodConfig(**kw)


def snr_db(sig, ref):
    sig, ref = np.asarray(sig, np.float64), np.asarray(ref, np.float64)
    return 10 * np.log10(np.sum(ref ** 2) / (np.sum((sig - ref) ** 2) + 1e-30))


def rds_bytes(pred: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """The RDS bytes of one channel's symbols through the host chain."""
    chain = make_rds_chain()
    sym = pred[valid]
    if sym.size:
        chain.process_symbols(sym)
    return (np.concatenate(chain.rds_bytes) if chain.rds_bytes
            else np.zeros(0, np.uint8))


@pytest.mark.parametrize("form", list(FORMS))
def test_process_all_matches_process(form):
    """The same calls (6 blocks and a tail each, the tail pending into the
    next) through ``process`` and ``process_all``: audio bit for bit, the
    RDS bytes identical (and some decoded), the pending tail equal."""
    make, kw = FORMS[form]
    x = make(station(CALLS * CALL, seed=1))
    apps = [tapp.App(BLOCK, DemodConfig(**kw), 1, device="cpu")
            for _ in range(2)]
    for i in range(CALLS):
        part = x[..., i * CALL:(i + 1) * CALL]
        apps[0].process(part)
        apps[1].process_all(part)
    a, b = apps
    np.testing.assert_array_equal(a.audio, b.audio)
    assert a.audio.shape[1] == (CALLS * CALL // BLOCK) * BLOCK // 32
    assert a.rds_bytes(0).size > 0
    np.testing.assert_array_equal(a.rds_bytes(0), b.rds_bytes(0))
    assert a._pending.dtype == b._pending.dtype
    np.testing.assert_array_equal(a._pending, b._pending)


def test_process_all_short_call_stays_pending():
    """A call shorter than a block runs nothing and keeps it all pending,
    as ``process`` does."""
    make, kw = FORMS["i8"]
    x = make(station(BLOCK // 2))
    app = tapp.App(BLOCK, DemodConfig(**kw), 1, device="cpu")
    app.process_all(x)
    assert app.audio.shape == (1, 0, 2)
    np.testing.assert_array_equal(app._pending, x)


def test_process_all_respects_runtime_controls():
    """``update_controls`` between calls (L+R audio, de-emphasis on) is
    honoured by ``process_all`` as by ``process``: the demod's live config
    and coefficients, not a stale copy (JAX
    ``test_process_all_respects_runtime_controls``)."""
    make, kw = FORMS["f32w"]
    x = make(station(4 * BLOCK, seed=2))

    def run(batch: bool):
        app = tapp.App(BLOCK, DemodConfig(**kw), 1, decode_rds=False,
                       device="cpu")
        go = app.process_all if batch else app.process
        go(x[..., :2 * BLOCK])
        app.demod.update_controls(audio_out="lpr", use_deemphasis_filter=True)
        go(x[..., 2 * BLOCK:])
        return app.audio[0]

    a, b = run(False), run(True)
    np.testing.assert_array_equal(a, b)
    half = 2 * BLOCK // 32
    np.testing.assert_array_equal(a[half:, 0], a[half:, 1])  # L+R only
    assert not np.array_equal(a[:half, 0], a[:half, 1])        # stereo


@pytest.mark.parametrize("form", list(FORMS))
def test_demod_stream_matches_jax(form):
    """The port's ``demod_stream`` (plain versions) against the JAX
    package's (``lax.scan``) over 32 blocks from one start state: the RDS
    bytes of the symbols identical (and some decoded), the RDS decisions'
    validity identical, audio >= 75 dB SNR; the block axis folded into
    time in both."""
    make, kw = FORMS[form]
    n_blocks = 32
    x = np.ascontiguousarray(make(station(n_blocks * BLOCK, seed=3)))
    tcfg, jcfg = cfgs(**kw)
    st_t, ot = tapp.demod_stream(tcfg, x, BLOCK, device="cpu")
    st_j, oj = japp.demod_stream(jcfg, x, BLOCK)
    ot = {k: v.numpy() for k, v in ot.items()}
    oj = {k: np.asarray(v) for k, v in oj.items()}
    assert ot["audio"].shape == oj["audio"].shape == (1, n_blocks * BLOCK
                                                      // 32, 2)
    assert ot["rds_pred"].shape == oj["rds_pred"].shape
    np.testing.assert_array_equal(ot["rds_valid"], oj["rds_valid"])
    bt = rds_bytes(ot["rds_pred"][0], ot["rds_valid"][0])
    bj = rds_bytes(oj["rds_pred"][0], oj["rds_valid"][0])
    assert bj.size > 0
    np.testing.assert_array_equal(bt, bj)
    assert snr_db(ot["audio"], oj["audio"]) >= SNR_MIN_DB


def test_demod_stream_refuses_a_partial_block():
    """T must be a whole number of blocks, on every device."""
    x = np.zeros((1, BLOCK + 8), np.complex64)
    with pytest.raises(ValueError, match="whole number of blocks"):
        tapp.demod_stream(DemodConfig(), x, BLOCK, device="cpu")


# ---- the host subcommands -------------------------------------------------


def test_cli_rds_decode(tmp_path, capsys):
    """``rds-decode`` on bytes from the port's chain: the JAX command's
    JSON (groups and the database) and its group log lines."""
    from fm_radio_tpu_torch.apps.cli import main

    make, kw = FORMS["i8"]
    app = tapp.App(BLOCK, DemodConfig(**kw), 1, device="cpu")
    app.process_all(make(station(96 * BLOCK, seed=4)))
    data = app.rds_bytes(0)
    assert data.size > 0
    path = tmp_path / "rds.bin"
    data.tofile(path)
    assert main(["rds-decode", "-i", str(path)]) == 0
    cap = capsys.readouterr()
    out = json.loads(cap.out.strip().splitlines()[-1])
    assert out["groups"] > 0 and out["pi_code"] == f"{PI:04X}"
    assert "[rds_decoder]" in cap.err


def test_cli_synth_then_demod(tmp_path, capsys):
    """``synth`` writes a capture (the JAX command's JSON) that ``demod
    --device cpu`` decodes to its PI code; a wideband ``synth`` writes M
    times the samples at M times the rate."""
    from fm_radio_tpu_torch.apps.cli import main

    pcm = tmp_path / "st.pcm"
    assert main(["synth", "-o", str(pcm), "--seconds", "0.6", "--pi",
                 "0xBEEF", "--ps", "SYNTHPRT", "--cnr", "40"]) == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info == {"path": str(pcm), "samples": 614400, "rate": 1_024_000,
                    "stations": 1}
    assert pcm.stat().st_size == 2 * 614400
    assert main(["demod", "-i", str(pcm), "-b", "16384", "--device",
                 "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["pi_code"] == "BEEF"
    wide = tmp_path / "wide.pcm"
    assert main(["synth", "-o", str(wide), "--seconds", "0.01",
                 "--stations", "2"]) == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (info["rate"], info["stations"]) == (4 * 1_024_000, 2)
    assert info["samples"] == 4 * 10240
    assert wide.stat().st_size == 2 * info["samples"]
