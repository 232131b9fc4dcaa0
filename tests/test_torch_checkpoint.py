"""Checkpoint and resume: the port's ``utils/checkpoint.py`` and ``demod``'s
four checkpoint flags, on the host.

The port flattens its state (the dict, nested dicts and the ``pll`` /
``bpsk`` NamedTuples) under the JAX package's ``a/b`` keys and leaf
dtypes, so a checkpoint that either package writes resumes in the other.
Here, on a synthesized stereo + RDS station (BLOCK = 8,192, its noise from
a seed): a resume in the port is bit for bit the uninterrupted run on
every ingest form, ``block_index`` round-trips; the two packages' files
hold the same keys, dtypes and shapes; a JAX checkpoint resumed in the
port and a port checkpoint resumed in JAX agree with the other package's
uninterrupted run (RDS bytes identical, audio >= 75 dB SNR); and ``demod
--save-state`` / ``--resume-state`` / ``--checkpoint-every`` /
``--resume-seek`` give the single pass's WAV, as the JAX command's tests
(``tests/test_cli.py``) hold it.  On the card:
``tests/test_torch_gpu.py::test_checkpoint_on_card``.
"""

import io

import jax
import numpy as np
import pytest
import torch

from fm_radio_tpu.models import demod as jdemod
from fm_radio_tpu.utils import checkpoint as jckpt
from fm_radio_tpu_torch.io.wav import read_wav_int16
from fm_radio_tpu_torch.models import demod as tdemod
from fm_radio_tpu_torch.utils import checkpoint as tckpt

from test_torch_stream import (BLOCK, FORMS, SNR_MIN_DB, cfgs, rds_bytes,
                               snr_db, station)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small tensor ops; with pytest-xdist
    workers sharing the cores, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blocks(x, n: int):
    return [np.ascontiguousarray(x[..., i * BLOCK:(i + 1) * BLOCK])
            for i in range(n)]


def _run(dm, blocks) -> dict:
    """Each block through a BroadcastFMDemod of either package; the outs
    concatenated in time (numpy)."""
    outs = [dm.process(b) for b in blocks]
    return {k: np.concatenate([np.asarray(o[k]) for o in outs], axis=1)
            for k in ("audio", "rds_pred", "rds_valid")}


@pytest.mark.parametrize("form", list(FORMS))
def test_checkpoint_resume_in_port(form):
    """Save after 3 of 6 blocks (``block_index`` an extra), load into a
    fresh demod's template: its 3 blocks are bit for bit the uninterrupted
    run's, its state too, and every leaf keeps its template's dtype."""
    make, kw = FORMS[form]
    tcfg, _ = cfgs(**kw)
    blocks = _blocks(make(station(6 * BLOCK, seed=5)), 6)
    a = tdemod.BroadcastFMDemod(tcfg, 1, "cpu")
    _run(a, blocks[:3])
    buf = io.BytesIO()
    tckpt.save_state(buf, a.state, extra={"block_index": 3})
    buf.seek(0)
    b = tdemod.BroadcastFMDemod(tcfg, 1, "cpu")
    b.state, extras = tckpt.load_state(buf, b.state)
    assert int(extras["block_index"]) == 3
    got, want = _run(b, blocks[3:]), _run(a, blocks[3:])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    sa, sb = tckpt.state_to_arrays(a.state), tckpt.state_to_arrays(b.state)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype
        np.testing.assert_array_equal(sa[k], sb[k])
    assert len(tckpt.roundtrip_bytes(a.state)) > 0


@pytest.mark.parametrize("kw", [{}, {"frontend_int8": True,
                                     "use_deemphasis_filter": True}],
                         ids=["default", "int8_deemph"])
def test_checkpoint_keys_and_dtypes_match_jax(kw, tmp_path):
    """The two packages' .npz of one start state: the same keys (extras
    among them), and each array's dtype and shape."""
    tcfg, jcfg = cfgs(**kw)
    jckpt.save_state(tmp_path / "j.npz", jdemod.demod_init_state(jcfg, 3),
                     extra={"block_index": 7})
    tckpt.save_state(tmp_path / "t.npz",
                     tdemod.demod_init_state(tcfg, 3, "cpu"),
                     extra={"block_index": 7})
    j, t = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(j.files) == sorted(t.files)
    assert "__extra__/block_index" in t.files and "pll/nco_t" in t.files
    for k in j.files:
        assert (j[k].dtype, j[k].shape) == (t[k].dtype, t[k].shape), k
    assert {t[k].dtype.name for k in t.files} >= {"complex64", "int32",
                                                  "float32"}


@pytest.mark.parametrize("way", ["jax_to_port", "port_to_jax"])
def test_checkpoint_across_packages(way, tmp_path):
    """16 blocks in one package, its checkpoint loaded into the other's
    template, 16 more blocks there; against the first package's
    uninterrupted 32: the RDS bytes of (the first package's symbols, then
    the resumed package's) identical to the uninterrupted run's, and some
    decoded after the resume; the resumed audio >= 75 dB SNR; the resumed
    package's leaves in its own template's dtypes."""
    make, kw = FORMS["i8"]
    tcfg, jcfg = cfgs(**kw)
    blocks = _blocks(make(station(32 * BLOCK, seed=6)), 32)
    path = tmp_path / "state.npz"
    if way == "jax_to_port":
        src = jdemod.BroadcastFMDemod(jcfg, 1)
        pre = _run(src, blocks[:16])
        jckpt.save_state(path, src.state, extra={"block_index": 16})
        dst = tdemod.BroadcastFMDemod(tcfg, 1, "cpu")
        dst.state, extras = tckpt.load_state(
            path, tdemod.demod_init_state(tcfg, 1, "cpu"))
        assert all(isinstance(v, np.ndarray) for v in
                   tckpt.state_to_arrays(dst.state).values())
    else:
        src = tdemod.BroadcastFMDemod(tcfg, 1, "cpu")
        pre = _run(src, blocks[:16])
        tckpt.save_state(path, src.state, extra={"block_index": 16})
        dst = jdemod.BroadcastFMDemod(jcfg, 1)
        dst.state, extras = jckpt.load_state(
            path, jdemod.demod_init_state(jcfg, 1))
        leaves = jax.tree.leaves(dst.state)
        assert {str(v.dtype) for v in leaves} >= {"complex64", "int32"}
    assert int(extras["block_index"]) == 16
    post = _run(dst, blocks[16:])
    ref = _run(src, blocks[16:])  # the first package, uninterrupted
    both = {k: np.concatenate([pre[k], post[k]], axis=1)
            for k in ("rds_pred", "rds_valid")}
    one = {k: np.concatenate([pre[k], ref[k]], axis=1)
           for k in ("rds_pred", "rds_valid")}
    got = rds_bytes(both["rds_pred"][0], both["rds_valid"][0])
    want = rds_bytes(one["rds_pred"][0], one["rds_valid"][0])
    assert want.size > rds_bytes(pre["rds_pred"][0],
                                 pre["rds_valid"][0]).size
    np.testing.assert_array_equal(got, want)
    assert snr_db(post["audio"], ref["audio"]) >= SNR_MIN_DB


# ---- the demod command's flags --------------------------------------------


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """A 12-block u8 capture of the station (8,192-sample blocks)."""
    path = tmp_path_factory.mktemp("ckpt") / "station.pcm"
    station(12 * BLOCK, seed=7).tofile(path)
    return path


def _demod(capture, wav, *flags, capsys=None):
    from fm_radio_tpu_torch.apps.cli import main

    assert main(["demod", "-i", str(capture), "-b", str(BLOCK), "-o",
                 str(wav), "--no-rds", "--device", "cpu", *flags]) == 0
    return read_wav_int16(str(wav))[0]


@pytest.mark.parametrize("ingest", ["i8", "f32w"])
def test_cli_demod_save_resume_split_capture(capture, tmp_path, ingest):
    """``--save-state`` on the first half of a capture and
    ``--resume-state`` on the second: the two WAVs concatenated equal the
    single pass (JAX ``test_demod_checkpoint_resume``)."""
    data = np.fromfile(capture, np.uint8)
    split = 5 * 2 * BLOCK
    p1, p2 = tmp_path / "a.pcm", tmp_path / "b.pcm"
    data[:split].tofile(p1)
    data[split:].tofile(p2)
    ckpt = tmp_path / "state.npz"
    flags = ("--ingest", ingest)
    full = _demod(capture, tmp_path / "full.wav", *flags)
    a = _demod(p1, tmp_path / "p1.wav", *flags, "--save-state", str(ckpt))
    assert int(np.load(ckpt)["__extra__/block_index"]) == 5
    b = _demod(p2, tmp_path / "p2.wav", *flags, "--resume-state", str(ckpt))
    np.testing.assert_array_equal(full, np.concatenate([a, b]))


def test_cli_demod_crash_restart_with_periodic_checkpoint(capture, tmp_path,
                                                          capfd):
    """``--checkpoint-every 2`` on a capture cut at block 6 (the crash),
    then ``--resume-state --resume-seek`` on the whole capture: the WAVs
    concatenated equal the single pass, and the periodic save left no
    temporary file (JAX ``test_demod_crash_restart_with_periodic_
    checkpoint``)."""
    data = np.fromfile(capture, np.uint8)
    trunc = tmp_path / "trunc.pcm"
    data[:6 * 2 * BLOCK].tofile(trunc)
    ckpt = tmp_path / "state.npz"
    full = _demod(capture, tmp_path / "full.wav")
    capfd.readouterr()
    a = _demod(trunc, tmp_path / "before.wav", "--save-state", str(ckpt),
               "--checkpoint-every", "2")
    assert "final block_index=6" in capfd.readouterr().err
    assert not (tmp_path / "state.npz.tmp.npz").exists()
    b = _demod(capture, tmp_path / "after.wav", "--resume-state", str(ckpt),
               "--resume-seek")
    err = capfd.readouterr().err
    assert "block_index=6" in err and "seeking past 6" in err
    np.testing.assert_array_equal(full, np.concatenate([a, b]))
