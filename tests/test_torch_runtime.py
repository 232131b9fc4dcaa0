"""The port's native runtime (``fm_radio_tpu_torch/runtime.py``) against
the JAX package's bindings (``fm_radio_tpu/runtime.py``) on the same
inputs, as JAX tests/test_runtime.py holds them against Python: the u8
conversion, the reader's blocks, the WAV writer's bytes, CRC-10,
Manchester, group sync; ``NativeRDSFullChain`` against the Python chain
at the App level and under bit errors; the build's place, key and
refusals.  The tests that need the library skip where no C++ compiler is
found."""

import ctypes
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fm_radio_tpu import runtime as jrt
from fm_radio_tpu.io.synth import encode_rds_group, rds_bits_to_symbols
from fm_radio_tpu.rds.chain import RDSFullChain as JRDSFullChain
from fm_radio_tpu.rds.crc import crc10_bitserial
from fm_radio_tpu_torch import runtime as trt
from fm_radio_tpu_torch.io.pcm import c64_to_u8
from fm_radio_tpu_torch.io.wav import write_wav_int16
from fm_radio_tpu_torch.rds import chain as tchain

REPO = Path(__file__).resolve().parent.parent
needs_cxx = pytest.mark.skipif(not trt.available(),
                               reason="no C++ compiler: the native runtime "
                                      "cannot be built")
needs_jax_rt = pytest.mark.skipif(not jrt.available(),
                                  reason="the JAX package's runtime does not "
                                         "build here")


def _capture(tmp_path, n: int, seed: int) -> str:
    rng = np.random.default_rng(seed)
    iq = (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    iq = (iq / np.abs(iq).max() * 100).astype(np.complex64)
    path = tmp_path / f"x{seed}.pcm"
    c64_to_u8(iq).tofile(path)
    return str(path)


def test_build_flags_are_the_makefiles():
    """The port compiles with runtime/Makefile's CXXFLAGS and ``-shared``,
    from the repo's source."""
    make = (REPO / "runtime" / "Makefile").read_text()
    flags = re.search(r"^CXXFLAGS \?= (.*)$", make, re.M).group(1).split()
    assert trt.CXX_FLAGS == tuple(flags) + ("-shared",)
    assert trt.SOURCE == REPO / "runtime" / "fmtpu_runtime.cpp"


@needs_cxx
def test_build_lives_in_the_ports_build_dir():
    """The library is the port's own build under ``_build/runtime-<hash>``
    (keyed by the source, the compiler and the flags), never the JAX
    package's ``runtime/libfmtpu_runtime.so``."""
    lib = Path(trt.build())
    assert lib.parent.parent == trt.BUILD_ROOT
    assert lib.parent.name.startswith("runtime-")
    assert lib.parent == trt.build_dir(trt.compiler())
    assert Path(trt.load()._name) == lib
    assert lib.resolve() != (REPO / "runtime" / "libfmtpu_runtime.so")


def _runtime_files() -> dict:
    """runtime/'s files and their times, but the JAX package's build lock,
    which its loader truncates at every load (other test workers load it
    while these tests run)."""
    d = REPO / "runtime"
    return {p.name: p.stat().st_mtime_ns for p in d.iterdir()
            if p.name != ".build.lock"}


def test_no_compiler_raises_and_writes_nothing(tmp_path, monkeypatch):
    """Without a C++ compiler (``CXX`` unset, none on ``PATH``) and no
    earlier build, ``make_rds_chain("native")`` and ``App(rds_backend=
    "native")`` raise ``NativeRuntimeUnavailable`` (no Python chain in
    their place), and a real build writes no file under ``runtime/``."""
    from fm_radio_tpu_torch.models.app import App

    before = _runtime_files()
    monkeypatch.setattr(trt, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(trt.shutil, "which", lambda name: None)
    trt.load.cache_clear()
    try:
        with pytest.raises(trt.NativeRuntimeUnavailable,
                           match="no C\\+\\+ compiler"):
            tchain.make_rds_chain("native")
        with pytest.raises(trt.NativeRuntimeUnavailable):
            App(block_size=8192, channels=2, rds_backend="native",
                device="cpu")
        assert not trt.available()
        monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
        with pytest.raises(trt.NativeRuntimeUnavailable):
            trt.load()
        monkeypatch.undo()
        monkeypatch.setattr(trt, "BUILD_ROOT", tmp_path / "build")
        trt.load.cache_clear()
        if trt.available():
            assert (tmp_path / "build").is_dir()
    finally:
        trt.load.cache_clear()
    assert _runtime_files() == before
    assert isinstance(tchain.make_rds_chain("python"), tchain.RDSFullChain)


def test_failed_build_raises_its_output(tmp_path, monkeypatch):
    """A compiler that fails raises with its output; nothing is left in
    the build directory to be loaded later."""
    fake = tmp_path / "fake-cxx"
    fake.write_text("#!/bin/sh\necho 'fake: error: no' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(trt, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setenv("CXX", str(fake))
    trt.load.cache_clear()
    try:
        with pytest.raises(trt.NativeRuntimeUnavailable,
                           match="fake: error: no"):
            trt.load()
        assert not list((tmp_path / "build").rglob("*.so"))
    finally:
        trt.load.cache_clear()


@needs_cxx
@needs_jax_rt
def test_u8_convert_and_crc10_match_jax():
    rng = np.random.default_rng(11)
    raw = rng.integers(0, 256, size=2 * 1000, dtype=np.uint8)
    got = trt.u8_to_f32_center(raw)
    want = np.empty(2000, dtype=np.float32)
    jrt.load().rt_u8_to_f32_center(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        want.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 1000)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, raw.astype(np.float32) - 127.0)
    for x in rng.integers(0, 1 << 26, 300):
        assert trt.crc10(int(x)) == jrt.load().rt_crc10(int(x)) == \
            crc10_bitserial(int(x))


@needs_cxx
@needs_jax_rt
@pytest.mark.parametrize("form", ["c64", "packed", "i8"])
def test_pcm_reader_matches_jax(form, tmp_path):
    """Three whole blocks and a partial one (dropped): every block of each
    form equal to the JAX reader's."""
    path = _capture(tmp_path, 3 * 4096 + 777, seed=3)
    readers = [trt.NativePcmReader(path, 4096), jrt.NativePcmReader(path,
                                                                     4096)]
    got = [[], []]
    for r, out in zip(readers, got):
        while True:
            if form == "c64":
                try:
                    blk = next(r).copy()
                except StopIteration:
                    break
            else:
                blk = r.next_i8() if form == "i8" else r.next_packed()
                if blk is None:
                    break
            out.append(blk)
        r.close()
    assert len(got[0]) == len(got[1]) == 3
    for a, b in zip(*got):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@needs_cxx
@needs_jax_rt
def test_wav_writer_matches_jax_and_python(tmp_path):
    rng = np.random.default_rng(12)
    audio = (rng.standard_normal((500, 2)) * 0.5).astype(np.float32)
    paths = [tmp_path / "t.wav", tmp_path / "j.wav"]
    for mod, p in zip((trt, jrt), paths):
        w = mod.NativeWavWriter(str(p), 32000, 2)
        w.write(audio[:200])
        w.write(audio[200:])
        w.close()
    write_wav_int16(str(tmp_path / "p.wav"), audio, 32000)
    assert paths[0].read_bytes() == paths[1].read_bytes() == \
        (tmp_path / "p.wav").read_bytes()


def _symbols(groups, flips: int = 0, seed: int = 5) -> np.ndarray:
    bits = np.concatenate([encode_rds_group(g) for g in groups])
    sym = rds_bits_to_symbols(bits).astype(np.float32)
    if flips:
        rng = np.random.default_rng(seed)
        sym[rng.choice(len(sym), size=len(sym) // flips, replace=False)] *= -1
    return sym


@needs_cxx
@needs_jax_rt
def test_manchester_matches_jax():
    sym = np.random.default_rng(13).standard_normal(4096).astype(np.float32)
    outs = []
    for mod in (trt, jrt):
        lib = mod.load()
        h = lib.rt_manchester_new()
        out = np.zeros(4096 // 16 + 2, dtype=np.uint8)
        nbits = lib.rt_manchester_process(
            h, sym.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(sym),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), 0)
        lib.rt_manchester_free(h)
        outs.append((nbits, out))
    assert outs[0][0] == outs[1][0] == 2048
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


@needs_cxx
@needs_jax_rt
@pytest.mark.parametrize("flips", [0, 200])
def test_group_sync_matches_jax(flips):
    """The bit decoder's groups (words, block types, validity) equal to the
    JAX bindings' on a 40-group stream in awkward chunks, clean and with
    0.5% of the symbols flipped (CRC correction, dropped blocks,
    resyncs)."""
    rng = np.random.default_rng(5)
    groups = [(0x1234, (int(t) << 12) | int(v & 0x3FF),
               int(rng.integers(0, 1 << 16)), int(rng.integers(0, 1 << 16)))
              for t, v in zip(rng.integers(0, 16, 40),
                              rng.integers(0, 1 << 10, 40))]
    sym = _symbols(groups, flips)
    got = []
    for mod in (trt, jrt):
        dec = mod.NativeRDSBitDecoder()
        out = []
        for chunk in np.split(sym, [997, 2003, 4099]):
            out.extend(dec.process_symbols(chunk))
        got.append(out)
    assert len(got[0]) >= 30 and got[0] == got[1]
    if flips:
        assert any(not all(g["valid"]) for g in got[0])


@needs_cxx
@pytest.mark.parametrize("flips", [0, 200])
def test_native_chain_matches_python_chain(flips):
    """``NativeRDSFullChain`` against the Python chain on one symbol
    stream, clean and with 0.5% of the symbols flipped: the same database
    summary, and the Python chain's groups (words and validity) and log
    lines a prefix of the native chain's (the Python chain takes bytes in
    16s, app.cpp:16, so the native chain may decode trailing groups more);
    and the same as the JAX package's Python chain."""
    groups = [(0xBEEF, (0 << 12) | (1 << 10) | seg, 0xE101,
               (b"NATIVE! "[2 * seg] << 8) | b"NATIVE! "[2 * seg + 1])
              for seg in range(4)] * 3
    sym = _symbols(groups, flips)
    nat, py = tchain.make_rds_chain("native"), tchain.make_rds_chain()
    jpy = JRDSFullChain()
    assert isinstance(nat, tchain.NativeRDSFullChain)
    for chunk in np.split(sym, [257, 1031]):
        nat.process_symbols(chunk)
        py.process_symbols(chunk)
        jpy.process_symbols(chunk)

    def seq(ch):
        return [([b.data for b in g], [bool(b.is_valid) for b in g])
                for g in ch.chain.groups]

    assert len(seq(py)) >= 8
    assert seq(nat)[: len(seq(py))] == seq(py) == seq(jpy)
    assert nat.chain.log_lines[: len(py.chain.log_lines)] == \
        py.chain.log_lines == jpy.chain.log_lines
    assert nat.db.summary() == py.db.summary() == jpy.db.summary()
    assert nat.rds_bytes == []
    if not flips:
        assert nat.db.service_name_str == "NATIVE! "


@needs_cxx
def test_native_chain_at_app_level():
    """Two channels of one station through ``App(rds_backend="native")``
    and the Python chain's App on the CPU: the same databases, and the
    Python App's group log lines a prefix of the native App's."""
    from fm_radio_tpu_torch.apps.cli import selftest_planes
    from fm_radio_tpu_torch.models.app import App
    from fm_radio_tpu_torch.models.demod import INT8_CONFIG

    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        x8 = selftest_planes(0.5, 8192)
        x8 = np.concatenate([x8, x8], axis=1)
        apps = {b: App(block_size=8192, cfg=INT8_CONFIG, channels=2,
                       rds_backend=b, device="cpu")
                for b in ("native", "python")}
        for app in apps.values():
            app.process(x8)
    finally:
        torch.set_num_threads(torch_threads)
    nat, py = apps["native"], apps["python"]
    assert isinstance(nat.rds_chains[0], tchain.NativeRDSFullChain)
    for c in range(2):
        lines = py.rds_log_lines(c)
        assert len(lines) >= 2
        assert nat.rds_log_lines(c)[: len(lines)] == lines
        assert nat.rds_database(c).summary() == py.rds_database(c).summary()
        assert nat.rds_database(c).summary()["pi_code"] == "1234"
        assert nat.rds_bytes(c).size == 0
    drained = nat.drain()
    assert drained["rds_bytes"][0].size == 0 and drained["log_lines"][0]


def test_runtime_imports_build_nothing():
    """Importing the module builds nothing and loads no library (the
    tests' collection imports every module)."""
    import subprocess
    import sys

    code = ("import fm_radio_tpu_torch.runtime as r; "
            "print(r.load.cache_info().currsize)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0"
