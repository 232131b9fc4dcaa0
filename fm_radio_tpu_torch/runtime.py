"""ctypes bindings for the native runtime (``runtime/fmtpu_runtime.cpp``).

Counterpart of ``fm_radio_tpu/runtime.py``: a prefetching u8 IQ block
reader, an incremental WAV writer, and the RDS bit loops (Manchester
slicer, CRC-10, group sync) in C++, for ``scrape --stream`` and the native
RDS chain (``rds/chain.py::NativeRDSFullChain``, ``stations
--rds-native``).

The library is built at first use from the repo's own source, with the
C++ compiler (``$CXX``, else ``g++``, else ``c++``) and the flags of
``runtime/Makefile``, into ``fm_radio_tpu_torch/_build/runtime-<hash>/``:
the hash covers the source, the compiler and the flags, so an edited
source builds anew, as ``kernels/_build.py`` keys the CUDA libraries.  It
never runs ``make`` in ``runtime/`` and never loads
``runtime/libfmtpu_runtime.so`` (the JAX package's build), so the two
packages' builds cannot race.  A build that fails raises
:class:`NativeRuntimeUnavailable` with the compiler's output: no library
of an older source is loaded in its place, and nothing here falls back
to the Python implementations.  Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG.parent / "runtime" / "fmtpu_runtime.cpp"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libfmtpu_runtime.so"
# runtime/Makefile's CXXFLAGS, and its link line's -shared
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
             "-shared")


class NativeRuntimeUnavailable(RuntimeError):
    pass


def compiler() -> str:
    """The C++ compiler: ``$CXX`` (as the Makefile takes it), else ``g++``
    or ``c++`` on ``PATH``; raises if there is none."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx or not (os.path.isfile(cxx) or shutil.which(cxx)):
        raise NativeRuntimeUnavailable(
            f"no C++ compiler found (CXX={os.environ.get('CXX')!r}, no g++ "
            f"or c++ on PATH): the native runtime cannot be built")
    return cxx


def build_dir(cxx: str) -> Path:
    h = hashlib.sha256(" ".join((cxx,) + CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / f"runtime-{h.hexdigest()[:16]}"


def build() -> Path:
    """The library's path, compiled first if this source has no build yet
    (into a temporary file, then renamed: concurrent builds each finish
    whole); raises :class:`NativeRuntimeUnavailable` if it cannot be
    built."""
    cxx = compiler()
    out = build_dir(cxx)
    lib = out / LIB_NAME
    if lib.is_file():
        return lib
    try:
        out.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
        os.close(fd)
    except OSError as e:
        raise NativeRuntimeUnavailable(
            f"cannot build the native runtime in {out}: {e}") from e
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        os.unlink(tmp)
        raise NativeRuntimeUnavailable(
            f"cannot build the native runtime ({' '.join(cmd)}): {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise NativeRuntimeUnavailable(
            f"cannot build the native runtime ({' '.join(cmd)}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the library, its argument types set."""
    lib = ctypes.CDLL(str(build()))
    u8p, f32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)

    lib.rt_u8_to_f32_center.argtypes = [u8p, f32p, ctypes.c_int64]
    lib.rt_pcm_open.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]
    lib.rt_pcm_open.restype = ctypes.c_void_p
    lib.rt_pcm_next_block_f32.argtypes = [ctypes.c_void_p, f32p]
    lib.rt_pcm_next_block_f32.restype = ctypes.c_int
    lib.rt_pcm_next_block_packed_f32.argtypes = [ctypes.c_void_p, f32p]
    lib.rt_pcm_next_block_packed_f32.restype = ctypes.c_int
    lib.rt_pcm_next_block_i8.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_int8)]
    lib.rt_pcm_next_block_i8.restype = ctypes.c_int
    lib.rt_pcm_close.argtypes = [ctypes.c_void_p]

    lib.rt_wav_open.argtypes = [ctypes.c_char_p, ctypes.c_int32,
                                ctypes.c_int16]
    lib.rt_wav_open.restype = ctypes.c_void_p
    lib.rt_wav_write_f32.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int64]
    lib.rt_wav_close.argtypes = [ctypes.c_void_p]

    lib.rt_manchester_new.restype = ctypes.c_void_p
    lib.rt_manchester_free.argtypes = [ctypes.c_void_p]
    lib.rt_manchester_process.argtypes = [ctypes.c_void_p, f32p,
                                          ctypes.c_int64, u8p,
                                          ctypes.c_int64]
    lib.rt_manchester_process.restype = ctypes.c_int64

    lib.rt_crc10.argtypes = [ctypes.c_uint32]
    lib.rt_crc10.restype = ctypes.c_uint16
    lib.rt_group_sync_new.restype = ctypes.c_void_p
    lib.rt_group_sync_free.argtypes = [ctypes.c_void_p]
    lib.rt_group_sync_process.argtypes = [
        ctypes.c_void_p, u8p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64]
    lib.rt_group_sync_process.restype = ctypes.c_int64
    return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        load()
        return True
    except (NativeRuntimeUnavailable, OSError):
        return False


def u8_to_f32_center(raw: np.ndarray) -> np.ndarray:
    """Interleaved u8 IQ bytes -> float32 of the same length, u8 - 127."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    out = np.empty(raw.size, dtype=np.float32)
    load().rt_u8_to_f32_center(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), raw.size // 2)
    return out


def crc10(x: int) -> int:
    """The RDS block check word of a 26-bit block (``rds/crc.py``)."""
    return int(load().rt_crc10(x))


class NativePcmReader:
    """Background-prefetching pcm block source: ``block_size`` samples a
    block (the final partial block is dropped), as centred complex64
    (iteration), packed words or int8 planes."""

    def __init__(self, path: str, block_size: int, n_prefetch: int = 4):
        self._lib = load()
        self.block_size = block_size
        self._h = self._lib.rt_pcm_open(path.encode(), block_size, n_prefetch)
        if not self._h:
            raise OSError(f"cannot open {path}")
        self._buf = np.empty(2 * block_size, dtype=np.float32)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        ok = self._lib.rt_pcm_next_block_f32(
            self._h, self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if not ok:
            raise StopIteration
        return self._buf[0::2] + 1j * self._buf[1::2].astype(np.float32)

    def next_packed(self) -> np.ndarray | None:
        """Next block as packed u8 words (w = I*256 + Q, float32:
        ``utils/transfer.pack_iq_u8``); None at the end of the stream."""
        out = np.empty(self.block_size, dtype=np.float32)
        ok = self._lib.rt_pcm_next_block_packed_f32(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out if ok else None

    def next_i8(self) -> np.ndarray | None:
        """Next block as [2, 1, block_size] int8 (I - 128, Q - 128) planes
        (``utils/transfer.split_iq_i8``); None at the end of the stream."""
        out = np.empty((2, 1, self.block_size), dtype=np.int8)
        ok = self._lib.rt_pcm_next_block_i8(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
        return out if ok else None

    def close(self):
        if self._h:
            self._lib.rt_pcm_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeWavWriter:
    """16-bit PCM WAV with its header restamped after every write."""

    def __init__(self, path: str, sample_rate: int, channels: int = 2):
        self._lib = load()
        self._h = self._lib.rt_wav_open(path.encode(), sample_rate, channels)
        if not self._h:
            raise OSError(f"cannot open {path}")
        self.channels = channels

    def write(self, frames: np.ndarray) -> None:
        """frames: [N, channels] float32 in [-1, 1]."""
        f = np.ascontiguousarray(frames, dtype=np.float32)
        self._lib.rt_wav_write_f32(
            self._h, f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            f.shape[0])

    def close(self):
        if self._h:
            self._lib.rt_wav_close(self._h)
            self._h = None


class NativeRDSBitDecoder:
    """Native Manchester + group sync: soft symbols in, groups out."""

    # the bit staging buffer holds 2^16 bytes = 2^19 bits; a bit lands per
    # 2 symbols, so a native call takes at most 2^19 symbols
    _MAX_SYMBOLS_PER_CALL = 1 << 19
    _NAMES = ("A", "B", "C", "C1", "D")

    def __init__(self):
        self._lib = load()
        self._m = self._lib.rt_manchester_new()
        self._g = self._lib.rt_group_sync_new()
        self._bits = np.zeros(1 << 16, dtype=np.uint8)
        self._nbits = 0

    def process_symbols(self, symbols: np.ndarray) -> list[dict]:
        s = np.ascontiguousarray(symbols, dtype=np.float32)
        groups: list[dict] = []
        for i0 in range(0, len(s), self._MAX_SYMBOLS_PER_CALL):
            groups.extend(
                self._process_chunk(s[i0 : i0 + self._MAX_SYMBOLS_PER_CALL]))
        return groups

    def _process_chunk(self, s: np.ndarray) -> list[dict]:
        u8p = ctypes.POINTER(ctypes.c_uint8)
        self._nbits = self._lib.rt_manchester_process(
            self._m, s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(s),
            self._bits.ctypes.data_as(u8p), self._nbits)
        n_bytes = self._nbits // 8
        if n_bytes == 0:
            return []
        # at most one group per 104 bits
        max_groups = n_bytes * 8 // 104 + 2
        out = np.zeros(12 * max_groups, dtype=np.uint16)
        n = self._lib.rt_group_sync_process(
            self._g, self._bits.ctypes.data_as(u8p), n_bytes,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), max_groups)
        # the leftover bits (not a whole byte) move to the buffer's front
        rem_bits = self._nbits - 8 * n_bytes
        if rem_bits:
            self._bits[0] = self._bits[n_bytes]
        self._nbits = rem_bits
        groups = []
        for i in range(n):
            o = out[12 * i : 12 * (i + 1)]
            groups.append({"data": [int(v) for v in o[0:4]],
                           "types": [self._NAMES[v] for v in o[4:8]],
                           "valid": [bool(v) for v in o[8:12]]})
        return groups

    def __del__(self):
        try:
            self._lib.rt_manchester_free(self._m)
            self._lib.rt_group_sync_free(self._g)
        except Exception:
            pass
