"""Recorded IQ (*.pcm, interleaved u8 I/Q): recentring and lazy views.

Counterparts of ``fm_radio_tpu/io/pcm.py``: ``u8_to_c64`` and
``c64_to_u8`` are copies; ``LazyPackedPcm`` and ``LazyI8Pcm`` pack and
split with the port's copies of ``pack_iq_u8`` and ``split_iq_i8`` (the
JAX package's module imports jax).
"""

from __future__ import annotations

import sys

import numpy as np

from fm_radio_tpu_torch.utils.transfer import pack_iq_u8, split_iq_i8


def u8_to_c64(iq_u8: np.ndarray) -> np.ndarray:
    """Recenter: (u8 - 127) + j(u8 - 127)  (app.cpp:57-63)."""
    f = iq_u8.astype(np.float32) - 127.0
    return (f[..., 0] + 1j * f[..., 1]).astype(np.complex64)


def c64_to_u8(x: np.ndarray) -> np.ndarray:
    """Quantize centered complex IQ back to interleaved u8 (for synthesizing
    reference-format recordings)."""
    out = np.empty(x.shape + (2,), dtype=np.uint8)
    out[..., 0] = np.clip(np.round(x.real + 127.0), 0, 255).astype(np.uint8)
    out[..., 1] = np.clip(np.round(x.imag + 127.0), 0, 255).astype(np.uint8)
    return out


class LazyPackedPcm:
    """Constant-memory packed-word view of a u8 IQ capture on disk:
    ``len()`` counts complex samples, and a contiguous slice returns
    ``pack_iq_u8`` of those samples, read from a byte memmap on demand."""

    def __init__(self, path: str, max_samples: int | None = None):
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        self._n = self._mm.size // 2
        if max_samples is not None:
            self._n = min(self._n, max_samples)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, sl: slice) -> np.ndarray:
        start, stop, step = sl.indices(self._n)
        if step != 1:
            raise ValueError("LazyPackedPcm supports contiguous slices only")
        return pack_iq_u8(np.asarray(self._mm[2 * start : 2 * stop])
                          .reshape(-1, 2))


class LazyI8Pcm:
    """Constant-memory int8-plane view of a u8 IQ capture on disk: slices
    come back as [2, 1, N] int8 planes of (I - 128, Q - 128)
    (``split_iq_i8``); ``len()`` counts complex samples."""

    def __init__(self, path: str, max_samples: int | None = None):
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        self._n = self._mm.size // 2
        if max_samples is not None:
            self._n = min(self._n, max_samples)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, sl: slice) -> np.ndarray:
        start, stop, step = sl.indices(self._n)
        if step != 1:
            raise ValueError("LazyI8Pcm supports contiguous slices only")
        chunk = np.asarray(self._mm[2 * start : 2 * stop]).reshape(-1, 2)
        return split_iq_i8(chunk)[:, None, :]


def read_u8(path: str | None, max_samples: int | None = None) -> np.ndarray:
    """A whole capture (stdin for None or "-") as u8 pairs [N, 2]."""
    if path in (None, "-"):
        raw = np.frombuffer(sys.stdin.buffer.read(), dtype=np.uint8)
    else:
        raw = np.fromfile(path, dtype=np.uint8)
    n = raw.size // 2
    if max_samples:
        n = min(n, max_samples)
    return raw[: 2 * n].reshape(n, 2)


def i8_input(path: str | None, max_samples: int | None = None):
    """int8 planes [2, 1, N] of a capture: a lazy memmap view for a file;
    stdin, an empty or a special file is read whole."""
    if path not in (None, "-"):
        try:
            return LazyI8Pcm(path, max_samples)
        except (OSError, ValueError):
            pass  # empty and special files cannot be memmapped
    return split_iq_i8(read_u8(path, max_samples))[:, None, :]


def packed_input(path: str | None, max_samples: int | None = None):
    """Packed words of a capture: a lazy memmap view for a file; stdin
    ("-" or None), an empty or a special file is read whole."""
    if path not in (None, "-"):
        try:
            return LazyPackedPcm(path, max_samples)
        except (OSError, ValueError):
            pass  # empty and special files cannot be memmapped
    return pack_iq_u8(read_u8(path, max_samples))
