"""Recorded wideband IQ (*.pcm, interleaved u8 I/Q) as packed words.

Counterpart of ``fm_radio_tpu/io/pcm.py::LazyPackedPcm``, which packs with
the JAX package's ``pack_iq_u8`` (its module imports jax); this one packs
with the port's copy.
"""

from __future__ import annotations

import sys

import numpy as np

from fm_radio_tpu_torch.utils.transfer import pack_iq_u8


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


def packed_input(path: str | None, max_samples: int | None = None):
    """Packed words of a capture: a lazy memmap view for a file; stdin
    ("-" or None), an empty or a special file is read whole."""
    if path not in (None, "-"):
        try:
            return LazyPackedPcm(path, max_samples)
        except (OSError, ValueError):
            # empty and special files (/dev/null, pipes) cannot be memmapped
            raw = np.fromfile(path, dtype=np.uint8)
    else:
        raw = np.frombuffer(sys.stdin.buffer.read(), dtype=np.uint8)
    n = raw.size // 2
    if max_samples:
        n = min(n, max_samples)
    return pack_iq_u8(raw[: 2 * n].reshape(n, 2))
