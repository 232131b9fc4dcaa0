"""Differential Manchester symbol->byte decoding.

Parity: ``DifferentialManchesterDecoder`` (``src/rds_decoder/
differential_manchester_decoder.h:7-61``): keep every 2nd soft symbol,
hard-slice > 0, XOR with the previous kept bit, pack MSB-first, emit every
``buf_size`` bytes (16 by default, ``app.cpp:16``).

The per-symbol loop is replaced by vectorized slicing/XOR/packbits; only three
scalars (phase toggle, previous bit, partial-bit buffer) persist across calls,
so arbitrary block boundaries reproduce the reference exactly.

Copy of ``fm_radio_tpu/rds/manchester.py`` in the port (imports rewritten).
"""

from __future__ import annotations

from typing import Callable

import numpy as np


class DifferentialManchesterDecoder:
    def __init__(self, buf_size: int = 16, on_bytes: Callable | None = None):
        self.buf_size = buf_size
        self.on_bytes = on_bytes
        self._is_read_bit = False   # toggled before each symbol; read when True
        self._prev_bit = 0
        self._bit_buf: list[int] = []  # pending bits (< 8*buf_size)
        self._out: list[np.ndarray] = []

    def process(self, symbols: np.ndarray) -> list[np.ndarray]:
        """symbols: [N] float soft symbols.  Returns list of emitted 16-byte
        buffers (also forwarded to ``on_bytes``)."""
        n = len(symbols)
        if n == 0:
            return []
        # which symbols are "read" under the toggling phase
        # toggle-then-test: symbol i is read iff (phase + i) is even when
        # starting from phase False meaning next symbol is read
        start_read = not self._is_read_bit  # first symbol read?
        kept = symbols[0::2] if start_read else symbols[1::2]
        self._is_read_bit = (self._is_read_bit ^ (n % 2 == 1))

        hard = (np.asarray(kept) > 0.0).astype(np.uint8)
        if hard.size:
            prev = np.concatenate([[self._prev_bit], hard[:-1]]).astype(np.uint8)
            bits = hard ^ prev
            self._prev_bit = int(hard[-1])
            self._bit_buf.extend(bits.tolist())

        emitted = []
        nbits = 8 * self.buf_size
        while len(self._bit_buf) >= nbits:
            chunk = np.array(self._bit_buf[:nbits], dtype=np.uint8)
            del self._bit_buf[:nbits]
            buf = np.packbits(chunk)  # MSB-first, matches PushBit shift 7-idx
            emitted.append(buf)
            if self.on_bytes is not None:
                self.on_bytes(buf)
        return emitted
