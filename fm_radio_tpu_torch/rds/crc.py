"""RDS CRC-10 error protection (Clause 2.3).

Parity: ``src/rds_decoder/crc10.cpp:9-60`` and ``rds_constants.h:14-28``.
g(x) = x^10 + x^8 + x^7 + x^5 + x^4 + x^3 + 1.

Besides the bit-serial oracle, the syndrome is expressed as a GF(2) matrix
product (CRC is linear), which vectorizes over batches of blocks — the form a
Pallas kernel uses when decoding thousands of channels on-device.

Copy of ``fm_radio_tpu/rds/crc.py`` in the port (imports rewritten).
"""

from __future__ import annotations

import numpy as np

CRC10_POLY = 0b0110111001  # rds_constants.h:15
NB_BLOCK_BITS = 26
NB_DATA_BITS = 16
NB_CRC_BITS = 10

# Annex A, Table A.1 (rds_constants.h:21-28)
OFFSET_WORDS = {
    "A": 0b0011111100,
    "B": 0b0110011000,
    "C": 0b0101101000,
    "C1": 0b1101010000,
    "D": 0b0110110100,
    "E1": 0b0000000000,
}
OFFSET_ORDER = ["A", "B", "C", "C1", "D", "E1"]


def crc10_bitserial(x: int) -> int:
    """Bit-serial LFSR: remainder of the 26-bit word x modulo g
    (``crc10.cpp:9-26``)."""
    reg = 0
    for i in range(NB_BLOCK_BITS):
        bit = (x >> (NB_BLOCK_BITS - 1 - i)) & 1
        reg = (reg << 1) | bit
        if reg & (1 << NB_CRC_BITS):
            reg ^= CRC10_POLY
    return reg & ((1 << NB_CRC_BITS) - 1)


def _build_syndrome_matrix() -> np.ndarray:
    """M[j] = crc10(1 << (25 - j)) — syndrome of bit j (MSB-first).  CRC is
    GF(2)-linear, so crc10(x) = XOR of M[j] over set bits of x."""
    return np.array(
        [crc10_bitserial(1 << (NB_BLOCK_BITS - 1 - j)) for j in range(NB_BLOCK_BITS)],
        dtype=np.uint16,
    )

SYNDROME_MATRIX = _build_syndrome_matrix()


def _build_error_table() -> dict[int, int]:
    """Syndrome -> 1-bit error pattern (``crc10.cpp:29-52``; 2-bit patterns
    deliberately excluded — too many false corrections)."""
    table: dict[int, int] = {}
    for i in range(NB_CRC_BITS, NB_BLOCK_BITS):  # data-bit errors
        pattern = 1 << i
        table[crc10_bitserial(pattern)] = pattern
    for i in range(NB_CRC_BITS):  # checksum-bit errors
        pattern = 1 << i
        table[crc10_bitserial(pattern)] = pattern
    return table

ERROR_TABLE = _build_error_table()


def calculate_crc10(x) -> np.ndarray | int:
    """Vectorized syndrome via the GF(2) matrix; accepts int or uint32 array."""
    scalar = np.isscalar(x)
    xa = np.atleast_1d(np.asarray(x, dtype=np.uint32))
    bits = (xa[..., None] >> (NB_BLOCK_BITS - 1 - np.arange(NB_BLOCK_BITS))) & 1
    syn = np.bitwise_xor.reduce(
        np.where(bits.astype(bool), SYNDROME_MATRIX, np.uint16(0)), axis=-1
    )
    return int(syn[0]) if scalar else syn


def get_error_from_syndrome(syndrome: int) -> int:
    """0 if not a known 1-bit error pattern (``crc10.cpp:54-60``)."""
    return ERROR_TABLE.get(syndrome, 0)


def validate_codeword(x: int) -> tuple[bool, int, int, int]:
    """(is_valid, corrected_codeword, error_pattern, syndrome) — semantics of
    ``ValidateCRCCodeword`` (``rds_group_sync.cpp:136-175``)."""
    syndrome = crc10_bitserial(x)
    if syndrome == 0:
        return True, x, 0, 0
    pattern = get_error_from_syndrome(syndrome)
    if pattern == 0:
        return False, x, 0, syndrome
    x_corr = x ^ pattern
    if crc10_bitserial(x_corr) == 0:
        return True, x_corr, pattern, syndrome
    return False, x, pattern, syndrome
