"""Ingest conventions shared with the JAX package.

``split_iq_i8`` is a copy of ``fm_radio_tpu/utils/transfer.py::split_iq_i8``
(that module imports jax): raw u8 IQ -> [2, ..., N] int8 planes of
(I - 128, Q - 128).  The shift is -128, not the reference's -127
(app.cpp:57-63), because 255 - 127 overflows int8; K12 adds the +1 back.
"""

from __future__ import annotations

import numpy as np


def split_iq_i8(iq_u8: np.ndarray) -> np.ndarray:
    """u8 IQ [..., N, 2] -> [2, ..., N] int8 planes of (I - 128, Q - 128)."""
    iq = np.asarray(iq_u8)
    if iq.shape[-1] != 2 or iq.dtype != np.uint8:
        raise ValueError(f"expected [..., N, 2] uint8, got {iq.dtype} "
                         f"{iq.shape}")
    planes = np.moveaxis(iq, -1, 0).astype(np.int16) - 128
    return np.ascontiguousarray(planes.astype(np.int8))
