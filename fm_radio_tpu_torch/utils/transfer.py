"""Ingest conventions shared with the JAX package.

Copies of ``fm_radio_tpu/utils/transfer.py`` functions (that module imports
jax):

- ``split_iq_i8``: raw u8 IQ -> [2, ..., N] int8 planes of (I - 128,
  Q - 128).  The shift is -128, not the reference's -127 (app.cpp:57-63),
  because 255 - 127 overflows int8; K12 adds the +1 back.
- ``i8_planes_to_f32``: those planes back to centred (re, im) float32
  (u8 - 127), exactly.
- ``pack_iq_u8`` / ``unpack_iq_words``: one float32 word per complex
  sample, w = I * 256 + Q (exact integers < 2^16), the wideband
  channelizer's and ``demod --ingest f32w``'s input; unpacked and
  recentred by -127 exactly.
- ``fetch`` / ``take_rows``: a tensor to host numpy, and rows picked by
  host indices on the tensor's device (the JAX versions route complex
  and integer arrays through float32 for the TPU's host boundary; here
  they are plain tensor ops).
"""

from __future__ import annotations

import numpy as np
import torch


def pack_iq_u8(iq_u8: np.ndarray) -> np.ndarray:
    """u8 IQ [..., N, 2] -> [..., N] float32 words w = I * 256 + Q."""
    iq = np.asarray(iq_u8)
    if iq.shape[-1] != 2 or iq.dtype != np.uint8:
        raise ValueError(f"expected [..., N, 2] uint8, got {iq.dtype} "
                         f"{iq.shape}")
    w = iq[..., 0].astype(np.float32)
    w *= 256.0
    w += iq[..., 1]
    return w


def unpack_iq_words(w: torch.Tensor):
    """Packed words -> centred (re, im) float32: I = floor(w/256) - 127,
    Q = w - 256 floor(w/256) - 127.  Exact on integers < 2^16 (the scale
    by 2^-8, floor and the subtractions round nothing)."""
    ihi = torch.floor(w * (1.0 / 256.0))
    return ihi - 127.0, (w - ihi * 256.0) - 127.0


def split_iq_i8(iq_u8: np.ndarray) -> np.ndarray:
    """u8 IQ [..., N, 2] -> [2, ..., N] int8 planes of (I - 128, Q - 128)."""
    iq = np.asarray(iq_u8)
    if iq.shape[-1] != 2 or iq.dtype != np.uint8:
        raise ValueError(f"expected [..., N, 2] uint8, got {iq.dtype} "
                         f"{iq.shape}")
    planes = np.moveaxis(iq, -1, 0).astype(np.int16) - 128
    return np.ascontiguousarray(planes.astype(np.int8))


def i8_planes_to_f32(x8: torch.Tensor):
    """[2, ..., N] int8 planes (u8 - 128) -> centred (re, im) float32
    planes (u8 - 127): the cast and the +1 are exact."""
    return x8[0].to(torch.float32) + 1.0, x8[1].to(torch.float32) + 1.0


def fetch(x) -> np.ndarray:
    """A tensor (any device) as host numpy of its own dtype; numpy passes
    through."""
    if isinstance(x, np.ndarray):
        return x
    return x.detach().cpu().numpy()


def take_rows(y: torch.Tensor, select) -> torch.Tensor:
    """Rows ``select`` (host indices) of y along its first axis, gathered
    on y's device."""
    idx = torch.as_tensor(np.asarray(select, np.int64), device=y.device)
    return y.index_select(0, idx)
