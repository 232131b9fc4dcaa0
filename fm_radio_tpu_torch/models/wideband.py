"""Wideband end-to-end step: channelizer -> int8 bridge -> batched demod.

Counterpart of ``fm_radio_tpu/models/wideband.py``: W wideband captures of
packed u8 IQ words (M channels each) -> the polyphase FFT channelizer ->
``demod_block`` over all C = W*M stations, on the device, with nothing
passing through the host.  Per-channel block B = T/M for a wide block of T
samples per capture.

Bridges (``bridge``):
- "i8" (production): the channelizer writes the 1/M-descaled channel planes
  on the u8 grid as int8 (the demod's u8 - 128 convention), the same 8-bit
  quantisation the capture already had.  At M = 32 it writes them as
  phase-split planes [2, 4, C, B/4], which K12's phase-split entry reads
  directly; at other M as [2, W, M, B], a free reshape to [2, C, B].
- "f32": the exact float32 channel planes, scaled by 1/M, as [2, C, B]
  float32 planes into the split front end (K1 on planes, then K2): the
  accuracy oracle of the bridge.
"""

from __future__ import annotations

import torch

from fm_radio_tpu_torch.models.demod import demod_block, demod_init_state
from fm_radio_tpu_torch.ops.cmath import f32
from fm_radio_tpu_torch.parallel.channelizer import (
    as_tables,
    channelize_batch_p,
    make_channelizer_taps,
    resolve_splits,
)

PHASE_SPLIT_M = 32  # the channelizer's 128/M frame phases = the ds x4 phases


def wideband_init_state(cfg, num_channels: int, n_captures: int,
                        taps_per_phase: int = 16, device="cpu") -> dict:
    """Carried state of :func:`wideband_demod_block`: per-capture
    filterbank tails (sr, si) each [W, (K-1)*M] float32, and the demod
    state of C = W*M channels (the JAX package's layout)."""
    m = num_channels
    n_tail = (taps_per_phase - 1) * m
    zeros = torch.zeros((n_captures, n_tail), dtype=torch.float32,
                        device=device)
    return {
        "chan": (zeros, zeros.clone()),
        "demod": demod_init_state(cfg, n_captures * m, device),
    }


def wideband_demod_block(cfg, coeffs, ch_taps, state: dict, w_words,
                         num_channels: int, bridge: str = "i8",
                         splits: int | None = None,
                         record: dict | None = None):
    """One wideband block: [W, T] packed u8 IQ words (or the [W, T/128, 128]
    view) -> channelize -> bridge -> ``demod_block`` over C = W*M stations.

    ``ch_taps``: None (``make_channelizer_taps(M)``), the prototype taps,
    or ``ChannelizerTables`` on the words' device.  ``splits`` is the
    channelizer's precision mode (``parallel/channelizer.py::
    resolve_splits``: None reads ``FMTPU_WB_SPLITS``, default 3); the f32
    bridge passes none, as the JAX package's does.  Returns (state', outs)
    with ``demod_block``'s outs.  ``record``, if given, receives the
    arguments of the channelizer wrapper (``kernels/channelizer.py::
    channelize``: tables, state, words, M, out, and the mode that ran)
    under "channelizer" and is passed on to ``demod_block``, which records
    its own kernels' arguments."""
    m = num_channels
    if bridge not in ("i8", "f32"):
        raise ValueError(f"bridge must be 'i8' or 'f32', got {bridge!r}")
    if ch_taps is None:
        ch_taps = make_channelizer_taps(m)
    tab = as_tables(ch_taps, m, w_words.device)
    if bridge == "f32":
        out, splits = "f32", None
    else:
        out = "i8ps" if m == PHASE_SPLIT_M else "i8"
    mode = resolve_splits(splits, w_words, m, tab.w_rev.shape[0])
    st = dict(state)
    if record is not None:
        record["channelizer"] = (tab, st["chan"], w_words, m, out, mode)
    st["chan"], y = channelize_batch_p(tab, st["chan"], w_words, m,
                                       out=out, splits=mode)
    if out == "f32":
        # undo the filterbank's DFT scaling (wideband.py:85-92)
        c = y[0].shape[0] * m
        inv_m = f32(1.0 / m)
        x = torch.stack([y[0].reshape(c, -1) * inv_m,
                         y[1].reshape(c, -1) * inv_m])
    else:
        x = y if out == "i8ps" else y.reshape(2, y.shape[1] * m, -1)
    st["demod"], outs = demod_block(cfg, coeffs, st["demod"], x,
                                    record=record)
    return st, outs
