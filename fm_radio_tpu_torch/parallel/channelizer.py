"""Polyphase FFT filterbank channelizer: wideband IQ -> M station channels.

Counterpart of ``fm_radio_tpu/parallel/channelizer.py``: a wideband capture
at M * fs_channel splits into M critically sampled channels, channel k
centred on k * fs_channel (above M/2: negative frequencies).  With
h = prototype LPF of M*K taps and frames[j, p] = x[j*M + p]:

    z_p[n] = sum_r h_rev[r*M + p] * frames[n + r, p]
    y_k[n] = sum_p exp(-2 pi i k p / M) * z_p[n]

Every function runs through ``kernels/channelizer.py::channelize`` (the
CUDA kernel for CUDA tensors, its plain version for CPU tensors).  ``taps``
may be the prototype (numpy, [K*M]) or the :class:`ChannelizerTables`
made from it on the data's device; a loop over blocks passes tables, so
that no block copies constants to the device.  ``channelize_batch_p``
also takes the TPU kernel's quantised-matrix modes (``splits``).

The exact kernel takes a wide block that is a multiple of
``kernels/channelizer.py::T_MULTIPLE`` (4,096) samples; the JAX package
takes any whole number of frames.  :func:`channelize_frames` takes such
lengths too: it zero-pads the words to the kernel's multiple and keeps the
first T/M outputs (the filterbank is causal, so the padding changes no
output of a real frame) and the carried tail of the unpadded input.
:func:`stream_selected` is the JAX package's chunked loop behind
``stations``, ``scan`` and the wideband ``selftest``.
"""

from __future__ import annotations

import numpy as np
import torch

from fm_radio_tpu_torch.kernels import channelizer as kch
from fm_radio_tpu_torch.kernels.channelizer import ChannelizerTables
from fm_radio_tpu_torch.ops.design import create_fir_lpf
from fm_radio_tpu_torch.utils.transfer import fetch, take_rows, unpack_iq_words


def make_channelizer_taps(num_channels: int, taps_per_phase: int = 16,
                          rolloff: float = 0.95) -> np.ndarray:
    """Prototype LPF: cutoff at the channel Nyquist with early roll-off
    (same policy as the decimators, broadcast_fm_demod.cpp:129)."""
    m, k = num_channels, taps_per_phase
    return create_fir_lpf(m * k, rolloff / m)


def channelizer_init_state(num_channels: int, taps_per_phase: int,
                           device="cpu") -> torch.Tensor:
    """Carried raw-IQ tail of (K-1)*M complex64 samples."""
    n = (taps_per_phase - 1) * num_channels
    return torch.zeros((n,), dtype=torch.complex64, device=device)


def as_tables(taps, m: int, device) -> ChannelizerTables:
    """``taps`` as :class:`ChannelizerTables` on ``device`` (tables pass
    through as they are)."""
    if isinstance(taps, ChannelizerTables):
        return taps
    return kch.make_tables(taps, m, device)


# the TPU kernel's carried tail in frames (channelizer_pallas.py:65): its
# quantised modes need K - 1 <= _TBF
_TBF = 16


def _chan_vmem_bytes(n_t: int, m: int, k: int = _TBF) -> int:
    """Copy of channelizer_pallas.py::_chan_vmem_bytes: the TPU kernel's
    scoped-VMEM bytes of one grid step, which :func:`pick_tile_chan`
    holds to its budget."""
    n_rows = n_t * m // 128
    tl = max(-(-((k - 1) * m) // 128), 1)
    stream = 2 * n_rows * 128 + 2 * 2 * 128 * max(n_rows, n_t // 4)
    rings = 3 * 128 * (tl + n_rows)
    vals = (6 + 2 * (tl + 1)) * 128 * n_rows
    consts_bytes = 2 * 3 * (tl + 1) * 128 * 128 * 2
    return 4 * (stream + rings + vals) + consts_bytes


def pick_tile_chan(n_frames: int, m: int, k: int = _TBF) -> int | None:
    """Copy of channelizer_pallas.py::pick_tile_chan (its unused capture
    count dropped): the TPU kernel's frame tile, or None where the JAX
    package takes its exact XLA form instead."""
    if m % 8 != 0 or m > 128:
        return None
    budget = 12 << 20
    n_t = max(256, 16384 // m)
    if n_frames % n_t != 0 or _chan_vmem_bytes(n_t, m, k) > budget:
        return None
    while (n_t * 2 <= 8192 and n_frames % (n_t * 2) == 0
           and _chan_vmem_bytes(n_t * 2, m, k) <= budget):
        n_t *= 2
    return n_t


def resolve_splits(splits: int | None, xp, num_channels: int,
                   taps_per_phase: int) -> int:
    """The precision mode a call runs, drawn as the JAX TPU route draws
    it (parallel/channelizer.py:160-169 and channelizer_pallas.py:104-153
    there): ``splits`` None reads ``FMTPU_WB_SPLITS`` (once, at import;
    default 3).  1 and 2 apply to packed words where the TPU kernel runs
    (K - 1 <= 16 and :func:`pick_tile_chan`: M % 8 == 0, M <= 128, whole
    frame tiles); on planes the TPU kernel takes its near-exact form
    whatever ``splits`` is, and outside its gate the JAX package takes the
    exact XLA form: both are the port's splits=3."""
    if splits is None:
        splits = kch.SPLITS_DEFAULT
    if splits not in kch.SPLITS:
        raise ValueError(f"channelizer splits={splits} is not one of "
                         f"{kch.SPLITS}")
    if splits == 3 or isinstance(xp, (tuple, list)):
        return 3
    m, k = num_channels, taps_per_phase
    t = xp.shape[1] * 128 if xp.ndim == 3 else xp.shape[-1]
    if k - 1 > _TBF or pick_tile_chan(t // m, m, k) is None:
        return 3
    return splits


def channelize_batch_p(taps, state_p, xp, num_channels: int,
                       out: str = "f32", splits: int | None = None):
    """W independent wideband captures through one kernel launch.

    state_p: (sr, si) each [W, (K-1)*M]; xp: [W, T] packed float32 words
    (``utils/transfer.pack_iq_u8``; also as the [W, T/128, 128] view) or
    (re, im) planes each [W, T].  Returns (state_p', (y_re, y_im)
    [W, M, T/M]); with ``out="i8"`` (state_p', y8 [2, W, M, T/M] int8) on
    the demod's u8 - 128 grid; with ``out="i8ps"`` (M = 32) the same as
    phase-split planes [2, 4, W*M, T/(4M)].  ``splits`` picks the precision
    mode as :func:`resolve_splits` draws it: 3 the exact float32
    filterbank, 1 the int8 matrices, 2 the single-bf16 matrices
    (kernels/channelizer.py).  The JAX package runs 1 and 2 only on a TPU;
    the port runs them on every device, its plain versions being the CPU
    route."""
    x0 = xp[0] if isinstance(xp, (tuple, list)) else xp
    tab = as_tables(taps, num_channels, x0.device)
    mode = resolve_splits(splits, xp, num_channels, tab.w_rev.shape[0])
    return kch.channelize(tab, state_p, xp, num_channels, out=out,
                          splits=mode)


def channelize_p(taps, state_p, xp, num_channels: int):
    """One capture, plane-tuple form: xp (re, im) [T] float32 or packed
    words [T]; state_p (re, im) [(K-1)*M].  Returns (state_p',
    (y_re, y_im) [M, T/M])."""
    if isinstance(xp, (tuple, list)):
        xb = (xp[0][None], xp[1][None])
    else:
        xb = xp[None]
    (sr, si), (y_re, y_im) = channelize_batch_p(
        taps, (state_p[0][None], state_p[1][None]), xb, num_channels)
    return (sr[0], si[0]), (y_re[0], y_im[0])


def channelize(taps, state: torch.Tensor, x: torch.Tensor,
               num_channels: int):
    """x: [T] complex64, T a multiple of the kernel's block.  Returns
    (state', y [M, T/M] complex64)."""
    st, (y_re, y_im) = channelize_p(
        taps, (state.real.contiguous(), state.imag.contiguous()),
        (x.real.contiguous(), x.imag.contiguous()), num_channels)
    return torch.complex(*st), torch.complex(y_re, y_im)


def channelize_packed(taps, state: torch.Tensor, w_packed: torch.Tensor,
                      num_channels: int):
    """Packed-word input [T] float32 (``pack_iq_u8``).  Returns
    (state' complex64, y [M, T/M] complex64)."""
    st, (y_re, y_im) = channelize_p(
        taps, (state.real.contiguous(), state.imag.contiguous()), w_packed,
        num_channels)
    return torch.complex(*st), torch.complex(y_re, y_im)


def channelize_batch(taps, state: torch.Tensor, x: torch.Tensor,
                     num_channels: int):
    """Batched complex captures: state [W, (K-1)*M], x [W, T] complex64 ->
    (state', y [W, M, T/M] complex64)."""
    (sr, si), (y_re, y_im) = channelize_batch_p(
        taps, (state.real.contiguous(), state.imag.contiguous()),
        (x.real.contiguous(), x.imag.contiguous()), num_channels)
    return torch.complex(sr, si), torch.complex(y_re, y_im)


def channelize_frames(taps, state: torch.Tensor, w_packed: torch.Tensor,
                      num_channels: int):
    """:func:`channelize_packed` on packed words [T] of any whole number of
    frames (T a multiple of M, 0 included): the words are zero-padded to a
    multiple of the kernel's block and the outputs cut back to T/M (module
    docstring); the carried state is the last (K-1)*M samples of the
    unpadded stream.  Returns (state' complex64, y [M, T/M] complex64)."""
    m = num_channels
    t = w_packed.shape[-1]
    if t % m:
        raise ValueError(f"channelizer: {t} samples are not whole frames "
                         f"of M = {m}")
    pad = -t % kch.T_MULTIPLE
    if pad == 0 and t:
        return channelize_packed(taps, state, w_packed, m)
    dev = w_packed.device
    if t:
        words = torch.cat([w_packed, w_packed.new_zeros(pad)])
        _, y = channelize_packed(taps, state, words, m)
        y = y[:, : t // m]
    else:
        y = torch.zeros((m, 0), dtype=torch.complex64, device=dev)
    n_tail = state.shape[-1]
    re, im = unpack_iq_words(w_packed[t - min(t, n_tail):])
    stream = torch.cat([state, torch.complex(re, im)])
    return stream[stream.shape[0] - n_tail:].contiguous(), y


def stream_selected(taps, state: torch.Tensor, w, num_channels: int, select,
                    consume, chunk_min: int = 1 << 22):
    """Chunked packed-word wideband streaming (the JAX package's
    ``stream_selected``): the filterbank on the state's device a chunk at a
    time, the ``select`` rows gathered there, fetched, divided by M (the
    filterbank's FFT gain) and handed to ``consume`` as complex64
    [len(select), T'] numpy.  ``w``: packed words [T] (numpy or a lazy
    view of a capture), of which the whole frames run; a chunk is
    ``max(chunk_min, M)`` words less its remainder mod M, the last one
    shorter (:func:`channelize_frames`).  The (K-1)-frame tail carries
    exactly across chunks; returns the carried state."""
    m = num_channels
    dev = state.device
    tab = as_tables(taps, m, dev)
    n = (len(w) // m) * m
    chunk = max(chunk_min, m)
    chunk -= chunk % m
    for i0 in range(0, n, chunk):
        x = torch.as_tensor(np.asarray(w[i0 : min(i0 + chunk, n)],
                                       np.float32), device=dev)
        state, y = channelize_frames(tab, state, x, m)
        consume(fetch(take_rows(y, select)) / m)
    return state
