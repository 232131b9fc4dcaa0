"""Application orchestration: IQ in -> audio + RDS database out.

Counterpart of ``fm_radio_tpu/models/app.py`` (parity: ``App``,
``src/app.{h,cpp}``): re-blocks arbitrary input chunks to exactly
``block_size`` (ReconstructionBuffer), runs the demodulator, and feeds the
RDS symbols of every channel through the shared host RDS chain
(``rds/chain.py``: Manchester -> group sync -> decoder -> database).

``App`` takes pre-split channels in any ingest form of ``demod_block``
(complex64 baseband, packed u8 words, float32 or int8 planes; raw u8 IQ
through ``process_u8``); ``App.process_all`` runs every whole block of a
call through :func:`demod_stream`, on the card one CUDA graph replay (the
counterpart of the JAX package's one ``lax.scan`` dispatch), on the CPU a
loop of ``demod_block``'s plain versions; ``rds_backend="native"``
decodes RDS on the C++ runtime.  The wideband commands feed ``App`` the
channelizer's selected rows as complex64 (``apps/cli.py::
run_channelized``, as the JAX commands do).  ``StationsApp`` takes the
packed u8 IQ words of one wideband capture and runs the device-resident
``wideband_demod_block`` (channelizer -> int8 bridge -> demod of every
channel, bench.py's wideband path), keeping the audio and RDS of the
selected channels; no command uses it.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict

import numpy as np
import torch

from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.kernels import _build
from fm_radio_tpu_torch.rds.chain import make_rds_chain
from fm_radio_tpu_torch.kernels.channelizer import make_tables
from fm_radio_tpu_torch.models.demod import (
    INT8_CONFIG,
    BroadcastFMDemod,
    demod_block,
    demod_init_state,
    ingest_form,
    make_coeffs,
)
from fm_radio_tpu_torch.models.wideband import (
    wideband_demod_block,
    wideband_init_state,
)
from fm_radio_tpu_torch.parallel.channelizer import make_channelizer_taps


class _Outputs:
    """Audio and RDS accumulated per output channel."""

    def __init__(self, channels: int, decode_rds: bool = True,
                 strict_ref: bool = False, rds_backend: str = "python"):
        self.channels = channels
        self.decode_rds = decode_rds
        self.rds_chains = ([make_rds_chain(rds_backend, strict_ref=strict_ref)
                            for _ in range(channels)] if decode_rds else [])
        self.audio_blocks: list[np.ndarray] = []

    def _feed(self, outs: dict) -> None:
        """One block's numpy outs of ``channels`` rows: audio appended, the
        valid RDS symbols of each row into its chain."""
        self.audio_blocks.append(outs["audio"])
        if not self.decode_rds:
            return
        pred, valid = outs["rds_pred"], outs["rds_valid"]
        for c in range(self.channels):
            sym = pred[c][valid[c]]
            if sym.size:
                self.rds_chains[c].process_symbols(sym)

    @property
    def audio(self) -> np.ndarray:
        """[C, T_audio, 2] concatenated output audio."""
        if not self.audio_blocks:
            return np.zeros((self.channels, 0, 2), np.float32)
        return np.concatenate(self.audio_blocks, axis=1)

    def drain(self) -> dict:
        """Detach and return everything accumulated since the last drain,
        leaving the demod state, RDS sync state and databases intact.
        Returns {"audio": [C, T, 2], "rds_bytes": [C arrays],
        "log_lines": [C lists of new group log lines]}."""
        audio = self.audio
        self.audio_blocks.clear()
        rds_bytes, log_lines = [], []
        for c, ch in enumerate(self.rds_chains):
            rds_bytes.append(self.rds_bytes(c))
            ch.rds_bytes.clear()
            log_lines.append(list(ch.chain.log_lines))
            ch.chain.log_lines.clear()
            ch.chain.groups.clear()
        return {"audio": audio, "rds_bytes": rds_bytes,
                "log_lines": log_lines}

    def rds_database(self, channel: int = 0):
        return self.rds_chains[channel].db

    def rds_bytes(self, channel: int = 0) -> np.ndarray:
        bufs = self.rds_chains[channel].rds_bytes
        return np.concatenate(bufs) if bufs else np.zeros(0, np.uint8)

    def rds_log_lines(self, channel: int = 0) -> list[str]:
        return self.rds_chains[channel].chain.log_lines


class App(_Outputs):
    """Pre-split channels -> audio + RDS per channel (``app.py::App``).

    ``integer_input=True`` declares the baseband integer-valued (u8 IQ
    recentred by -127, the radio's native format): it sets
    ``cfg.assume_integer_input``, which lets ``frontend_int8`` take int8
    taps on float32 planes too.  Keep it False for non-integer sources
    (channelizer output).  ``rds_backend`` "native" decodes RDS on the C++
    runtime's bit loops (``rds/chain.py::make_rds_chain``: raises where the
    runtime cannot be built)."""

    def __init__(
        self,
        block_size: int = 65536,
        cfg: DemodConfig = DemodConfig(),
        channels: int = 1,
        decode_rds: bool = True,
        integer_input: bool = False,
        rds_backend: str = "python",
        strict_ref: bool = False,
        device="cuda",
    ):
        super().__init__(channels, decode_rds, strict_ref, rds_backend)
        if integer_input:
            cfg = dataclasses.replace(cfg, assume_integer_input=True)
        self.block_size = block_size
        self.demod = BroadcastFMDemod(cfg, channels, device)
        self._pending = np.zeros((channels, 0), dtype=np.complex64)

    @property
    def cfg(self) -> DemodConfig:
        """The live config (tracks ``demod.update_controls``)."""
        return self.demod.cfg

    def _match_pending(self, x: np.ndarray) -> np.ndarray:
        """Pending re-block buffer in the stream's dtype (complex64
        baseband, float32 packed words, or [2, C, N] planes): a stream keeps
        ONE format throughout (app.py:68-83)."""
        if self._pending.dtype != x.dtype or self._pending.ndim != x.ndim:
            if self._pending.size:
                raise ValueError(
                    "input format changed mid-stream with samples pending "
                    f"({self._pending.dtype} -> {x.dtype}); a stream must "
                    "keep one format (complex64 baseband, f32 packed words, "
                    "or int8 planes)")
            shape = ((2, self.channels, 0) if x.ndim == 3
                     else (self.channels, 0))
            self._pending = np.zeros(shape, x.dtype)
        return self._pending

    def process_u8(self, iq_u8: np.ndarray) -> None:
        """iq_u8: [N, 2] raw interleaved bytes (one channel) or [C, N, 2],
        recentred by -127 into complex64 (app.py:85-90)."""
        f = iq_u8.astype(np.float32) - 127.0
        self.process((f[..., 0] + 1j * f[..., 1]).astype(np.complex64))

    def process(self, x: np.ndarray) -> None:
        """x: [N] or [C, N] centred complex64, float32 packed u8 words
        (``pack_iq_u8``), or [2, C, N] int8 planes (``split_iq_i8``; [2, N]
        for one channel) or float32 planes.  Re-blocks internally
        (reconstruction_buffer.h:16-26)."""
        x = np.asarray(x)
        if x.ndim == 1:
            x = x[None, :]
        elif x.ndim == 2 and x.dtype == np.int8:
            x = x[:, None, :]
        buf = np.concatenate([self._match_pending(x), x], axis=-1)
        n_blocks = buf.shape[-1] // self.block_size
        for b in range(n_blocks):
            blk = buf[..., b * self.block_size : (b + 1) * self.block_size]
            self._feed(self.demod.process(blk))
        self._pending = buf[..., n_blocks * self.block_size :]

    def process_all(self, x: np.ndarray) -> None:
        """The outputs of :meth:`process`, with every whole block of the
        call in one :func:`demod_stream` (app.py:107-145): on the card one
        CUDA graph replay, cached by shape, so a stream of equal calls pays
        one capture; on the CPU a loop of the plain versions.  The RDS
        chains take the call's valid symbols at once, and the partial
        block stays pending, as in the JAX package."""
        x = np.asarray(x)
        if x.ndim == 1:
            x = x[None, :]
        elif x.ndim == 2 and x.dtype == np.int8:
            x = x[:, None, :]
        buf = (np.concatenate([self._match_pending(x), x], axis=-1)
               if self._pending.size else x)
        n_blocks = buf.shape[-1] // self.block_size
        if n_blocks == 0:
            self._pending = buf
            return
        t = n_blocks * self.block_size
        # demod.cfg and demod.coeffs track update_controls
        state, outs = _stream(self.demod.cfg,
                              torch.from_numpy(np.ascontiguousarray(
                                  buf[..., :t])),
                              self.block_size, self.demod.state,
                              self.demod.coeffs, self.demod.device)
        self.demod.state = _clone(state)
        self._feed({k: v.cpu().numpy() for k, v in outs.items()})
        self._pending = buf[..., t:]


class StationsApp(_Outputs):
    """One wideband capture of M channels -> the selected stations.

    ``process`` takes packed u8 IQ words (``utils/transfer.pack_iq_u8``) in
    chunks of any length and runs ``wideband_demod_block`` on every whole
    wide block of M * ``block_size`` words; a final partial block stays
    pending, as ``App`` keeps a partial block.  All M channels are
    demodulated on the device; the rows of ``select`` are fetched."""

    def __init__(self, num_channels: int, block_size: int = 65536,
                 select=None, taps_per_phase: int = 16,
                 cfg: DemodConfig = INT8_CONFIG, device="cuda"):
        m = num_channels
        self.select = list(range(m)) if select is None else list(select)
        super().__init__(len(self.select))
        self.num_channels = m
        self.block_size = block_size
        self.cfg = cfg
        self.device = torch.device(device)
        self.coeffs = make_coeffs(cfg, self.device)
        self.tables = make_tables(make_channelizer_taps(m, taps_per_phase), m,
                                  self.device)
        self.state = wideband_init_state(cfg, m, 1, taps_per_phase,
                                         self.device)
        self._rows = torch.as_tensor(self.select, device=self.device)
        self._pending = np.zeros(0, np.float32)

    def process(self, words: np.ndarray) -> None:
        buf = np.concatenate([self._pending, np.asarray(words, np.float32)])
        wide = self.num_channels * self.block_size
        n_blocks = buf.size // wide
        for b in range(n_blocks):
            x = torch.from_numpy(buf[b * wide : (b + 1) * wide])
            self.state, outs = wideband_demod_block(
                self.cfg, self.coeffs, self.tables, self.state,
                x.to(self.device)[None], self.num_channels)
            self._feed({k: outs[k][self._rows].cpu().numpy()
                        for k in ("audio", "rds_pred", "rds_valid")})
        self._pending = buf[n_blocks * wide :]


# ---- the whole stream: one CUDA graph on the card -------------------------

_STREAM_OUTS = ("audio", "rds_pred", "rds_valid")
_GRAPHS_KEPT = 4  # captured graphs cached, the oldest dropped first
_graphs: OrderedDict = OrderedDict()
# the last CUDA call of demod_stream: whether it captured, the capture's
# wall ms and the bytes it reserved for the graph's private pool
last_stream: dict = {}


def _clone(tree):
    """A copy of a state's every tensor (dicts, NamedTuples kept)."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_clone(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(
            items)
    return tree.clone()


def _leaves(tree, out: list) -> list:
    """The tensors of a state in a fixed order (dict keys, tuple fields)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    elif isinstance(tree, tuple):
        for v in tree:
            _leaves(v, out)
    else:
        out.append(tree)
    return out


def block_of(x: torch.Tensor, i: int, block_size: int) -> torch.Tensor:
    """Block i of x [..., T], contiguous: where x holds more than one row,
    a copy, moved as 8-byte words where the rows allow it (a strided copy
    of int8 or float32 elements moves a fraction of the card's rate)."""
    blk = x[..., i * block_size:(i + 1) * block_size]
    if blk.is_contiguous():
        return blk
    if (not blk.is_complex() and blk.element_size() < 8
            and block_size * blk.element_size() % 8 == 0
            and blk.storage_offset() * blk.element_size() % 8 == 0):
        return blk.view(torch.int64).contiguous().view(blk.dtype)
    return blk.contiguous()


def _run_blocks(cfg, coeffs, state, x, block_size: int, n_blocks: int):
    """``demod_block`` over the blocks of x [..., n_blocks * block_size]
    (:func:`block_of`), the outs folded back into time."""
    got = {k: [] for k in _STREAM_OUTS}
    for i in range(n_blocks):
        state, outs = demod_block(cfg, coeffs, state,
                                  block_of(x, i, block_size))
        for k in _STREAM_OUTS:
            got[k].append(outs[k])
    return state, {k: torch.cat(v, dim=1) for k, v in got.items()}


class _StreamGraph:
    """One captured stream: ``graph`` replays ``demod_block`` over the
    blocks of ``src`` from the state in ``state_in`` into ``state_out``
    and ``outs`` (all of them the graph's own tensors); it holds the
    coefficients it read, so their memory outlives it."""

    def __init__(self, cfg, coeffs, state, src, block_size: int,
                 n_blocks: int):
        dev = src.device
        # one block first, on a copy of the state: every kernel library
        # built, loaded and its launch attributes set before the capture
        _run_blocks(cfg, coeffs, _clone(state), src, block_size, 1)
        torch.cuda.synchronize(dev)
        self.coeffs, self.src = coeffs, src
        self.state_in = _clone(state)
        self.graph = torch.cuda.CUDAGraph()
        torch.cuda.empty_cache()  # as the capture's entry does
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph, pool=torch.cuda.graph_pool_handle()):
            self.state_out, self.outs = _run_blocks(
                cfg, coeffs, self.state_in, src, block_size, n_blocks)
        torch.cuda.synchronize(dev)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved


def clear_stream_graphs() -> None:
    """Drop every cached stream graph (and with it its private pool)."""
    _graphs.clear()


def _stream(cfg, x: torch.Tensor, block_size: int, state: dict, coeffs,
            device: torch.device):
    """:func:`demod_stream` without the copies of the outputs: on the card
    the graph's own state and outs, valid until its next replay."""
    n_blocks = x.shape[-1] // block_size
    if device.type == "cpu":
        return _run_blocks(cfg, coeffs, state, x.to(device), block_size,
                           n_blocks)
    on_card = x.device.type == "cuda"
    # jax.jit caches by shape; a graph also bakes the pointers it reads:
    # the caller's device tensor (read in place) or its own staging buffer
    key = (cfg, id(coeffs), ingest_form(x), tuple(x.shape), x.dtype,
           block_size, n_blocks, str(device), _build._checked,
           (x.data_ptr(), x.stride()) if on_card else None)
    g = _graphs.get(key)
    captured = g is None
    if captured:
        src = x if on_card else x.to(device)
        g = _StreamGraph(cfg, coeffs, state, src, block_size, n_blocks)
        _graphs[key] = g
        while len(_graphs) > _GRAPHS_KEPT:
            _graphs.popitem(last=False)
    else:
        _graphs.move_to_end(key)
        if not on_card:
            g.src.copy_(x)
    torch._foreach_copy_(_leaves(g.state_in, []), _leaves(state, []))
    g.graph.replay()
    last_stream.clear()
    last_stream.update(captured=captured, capture_ms=g.capture_ms,
                       pool_bytes=g.pool_bytes, blocks=n_blocks)
    return g.state_out, g.outs


def demod_stream(cfg: DemodConfig, x, block_size: int = 65536,
                 state: dict | None = None, coeffs=None, device=None):
    """Whole-stream demodulation (``app.py::demod_stream``, :203-273).

    x: [C, T] complex64, [C, T] float32 packed u8 IQ words, or [2, C, T]
    int8 planes (u8 - 128), numpy or torch; T a multiple of
    ``block_size``.  Returns (final_state, outs): audio [C, T/32, 2],
    rds_pred and rds_valid [C, T/64], the block axis folded into time.
    Pass ``coeffs`` to reuse a design (after ``update_controls``); by
    default they are designed from ``cfg``.

    ``device`` (default: x's device for a tensor, else the state's, else
    cuda) runs it.  On the CPU it is a loop of ``demod_block``'s plain
    versions.  On the card the whole stream is one CUDA graph replay, the
    counterpart of the JAX package's one ``lax.scan`` dispatch: the first
    call at a shape captures ``demod_block`` over its blocks (one block
    run first on a copy of the state), and later calls with the same
    config, coefficients (by identity), ingest form, shape, block size
    and device replay it, the carried state copied into the graph's own
    before each replay and the outputs copied out after it.  An input on
    the card is read in place (its pointer is part of the key); a host
    input is copied into the graph's staging buffer.  A capture that
    fails raises: the blocks never run eagerly on the card instead.  The
    kernel wrappers' ``launches`` counters count the capture's calls only:
    a replay counts nothing.
    """
    xt = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    if xt.dtype in (torch.float64, torch.complex128):
        xt = xt.to(torch.complex64 if xt.is_complex() else torch.float32)
    t = xt.shape[-1]
    if t % block_size:
        raise ValueError(f"stream of {t} samples is not a whole number of "
                         f"blocks of {block_size}")
    if device is None:
        device = (xt.device if isinstance(x, torch.Tensor)
                  else state["ds_fm_in"].device if state is not None
                  else "cuda")
    device = torch.device(device)
    if coeffs is None:
        coeffs = make_coeffs(cfg, device)
    if state is None:
        state = demod_init_state(cfg, xt.shape[-2], device)
    state, outs = _stream(cfg, xt, block_size, state, coeffs, device)
    if device.type == "cpu":
        return state, outs
    return _clone(state), {k: v.clone() for k, v in outs.items()}
