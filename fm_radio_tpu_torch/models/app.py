"""Application orchestration: IQ in -> audio + RDS database out.

Counterpart of ``fm_radio_tpu/models/app.py`` (parity: ``App``,
``src/app.{h,cpp}``): re-blocks arbitrary input chunks to exactly
``block_size`` (ReconstructionBuffer), runs the demodulator, and feeds the
RDS symbols of every channel through the shared host RDS chain
(``rds/chain.py``: Manchester -> group sync -> decoder -> database).

``App`` takes pre-split channels in any ingest form of ``demod_block``
(complex64 baseband, packed u8 words, float32 or int8 planes; raw u8 IQ
through ``process_u8``); ``StationsApp`` takes the
packed u8 IQ words of one wideband capture and runs the device-resident
``wideband_demod_block`` (channelizer -> int8 bridge -> demod), keeping the
audio and RDS of the selected channels (``fmtpu stations``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.rds.chain import make_rds_chain
from fm_radio_tpu_torch.kernels.channelizer import make_tables
from fm_radio_tpu_torch.models.demod import (
    INT8_CONFIG,
    BroadcastFMDemod,
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
                 strict_ref: bool = False):
        self.channels = channels
        self.decode_rds = decode_rds
        self.rds_chains = ([make_rds_chain(strict_ref=strict_ref)
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
    (channelizer output)."""

    def __init__(
        self,
        block_size: int = 65536,
        cfg: DemodConfig = DemodConfig(),
        channels: int = 1,
        decode_rds: bool = True,
        integer_input: bool = False,
        strict_ref: bool = False,
        device="cuda",
    ):
        super().__init__(channels, decode_rds, strict_ref)
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
