"""Software broadcast-FM modulator — the synthetic signal source.

The reference validates only against released off-air recordings
(``README.md:56-60``); we additionally generate known multiplex signals so the
whole chain (pilot lock, stereo separation, RDS group round-trip) is testable
hermetically (SURVEY.md §4).

Multiplex composition (standard broadcast FM, matching what the demodulator at
``broadcast_fm_demod.h:99-104`` expects):

    mpx(t) = a_mono * (L+R)/2
           + a_pilot * cos(2*pi*19k*t)
           + a_stereo * (L-R)/2 * sin(2*pi*38k*t)     (DSB-SC, 2nd harmonic)
           + a_rds * d(t) * sin(2*pi*57k*t)           (BPSK,   3rd harmonic)

    iq(t) = A * exp(j * 2*pi*Fd * integral(mpx))

The L-R / RDS subcarriers use the quadrature (sin) phase so that after the
demodulator's pilot-locked harmonic downconversion the payload lands on the
imaginary axis — where the reference reads it (``broadcast_fm_demod.cpp:518-521``
for L-R, the ±j constellation at ``bpsk_synchroniser.cpp:158-166`` for RDS).

RDS bit stream: groups -> CRC10 + offset words -> differential encoding ->
biphase (Manchester) symbols at 2*1187.5 Bd (Clause 2 of the RDS standard;
block structure per ``rds_constants.h``).

Copy of ``fm_radio_tpu/io/synth.py`` in the port (imports rewritten).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from fm_radio_tpu_torch.rds.crc import OFFSET_WORDS, crc10_bitserial


@dataclasses.dataclass
class ModulatorConfig:
    fs: int = 1_024_000
    f_deviation: float = 75e3
    f_pilot: float = 19e3
    # amplitudes (fractions of total deviation)
    a_mono: float = 0.45
    a_pilot: float = 0.10
    a_stereo: float = 0.45
    a_rds: float = 0.06
    rds_symbol_rate: float = 1187.5
    amplitude: float = 100.0  # IQ amplitude in u8 counts (max 127)


def encode_rds_group(blocks: tuple[int, int, int, int]) -> np.ndarray:
    """4 x 16-bit data words -> 104 bits (4 x 26-bit blocks with offsets
    A, B, C|C', D — version-B groups (bit 11 of block B) use offset C' on
    the third block per IEC 62106 §5.1).

    checkword = crc10(data << 10); transmitted block = (data<<10 | crc) ^ offset.
    """
    version_b = (blocks[1] >> 11) & 1
    out = []
    offsets = ("A", "B", "C1" if version_b else "C", "D")
    for data, off_name in zip(blocks, offsets):
        crc = crc10_bitserial(data << 10)
        codeword = ((data & 0xFFFF) << 10) | crc
        codeword ^= OFFSET_WORDS[off_name]
        for i in range(25, -1, -1):
            out.append((codeword >> i) & 1)
    return np.array(out, dtype=np.uint8)


def rds_bits_to_symbols(bits: np.ndarray, initial: int = 0) -> np.ndarray:
    """Differential encode then biphase: each coded bit b' -> (+s, -s).

    The receiver decodes bit = curr ^ prev over every-other symbol
    (``differential_manchester_decoder.h:38-42``), so we transmit
    e[n] = bits[n] ^ e[n-1] and emit symbol pair (e, 1-e) as ±1.
    """
    enc = np.zeros(len(bits), dtype=np.uint8)
    prev = initial
    for i, b in enumerate(bits):
        prev = prev ^ int(b)
        enc[i] = prev
    sym = np.empty(2 * len(bits), dtype=np.float32)
    sym[0::2] = enc * 2.0 - 1.0
    sym[1::2] = -(enc * 2.0 - 1.0)
    return sym


def station_group_schedule(
    pi: int,
    ps: str = "",
    rt: str = "",
    af_mhz: list[float] | None = None,
    pty: int = 0,
    tp: int = 0,
) -> list[tuple[int, int, int, int]]:
    """Build the repeating RDS group cycle for a station: 0A groups carrying
    the 8-char programme-service name + method-A alternative frequencies,
    interleaved with 2A RadioText groups (IEC 62106 §6.1.5.1/.3 layouts —
    the same fields ``rds_decoder.cpp:159-337`` parses)."""
    groups: list[tuple[int, int, int, int]] = []
    ps8 = (ps or "").ljust(8)[:8].encode("latin-1", "replace")
    # AF code stream: count header then VHF codes, padded to pairs with 205
    af_codes: list[int] = []
    if af_mhz:
        af_codes.append(224 + len(af_mhz))
        for f in af_mhz:
            code = int(round((f - 87.5) * 10))
            if not 1 <= code <= 204:
                raise ValueError(f"AF {f} MHz outside 87.6..107.9")
            af_codes.append(code)
    if len(af_codes) % 2:
        af_codes.append(205)  # filler
    # AF codes stream 2-per-0A-group independent of the PS segment address,
    # so a long AF list needs more than one 4-segment PS cycle — otherwise
    # the announced count is never reached and no list ever commits
    n_0a = max(4, len(af_codes) // 2)
    for gi in range(n_0a):
        seg = gi % 4
        b = (0 << 12) | (tp << 10) | ((pty & 0x1F) << 5) | seg
        if seg == 3:
            b |= 1 << 2  # DI stereo bit arrives on segment 3
        c = ((af_codes[2 * gi] << 8) | af_codes[2 * gi + 1]
             if 2 * gi + 1 < len(af_codes) else (205 << 8) | 205)
        d = (ps8[2 * seg] << 8) | ps8[2 * seg + 1]
        groups.append((pi, b, c, d))
    if rt:
        text = rt[:64]
        if len(text) < 64:
            text += "\r"  # carriage-return terminator (Clause 6.1.5.3)
        text += "\r" * ((-len(text)) % 4)  # pad the last group
        tb = text.encode("latin-1", "replace")
        for seg in range(len(tb) // 4):
            b = (2 << 12) | (tp << 10) | ((pty & 0x1F) << 5) | seg
            c = (tb[4 * seg] << 8) | tb[4 * seg + 1]
            d = (tb[4 * seg + 2] << 8) | tb[4 * seg + 3]
            groups.append((pi, b, c, d))
    return groups


def make_wideband(
    station_iq: dict[int, np.ndarray], m: int, fs_ch: float = 1_024_000.0
) -> np.ndarray:
    """Mix channel-rate station IQ into one wideband capture at ``m*fs_ch``:
    station ``k`` lands at carrier ``k*fs_ch`` (the channelizer's bin grid).
    Zero-order-hold interpolation: its sinc images are far below FM's
    capture threshold and fall in other bins' stopbands."""
    n_wide = max(iq.size for iq in station_iq.values()) * m
    t = np.arange(n_wide) / (fs_ch * m)
    wide = np.zeros(n_wide, np.complex64)
    for k, iq in station_iq.items():
        up = np.repeat(iq, m)[:n_wide]
        wide += (up * np.exp(2j * np.pi * (k * fs_ch) * t)).astype(np.complex64)
    return wide


class FMModulator:
    """Stateful block modulator (phase-continuous across blocks)."""

    def __init__(self, cfg: ModulatorConfig = ModulatorConfig()):
        self.cfg = cfg
        self._phase = 0.0
        self._n = 0  # absolute sample counter (for subcarrier phases)

    def multiplex(
        self,
        left: np.ndarray,
        right: np.ndarray,
        rds_symbols: np.ndarray | None = None,
    ) -> np.ndarray:
        """Build the MPX baseband from audio (at fs!) and RDS symbols."""
        cfg = self.cfg
        n = len(left)
        t_idx = self._n + np.arange(n)
        t = t_idx / cfg.fs
        w1 = 2 * np.pi * cfg.f_pilot
        mpx = (
            cfg.a_mono * 0.5 * (left + right)
            + cfg.a_pilot * np.cos(w1 * t)
            + cfg.a_stereo * 0.5 * (left - right) * np.sin(2 * w1 * t)
        )
        if rds_symbols is not None:
            sps = cfg.fs / (2 * cfg.rds_symbol_rate)  # samples per biphase symbol
            idx = np.minimum((t_idx / sps).astype(np.int64), len(rds_symbols) - 1)
            d = rds_symbols[idx]
            mpx = mpx + cfg.a_rds * d * np.sin(3 * w1 * t)
        return mpx.astype(np.float64)

    def modulate(self, mpx: np.ndarray) -> np.ndarray:
        """FM modulate: phase-continuous complex IQ (centered, float)."""
        cfg = self.cfg
        dphi = 2 * np.pi * cfg.f_deviation * mpx / cfg.fs
        phase = self._phase + np.cumsum(dphi)
        self._phase = float(phase[-1])
        self._n += len(mpx)
        return (cfg.amplitude * np.exp(1j * phase)).astype(np.complex64)

    def generate(
        self,
        n_samples: int,
        left_hz: float = 0.0,
        right_hz: float = 0.0,
        left_amp: float = 1.0,
        right_amp: float = 1.0,
        rds_groups: list[tuple[int, int, int, int]] | None = None,
    ) -> np.ndarray:
        """Convenience: tone audio + optional repeated RDS groups -> IQ."""
        cfg = self.cfg
        t = (self._n + np.arange(n_samples)) / cfg.fs
        left = left_amp * np.sin(2 * np.pi * left_hz * t) if left_hz else np.zeros(n_samples)
        right = right_amp * np.sin(2 * np.pi * right_hz * t) if right_hz else np.zeros(n_samples)
        sym = None
        if rds_groups is not None:
            bits = np.concatenate([encode_rds_group(g) for g in rds_groups])
            # repeat the BIT stream, then differentially encode once:
            # tiling the encoded symbols instead would break differential
            # continuity at every repetition seam (one bit error per ~104
            # bits unless the final encoded level happens to be 0).
            # multiplex() indexes symbols by the ABSOLUTE sample counter, so
            # a streaming (multi-call) modulator must cover 0.._n+n_samples
            # — sizing from n_samples alone froze the subcarrier at the last
            # symbol from the second block on.
            sps = cfg.fs / (2 * cfg.rds_symbol_rate)
            need_sym = int(np.ceil((self._n + n_samples) / sps)) + 1
            reps = max(int(np.ceil(need_sym / (2 * len(bits)))), 1)
            sym = rds_bits_to_symbols(np.tile(bits, reps))
        return self.modulate(self.multiplex(left, right, sym))
