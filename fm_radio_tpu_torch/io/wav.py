"""WAV sink with the exact artifact format of the reference scraper:
16-bit PCM, int16 rescale by 32767*0.95 (``fm_scraper.cpp:79-82``),
header per ``fm_scraper.cpp:92-171``.

Copy of ``fm_radio_tpu/io/wav.py`` in the port (imports rewritten).
"""

from __future__ import annotations

import struct

import numpy as np

CONVERT_RESCALE = 32767.0 * 0.95  # fm_scraper.cpp:79


def float_to_int16(audio: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> int16 with the scraper's 0.95 headroom scale.

    Matches Frame<int16_t>(data * CONVERT_RESCALE): C float->int16 conversion
    truncates toward zero.
    """
    return np.trunc(audio * CONVERT_RESCALE).clip(-32768, 32767).astype(np.int16)


def write_wav_int16(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """audio: [N, channels] float in [-1, 1] or int16."""
    if audio.ndim == 1:
        audio = audio[:, None]
    if audio.dtype != np.int16:
        audio = float_to_int16(audio)
    n_channels = audio.shape[1]
    data = audio.astype("<i2").tobytes()
    byte_rate = sample_rate * n_channels * 2
    block_align = n_channels * 2
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<i", 36 + len(data)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<ihhiihh", 16, 1, n_channels, sample_rate, byte_rate, block_align, 16))
        f.write(b"data")
        f.write(struct.pack("<i", len(data)))
        f.write(data)


def read_wav_int16(path: str) -> tuple[np.ndarray, int]:
    """Minimal RIFF reader for round-trip tests. Returns ([N, C] int16, fs)."""
    with open(path, "rb") as f:
        blob = f.read()
    assert blob[:4] == b"RIFF" and blob[8:12] == b"WAVE"
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(blob):
        cid = blob[pos : pos + 4]
        size = struct.unpack("<i", blob[pos + 4 : pos + 8])[0]
        body = blob[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<hhiihh", body[:16])
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)
    assert fmt is not None and data is not None
    _, n_channels, fs, _, _, bits = fmt
    assert bits == 16
    audio = np.frombuffer(data, dtype="<i2").reshape(-1, n_channels)
    return audio, fs
