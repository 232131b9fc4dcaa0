"""Artifact sink with the reference ``FM_Scraper``'s exact file lifecycle
(``src/fm_scraper.{h,cpp}``):

* audio -> ``<time>_audio.wav``: the file opens LAZILY on the first audio
  block and a NEW timestamped file opens whenever the sample rate changes
  (``fm_scraper.cpp:56-66``); samples are int16 at the 32767*0.95 headroom
  rescale (``:79-82``); the RIFF header is re-stamped after every write so
  a truncated capture is still playable (``:92-171``).
* RDS bytes -> ``<time>_rds.bin``: one lazily-opened file on the first
  byte buffer (``fm_scraper.cpp:179-200``).

Time string format: ``%04d-%02d-%02dT%02d-%02d-%02d``
(``fm_scraper.cpp:40-45``).  As in the reference, two rotations within the
same second reuse the same name (truncating open) — seconds resolution is
part of the artifact contract.

Copy of ``fm_radio_tpu/io/scraper.py`` in the port (imports rewritten;
``use_native`` takes the port's ``runtime.py``).
"""

from __future__ import annotations

import os
import struct
import time

import numpy as np

from fm_radio_tpu_torch.io.wav import float_to_int16


def reference_time_string(t: float | None = None) -> str:
    """``get_current_time`` parity (``fm_scraper.cpp:36-45``, localtime)."""
    tm = time.localtime(t)
    return (f"{tm.tm_year:04d}-{tm.tm_mon:02d}-{tm.tm_mday:02d}"
            f"T{tm.tm_hour:02d}-{tm.tm_min:02d}-{tm.tm_sec:02d}")


class IncrementalWavWriter:
    """Append-mode 16-bit PCM WAV with in-place header updates
    (``fm_scraper.cpp:92-171``): sizes are re-stamped after every write."""

    def __init__(self, path: str, sample_rate: int, n_channels: int = 2):
        self.path = path
        self.n_channels = n_channels
        self._f = open(path, "wb+")
        byte_rate = sample_rate * n_channels * 2
        block_align = n_channels * 2
        self._f.write(b"RIFF")
        self._f.write(struct.pack("<i", 36))
        self._f.write(b"WAVE")
        self._f.write(b"fmt ")
        self._f.write(struct.pack("<ihhiihh", 16, 1, n_channels, sample_rate,
                                  byte_rate, block_align, 16))
        self._f.write(b"data")
        self._f.write(struct.pack("<i", 0))
        self._data_bytes = 0

    def write(self, audio: np.ndarray) -> None:
        """audio: [N, channels] float in [-1, 1] (rescaled) or int16."""
        if audio.ndim == 1:
            audio = audio[:, None]
        if audio.dtype != np.int16:
            audio = float_to_int16(audio)
        blob = audio.astype("<i2").tobytes()
        self._f.seek(0, os.SEEK_END)
        self._f.write(blob)
        self._data_bytes += len(blob)
        # update_wav_header parity: RIFF size + data size after every write.
        # RIFF sizes are u32 per spec; clamp instead of crashing once a
        # capture passes 4 GiB (signed '<i' would raise struct.error at
        # 2 GiB — ~4.6 h of 32 kHz stereo — and kill the live scrape)
        riff = min(36 + self._data_bytes, 0xFFFFFFFF)
        data = min(self._data_bytes, 0xFFFFFFFF)
        self._f.seek(4)
        self._f.write(struct.pack("<I", riff))
        self._f.seek(40)
        self._f.write(struct.pack("<I", data))
        # a crash/kill between writes must still leave a playable file —
        # the in-place header update is pointless if it sits in a stdio
        # buffer, so flush per write (block-rate ~2 Hz: negligible)
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.flush()
            self._f.close()
            self._f = None


class FMScraper:
    """Reference-lifecycle artifact sink.  ``now_fn`` is injectable so tests
    can force deterministic names / same-second collisions."""

    def __init__(self, out_dir: str, now_fn=None, use_native: bool = False):
        """``use_native=True`` backs the incremental WAV files with the C++
        runtime writer (runtime/fmtpu_runtime.cpp) — same artifact bytes,
        used by the ``--stream`` serving path."""
        self.dir = out_dir
        self._now = now_fn if now_fn is not None else (lambda: None)
        self._use_native = use_native
        os.makedirs(out_dir, exist_ok=True)  # fm_scraper.cpp:205
        self._wav: IncrementalWavWriter | None = None
        self._old_f_sample: int | None = None
        self._rds_f = None
        self.wav_paths: list[str] = []
        self.rds_path: str | None = None

    # -- audio (Audio_Scraper::on_audio_data, fm_scraper.cpp:55-90) --------

    def on_audio_data(self, data: np.ndarray, f_sample: int) -> None:
        """data: [N, 2] float frames at ``f_sample`` Hz.  A sample-rate
        change closes the current WAV and opens a new timestamped one."""
        f_sample = int(f_sample)
        if self._old_f_sample != f_sample:
            if self._wav is not None:
                self._wav.close()
            os.makedirs(self.dir, exist_ok=True)
            path = os.path.join(
                self.dir, f"{reference_time_string(self._now())}_audio.wav"
            )
            if self._use_native:
                from fm_radio_tpu_torch import runtime as rt

                self._wav = rt.NativeWavWriter(path, f_sample, channels=2)
            else:
                self._wav = IncrementalWavWriter(path, f_sample, n_channels=2)
            self.wav_paths.append(path)
            self._old_f_sample = f_sample
        if len(data):
            self._wav.write(np.asarray(data))

    # -- RDS (RDS_Scraper::on_rds_bytes, fm_scraper.cpp:179-200) -----------

    def on_rds_bytes(self, data: np.ndarray) -> None:
        if self._rds_f is None:
            os.makedirs(self.dir, exist_ok=True)
            self.rds_path = os.path.join(
                self.dir, f"{reference_time_string(self._now())}_rds.bin"
            )
            self._rds_f = open(self.rds_path, "wb+")
        self._rds_f.write(np.asarray(data, dtype=np.uint8).tobytes())

    def close(self) -> None:
        if self._wav is not None:
            self._wav.close()
            self._wav = None
        if self._rds_f is not None:
            self._rds_f.flush()
            self._rds_f.close()
            self._rds_f = None
