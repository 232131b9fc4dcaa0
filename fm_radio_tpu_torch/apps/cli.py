"""Command-line entry point of the PyTorch/CUDA port.

    python -m fm_radio_tpu_torch.apps.cli demod -i in.pcm [-o out.wav]
        [--ingest i8|f32w] [-b 65536] [--audio-mode stereo|lpr|lmr]
        [--deemphasis-us US] [--lpr-cutoff-hz HZ] [--lmr-cutoff-hz HZ]
        [--stereo-gain G] [--no-rds] [--strict-ref] [--save-state S.npz
        [--checkpoint-every N]] [--resume-state S.npz [--resume-seek]]
        [--device cuda|cpu]
    python -m fm_radio_tpu_torch.apps.cli rds-decode [-i bytes.bin]
        [--strict-ref]
    python -m fm_radio_tpu_torch.apps.cli synth -o out.pcm [--seconds 1]
        [--pi 0x1234] [--ps NAME] [--rt TEXT] [--af MHZ,..] [--pty N]
        [--left-hz HZ] [--right-hz HZ] [--cnr DB] [--seed N]
        [--stations K [-m M]]
    python -m fm_radio_tpu_torch.apps.cli bench [-i in.pcm] [-b 65536]
        [-c 64] [--device cuda|cpu]
    python -m fm_radio_tpu_torch.apps.cli selftest [--seconds 2.0]
        [-b 65536] [--cnr DB] [--stations K] [--device cuda|cpu]
    python -m fm_radio_tpu_torch.apps.cli stations -i wide.pcm -o outdir
        [-m 16] [-b 65536] [--taps-per-phase 16] [--rds-native]
        [--select 1,5 | --auto [--threshold-db 15]] [--device cuda|cpu]
    python -m fm_radio_tpu_torch.apps.cli scan -i wide.pcm [-m 16]
        [-b 65536] [--taps-per-phase 16] [--seconds 1.0]
        [--threshold-db 15] [--device cuda|cpu]
    python -m fm_radio_tpu_torch.apps.cli channelize -i wide.pcm -o outdir
        [-m 16] [--taps-per-phase 16] [--device cuda|cpu]
    python -m fm_radio_tpu_torch.apps.cli scrape -i in.pcm -o outdir
        [-b 65536] [--ingest i8|f32w] [--stream] [--device cuda|cpu]
    python -m fm_radio_tpu_torch.apps.cli tune -i wide.pcm -r 8192000
        -f 1024000 -o outdir [-b 65536] [--taps-per-phase 16]
        [--device cuda|cpu]

``demod`` is the port of ``fm_radio_tpu/apps/cli.py::cmd_demod``: one
recorded u8 IQ capture -> WAV (``-o``) and the RDS database (JSON on
stdout, group log lines on stderr).  ``--ingest i8`` (the default) feeds
int8 planes with ``frontend_int8`` (the fused K12); ``--ingest f32w``
feeds packed u8 words under ``DemodConfig()`` with integer input (the
split K1 on words, float taps, then K2).  ``--save-state``,
``--resume-state``, ``--resume-seek`` and ``--checkpoint-every`` run as
the JAX command's (``utils/checkpoint.py``: a checkpoint of either
package resumes in the other).  Its flags that need modules not ported
yet (``--taps``, ``--rate``, ``--play``, ``--play-format``) exit with
code 2 and the ROADMAP.md item that adds them.

``rds-decode`` (RDS bytes -> group log lines on stderr and the database
JSON) and ``synth`` (a stereo + RDS station, or K stations on the
channelizer's carrier grid, as a u8 IQ capture, optionally with AWGN) are
the JAX commands, on the port's host copies; they run no kernel.

``bench`` is the port of ``cmd_bench``: complex64 baseband through
``demod_block`` under ``DemodConfig()`` (the split K1 on planes, then K2),
``-c`` channels, 8 blocks (or the blocks of ``-i``, up to 8), best of 3
runs after one warm-up; it prints the JAX command's JSON keys and the
device.

``selftest`` is the port of ``fm_radio_tpu/apps/cli.py::cmd_selftest``:
synthesize a known stereo + RDS station, quantize it to u8 and split it
into int8 planes (the production ingest), demodulate it, and gate on tone
recovery, stereo separation and RDS decode.  With ``--stations K`` (> 1)
it runs the wideband leg instead (``_selftest_wideband``): K stations on
the channelizer's carrier grid of M = power_ceil(K + 2) channels, through
``stations``' pipeline, gated on each station's PI, name and group count.
It prints a one-line JSON verdict and exits 1 on failure.

The wideband commands run the JAX commands' pipeline
(:func:`run_channelized`, JAX ``_run_channelized``): the capture's packed
words through the exact channelizer chunk by chunk
(``parallel/channelizer.py::stream_selected``), the selected channels'
rows fetched as complex64 divided by M, into one channel-batched ``App``
on the complex64 split path (``DemodConfig()``: K1, K2, the PLL,
extract, BPSK).  ``stations`` writes ``station_KK.wav`` for each selected
channel and prints a JSON summary of their RDS databases; ``--auto``
selects the channels whose power clears the median by ``--threshold-db``,
and ``--rds-native`` decodes RDS on the C++ runtime's bit loops
(``runtime.py``).  ``scan`` finds the active channels in the first
``--seconds`` of a capture and identifies them (pilot, PI, name).
``channelize`` writes every channel as ``channel_KK.pcm`` (u8 IQ) under
one common scale.

``scrape`` (JAX ``cmd_scrape``) writes the reference scraper's artifacts,
a timestamped WAV and RDS byte file (``io/scraper.py``), on either ingest
(``i8``: int8 planes into K12; ``f32w``: packed words into K1), 64 blocks
at a time; ``--stream`` reads the capture with the native runtime's
prefetching reader and writes the WAV with its writer (it exits 1 where
the runtime cannot be built).  ``tune`` (JAX ``cmd_tune``) mixes a
station at ``-f`` Hz of an ``-r`` Hz capture down to DC
(``ops/mixer.py::freq_shift_p``), decimates it to 1.024 MHz
(``ops/fir.py::polyphase_decimate_p``, ``--taps-per-phase`` taps a
phase) and demodulates it as complex64, then writes the scraper's
artifacts, the RDS database JSON and a "wrote" line.

``--device cuda`` (the default) runs the CUDA kernels; ``--device cpu``
runs their plain PyTorch versions.  The JAX CLI's ``monitor`` is not
ported yet (ROADMAP.md, modules still to port, item 7).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from fm_radio_tpu_torch.io.pcm import c64_to_u8, i8_input, packed_input
from fm_radio_tpu_torch.io.synth import (
    FMModulator,
    ModulatorConfig,
    make_wideband,
    station_group_schedule,
)

SELFTEST_PI, SELFTEST_PS = 0x1234, "SELFTEST"
LEFT_HZ, RIGHT_HZ = 1000.0, 3000.0


def power_ceil(x: int) -> int:
    """Round up to a power of two (fm_demod_no_tuner.cpp:95-101)."""
    return 1 if x <= 1 else 1 << (int(x) - 1).bit_length()


def add_awgn(iq: np.ndarray, cnr_db: float, seed: int = 0) -> np.ndarray:
    """Complex AWGN at a carrier-to-noise ratio (dB) relative to the mean
    carrier amplitude (as the JAX CLI's selftest adds it)."""
    amp = float(np.mean(np.abs(iq)))
    sigma = amp / np.sqrt(2.0 * 10.0 ** (cnr_db / 10.0))
    rng = np.random.default_rng(seed)
    return iq + sigma * (
        rng.standard_normal(iq.size) + 1j * rng.standard_normal(iq.size)
    ).astype(np.complex64)


def selftest_u8(seconds: float, block: int,
                cnr: float | None = None) -> np.ndarray:
    """The selftest station as u8 IQ [N, 2] (N a multiple of ``block``, at
    least 8 blocks)."""
    n = max(int(seconds * 1_024_000) // block, 8) * block
    groups = station_group_schedule(SELFTEST_PI, ps=SELFTEST_PS,
                                    rt="FMTPU SELFTEST")
    iq = FMModulator(ModulatorConfig()).generate(
        n, left_hz=LEFT_HZ, right_hz=RIGHT_HZ, rds_groups=groups)
    if cnr is not None:
        iq = add_awgn(iq, cnr)
    return c64_to_u8(iq.astype(np.complex64)).reshape(-1, 2)


def selftest_planes(seconds: float, block: int, cnr: float | None = None):
    """The selftest station as [2, 1, N] int8 planes (the production
    ingest)."""
    from fm_radio_tpu_torch.utils.transfer import split_iq_i8

    return split_iq_i8(selftest_u8(seconds, block, cnr))[:, None, :]


def selftest_checks(app) -> dict:
    """The selftest gates on an App that has demodulated the station."""
    audio = app.audio[0]
    fs = app.demod.fs_audio
    settle = int(0.15 * fs)
    left, right = audio[settle:, 0], audio[settle:, 1]

    def tone_ratio_db(x, f0, bw=100.0):
        spec = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
        freqs = np.fft.rfftfreq(len(x), 1 / fs)
        band = (freqs > f0 - bw) & (freqs < f0 + bw)
        return 10 * np.log10(spec[band].sum() / (spec.sum() + 1e-30))

    separation = tone_ratio_db(right, RIGHT_HZ) - tone_ratio_db(left, RIGHT_HZ)
    db = app.rds_database(0).summary()
    checks = {
        "left_tone_db": (round(float(tone_ratio_db(left, LEFT_HZ)), 1), -3.0),
        "right_tone_db": (round(float(tone_ratio_db(right, RIGHT_HZ)), 1),
                          -3.0),
        "stereo_separation_db": (round(float(separation), 1), 20.0),
        "rds_groups": (len(app.rds_log_lines(0)), 5),
    }
    results = {k: {"value": v, "min": lo, "pass": bool(v > lo)}
               for k, (v, lo) in checks.items()}
    results["rds_pi"] = {"value": db["pi_code"],
                         "expect": f"{SELFTEST_PI:04X}",
                         "pass": db["pi_code"] == f"{SELFTEST_PI:04X}"}
    results["rds_service_name"] = {"value": db["service_name"],
                                   "expect": SELFTEST_PS,
                                   "pass": db["service_name"] == SELFTEST_PS}
    return results


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def _device(args, cmd: str) -> torch.device | None:
    """The requested device, or None (after a message) when it is a CUDA
    device and there is none: nothing falls back to the CPU."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"{cmd}: no CUDA device (use --device cpu for the plain "
              "PyTorch versions)", file=sys.stderr)
        return None
    return device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def normalize_wideband(iq: np.ndarray) -> np.ndarray:
    """Scale a multi-station sum to the u8 grid: a fixed /2 clips at >= 3
    stations (each has amplitude 100; peaks add)."""
    peak = max(float(np.abs(iq.real).max()), float(np.abs(iq.imag).max()))
    return iq * (120.0 / max(peak, 1e-9))


def wideband_capture(k_st: int, m: int, n: int, base_pi: int = SELFTEST_PI,
                     cnr: float | None = None) -> np.ndarray:
    """The wideband selftest capture: stations 1..K on the carrier grid of
    M channels (station k: PI base + k - 1, name "ST kk", left tone
    1000 (1 + k/2) Hz), n samples each, as u8 IQ [n * M, 2]."""
    station_iq = {}
    for k in range(k_st):
        groups = station_group_schedule(base_pi + k,
                                        ps=f"ST {k + 1:02d}".ljust(8))
        station_iq[k + 1] = FMModulator(ModulatorConfig()).generate(
            n, left_hz=LEFT_HZ * (1 + 0.5 * k), right_hz=RIGHT_HZ,
            rds_groups=groups)
    iq = normalize_wideband(make_wideband(station_iq, m))
    if cnr is not None:
        iq = add_awgn(iq, cnr)
    return c64_to_u8(iq.astype(np.complex64)).reshape(-1, 2)


def wideband_checks(app, base_pi: int = SELFTEST_PI) -> dict:
    """Per-station gates of the wideband selftest: PI, name, >= 5 groups."""
    results = {}
    for i in range(app.channels):
        db = app.rds_database(i).summary()
        want_pi, want_ps = f"{base_pi + i:04X}", f"ST {i + 1:02d}".ljust(8)
        results[f"station_{i + 1}"] = {
            "pi": db["pi_code"], "expect_pi": want_pi,
            "service_name": db["service_name"],
            "groups": len(app.rds_log_lines(i)),
            "pass": (db["pi_code"] == want_pi
                     and db["service_name"] == want_ps
                     and len(app.rds_log_lines(i)) >= 5),
        }
    return results


def run_channelized(words, m: int, taps_per_phase: int, select, app):
    """Chunked wideband streaming (JAX ``_run_channelized``): packed words
    -> the channelizer on ``app``'s device -> the ``select`` rows, divided
    by M, into the channel-batched ``app``, a chunk of M * block words at
    a time (``parallel/channelizer.py::stream_selected``; the filterbank's
    tail carries across chunks, the demod state in ``app``)."""
    from fm_radio_tpu_torch.parallel.channelizer import (
        channelizer_init_state,
        make_channelizer_taps,
        stream_selected,
    )

    st = channelizer_init_state(m, taps_per_phase, app.demod.device)
    return stream_selected(make_channelizer_taps(m, taps_per_phase), st,
                           words, m, select, app.process,
                           chunk_min=m * app.block_size)


def selftest_wideband(k_st: int, m: int, n: int, block: int, device,
                      cnr: float | None = None):
    """The wideband selftest (JAX ``_selftest_wideband``): K stations on
    the carrier grid of M channels through :func:`run_channelized` into
    ``App`` on ``device``.  Returns (app, seconds elapsed, checks)."""
    from fm_radio_tpu_torch.models.app import App
    from fm_radio_tpu_torch.utils.transfer import pack_iq_u8

    words = pack_iq_u8(wideband_capture(k_st, m, n, cnr=cnr))
    app = App(block_size=block, channels=k_st, device=device)
    t0 = time.time()
    run_channelized(words, m, 16, list(range(1, k_st + 1)), app)
    _sync(torch.device(device))
    return app, time.time() - t0, wideband_checks(app)


def cmd_selftest(args) -> int:
    from fm_radio_tpu_torch.models.app import App
    from fm_radio_tpu_torch.models.demod import INT8_CONFIG

    device = _device(args, "selftest")
    if device is None:
        return 2
    block = power_ceil(args.block_size)
    if args.stations > 1:
        m = power_ceil(args.stations + 2)
        n = max(int(args.seconds * 1_024_000) // block, 8) * block
        _, elapsed, results = selftest_wideband(args.stations, m, n, block,
                                                device, args.cnr)
        ok = all(r["pass"] for r in results.values())
        print(json.dumps({
            "pass": ok,
            "device": device_name(device),
            "mode": f"wideband x{args.stations} (m={m})",
            "seconds_audio": round(n / 1_024_000, 3),
            "seconds_elapsed": round(elapsed, 3),
            "checks": results,
        }))
        return 0 if ok else 1
    x8 = selftest_planes(args.seconds, block, args.cnr)
    app = App(block_size=block, cfg=INT8_CONFIG, channels=1, device=device)
    t0 = time.time()
    app.process(x8)
    _sync(device)
    elapsed = time.time() - t0
    results = selftest_checks(app)
    ok = all(r["pass"] for r in results.values())
    print(json.dumps({
        "pass": ok,
        "device": device_name(device),
        "seconds_audio": round(x8.shape[-1] / 1_024_000, 3),
        "seconds_elapsed": round(elapsed, 3),
        "checks": results,
    }))
    return 0 if ok else 1


def channel_powers_db(words, m: int, taps_per_phase: int, window: int,
                      device) -> np.ndarray:
    """Per-channel power (dB) over the first ``window`` wide samples of a
    packed capture, cut to whole frames of M (JAX ``_channel_powers_db``):
    the filterbank's first ``taps_per_phase`` outputs (its fill) left
    out."""
    from fm_radio_tpu_torch.parallel.channelizer import (
        channelize_frames,
        channelizer_init_state,
        make_channelizer_taps,
    )

    n = min(len(words), window) // m * m
    x = torch.as_tensor(np.asarray(words[0:n], np.float32), device=device)
    _, y = channelize_frames(make_channelizer_taps(m, taps_per_phase),
                             channelizer_init_state(m, taps_per_phase,
                                                    device), x, m)
    settle = taps_per_phase  # filterbank fill
    p = (y.real[:, settle:].double() ** 2 + y.imag[:, settle:].double() ** 2)
    return 10.0 * np.log10(p.mean(dim=1).cpu().numpy() + 1e-20)


def detect_active_channels(powers_db: np.ndarray,
                           threshold_db: float) -> list[int]:
    """Channels whose power clears the median (noise-floor estimate) by
    ``threshold_db``: FM carriers are constant-envelope and sit far above
    an empty channel's noise."""
    floor = float(np.median(powers_db))
    return [int(k) for k in np.nonzero(powers_db > floor + threshold_db)[0]]


def stations_app(args, device):
    """``stations``' channels and its App on ``device``, fed those channels
    of the capture of ``args`` (:func:`run_channelized`): (select, app);
    None (after a message) where ``--auto`` finds no active channel."""
    from fm_radio_tpu_torch.models.app import App

    m = args.num_channels
    block = power_ceil(args.block_size)
    words = packed_input(args.input)
    if args.auto:
        window = min(len(words), 1_024_000 * m)  # ~1 s per channel
        powers = channel_powers_db(words, m, args.taps_per_phase, window,
                                   device)
        select = detect_active_channels(powers, args.threshold_db)
        if not select:
            print("stations: --auto found no active channels",
                  file=sys.stderr)
            return None
        print(f"auto-selected channels: {select}", file=sys.stderr)
    elif args.select:
        select = sorted(int(v) for v in args.select.split(","))
    else:
        select = list(range(m))
    app = App(block_size=block, channels=len(select), decode_rds=True,
              rds_backend="native" if args.rds_native else "python",
              device=device)
    run_channelized(words, m, args.taps_per_phase, select, app)
    _sync(device)
    return select, app


def cmd_stations(args) -> int:
    from fm_radio_tpu_torch.io.wav import write_wav_int16

    device = _device(args, "stations")
    if device is None:
        return 2
    run = stations_app(args, device)
    if run is None:
        return 1
    select, app = run
    os.makedirs(args.output, exist_ok=True)
    summary = []
    for i, k in enumerate(select):
        wav_path = os.path.join(args.output, f"station_{k:02d}.wav")
        write_wav_int16(wav_path, app.audio[i], app.demod.fs_audio)
        summary.append({"channel": k, "wav": wav_path,
                        **app.rds_database(i).summary()})
    print(json.dumps(summary, indent=1))
    return 0


def cmd_scan(args) -> int:
    """Station scanner (JAX ``cmd_scan``): the channels whose power over
    the first ``--seconds`` clears the median by ``--threshold-db``, each
    demodulated and identified (stereo pilot, PI, name)."""
    from fm_radio_tpu_torch.models.app import App

    device = _device(args, "scan")
    if device is None:
        return 2
    m = args.num_channels
    block = power_ceil(args.block_size)
    fs_ch = 1_024_000
    window = int(args.seconds * fs_ch) * m
    words = packed_input(args.input, max_samples=window)
    powers = channel_powers_db(words, m, args.taps_per_phase, window, device)
    active = detect_active_channels(powers, args.threshold_db)
    floor = float(np.median(powers))
    report = []
    if active:
        app = App(block_size=block, channels=len(active), decode_rds=True,
                  device=device)
        run_channelized(words, m, args.taps_per_phase, active, app)
        for i, k in enumerate(active):
            db = app.rds_database(i)
            audio = app.audio[i]
            # stereo L-R energy exists only under pilot lock
            lmr = audio[:, 0] - audio[:, 1]
            report.append({
                "channel": k,
                "offset_hz": (k if k <= m // 2 else k - m) * fs_ch,
                "power_db": round(float(powers[k]), 1),
                "above_floor_db": round(float(powers[k]) - floor, 1),
                "stereo": bool(np.sqrt((lmr ** 2).mean()) > 1e-3),
                "pi": f"{db.pi_code:04X}" if db.pi_code else None,
                "ps": db.service_name_str.strip() or None,
            })
    print(json.dumps({
        "channels": m,
        "noise_floor_db": round(floor, 1),
        "active": report,
        "select": ",".join(str(k) for k in active),
    }, indent=1))
    return 0


def cmd_channelize(args) -> int:
    """Wideband IQ -> one u8 IQ file a channel (JAX ``cmd_channelize``):
    the filterbank over chunks of ``max(2^22, M)`` words, every channel
    written under ONE common scale (a per-channel one would blow an empty
    channel's leakage up to full-scale noise)."""
    from fm_radio_tpu_torch.parallel.channelizer import (
        as_tables,
        channelize_frames,
        channelizer_init_state,
        make_channelizer_taps,
    )
    from fm_radio_tpu_torch.utils.transfer import fetch

    device = _device(args, "channelize")
    if device is None:
        return 2
    m = args.num_channels
    words = packed_input(args.input)
    n = (len(words) // m) * m
    tab = as_tables(make_channelizer_taps(m, args.taps_per_phase), m, device)
    st = channelizer_init_state(m, args.taps_per_phase, device)
    chunk = max(1 << 22, m)
    chunk -= chunk % m
    parts = []
    for i0 in range(0, n, chunk):
        x = torch.as_tensor(np.asarray(words[i0 : min(i0 + chunk, n)],
                                       np.float32), device=device)
        st, y = channelize_frames(tab, st, x, m)
        parts.append(fetch(y))
    y = (np.concatenate(parts, axis=1) if parts
         else np.zeros((m, 0), np.complex64))
    os.makedirs(args.output, exist_ok=True)
    scale = max(float(np.abs(y).max()) / 100.0, 1e-9) if y.size else 1.0
    for ch in range(m):
        path = os.path.join(args.output, f"channel_{ch:02d}.pcm")
        c64_to_u8(y[ch] / scale).tofile(path)
    print(f"wrote {m} channel files to {args.output}")
    return 0


def wrote(scraper) -> str:
    """The artifacts of ``scraper``, as ``scrape``'s last line names them."""
    wav = scraper.wav_paths[-1] if scraper.wav_paths else "no audio"
    return f"{wav} and {scraper.rds_path or 'no RDS bytes'}"


def cmd_scrape(args) -> int:
    """WAV + RDS-byte artifacts, format-compatible with fm_demod_scraper
    (JAX ``cmd_scrape``): batch mode reads 64 blocks at a time; ``--stream``
    reads with the native runtime's prefetching reader and writes with its
    WAV writer, a block at a time."""
    import dataclasses

    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.io.scraper import FMScraper
    from fm_radio_tpu_torch.models.app import App

    device = _device(args, "scrape")
    if device is None:
        return 2
    block = power_ceil(args.block_size)
    i8 = args.ingest == "i8"
    cfg = (dataclasses.replace(DemodConfig(), frontend_int8=True)
           if i8 else DemodConfig())

    def feed(app, scraper, blocks) -> None:
        """Each chunk into ``app``, its audio and RDS bytes drained into
        ``scraper`` after it."""
        fs_audio = int(app.demod.fs_audio)
        rds_bufs = app.rds_chains[0].rds_bytes
        for blk in blocks:
            app.process(blk)
            for a in app.audio_blocks:
                scraper.on_audio_data(a[0], fs_audio)
            app.audio_blocks.clear()
            if rds_bufs:
                scraper.on_rds_bytes(np.concatenate(rds_bufs))
                rds_bufs.clear()

    if args.stream:
        from fm_radio_tpu_torch import runtime as rt

        if args.input in (None, "-"):
            print("--stream needs a file input (-i)", file=sys.stderr)
            return 1
        try:
            rt.load()
        except rt.NativeRuntimeUnavailable as e:
            print(f"--stream needs the native runtime: {e}", file=sys.stderr)
            return 1
        app = App(block_size=block, cfg=cfg, channels=1, decode_rds=True,
                  integer_input=True, device=device)
        scraper = FMScraper(args.output, use_native=True)
        reader = rt.NativePcmReader(args.input, block)

        def blocks():
            while True:
                blk = reader.next_i8() if i8 else reader.next_packed()
                if blk is None:
                    return
                yield blk if i8 else blk[None, :]

        try:
            feed(app, scraper, blocks())
        finally:
            reader.close()
            scraper.close()
        print(f"wrote {wrote(scraper)} (streamed)")
        return 0

    iq = i8_input(args.input) if i8 else packed_input(args.input)
    app = App(block_size=block, cfg=cfg, channels=1, decode_rds=True,
              integer_input=True, device=device)
    scraper = FMScraper(args.output)
    chunk = 64 * block  # O(chunk) host memory for any capture length
    try:
        feed(app, scraper, (iq[i0 : min(i0 + chunk, len(iq))]
                            for i0 in range(0, len(iq), chunk)))
    finally:
        scraper.close()
    print(f"wrote {wrote(scraper)}")
    return 0


def cmd_tune(args) -> int:
    """Tuner for recorded wideband captures (JAX ``cmd_tune``,
    ``fm_demod_tuner.cpp:136``): the station at ``-f`` Hz mixed to DC with
    carried phase, low-pass decimated by m = rate / 1.024 MHz to the
    chain's rate, demodulated as complex64; then the scraper's WAV and RDS
    file, the database JSON and the "wrote" line."""
    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.io.pcm import read_u8
    from fm_radio_tpu_torch.io.scraper import FMScraper
    from fm_radio_tpu_torch.models.app import App
    from fm_radio_tpu_torch.ops.design import create_fir_lpf
    from fm_radio_tpu_torch.ops.fir import polyphase_decimate_p
    from fm_radio_tpu_torch.ops.mixer import freq_shift_p
    from fm_radio_tpu_torch.utils.transfer import fetch

    device = _device(args, "tune")
    if device is None:
        return 2
    cfg = DemodConfig()
    fs_bb = cfg.rates.fs_baseband
    rate = int(args.rate)
    if rate % fs_bb != 0:
        print(f"--rate must be an integer multiple of {fs_bb}",
              file=sys.stderr)
        return 1
    m = rate // fs_bb
    f_norm = float(args.freq) / rate
    if abs(f_norm) > 0.5:
        print("--freq is outside the capture bandwidth", file=sys.stderr)
        return 1
    block = power_ceil(args.block_size)
    os.makedirs(args.output, exist_ok=True)
    # the capture memory-mapped and converted a chunk at a time
    iq_u8 = None
    if args.input not in (None, "-"):
        try:
            raw = np.memmap(args.input, dtype=np.uint8, mode="r")
            iq_u8 = raw[: (raw.size // 2) * 2].reshape(-1, 2)
        except (OSError, ValueError):
            pass  # empty and special files cannot be memmapped
    if iq_u8 is None:
        iq_u8 = read_u8(args.input)

    app = App(block_size=block, channels=1, decode_rds=True, device=device)
    phase = torch.zeros((1,), dtype=torch.float32, device=device)
    if m > 1:
        taps = torch.from_numpy(create_fir_lpf(
            args.taps_per_phase * m,
            (1.0 / m) * cfg.downsampling_rolloff_factor)).to(device)
        tail = torch.zeros((1, taps.shape[0] - m), dtype=torch.complex64,
                           device=device)
    chunk = m * block
    n_in = iq_u8.shape[0]
    n_chunks = n_in // chunk
    # samples past the last whole chunk still run; only a remainder of
    # less than one decimation frame is dropped
    leftover = ((n_in - n_chunks * chunk) // m) * m
    dropped = n_in - n_chunks * chunk - leftover
    if dropped:
        print(f"dropping {dropped} trailing samples (< one decimation "
              f"frame)", file=sys.stderr)
    spans = [slice(i * chunk, (i + 1) * chunk) for i in range(n_chunks)]
    if leftover:
        spans.append(slice(n_chunks * chunk, n_chunks * chunk + leftover))
    for sl in spans:
        c = torch.from_numpy(np.asarray(iq_u8[sl], dtype=np.float32)
                             - 127.0).to(device)
        phase, yp = freq_shift_p(phase, (c[None, :, 0], c[None, :, 1]),
                                 f_norm)
        if m > 1:
            tail, yp = polyphase_decimate_p(taps, tail, yp, m)
        app.process(fetch(torch.complex(*yp))[0])
    _sync(device)
    scraper = FMScraper(args.output)
    scraper.on_audio_data(app.audio[0], int(app.demod.fs_audio))
    scraper.on_rds_bytes(app.rds_bytes(0))
    scraper.close()
    print(json.dumps(app.rds_database(0).summary()))
    print(f"wrote {scraper.wav_paths[-1]} and {scraper.rds_path}")
    return 0


# demod flags that need modules not ported yet -> the ROADMAP.md item
_DEMOD_NOT_PORTED = {
    "taps": "modules still to port, item 2 (include_taps and the scan loops)",
    "rate": "modules still to port, item 7 (ops/resample.py)",
    "play": "modules still to port, item 7 (io/player.py, ops/resample.py)",
    "play_format": "modules still to port, item 7 (io/player.py, "
                   "ops/resample.py)",
}


def demod_config(args):
    """``DemodConfig()`` with the audio controls of ``demod``'s flags (the
    reference's GUI sliders, render_fm_demod.cpp:305-374), and
    ``frontend_int8`` for ``--ingest i8``."""
    from fm_radio_tpu_torch.config import DemodConfig

    changes = {}
    if args.audio_mode != "stereo":
        changes["audio_out"] = args.audio_mode
    if args.deemphasis_us:
        changes["use_deemphasis_filter"] = True
        changes["deemphasis_cutoff_us"] = int(args.deemphasis_us)
    if args.lpr_cutoff_hz:
        changes["audio_lpr_cutoff_hz"] = int(args.lpr_cutoff_hz)
    if args.lmr_cutoff_hz:
        changes["audio_lmr_cutoff_hz"] = int(args.lmr_cutoff_hz)
    if args.stereo_gain is not None:
        changes["audio_stereo_mix_factor"] = float(args.stereo_gain)
    if args.ingest == "i8":
        changes["frontend_int8"] = True
    return DemodConfig(**changes)


def demod_app(args, device):
    """``demod``'s App on ``device``, fed the whole capture of ``args``
    (``-i``, ``--ingest``, ``-b``, the audio controls, ``--no-rds``,
    ``--strict-ref``) in chunks of 64 blocks, with the JAX command's
    checkpoints (cli.py:138-197): ``--resume-state`` loads the carried
    state (``--resume-seek`` then skips the blocks it covers), and
    ``--save-state`` saves it at the end or, with ``--checkpoint-every
    N``, atomically every N blocks (a ``.tmp.npz``, then ``os.replace``),
    ``block_index`` an extra."""
    from fm_radio_tpu_torch.models.app import App
    from fm_radio_tpu_torch.models.demod import demod_init_state
    from fm_radio_tpu_torch.utils.checkpoint import load_state, save_state

    block = power_ceil(args.block_size)
    iq = i8_input(args.input) if args.ingest == "i8" else packed_input(
        args.input)
    app = App(block_size=block, cfg=demod_config(args), channels=1,
              decode_rds=not args.no_rds, integer_input=True,
              strict_ref=args.strict_ref, device=device)
    n_in = len(iq)
    extras = {}
    if args.resume_state:
        app.demod.state, extras = load_state(
            args.resume_state, demod_init_state(app.demod.cfg, 1, device))
        print(f"resumed from {args.resume_state} "
              f"(block_index={int(extras.get('block_index', -1))})",
              file=sys.stderr)
    start_block = off = 0
    if args.resume_state and args.resume_seek:
        # crash-restart on the same input: skip the checkpointed blocks
        start_block = int(extras.get("block_index", 0))
        print(f"seeking past {start_block} checkpointed blocks",
              file=sys.stderr)
        off = min(start_block * block, n_in)
    avail_blocks = (n_in - off) // block
    if args.checkpoint_every and args.save_state:
        n, done = args.checkpoint_every, 0
        while done < avail_blocks:
            upto = min(done + n, avail_blocks)
            app.process(iq[off + done * block : off + upto * block])
            tmp = f"{args.save_state}.tmp.npz"
            save_state(tmp, app.demod.state,
                       extra={"block_index": start_block + upto})
            os.replace(tmp, args.save_state)
            done = upto
        app.process(iq[off + done * block : n_in])  # leftover -> pending
        print(f"checkpointed every {n} blocks to {args.save_state} "
              f"(final block_index={start_block + done})", file=sys.stderr)
    else:
        chunk = 64 * block
        for i0 in range(off, n_in, chunk):
            app.process(iq[i0 : min(i0 + chunk, n_in)])
        if n_in == off:
            app.process(iq[off:n_in])  # empty input: clean empty outputs
        if args.save_state:
            save_state(args.save_state, app.demod.state,
                       extra={"block_index": start_block + avail_blocks})
            print(f"saved stream state to {args.save_state}",
                  file=sys.stderr)
    _sync(device)
    return app


def cmd_demod(args) -> int:
    from fm_radio_tpu_torch.io.wav import write_wav_int16

    for flag, item in _DEMOD_NOT_PORTED.items():
        if getattr(args, flag):
            print(f"demod: --{flag.replace('_', '-')} is not ported yet: "
                  f"ROADMAP.md, {item}", file=sys.stderr)
            return 2
    device = _device(args, "demod")
    if device is None:
        return 2
    app = demod_app(args, device)
    if args.output_wav:
        audio = app.audio[0]
        fs_out = int(app.demod.fs_audio)
        write_wav_int16(args.output_wav, audio, fs_out)
        print(f"wrote {args.output_wav} ({audio.shape[0]} frames "
              f"@{fs_out}Hz)")
    if not args.no_rds:
        for line in app.rds_log_lines(0):
            print(f"[rds_decoder] {line}", file=sys.stderr)
        print(json.dumps(app.rds_database(0).summary()))
    return 0


def cmd_bench(args) -> int:
    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.io.pcm import read_u8, u8_to_c64
    from fm_radio_tpu_torch.models.demod import (
        demod_block,
        demod_init_state,
        make_coeffs,
    )

    device = _device(args, "bench")
    if device is None:
        return 2
    block = power_ceil(args.block_size)
    cfg = DemodConfig()
    coeffs = make_coeffs(cfg, device)
    channels = args.channels
    if args.input:
        iq = u8_to_c64(read_u8(args.input, max_samples=block * 8))
        n_blocks = len(iq) // block
        if n_blocks == 0:
            print(f"bench: {args.input} holds less than one block of "
                  f"{block} samples", file=sys.stderr)
            return 2
        x = np.broadcast_to(iq[: n_blocks * block][None],
                            (channels, n_blocks * block))
    else:
        rng = np.random.default_rng(0)
        n_blocks = 8
        ph = np.cumsum(rng.standard_normal((channels, block * n_blocks))
                       * 0.5, -1)
        x = (100.0 * np.exp(1j * ph)).astype(np.complex64)
    xb = torch.from_numpy(np.ascontiguousarray(
        x.reshape(channels, n_blocks, block).transpose(1, 0, 2))).to(device)

    def run():
        st = demod_init_state(cfg, channels, device)
        for blk in xb:
            st, _ = demod_block(cfg, coeffs, st, blk)
        _sync(device)

    run()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    msps = channels * block * n_blocks / best / 1e6
    print(json.dumps({
        "channels": channels,
        "block_size": block,
        "seconds": round(best, 4),
        "aggregate_msps": round(msps, 2),
        "per_channel_realtime_x": round(msps * 1e6 / channels / 1.024e6, 2),
        "device": device_name(device),
    }))
    return 0


def cmd_rds_decode(args) -> int:
    """Bytes -> group log lines + database (parity with rds_decode.cpp;
    the JAX command, cli.py:440-453)."""
    from fm_radio_tpu_torch.rds.chain import RDSDecodingChain

    if args.input is None or args.input == "-":
        data = np.frombuffer(sys.stdin.buffer.read(), dtype=np.uint8)
    else:
        data = np.fromfile(args.input, dtype=np.uint8)
    chain = RDSDecodingChain(strict_ref=args.strict_ref)
    chain.process(data)
    for line in chain.log_lines:
        print(f"[rds_decoder] {line}", file=sys.stderr)
    print(json.dumps({"groups": len(chain.groups), **chain.db.summary()}))
    return 0


def cmd_synth(args) -> int:
    """Signal generator (the JAX command, cli.py:713-757): a stereo + RDS
    station, or with ``--stations K`` > 1 a wideband capture of K stations
    on the carrier grid of M channels, as a u8 IQ ``*.pcm``; ``--cnr``
    adds AWGN."""
    n = int(args.seconds * 1_024_000)
    af = [float(v) for v in args.af.split(",")] if args.af else None

    def one_station(pi: int, ps: str, left: float, right: float):
        groups = station_group_schedule(pi, ps=ps, rt=args.rt, af_mhz=af,
                                        pty=args.pty)
        return FMModulator(ModulatorConfig()).generate(
            n, left_hz=left, right_hz=right, rds_groups=groups)

    if args.stations <= 1:
        iq = one_station(int(args.pi, 0), args.ps, args.left_hz,
                         args.right_hz)
        rate = 1_024_000
    else:
        m = args.num_channels or power_ceil(args.stations + 2)
        base_pi = int(args.pi, 0)
        station_iq = {
            k + 1: one_station(base_pi + k, f"ST {k + 1:02d}".ljust(8),
                               args.left_hz * (1 + 0.5 * k), args.right_hz)
            for k in range(args.stations)}
        iq = normalize_wideband(make_wideband(station_iq, m))
        rate = 1_024_000 * m
    if args.cnr is not None:
        iq = add_awgn(iq, args.cnr, args.seed)
    c64_to_u8(iq.astype(np.complex64)).tofile(args.output)
    print(json.dumps({"path": args.output, "samples": int(iq.size),
                      "rate": rate, "stations": max(args.stations, 1)}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fm_radio_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("demod", help="demodulate IQ pcm -> audio + RDS")
    d.add_argument("-i", "--input", default=None,
                   help="input *.pcm (default stdin)")
    d.add_argument("-b", "--block-size", type=int, default=65536)
    d.add_argument("--ingest", choices=("i8", "f32w"), default="i8",
                   help="device ingest: int8 planes + the fused K12 "
                        "(default) or packed f32 words + the split K1/K2")
    d.add_argument("-o", "--output-wav", default=None)
    d.add_argument("--no-rds", action="store_true")
    d.add_argument("--audio-mode", choices=["stereo", "lpr", "lmr"],
                   default="stereo")
    d.add_argument("--deemphasis-us", type=int, default=0,
                   help="enable de-emphasis with this time constant in us "
                        "(0 = off)")
    d.add_argument("--lpr-cutoff-hz", type=int, default=0)
    d.add_argument("--lmr-cutoff-hz", type=int, default=0)
    d.add_argument("--stereo-gain", type=float, default=None)
    d.add_argument("--strict-ref", action="store_true",
                   help="version-B groups print Unsupported_Code, as the "
                        "reference decoder does")
    d.add_argument("--taps", default=None, help="not ported yet")
    d.add_argument("--rate", type=int, default=0, help="not ported yet")
    d.add_argument("--play", default=None, help="not ported yet")
    d.add_argument("--play-format", choices=["f32", "s16"], default=None,
                   help="not ported yet")
    d.add_argument("--save-state", default=None,
                   help="write the stream state (.npz) at the end")
    d.add_argument("--resume-state", default=None,
                   help="resume from a saved stream state (.npz; either "
                        "package's)")
    d.add_argument("--resume-seek", action="store_true",
                   help="with --resume-state on the SAME input: skip the "
                        "blocks the checkpoint covers (crash restart)")
    d.add_argument("--checkpoint-every", type=int, default=0,
                   help="with --save-state: save atomically every N "
                        "blocks")
    d.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    d.set_defaults(fn=cmd_demod)

    bn = sub.add_parser("bench", help="throughput benchmark (complex64, "
                                      "DemodConfig())")
    bn.add_argument("-i", "--input", default=None)
    bn.add_argument("-b", "--block-size", type=int, default=65536)
    bn.add_argument("-c", "--channels", type=int, default=64)
    bn.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    bn.set_defaults(fn=cmd_bench)

    sf = sub.add_parser(
        "selftest",
        help="synthesize a known station, demod it, gate accuracy (one-line "
             "JSON verdict; exit 1 on failure)")
    sf.add_argument("--seconds", type=float, default=2.0)
    sf.add_argument("-b", "--block-size", type=int, default=65536)
    sf.add_argument("--cnr", type=float, default=None,
                    help="optionally add AWGN at this carrier-to-noise dB")
    sf.add_argument("--stations", type=int, default=1,
                    help=">1: wideband mode — K stations through the "
                         "channelizer and one batched demod")
    sf.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    sf.set_defaults(fn=cmd_selftest)

    st = sub.add_parser(
        "stations",
        help="wideband IQ -> channelize -> batched demod of every station")
    st.add_argument("-i", "--input", default=None)
    st.add_argument("-o", "--output", required=True)
    st.add_argument("-m", "--num-channels", type=int, default=16)
    st.add_argument("-b", "--block-size", type=int, default=65536)
    st.add_argument("--taps-per-phase", type=int, default=16)
    st.add_argument("--rds-native", action="store_true",
                    help="decode RDS on the C++ runtime's bit loops")
    st.add_argument("--select", default=None,
                    help="comma-separated channel indices to keep")
    st.add_argument("--auto", action="store_true",
                    help="demodulate only channels with power above the "
                         "noise floor")
    st.add_argument("--threshold-db", type=float, default=15.0,
                    help="--auto detection threshold above the median "
                         "channel power")
    st.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    st.set_defaults(fn=cmd_stations)

    sc = sub.add_parser(
        "scan",
        help="find and identify the active FM stations in a wideband "
             "capture (power detect -> demod -> pilot / RDS)")
    sc.add_argument("-i", "--input", default=None)
    sc.add_argument("-m", "--num-channels", type=int, default=16)
    sc.add_argument("-b", "--block-size", type=int, default=65536)
    sc.add_argument("--taps-per-phase", type=int, default=16)
    sc.add_argument("--seconds", type=float, default=1.0,
                    help="scan window per channel")
    sc.add_argument("--threshold-db", type=float, default=15.0,
                    help="active threshold above the median channel power")
    sc.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    sc.set_defaults(fn=cmd_scan)

    c = sub.add_parser("channelize", help="wideband IQ -> station channels")
    c.add_argument("-i", "--input", default=None)
    c.add_argument("-o", "--output", required=True)
    c.add_argument("-m", "--num-channels", type=int, default=16)
    c.add_argument("--taps-per-phase", type=int, default=16)
    c.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    c.set_defaults(fn=cmd_channelize)

    sp = sub.add_parser("scrape", help="IQ pcm -> WAV + RDS bytes artifacts")
    sp.add_argument("-i", "--input", default=None)
    sp.add_argument("-b", "--block-size", type=int, default=65536)
    sp.add_argument("-o", "--output", required=True)
    sp.add_argument("--stream", action="store_true",
                    help="native runtime: prefetching reader + incremental "
                         "WAV writer, constant memory")
    sp.add_argument("--ingest", choices=("i8", "f32w"), default="i8",
                    help="device ingest: int8 planes + the fused K12 "
                         "(default) or packed f32 words + the split K1/K2")
    sp.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    sp.set_defaults(fn=cmd_scrape)

    t = sub.add_parser(
        "tune", help="tune to a station inside a wideband capture "
                     "(fm_demod_tuner for recorded files)")
    t.add_argument("-i", "--input", default=None,
                   help="wideband *.pcm (u8 IQ)")
    t.add_argument("-r", "--rate", type=float, default=1_024_000.0,
                   help="capture sample rate in Hz (multiple of 1.024M)")
    t.add_argument("-f", "--freq", type=float, required=True,
                   help="station offset from capture center in Hz")
    t.add_argument("-b", "--block-size", type=int, default=65536)
    t.add_argument("-o", "--output", required=True)
    t.add_argument("--taps-per-phase", type=int, default=16)
    t.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    t.set_defaults(fn=cmd_tune)

    r = sub.add_parser("rds-decode", help="RDS bytes -> groups + database")
    r.add_argument("-i", "--input", default=None)
    r.add_argument("--strict-ref", action="store_true",
                   help="exact reference RDS behavior: version-B groups "
                        "print Unsupported_Code (rds_decoder.cpp:146-155) "
                        "instead of being decoded (0B/2B/15B superset)")
    r.set_defaults(fn=cmd_rds_decode)

    sy = sub.add_parser(
        "synth",
        help="signal generator: synthesize a stereo+RDS station (or a "
             "wideband multi-station capture) as reference-format pcm")
    sy.add_argument("-o", "--output", required=True)
    sy.add_argument("--seconds", type=float, default=1.0)
    sy.add_argument("--pi", default="0x1234", help="PI code (hex ok)")
    sy.add_argument("--ps", default="FMTPU   ", help="8-char service name")
    sy.add_argument("--rt", default="", help="RadioText (<=64 chars)")
    sy.add_argument("--af", default=None,
                    help="comma-separated alternative freqs in MHz")
    sy.add_argument("--pty", type=int, default=0)
    sy.add_argument("--left-hz", type=float, default=1000.0)
    sy.add_argument("--right-hz", type=float, default=3000.0)
    sy.add_argument("--cnr", type=float, default=None,
                    help="add AWGN at this carrier-to-noise (dB)")
    sy.add_argument("--seed", type=int, default=0)
    sy.add_argument("--stations", type=int, default=1,
                    help=">1: wideband capture, stations on the carrier "
                         "grid")
    sy.add_argument("-m", "--num-channels", type=int, default=None,
                    help="wideband oversample factor (default: fits "
                         "stations)")
    sy.set_defaults(fn=cmd_synth)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
