"""Command-line entry point of the PyTorch/CUDA port.

    python -m fm_radio_tpu_torch.apps.cli demod -i in.pcm [-o out.wav]
        [--ingest i8|f32w] [-b 65536] [--audio-mode stereo|lpr|lmr]
        [--deemphasis-us US] [--lpr-cutoff-hz HZ] [--lmr-cutoff-hz HZ]
        [--stereo-gain G] [--no-rds] [--strict-ref] [--device cuda|cpu]
    python -m fm_radio_tpu_torch.apps.cli bench [-i in.pcm] [-b 65536]
        [-c 64] [--device cuda|cpu]
    python -m fm_radio_tpu_torch.apps.cli selftest [--seconds 2.0]
        [-b 65536] [--cnr DB] [--stations K] [--device cuda|cpu]
    python -m fm_radio_tpu_torch.apps.cli stations -i wide.pcm -o outdir
        [-m 16] [-b 65536] [--taps-per-phase 16] [--select 1,5 | --auto
        [--threshold-db 15]] [--device cuda|cpu]

``demod`` is the port of ``fm_radio_tpu/apps/cli.py::cmd_demod``: one
recorded u8 IQ capture -> WAV (``-o``) and the RDS database (JSON on
stdout, group log lines on stderr).  ``--ingest i8`` (the default) feeds
int8 planes with ``frontend_int8`` (the fused K12); ``--ingest f32w``
feeds packed u8 words under ``DemodConfig()`` with integer input (the
split K1 on words, float taps, then K2).  Its flags that need modules not
ported yet (``--save-state``, ``--resume-state``, ``--resume-seek``,
``--checkpoint-every``, ``--taps``, ``--rate``, ``--play``,
``--play-format``) exit with code
2 and the ROADMAP.md item that adds them.

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
the channelizer and one batched demod, gated on each station's PI, name
and group count.  It prints a one-line JSON verdict and exits 1 on
failure.

``stations`` is the port of ``cmd_stations``: a wideband u8 IQ capture ->
polyphase FFT channelizer -> int8 bridge -> one demod of every channel, on
the device block by block (``models/wideband.py::wideband_demod_block``),
then a WAV and the RDS database of each selected channel
(``station_KK.wav`` and a JSON summary on stdout).  ``--auto`` selects the
channels whose power clears the median by ``--threshold-db``.

``--device cuda`` (the default) runs the CUDA kernels; ``--device cpu``
runs their plain PyTorch versions.  The other subcommands of the JAX CLI
are not ported yet (ROADMAP.md, modules still to port, item 3).
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


def selftest_wideband(k_st: int, m: int, n: int, block: int, device,
                      cnr: float | None = None):
    """K stations through ``StationsApp`` on ``device``: returns (app,
    seconds elapsed, checks)."""
    from fm_radio_tpu_torch.models.app import StationsApp
    from fm_radio_tpu_torch.utils.transfer import pack_iq_u8

    words = pack_iq_u8(wideband_capture(k_st, m, n, cnr=cnr))
    app = StationsApp(m, block, select=range(1, k_st + 1), device=device)
    t0 = time.time()
    app.process(words)
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
    packed capture (cut to a multiple of the channelizer's block), from
    the channelizer's float32 output."""
    from fm_radio_tpu_torch.kernels.channelizer import T_MULTIPLE
    from fm_radio_tpu_torch.parallel.channelizer import (
        channelize_batch_p,
        make_channelizer_taps,
    )

    n = min(len(words), window) // T_MULTIPLE * T_MULTIPLE
    if n == 0:
        raise ValueError(f"--auto needs at least {T_MULTIPLE} wide samples")
    x = torch.as_tensor(np.asarray(words[0:n], np.float32),
                        device=device)[None]
    zeros = torch.zeros((1, (taps_per_phase - 1) * m), device=device)
    _, (y_re, y_im) = channelize_batch_p(
        make_channelizer_taps(m, taps_per_phase), (zeros, zeros.clone()), x,
        m)
    settle = taps_per_phase  # filterbank fill
    p = (y_re[0, :, settle:].double() ** 2 + y_im[0, :, settle:].double() ** 2)
    return 10.0 * np.log10(p.mean(dim=1).cpu().numpy() + 1e-20)


def detect_active_channels(powers_db: np.ndarray,
                           threshold_db: float) -> list[int]:
    """Channels whose power clears the median (noise-floor estimate) by
    ``threshold_db``."""
    floor = float(np.median(powers_db))
    return [int(k) for k in np.nonzero(powers_db > floor + threshold_db)[0]]


def cmd_stations(args) -> int:
    from fm_radio_tpu_torch.io.wav import write_wav_int16
    from fm_radio_tpu_torch.models.app import StationsApp

    device = _device(args, "stations")
    if device is None:
        return 2
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
            return 1
        print(f"auto-selected channels: {select}", file=sys.stderr)
    elif args.select:
        select = sorted(int(v) for v in args.select.split(","))
    else:
        select = list(range(m))
    app = StationsApp(m, block, select=select,
                      taps_per_phase=args.taps_per_phase, device=device)
    chunk = m * block
    for i0 in range(0, len(words), chunk):
        app.process(words[i0 : min(i0 + chunk, len(words))])
    os.makedirs(args.output, exist_ok=True)
    summary = []
    for i, k in enumerate(select):
        wav_path = os.path.join(args.output, f"station_{k:02d}.wav")
        write_wav_int16(wav_path, app.audio[i], app.cfg.rates.fs_audio)
        summary.append({"channel": k, "wav": wav_path,
                        **app.rds_database(i).summary()})
    print(json.dumps(summary, indent=1))
    return 0


# demod flags that need modules not ported yet -> the ROADMAP.md item
_DEMOD_NOT_PORTED = {
    "save_state": "modules still to port, item 4 (utils/checkpoint.py)",
    "resume_state": "modules still to port, item 4 (utils/checkpoint.py)",
    "resume_seek": "modules still to port, item 4 (utils/checkpoint.py)",
    "checkpoint_every": "modules still to port, item 4 (utils/checkpoint.py)",
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
    ``--strict-ref``) in chunks of 64 blocks."""
    from fm_radio_tpu_torch.models.app import App

    block = power_ceil(args.block_size)
    iq = i8_input(args.input) if args.ingest == "i8" else packed_input(
        args.input)
    app = App(block_size=block, cfg=demod_config(args), channels=1,
              decode_rds=not args.no_rds, integer_input=True,
              strict_ref=args.strict_ref, device=device)
    n_in = len(iq)
    chunk = 64 * block
    for i0 in range(0, n_in, chunk):
        app.process(iq[i0 : min(i0 + chunk, n_in)])
    if n_in == 0:
        app.process(iq[0:0])  # empty input: clean empty outputs
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
    d.add_argument("--save-state", default=None, help="not ported yet")
    d.add_argument("--resume-state", default=None, help="not ported yet")
    d.add_argument("--resume-seek", action="store_true",
                   help="not ported yet")
    d.add_argument("--checkpoint-every", type=int, default=0,
                   help="not ported yet")
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
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
