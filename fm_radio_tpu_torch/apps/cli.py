"""Command-line entry point of the PyTorch/CUDA port.

    python -m fm_radio_tpu_torch.apps.cli selftest [--seconds 2.0]
        [-b 65536] [--cnr DB] [--device cuda|cpu]

``selftest`` is the port of ``fm_radio_tpu/apps/cli.py::cmd_selftest``:
synthesize a known stereo + RDS station, quantize it to u8 and split it
into int8 planes (the production ingest), demodulate it, and gate on tone
recovery, stereo separation and RDS decode.  It prints a one-line JSON
verdict and exits 1 on failure.  ``--device cuda`` (the default) runs the
CUDA kernels; ``--device cpu`` runs their plain PyTorch versions.  The
other subcommands of the JAX CLI are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from fm_radio_tpu.io.pcm import c64_to_u8
from fm_radio_tpu.io.synth import (
    FMModulator,
    ModulatorConfig,
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


def selftest_planes(seconds: float, block: int, cnr: float | None = None):
    """The selftest station as [2, 1, N] int8 planes (N a multiple of
    ``block``, at least 8 blocks)."""
    from fm_radio_tpu_torch.utils.transfer import split_iq_i8

    n = max(int(seconds * 1_024_000) // block, 8) * block
    groups = station_group_schedule(SELFTEST_PI, ps=SELFTEST_PS,
                                    rt="FMTPU SELFTEST")
    iq = FMModulator(ModulatorConfig()).generate(
        n, left_hz=LEFT_HZ, right_hz=RIGHT_HZ, rds_groups=groups)
    if cnr is not None:
        iq = add_awgn(iq, cnr)
    u8 = c64_to_u8(iq.astype(np.complex64)).reshape(-1, 2)
    return split_iq_i8(u8)[:, None, :]


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


def cmd_selftest(args) -> int:
    from fm_radio_tpu_torch.models.app import App

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("selftest: no CUDA device (use --device cpu for the plain "
              "PyTorch versions)", file=sys.stderr)
        return 2
    block = power_ceil(args.block_size)
    x8 = selftest_planes(args.seconds, block, args.cnr)
    app = App(block_size=block, channels=1, device=device)
    t0 = time.time()
    app.process(x8)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fm_radio_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    sf = sub.add_parser(
        "selftest",
        help="synthesize a known station, demod it, gate accuracy (one-line "
             "JSON verdict; exit 1 on failure)")
    sf.add_argument("--seconds", type=float, default=2.0)
    sf.add_argument("-b", "--block-size", type=int, default=65536)
    sf.add_argument("--cnr", type=float, default=None,
                    help="optionally add AWGN at this carrier-to-noise dB")
    sf.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    sf.set_defaults(fn=cmd_selftest)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
