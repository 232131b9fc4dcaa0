#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA device.  Phases:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: nvcc builds the four kernels of fm_radio_tpu_torch/csrc/;
3. each kernel against its plain PyTorch version on the card, on the
   arguments ``demod_block`` gave it, at C=256 channels x B=131,072
   samples, two blocks with carried state (K12 also with de-emphasis on);
4. the main path at the bench cell (C=2048, B=131,072, int8 planes made
   as bench.py makes them): one warm-up block, then 8 blocks through
   ``demod_block`` with the launch counters set to 0 just before and read
   just after; then each kernel and its plain version timed alone on the
   arguments ``demod_block`` gave it in the last block, and compared there
   with the tolerances of phase 3;
5. the selftest station through the port's App on the card and through
   the plain versions on the host CPU: selftest gates, identical RDS
   bytes, audio SNR >= 75 dB.

Any failed phase raises and the script exits non-zero.  The last lines of
standard output are the nvidia-smi line, one JSON object with the
per-kernel results, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# (name, CUDA source, TPU kernel it replaces)
KERNELS = (
    ("k12", "fm_radio_tpu_torch/csrc/k12.cu",
     "fm_radio_tpu/kernels/k12_pallas.py:59"),
    ("pll", "fm_radio_tpu_torch/csrc/pll.cu",
     "fm_radio_tpu/kernels/pll_pallas.py:80"),
    ("extract", "fm_radio_tpu_torch/csrc/extract.cu",
     "fm_radio_tpu/kernels/extract_pallas.py:122"),
    ("bpsk", "fm_radio_tpu_torch/csrc/bpsk.cu",
     "fm_radio_tpu/kernels/bpsk_pallas.py:45"),
)
# kernel vs plain on the card: both evaluate the same float32 operations in
# the same order (the kernels are built with -fmad=false), so they agree to
# rounding; the power sums differ only in summation order
TOL = {"k12": 1e-5, "pll": 1e-6, "extract": 1e-5, "bpsk": 1e-6}
POWER_RTOL = 1e-5
SNR_MIN_DB = 75.0


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _modules():
    from fm_radio_tpu_torch.kernels import bpsk, extract, k12, pll

    return {"k12": k12, "pll": pll, "extract": extract, "bpsk": bpsk}


def bench_planes(channels: int, block: int, seed: int, device):
    """[2, C, B] int8 planes of an FM-like signal (constant envelope,
    random phase walk) quantized to the u8 grid, as bench.py makes its
    input, generated on the device from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    phase = torch.cumsum(
        torch.randn((channels, block), generator=g, device=device) * 0.5,
        dim=-1)
    planes = torch.stack([torch.round(100.0 * torch.cos(phase) + 127.0),
                          torch.round(100.0 * torch.sin(phase) + 127.0)])
    return (planes - 128.0).to(torch.int8)


def _wrapped_err(a, b) -> float:
    """Max difference of two phase tracks in cycles, wrapped to +-0.5."""
    d = a.double() - b.double()
    return float((d - torch.round(d)).abs().max())


def _max_err(pairs) -> float:
    return max((float((a.double() - b.double()).abs().max())
                for a, b in pairs if a.numel()), default=0.0)


def _state_err(sa: dict, sb: dict, keys) -> float:
    err = 0.0
    for k in keys:
        a, b = sa[k], sb[k]
        if isinstance(a, dict):
            err = max(err, _state_err(a, b, a.keys()))
        elif isinstance(a, tuple):
            for x, y in zip(a, b):
                err = max(err, float((torch.as_tensor(x).double()
                                      - torch.as_tensor(y).double())
                                     .abs().max()))
        else:
            if a.is_complex():
                a, b = torch.view_as_real(a), torch.view_as_real(b)
            err = max(err, float((a.double() - b.double()).abs().max()))
    return err


def _rel(a, b) -> float:
    return float(((a.double() - b.double()).abs()
                  / b.double().abs().clamp(min=1e-30)).max())


K12_KEYS = ("ds_fm_in", "disc_prev_theta", "ds_fm_out", "deemph", "hilbert",
            "peak_pilot")
EXTRACT_KEYS = ("ds_audio_lpr", "ds_audio_lmr", "ds_rds")


def _stages():
    """Each kernel's (wrapper, plain version), by the names under which
    ``demod_block`` records their arguments."""
    m = _modules()
    return {
        "k12": (m["k12"].k12, m["k12"].k12_plain),
        "pll": (m["pll"].pilot_pll_theta, m["pll"].pll_plain),
        "extract": (m["extract"].extract, m["extract"].extract_plain),
        "bpsk": (m["bpsk"].bpsk_sync, m["bpsk"].bpsk_plain),
    }


def stage_errors(name: str, kout, pout) -> dict:
    """A kernel's outputs against its plain version's on the same inputs:
    the max abs error over outputs and state ("err"), the relative error of
    the power sums ("rel") and, for BPSK, the count of differing ``valid``
    decisions ("valid_mismatch"; pred and sym compared where both are
    valid)."""
    if name == "k12":
        (sk, iq_k, th_k), (sp, iq_p, th_p) = kout, pout
        return {"err": max(_max_err(zip(iq_k, iq_p)), _wrapped_err(th_k, th_p),
                           _state_err(sk, sp, K12_KEYS)),
                "rel": _rel(sk["agc_pilot"], sp["agc_pilot"])}
    if name == "pll":
        (sk, dt_k), (sp, dt_p) = kout, pout
        return {"err": max(_max_err([(dt_k, dt_p)]), _max_err(zip(sk, sp)))}
    if name == "extract":
        return {"err": max(_max_err([(kout[1], pout[1])]),
                           _max_err(zip(kout[2], pout[2])),
                           _max_err(zip(kout[3], pout[3])),
                           _state_err(kout[0], pout[0], EXTRACT_KEYS)),
                "rel": _rel(kout[4], pout[4])}
    (bk, ok_), (bp, op_) = kout, pout
    v = ok_["valid"] & op_["valid"]
    return {"err": max(_max_err([(ok_["pred"][v], op_["pred"][v]),
                                 (ok_["sym"].real[v], op_["sym"].real[v])]),
                       _state_err(bk._asdict(), bp._asdict(), bk._fields)),
            "valid_mismatch": int((ok_["valid"] != op_["valid"]).sum())}


def _merge(acc: dict, name: str, e: dict) -> None:
    a = acc.setdefault(name, {})
    for k, v in e.items():
        a[k] = (a.get(k, 0) + v if k == "valid_mismatch"
                else max(a.get(k, 0.0), v))


def _verdict(name: str, e: dict) -> dict:
    ok = math.isfinite(e["err"]) and e["err"] <= TOL[name]
    ok = ok and e.get("rel", 0.0) <= POWER_RTOL and not e.get("valid_mismatch")
    return {"name": name, "max_abs_err": e["err"], "tol": TOL[name],
            "power_rel_err": e.get("rel"),
            "valid_mismatch": e.get("valid_mismatch"), "ok": ok}


def compare_kernels(channels: int = 256, block: int = 131072, blocks: int = 2,
                    device="cuda") -> list[dict]:
    """Each kernel against its plain version on the card: every block goes
    through ``demod_block`` (state carried), and each kernel and its plain
    version run again on the arguments ``demod_block`` gave that kernel;
    K12 also with de-emphasis on, on the same input.  Returns one row per
    kernel with its max abs error, tolerance and verdict."""
    from fm_radio_tpu_torch.models.demod import (
        SLICE_CONFIG, demod_block, demod_init_state, make_coeffs)

    stages = _stages()
    cfg = SLICE_CONFIG
    co = make_coeffs(cfg, device)
    cfg_de = dataclasses.replace(cfg, use_deemphasis_filter=True,
                                 deemphasis_cutoff_us=50)
    co_de = make_coeffs(cfg_de, device)
    st = demod_init_state(cfg, channels, device)
    x = bench_planes(channels, block * blocks, seed=1, device=device)
    acc = {}
    for blk in range(blocks):
        calls = {}
        xb = x[:, :, blk * block : (blk + 1) * block].contiguous()
        st, _ = demod_block(cfg, co, st, xb, record=calls)
        # the de-emphasis stage (off in the slice config) on the same input
        calls_de = {"k12": (co_de, cfg_de) + calls["k12"][2:]}
        for rec in (calls, calls_de):
            for name, args in rec.items():
                kern, plain = stages[name]
                _merge(acc, name, stage_errors(name, kern(*args), plain(*args)))
        torch.cuda.synchronize(device)
    return [_verdict(name, acc[name]) for name, _, _ in KERNELS]


def _cuda_ms(fn, reps: int):
    """(the last call's result, mean ms per call from CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def main_path(channels: int = 2048, block: int = 131072, blocks: int = 8,
              device="cuda") -> dict:
    """The bench cell through demod_block, with counted launches; then each
    kernel and its plain version, timed alone on the arguments
    ``demod_block`` gave that kernel in the last block, and compared."""
    from fm_radio_tpu_torch.models.demod import (
        SLICE_CONFIG, demod_block, demod_init_state, make_coeffs)

    m = _modules()
    cfg = SLICE_CONFIG
    co = make_coeffs(cfg, device)
    st = demod_init_state(cfg, channels, device)
    x = bench_planes(channels, block, seed=0, device=device)
    st, _ = demod_block(cfg, co, st, x)  # warm-up (first launches, caches)
    torch.cuda.synchronize(device)

    calls = {}
    for mod in m.values():
        mod.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(blocks):
        st, outs = demod_block(cfg, co, st, x, record=calls)
    end.record()
    torch.cuda.synchronize(device)
    launches = {name: mod.launches for name, mod in m.items()}
    ms = start.elapsed_time(end)
    for name, n in launches.items():
        if n != blocks:
            raise RuntimeError(f"main path launched {name} {n} times in "
                               f"{blocks} blocks")
    audio = outs["audio"]
    if tuple(audio.shape) != (channels, block // 32, 2):
        raise RuntimeError(f"audio shape {tuple(audio.shape)}")
    for k in ("audio", "rds_pred"):
        if not bool(torch.isfinite(outs[k]).all()):
            raise RuntimeError(f"non-finite {k}")

    # each stage alone, kernel then plain, on the last block's inputs
    kernel_ms, plain_ms, rows = {}, {}, []
    for name, (kern, plain) in _stages().items():
        args = calls[name]
        kern(*args)
        kout, kernel_ms[name] = _cuda_ms(lambda: kern(*args), reps=5)
        pout, plain_ms[name] = _cuda_ms(lambda: plain(*args), reps=1)
        rows.append(_verdict(name, stage_errors(name, kout, pout)))
    return {
        "launches": launches,
        "ms_per_block": ms / blocks,
        "msps": channels * block * blocks / (ms / 1e3) / 1e6,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "compare": rows,
    }


def station(device="cuda") -> dict:
    """The selftest station through the port's App on the card and,
    with the plain versions, on the host CPU."""
    from fm_radio_tpu_torch.apps.cli import (
        power_ceil, selftest_checks, selftest_planes)
    from fm_radio_tpu_torch.models.app import App

    block = power_ceil(65536)
    x8 = selftest_planes(2.0, block)
    apps = {}
    for dev in (device, "cpu"):
        app = App(block_size=block, channels=1, device=dev)
        t0 = time.perf_counter()
        app.process(x8)
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize(dev)
        apps[str(dev)] = (app, time.perf_counter() - t0)
    gpu, cpu = apps[str(device)][0], apps["cpu"][0]
    checks = selftest_checks(gpu)
    settle = int(0.15 * gpu.demod.fs_audio)
    a, b = gpu.audio[0, settle:], cpu.audio[0, settle:]
    snr = 10 * math.log10(float(np.sum(b.astype(np.float64) ** 2))
                          / (float(np.sum((a.astype(np.float64) - b) ** 2))
                             + 1e-30))
    same_rds = np.array_equal(gpu.rds_bytes(0), cpu.rds_bytes(0))
    return {
        "checks_pass": all(r["pass"] for r in checks.values()),
        "checks": checks,
        "rds_bytes": int(gpu.rds_bytes(0).size),
        "rds_identical": bool(same_rds),
        "snr_vs_cpu_db": snr,
        "seconds": {k: v[1] for k, v in apps.items()},
    }


def main() -> int:
    sys.path.insert(0, HERE)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import fm_radio_tpu_torch  # noqa: F401
        from fm_radio_tpu_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})",
              file=sys.stderr)
        return 1

    # 1. device
    smi = nvidia_smi_line()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(dev)
    log(f"[device] {smi} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | {name}")

    # 2. build
    t0 = time.perf_counter()
    _build.build()
    log(f"[build] nvcc {_build.build_dir().name}: "
        f"{time.perf_counter() - t0:.1f} s")

    # 3. kernel against plain on the card
    t0 = time.perf_counter()
    rows = compare_kernels(256, 131072, 2, dev)
    for r in rows:
        log(f"[compare] {json.dumps(r)}")
    log(f"[compare] {time.perf_counter() - t0:.1f} s")
    bad = [r["name"] for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: {bad}")

    # 4. main path at the bench cell
    t0 = time.perf_counter()
    mp = main_path(2048, 131072, 8, dev)
    torch.cuda.synchronize(dev)
    log(f"[main] {json.dumps(mp)}")
    log(f"[main] {time.perf_counter() - t0:.1f} s")
    bad = [r["name"] for r in mp["compare"] if not r["ok"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions at "
                           f"the bench cell: {bad}")

    # 5. station on the card and on the host CPU
    t0 = time.perf_counter()
    stn = station(dev)
    log(f"[station] {json.dumps(stn)}")
    log(f"[station] {time.perf_counter() - t0:.1f} s")
    if not (stn["checks_pass"] and stn["rds_identical"]
            and stn["snr_vs_cpu_db"] >= SNR_MIN_DB and stn["rds_bytes"] > 0):
        raise RuntimeError("station phase failed its gates")

    err = {r["name"]: r["max_abs_err"] for r in rows}
    err_main = {r["name"]: r["max_abs_err"] for r in mp["compare"]}
    kernels = [
        {"name": n, "route": "cuda", "source": src, "replaces": rep,
         "launches": mp["launches"][n],
         "max_abs_err": max(err[n], err_main[n]),
         "max_abs_err_bench_cell": err_main[n], "max_abs_err_c256": err[n],
         "ms": mp["kernel_ms"][n], "plain_ms": mp["plain_ms"][n]}
        for n, src, rep in KERNELS
    ]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
