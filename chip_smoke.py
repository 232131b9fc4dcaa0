#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA device.  Phases:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: nvcc builds the five kernel libraries of fm_radio_tpu_torch/csrc/
   (one nvcc per source, all started together);
3. each kernel against its plain PyTorch version on the card, on the
   arguments ``demod_block`` gave it, at C=256 channels x B=131,072
   samples, two blocks with carried state (K12 also with de-emphasis on);
   and the wideband kernels on the arguments ``wideband_demod_block`` gave
   them, two blocks with carried state, on captures loud enough to cross
   the int8 bridge (2.8*M per channel): the channelizer at W=4 captures
   for M=32 (packed words -> i8ps and -> f32, planes -> f32) and M=16
   (words -> i8), and on the planes scaled by M (full-range int8), K12 on phase-split planes at C=256 (M=32, W=8) and on
   phase-split bench planes (full int8 range) through ``demod_block``, and
   the phase-split K12 kernel against the flat K12 kernel on the same
   planes interleaved;
4. the pre-split main path at the bench cell (C=2048, B=131,072, int8
   planes made as bench.py makes them): one warm-up block, then 8 blocks
   through ``demod_block`` with the launch counters set to 0 just before
   and read just after; then each kernel and its plain version timed alone
   on the arguments ``demod_block`` gave it in the last block, and
   compared there with the tolerances of phase 3;
5. the wideband main path at its cell (bench.py's FMTPU_BENCH_WIDEBAND=32
   cell: 2048 stations = 64 captures x M=32, K=16 taps per phase, B=131,072
   per channel, packed words made on the card as bench.py makes them): one
   warm-up block, then 8 blocks through ``wideband_demod_block`` with the
   counters set to 0 just before and read just after; then the channelizer
   and the phase-split K12 timed alone beside their plain versions on the
   last block's arguments, and compared there.  bench.py's amplitude (2.8
   per channel) falls below half an LSB at the int8 bridge, so the same
   cell runs again on loud captures (2.8*M per channel), whose bridge
   output is not constant.  Then the M=16 bridge (stations' default: 128
   captures x 16, loud) for 2 counted blocks;
6. the selftest station through the port's App on the card and through
   the plain versions on the host CPU: selftest gates, identical RDS
   bytes, audio SNR >= 75 dB;
7. wideband stations through ``StationsApp``: ``selftest --stations 4``
   (M=8, flat int8 bridge, 2 s; every station's PI and name) and 3
   stations on an M=32 grid (phase-split bridge, 1.5 s; every station's
   PI, names reported) on the card; and the first 0.5 s of both through
   the card and through the plain versions on the host CPU: identical RDS
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
WIDEBAND_KERNELS = (
    ("channelizer", "fm_radio_tpu_torch/csrc/channelizer.cu",
     "fm_radio_tpu/kernels/channelizer_pallas.py:226"),
    ("k12_ps", "fm_radio_tpu_torch/csrc/k12.cu",
     "fm_radio_tpu/kernels/k12_pallas.py:112"),
)
# kernel vs plain on the card: both evaluate the same float32 operations in
# the same order (the kernels are built with -fmad=false), so they agree to
# rounding; the power sums differ only in summation order.  The channelizer
# has no power sum and its int8 outputs admit no slack: it must be exact.
TOL = {"k12": 1e-5, "pll": 1e-6, "extract": 1e-5, "bpsk": 1e-6,
       "k12_ps": 1e-5, "channelizer": 0.0}
POWER_RTOL = 1e-5
SNR_MIN_DB = 75.0
# per-channel amplitude of bench.py's wideband synthesis (bench.py:311-334)
BENCH_AMP = 2.8


def loud_amp(m: int) -> float:
    """A per-channel amplitude that survives the int8 bridge's 1/M descale
    (the u8 words clip; the bridge output takes several values)."""
    return BENCH_AMP * m


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _modules():
    from fm_radio_tpu_torch.kernels import bpsk, channelizer, extract, k12, pll

    return {"k12": k12, "pll": pll, "extract": extract, "bpsk": bpsk,
            "channelizer": channelizer}


def reset_counts() -> None:
    """Every kernel's launch count to 0 (K12's flat and phase-split
    entries count apart)."""
    for mod in _modules().values():
        mod.launches = 0
    _modules()["k12"].launches_ps = 0


def read_counts() -> dict:
    m = _modules()
    counts = {name: mod.launches for name, mod in m.items()}
    counts["k12_ps"] = m["k12"].launches_ps
    return counts


def check_counts(counts: dict, want: dict, what: str) -> None:
    """Raise unless each kernel launched as often as ``want`` says."""
    bad = {k: (counts[k], n) for k, n in want.items() if counts[k] != n}
    if bad:
        raise RuntimeError(f"{what}: launches (got, want) {bad}")


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


def plane_stats(x8) -> dict:
    """Int8 planes (u8 - 128) measured against their centre value -1 (u8
    127, the bridge's zero): mean |x + 1| in LSB and the share of samples
    at the centre.  Constant planes read 0.0 and 1.0."""
    d = x8.to(torch.float32) + 1.0
    return {"mean_abs_lsb": float(d.abs().mean()),
            "centre_share": float((d == 0).float().mean())}


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
        "k12_ps": (m["k12"].k12_ps, m["k12"].k12_ps_plain),
        "channelizer": (m["channelizer"].channelize,
                        m["channelizer"].channelize_plain),
    }


def stage_errors(name: str, kout, pout) -> dict:
    """A kernel's outputs against its plain version's on the same inputs:
    the max abs error over outputs and state ("err"), the relative error of
    the power sums ("rel") and, for BPSK, the count of differing ``valid``
    decisions ("valid_mismatch"; pred and sym compared where both are
    valid)."""
    if name == "channelizer":
        (sk, yk), (sp, yp) = kout, pout
        ys = zip(yk, yp) if isinstance(yk, tuple) else [(yk, yp)]
        return {"err": _max_err(list(ys) + list(zip(sk, sp)))}
    if name in ("k12", "k12_ps"):
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


def time_stages(calls: dict):
    """Each recorded kernel alone, kernel (mean of 5 calls after one) then
    plain version (1 call), on its recorded arguments, and compared:
    (kernel ms, plain ms, verdict rows), keyed by kernel name."""
    stages = _stages()
    kernel_ms, plain_ms, rows = {}, {}, []
    for name, args in calls.items():
        kern, plain = stages[name]
        kern(*args)
        kout, kernel_ms[name] = _cuda_ms(lambda: kern(*args), reps=5)
        pout, plain_ms[name] = _cuda_ms(lambda: plain(*args), reps=1)
        rows.append(_verdict(name, stage_errors(name, kout, pout)))
    return kernel_ms, plain_ms, rows


def wideband_words(n_captures: int, m: int, block: int, seed: int, device,
                   amp: float = BENCH_AMP):
    """[W, M*B] packed u8 IQ words made on the device as bench.py:311-334
    makes them: per channel an FM-like phase walk (amplitude ``amp``,
    N(0, 0.5) steps), synthesised into the wideband frame domain by an
    inverse DFT over the M channels (zero-order hold), u8-quantised
    (clipped) and packed."""
    g = torch.Generator(device=device).manual_seed(seed)
    k = torch.arange(m, device=device, dtype=torch.float64)
    fm = torch.exp(2j * math.pi * torch.outer(k, k) / m).to(torch.complex64)
    words = torch.empty((n_captures, m * block), device=device)
    for w in range(n_captures):
        phase = torch.cumsum(
            torch.randn((m, block), generator=g, device=device) * 0.5, dim=-1)
        iq = torch.polar(torch.full_like(phase, amp), phase)
        wide = (iq.t() @ fm).reshape(-1)  # frames [B, M] -> wide samples
        re = torch.round(wide.real.clamp(-127.0, 127.0) + 127.0)
        im = torch.round(wide.imag.clamp(-127.0, 127.0) + 127.0)
        words[w] = re * 256.0 + im
    return words


def compare_wideband(block: int = 131072, blocks: int = 2,
                     k12_channels: int = 256, chan_captures: int = 4,
                     device="cuda") -> tuple[list[dict], float]:
    """The wideband kernels against their plain versions, ``blocks``
    blocks with carried state, on the arguments ``wideband_demod_block``
    recorded from loud captures (:func:`loud_amp`): at M=32 (W =
    k12_channels/32) the channelizer on the first ``chan_captures``
    captures (words -> i8ps as recorded, words -> f32, planes -> f32) and
    K12 on phase planes; at M=16 (W = chan_captures) the channelizer
    words -> i8; at both, the channelizer also on the words' planes scaled
    by M, whose int8 output spans the full range.  K12 on phase planes also on bench planes (full int8
    range) split into phases, through ``demod_block``.  Returns (verdict
    rows, each with the :func:`plane_stats` of the int8 planes compared
    under "planes", keyed by input; max abs difference of the phase-split
    K12 kernel from the flat K12 kernel on the same planes interleaved)."""
    from fm_radio_tpu_torch.kernels.channelizer import make_tables
    from fm_radio_tpu_torch.models.demod import (
        SLICE_CONFIG, demod_block, demod_init_state, make_coeffs)
    from fm_radio_tpu_torch.models.wideband import (
        wideband_demod_block, wideband_init_state)
    from fm_radio_tpu_torch.parallel.channelizer import make_channelizer_taps
    from fm_radio_tpu_torch.utils.transfer import unpack_iq_words

    m_ = _modules()
    stages = _stages()
    cfg = SLICE_CONFIG
    co = make_coeffs(cfg, device)
    acc, stats, flat_err = {}, {}, 0.0

    def check(name, args, label=None, planes=None):
        kern, plain = stages[name]
        kout, pout = kern(*args), plain(*args)
        _merge(acc, name, stage_errors(name, kout, pout))
        if label is not None:
            stats.setdefault(name, {})[label] = plane_stats(
                pout[1] if planes is None else planes)
        return kout

    def check_k12_ps(args, label):
        nonlocal flat_err
        kout = check("k12_ps", args, label, args[3])
        flat = m_["k12"].interleave_ps(args[3]).contiguous()
        fout = m_["k12"].k12(*args[:3], flat)
        flat_err = max(flat_err, stage_errors("k12", kout, fout)["err"])

    for m, n_w in ((32, k12_channels // 32), (16, chan_captures)):
        tab = make_tables(make_channelizer_taps(m), m, device)
        st = wideband_init_state(cfg, m, n_w, device=device)
        x = wideband_words(n_w, m, block * blocks, seed=m, device=device,
                           amp=loud_amp(m))
        for blk in range(blocks):
            calls = {}
            xb = x[:, blk * m * block : (blk + 1) * m * block].contiguous()
            st, _ = wideband_demod_block(cfg, co, tab, st, xb, m, record=calls)
            _, (sr, si), words, _, out = calls["channelizer"]
            sub = (sr[:chan_captures], si[:chan_captures])
            w4 = words[:chan_captures]
            check("channelizer", (tab, sub, w4, m, out), f"m{m}_{out}")
            planes = tuple(p.contiguous() for p in unpack_iq_words(w4))
            # the same planes scaled by M: int8 output over its full range
            loud = tuple(p * float(m) for p in planes)
            check("channelizer", (tab, sub, loud, m, out),
                  f"m{m}_planes_x{m}_{out}")
            if m == 32:
                check("channelizer", (tab, sub, w4, m, "f32"))
                check("channelizer", (tab, sub, planes, m, "f32"))
                check_k12_ps(calls["k12_ps"], "m32_bridge")
            torch.cuda.synchronize(device)

    st = demod_init_state(cfg, k12_channels, device)
    x = bench_planes(k12_channels, block * blocks, seed=2, device=device)
    for blk in range(blocks):
        calls = {}
        xb = x[:, :, blk * block : (blk + 1) * block]
        x4 = xb.reshape(2, k12_channels, block // 4, 4).permute(0, 3, 1, 2)
        st, _ = demod_block(cfg, co, st, x4.contiguous(), record=calls)
        check_k12_ps(calls["k12_ps"], "bench_planes")
        torch.cuda.synchronize(device)
    rows = [dict(_verdict(name, acc[name]), planes=stats[name])
            for name, _, _ in WIDEBAND_KERNELS]
    return rows, flat_err


def wideband_path(n_captures: int = 64, m: int = 32, block: int = 131072,
                  blocks: int = 8, amp: float = BENCH_AMP,
                  time_kernels: bool = True, device="cuda") -> dict:
    """The wideband cell through wideband_demod_block with counted
    launches (one warm-up block first), on captures of per-channel
    amplitude ``amp``; the :func:`plane_stats` of the last block's bridge
    output; then, if ``time_kernels``, the channelizer and the phase-split
    K12 (at M=32) timed alone beside their plain versions on the last
    block's arguments, and compared."""
    from fm_radio_tpu_torch.kernels.channelizer import make_tables
    from fm_radio_tpu_torch.models.demod import SLICE_CONFIG, make_coeffs
    from fm_radio_tpu_torch.models.wideband import (
        wideband_demod_block, wideband_init_state)
    from fm_radio_tpu_torch.parallel.channelizer import make_channelizer_taps

    cfg = SLICE_CONFIG
    co = make_coeffs(cfg, device)
    tab = make_tables(make_channelizer_taps(m, 16), m, device)
    st = wideband_init_state(cfg, m, n_captures, 16, device)
    # the pre-flattened [W, T/128, 128] view that bench.py passes
    x = wideband_words(n_captures, m, block, seed=0, device=device, amp=amp)
    x = x.reshape(n_captures, -1, 128)
    st, _ = wideband_demod_block(cfg, co, tab, st, x, m)  # warm-up
    torch.cuda.synchronize(device)

    calls = {}
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(blocks):
        st, outs = wideband_demod_block(cfg, co, tab, st, x, m, record=calls)
    end.record()
    torch.cuda.synchronize(device)
    launches = read_counts()
    ms = start.elapsed_time(end)
    ps = m == 32
    check_counts(launches, {"channelizer": blocks, "k12_ps": blocks * ps,
                            "k12": blocks * (not ps), "pll": blocks,
                            "extract": blocks, "bpsk": blocks},
                 f"wideband path (M={m})")
    c = n_captures * m
    audio = outs["audio"]
    if tuple(audio.shape) != (c, block // 32, 2):
        raise RuntimeError(f"wideband audio shape {tuple(audio.shape)}")
    for k in ("audio", "rds_pred"):
        if not bool(torch.isfinite(outs[k]).all()):
            raise RuntimeError(f"wideband: non-finite {k}")
    bridged = calls["k12_ps" if ps else "k12"][3]
    res = {"m": m, "captures": n_captures, "channels": c, "block": block,
           "blocks": blocks, "amp": amp, "planes": plane_stats(bridged),
           "launches": launches,
           "ms_per_block": ms / blocks,
           "msps": c * block * blocks / (ms / 1e3) / 1e6}
    if time_kernels:
        timed = {k: calls[k] for k in ("channelizer", "k12_ps")}
        res["kernel_ms"], res["plain_ms"], res["compare"] = time_stages(timed)
    return res


def main_path(channels: int = 2048, block: int = 131072, blocks: int = 8,
              device="cuda") -> dict:
    """The bench cell through demod_block, with counted launches; then each
    kernel and its plain version, timed alone on the arguments
    ``demod_block`` gave that kernel in the last block, and compared."""
    from fm_radio_tpu_torch.models.demod import (
        SLICE_CONFIG, demod_block, demod_init_state, make_coeffs)

    cfg = SLICE_CONFIG
    co = make_coeffs(cfg, device)
    st = demod_init_state(cfg, channels, device)
    x = bench_planes(channels, block, seed=0, device=device)
    st, _ = demod_block(cfg, co, st, x)  # warm-up (first launches, caches)
    torch.cuda.synchronize(device)

    calls = {}
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(blocks):
        st, outs = demod_block(cfg, co, st, x, record=calls)
    end.record()
    torch.cuda.synchronize(device)
    launches = read_counts()
    ms = start.elapsed_time(end)
    check_counts(launches, {"k12": blocks, "pll": blocks, "extract": blocks,
                            "bpsk": blocks, "k12_ps": 0, "channelizer": 0},
                 "pre-split main path")
    audio = outs["audio"]
    if tuple(audio.shape) != (channels, block // 32, 2):
        raise RuntimeError(f"audio shape {tuple(audio.shape)}")
    for k in ("audio", "rds_pred"):
        if not bool(torch.isfinite(outs[k]).all()):
            raise RuntimeError(f"non-finite {k}")

    kernel_ms, plain_ms, rows = time_stages(calls)
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


def _snr_db(a, b) -> float:
    """SNR (dB) of ``a`` against the reference ``b``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return 10 * math.log10(float(np.sum(b ** 2))
                           / (float(np.sum((a - b) ** 2)) + 1e-30))


def wideband_stations(device="cuda", block: int = 65536,
                      cpu_seconds: float = 0.5) -> list[dict]:
    """Wideband stations through StationsApp: ``selftest --stations 4``
    (M=8, 2 s, the CLI's default) and 3 stations on an M=32 grid (1.5 s)
    on the card; then the first ``cpu_seconds`` of the same captures on the
    card and, with the plain versions, on the host CPU: RDS bytes
    identical and audio SNR of the card against the CPU for every station.
    Each row's "pass" is the selftest gate (PI, name, >= 5 groups) and
    "gate" what this phase holds: at M=8 the selftest gate; at M=32 the PI
    and the group count, with the name reported.  (The int8 bridge
    carries a station at 1/M of its capture amplitude, as the JAX
    package's bridge does: ~1.2 LSB rms at M=32, where a station's name
    may miss a segment in seconds of signal; identically in the JAX
    package, whose RDS bytes the port reproduces.  The CPU leg is
    shortened to stay under about two minutes.)"""
    from fm_radio_tpu_torch.apps.cli import selftest_wideband

    results = []
    for k_st, m, seconds in ((4, 8, 2.0), (3, 32, 1.5)):
        n = int(seconds * 1_024_000) // block * block
        _, t_gpu, checks = selftest_wideband(k_st, m, n, block, device)
        n_cmp = int(cpu_seconds * 1_024_000) // block * block
        short = {str(dev): selftest_wideband(k_st, m, n_cmp, block, dev)
                 for dev in (device, "cpu")}
        (gpu, _, _), (cpu, t_cpu, _) = short[str(device)], short["cpu"]
        settle = int(0.15 * gpu.cfg.rates.fs_audio)
        stations = []
        for i in range(k_st):
            ck = checks[f"station_{i + 1}"]
            stations.append({
                **ck,
                "gate": ck["pass"] if m == 8 else (
                    ck["pi"] == ck["expect_pi"] and ck["groups"] >= 5),
                "rds_bytes": int(gpu.rds_bytes(i).size),
                "rds_identical": bool(np.array_equal(gpu.rds_bytes(i),
                                                     cpu.rds_bytes(i))),
                "snr_vs_cpu_db": _snr_db(gpu.audio[i, settle:],
                                         cpu.audio[i, settle:])})
        results.append({"stations": k_st, "m": m,
                        "seconds_audio": n / 1_024_000,
                        "seconds_audio_vs_cpu": n_cmp / 1_024_000,
                        "seconds": {"card": t_gpu, "cpu": t_cpu},
                        "per_station": stations})
    return results


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

    t0 = time.perf_counter()
    wrows, flat_err = compare_wideband(131072, 2, 256, 4, dev)
    for r in wrows:
        log(f"[compare] {json.dumps(r)}")
    log(f"[compare] k12_ps kernel vs flat k12 kernel: max abs diff "
        f"{flat_err}; {time.perf_counter() - t0:.1f} s")
    bad = [r["name"] for r in wrows if not r["ok"]]
    if bad or flat_err != 0.0:
        raise RuntimeError(f"wideband kernels disagree: {bad}, phase-split "
                           f"vs flat K12 {flat_err}")
    silent = [(r["name"], k) for r in wrows for k, v in r["planes"].items()
              if v["centre_share"] >= 1.0]
    if silent:
        raise RuntimeError(f"wideband kernels compared on constant planes: "
                           f"{silent}")

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

    # 5. the wideband main path at its cell, then the M=16 bridge
    t0 = time.perf_counter()
    wb_bench = wideband_path(64, 32, 131072, 8, device=dev)
    log(f"[wideband] {json.dumps(wb_bench)}")
    wb = wideband_path(64, 32, 131072, 8, amp=loud_amp(32), device=dev)
    log(f"[wideband] {json.dumps(wb)}")
    wb16 = wideband_path(128, 16, 131072, 2, amp=loud_amp(16),
                         time_kernels=False, device=dev)
    log(f"[wideband] {json.dumps(wb16)}")
    log(f"[wideband] {time.perf_counter() - t0:.1f} s")
    bad = [r["name"] for r in wb_bench["compare"] + wb["compare"]
           if not r["ok"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions at "
                           f"the wideband cell: {bad}")
    if wb["planes"]["centre_share"] >= 1.0:
        raise RuntimeError("the loud wideband cell reached K12 silent")

    # 6. station on the card and on the host CPU
    t0 = time.perf_counter()
    stn = station(dev)
    log(f"[station] {json.dumps(stn)}")
    log(f"[station] {time.perf_counter() - t0:.1f} s")
    if not (stn["checks_pass"] and stn["rds_identical"]
            and stn["snr_vs_cpu_db"] >= SNR_MIN_DB and stn["rds_bytes"] > 0):
        raise RuntimeError("station phase failed its gates")

    # 7. wideband stations on the card and on the host CPU
    t0 = time.perf_counter()
    wst = wideband_stations(dev)
    log(f"[stations] {json.dumps(wst)}")
    log(f"[stations] {time.perf_counter() - t0:.1f} s")
    for grid in wst:
        for r in grid["per_station"]:
            if not (r["gate"] and r["rds_identical"] and r["rds_bytes"] > 0
                    and r["snr_vs_cpu_db"] >= SNR_MIN_DB):
                raise RuntimeError(f"wideband stations (M={grid['m']}) "
                                   f"failed their gates: {r}")

    err = {r["name"]: r["max_abs_err"] for r in rows + wrows}
    err_main = {}
    for r in mp["compare"] + wb_bench["compare"] + wb["compare"]:
        err_main[r["name"]] = max(err_main.get(r["name"], 0.0),
                                  r["max_abs_err"])
    paths = {"presplit": mp["launches"],
             "wideband_m32": wb_bench["launches"],
             "wideband_m32_loud": wb["launches"],
             "wideband_m16_loud": wb16["launches"]}
    kernels = [
        {"name": n, "route": "cuda", "source": src, "replaces": rep,
         "launches": cell["launches"][n],
         "launches_by_path": {p: c[n] for p, c in paths.items()},
         "max_abs_err": max(err[n], err_main[n]),
         "max_abs_err_full_width": err_main[n],
         "max_abs_err_small": err[n],
         "ms": cell["kernel_ms"][n], "plain_ms": cell["plain_ms"][n]}
        for cell, table in ((mp, KERNELS), (wb_bench, WIDEBAND_KERNELS))
        for n, src, rep in table
    ]
    # the wideband kernels: "ms" on the loud cell, whose int8 planes are
    # not constant, and also on bench.py's (silent at the bridge)
    planes = {r["name"]: r["planes"] for r in wrows}
    for k in kernels[len(KERNELS):]:
        n = k["name"]
        k.update(ms=wb["kernel_ms"][n], plain_ms=wb["plain_ms"][n],
                 ms_bench_input=wb_bench["kernel_ms"][n],
                 plain_ms_bench_input=wb_bench["plain_ms"][n],
                 planes_small=planes[n], planes_full_width=wb["planes"],
                 planes_full_width_bench_input=wb_bench["planes"])
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
