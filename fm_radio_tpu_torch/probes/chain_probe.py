"""Cumulative-prefix timing of ``demod_block`` on the card: where does the
time go?

Counterpart of ``tools/chain_probe.py``.  :func:`fused_prefix` runs the
port's split kernels stage by stage with state carried over n_blocks
blocks, and each prefix is timed (CUDA events over the blocks, best of
``--iters``) with the delta per stage printed:

  K1        ``frontend_i8`` on int8 planes (default), ``--packed`` the
            float-tap K1 on packed words, ``--planes`` on float32 planes
  + K2      ``midend``
  + PLL     ``pilot_pll_theta``
  + extract ``extract``
  + RDS AGC + BPSK  (the gain from extract's power sum, applied at BPSK's
            ingest, as ``demod_block``)

and at the end the whole ``demod_block`` and its Msps.  ``--k3iso`` splits
the extract stage's delta: ``glue`` (the port's tail packing alone,
``kernels/extract.py::ext_args``), ``twice`` (extract twice), ``stream3``
(extract replaced by the stream kernel: ``probes/k3_probe.py``'s
``stream`` at t_blk = 1024, the counterpart of ``_stream3_pallas``),
``preread`` (stream3, then extract), and ``barrier``: eager PyTorch has no
scheduler to defeat, so the row synchronises the stream before extract (a
host round trip, labelled so).  ``--unfused`` (:func:`chain_prefix`) runs
the port's ``ops/`` on the card stage by stage, as the JAX tool runs XLA
ops (the peak IIR is ``ops/iir.py``'s recurrence, one step at a time:
slow at the default shape), with the PLL and BPSK kernels.

    python -m fm_radio_tpu_torch.probes.chain_probe [C=256] [B=1048576]
        [n_blocks=8] [--unfused] [--packed] [--planes] [--k3iso]
        [--k3only] [--iters 3] [--device cpu]
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.kernels.bpsk import bpsk_sync
from fm_radio_tpu_torch.kernels.extract import ext_args, extract
from fm_radio_tpu_torch.kernels.frontend import frontend, frontend_i8
from fm_radio_tpu_torch.kernels.midend import midend
from fm_radio_tpu_torch.kernels.pll import pilot_pll_theta
from fm_radio_tpu_torch.models.demod import (
    demod_block,
    demod_init_state,
    ingest_form,
    make_coeffs,
)
from fm_radio_tpu_torch.ops.agc import _agc_gain, agc_process_p, mean_last
from fm_radio_tpu_torch.ops.cmath import atan2_poly, div_scalar, f32
from fm_radio_tpu_torch.ops.discriminator import fm_discriminate_p
from fm_radio_tpu_torch.ops.fir import (
    decimate_core,
    hilbert_fir_p,
    polyphase_decimate_p,
)
from fm_radio_tpu_torch.ops.iir import iir_filter_planes
from fm_radio_tpu_torch.ops.mixer import apply_harmonic_pll_p
from fm_radio_tpu_torch.probes import _probe, k3_probe

FUSED_STAGES = [
    "K1 ds4+disc kernel",
    "+ K2 ds2/deemph/hilbert/peak/theta",
    "+ PLL serial kernel",
    "+ K3 LPR/LMR/RDS extract",
    "+ RDS AGC + BPSK kernel",
]

UNFUSED_STAGES = [
    "nothing (loop overhead)",
    "ds x4 (fm_in)",
    "+ discriminator",
    "+ ds x2 (fm_out)",
    "+ hilbert 65",
    "+ peak IIR + AGC",
    "+ pilot PLL kernel",
    "+ LPR ds x4",
    "+ LMR mix + ds x4 + phase",
    "+ RDS mix + ds x8",
    "+ RDS AGC + BPSK kernel",
]

K3ISO = (("glue", "the tail packing alone, no kernel"),
         ("barrier", "extract after a stream synchronisation (eager "
                     "PyTorch has no scheduler barrier)"),
         ("twice", "extract x2 (delta = a second extract)"),
         ("stream3", "the stream kernel in place of extract (read only)"),
         ("preread", "stream3, then extract"))


def probe_sum(*arrays) -> torch.Tensor:
    """The TPU tool's completion probe: one element of each output, summed
    (a[..., 0, 0] as float32)."""
    return sum(a[..., 0, 0].float().reshape(()) for a in arrays)


def stream3(iq_p, dt):
    """k3_probe's stream kernel on (re, im, dt), as ``_stream3_pallas``
    reads them: (128, 1024) tiles (c_blk = C where C <= 128).  The same
    kernel and launch counter as k3_probe's stream (``k3_sum``)."""
    c = dt.shape[0]
    planes = tuple(p.contiguous() for p in (iq_p[0], iq_p[1], dt))
    return k3_probe.tile_sum("stream", planes, 1024,
                             c if c <= 128 else 128)[0]


def fused_prefix(cfg, coeffs, state: dict, x, upto: int, k3iso: str = ""):
    """The port's split kernels, stages 0 .. ``upto`` of
    :data:`FUSED_STAGES`, on one block: (state', probe).  ``k3iso`` (with
    upto = 3) isolates pieces of the extract stage (module docstring)."""
    st = dict(state)
    form = ingest_form(x)
    if form == "i8" and cfg.frontend_int8:
        st, fmd = frontend_i8(coeffs, cfg, st, x)
    else:
        int8_taps = cfg.frontend_int8 and (form in ("words", "i8")
                                           or cfg.assume_integer_input)
        st, fmd = frontend(coeffs, cfg, st, x, int8_taps)
    if upto == 0:
        return st, probe_sum(fmd)
    st, iq_p, theta = midend(coeffs, cfg, st, fmd)
    if upto == 1:
        return st, probe_sum(iq_p[0], iq_p[1], theta)
    st["pll"], dt = pilot_pll_theta(cfg, st["pll"], theta)
    if upto == 2:
        return st, probe_sum(dt, iq_p[0], iq_p[1])
    if upto == 3 and k3iso == "glue":
        a = ext_args("glue", coeffs, cfg, st, dt.shape[0], dt.device)
        tails = sum(a[k].sum() for k in ("t_lpr_re", "t_lpr_im", "t_lmr_re",
                                         "t_lmr_im", "t_rds_re", "t_rds_im"))
        return st, tails + probe_sum(dt, iq_p[0], iq_p[1])
    if upto == 3 and k3iso in ("stream3", "preread"):
        y = stream3(iq_p, dt)
        if k3iso == "stream3":
            return st, probe_sum(y, dt, iq_p[0], iq_p[1])
    if upto == 3 and k3iso == "barrier" and dt.device.type == "cuda":
        torch.cuda.current_stream(dt.device).synchronize()
    st, lpr, lmr, rds, rds_pow = extract(coeffs, cfg, st, iq_p, dt)
    if upto == 3 and k3iso == "twice":
        _, lpr2, lmr2, rds2, _ = extract(coeffs, cfg, st, iq_p, dt)
        return st, probe_sum(lpr, lmr[1], rds[0], rds[1], lpr2, lmr2[1],
                             rds2[0], rds2[1])
    if upto == 3:
        return st, probe_sum(lpr, lmr[1], rds[0], rds[1])
    st["agc_rds"] = _agc_gain(st["agc_rds"],
                              div_scalar(rds_pow, rds[0].shape[-1]),
                              cfg.bpsk.agc_target_power, 0.2)
    st["bpsk"], outs = bpsk_sync(cfg, st["bpsk"], rds, st["agc_rds"])
    return st, probe_sum(lpr, lmr[1], outs["pred"],
                         outs["valid"].to(torch.float32))


def chain_prefix(cfg, coeffs, state: dict, xp, upto: int):
    """The port's ``ops/`` stage by stage (1 .. ``upto`` of
    :data:`UNFUSED_STAGES`) on float32 planes xp = (re, im), with the PLL
    and BPSK kernels: (state', probe).  Full sums as probes, as the JAX
    tool (its XLA ops were partly dead-code eliminated otherwise)."""
    r = cfg.rates
    st = dict(state)
    probe = xp[0][0, -1] + xp[1][0, -1]
    if upto < 1:
        return st, probe
    st["ds_fm_in"], fm_in_p = polyphase_decimate_p(
        coeffs.taps_fm_in, st["ds_fm_in"], xp, r.ds_fm_in)
    probe = torch.sum(fm_in_p[0]) + torch.sum(fm_in_p[1])
    if upto < 2:
        return st, probe
    st["disc_prev_theta"], fm_demod = fm_discriminate_p(
        st["disc_prev_theta"], fm_in_p, cfg.analog.f_wbfm_deviation,
        float(r.fs_fm_in))
    probe = torch.sum(fm_demod)
    if upto < 3:
        return st, probe
    st["ds_fm_out"], fm_out = decimate_core(coeffs.taps_fm_out,
                                            st["ds_fm_out"], fm_demod,
                                            r.ds_fm_out)
    probe = torch.sum(fm_out)
    if upto < 4:
        return st, probe
    st["hilbert"], iq_p = hilbert_fir_p(coeffs.taps_hilbert, st["hilbert"],
                                        fm_out)
    probe = torch.sum(iq_p[0]) + torch.sum(iq_p[1])
    if upto < 5:
        return st, probe
    st["peak_pilot"], pilot_p = iir_filter_planes(
        coeffs.peak_b, coeffs.peak_a, st["peak_pilot"], iq_p)
    st["agc_pilot"], pilot_p = agc_process_p(st["agc_pilot"], pilot_p,
                                             target_power=1.0)
    probe = torch.sum(pilot_p[0]) + torch.sum(pilot_p[1])
    if upto < 6:
        return st, probe
    theta = atan2_poly(pilot_p[1], pilot_p[0]) * f32(1.0 / (2.0 * math.pi))
    st["pll"], dt = pilot_pll_theta(cfg, st["pll"], theta)
    probe = torch.sum(dt)
    if upto < 7:
        return st, probe
    st["ds_audio_lpr"], audio_lpr = polyphase_decimate_p(
        coeffs.taps_audio_lpr, st["ds_audio_lpr"], iq_p, r.ds_audio,
        imag_out=False)
    probe = probe + torch.sum(audio_lpr)
    if upto < 8:
        return st, probe
    h_lmr = cfg.analog.f_audio_lmr_center / cfg.analog.f_pilot
    mixed = apply_harmonic_pll_p(dt, iq_p, h_lmr, st["lmr_phase_err"])
    st["ds_audio_lmr"], lmr = polyphase_decimate_p(
        coeffs.taps_audio_lmr, st["ds_audio_lmr"], mixed, r.ds_audio)
    stride = cfg.audio_lmr_phase_read_stride
    phase = torch.atan2(lmr[1][:, ::stride], lmr[0][:, ::stride])
    half_pi = f32(math.pi / 2.0)
    est = torch.where(phase > 0.0, half_pi - phase, -half_pi - phase)
    new_off = st["lmr_phase_err"] + f32(cfg.audio_lmr_phase_beta) * \
        mean_last(est)
    st["lmr_phase_err"] = torch.fmod(new_off, f32(2.0 * math.pi))
    probe = probe + torch.sum(lmr[1])
    if upto < 9:
        return st, probe
    h_rds = cfg.analog.f_rds_center / cfg.analog.f_pilot
    mixed = apply_harmonic_pll_p(dt, iq_p, h_rds, 0.0)
    st["ds_rds"], rds = polyphase_decimate_p(coeffs.taps_rds, st["ds_rds"],
                                             mixed, r.ds_rds)
    probe = probe + torch.sum(rds[0]) + torch.sum(rds[1])
    if upto < 10:
        return st, probe
    st["agc_rds"], rds_agc = agc_process_p(
        st["agc_rds"], rds, target_power=cfg.bpsk.agc_target_power)
    st["bpsk"], outs = bpsk_sync(cfg, st["bpsk"], rds_agc, None)
    return st, probe + torch.sum(outs["pred"])


def make_input(channels: int, block: int, kind: str, device, seed: int = 0):
    """The TPU tool's signal (a random phase walk, numpy seed): int8 planes
    [2, C, B] (u8 - 128), packed words [C, B], or float32 planes [2, C,
    B]."""
    rng = np.random.default_rng(seed)
    phase = np.cumsum(rng.standard_normal((channels, block))
                      .astype(np.float32) * 0.5, axis=-1)
    if kind == "planes":
        x = np.stack([100.0 * np.cos(phase), 100.0 * np.sin(phase)]
                     ).astype(np.float32)
    else:
        u8 = np.stack([np.round(100.0 * np.cos(phase) + 127.0),
                       np.round(100.0 * np.sin(phase) + 127.0)]
                      ).astype(np.uint8)
        if kind == "packed":
            x = (u8[0].astype(np.float32) * 256.0 + u8[1]).astype(np.float32)
        else:
            x = (u8.astype(np.int16) - 128).astype(np.int8)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def config(kind: str, unfused: bool = False) -> DemodConfig:
    """The TPU tool's config: int8 planes with the int8-direct K1, packed
    words with float taps, or float32 planes."""
    planes = kind == "planes" or unfused
    return DemodConfig(assume_integer_input=not planes,
                       frontend_int8=kind == "i8" and not unfused)


def _timed(step, state, n_blocks: int, repeats: int, device) -> float:
    """ms per block: ``n_blocks`` steps with state carried, timed with CUDA
    events (the host clock around a synchronise on the CPU), best of
    ``repeats`` after one run."""
    def run():
        st, acc = state, None
        for _ in range(n_blocks):
            st, p = step(st)
            acc = p if acc is None else acc + p
        return acc

    float(run())
    best = math.inf
    for _ in range(repeats):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = run()
            end.record()
            float(out)
            best = min(best, start.elapsed_time(end))
        else:
            import time

            t0 = time.perf_counter()
            float(run())
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best / n_blocks


def run(channels: int, block: int, n_blocks: int, kind: str, unfused: bool,
        k3iso: bool, k3only: bool, repeats: int, device,
        emit=_probe.emit) -> list[dict]:
    """Every prefix (and the k3iso rows, and the whole demod_block) timed;
    rows with ms per block and the delta to the previous prefix.  On the
    CPU the times are the host's (``device``: "cpu")."""
    cfg = config(kind, unfused)
    co = make_coeffs(cfg, device)
    st0 = demod_init_state(cfg, channels, device)
    x = make_input(channels, block, "planes" if unfused else kind, device)
    xp = (x[0].contiguous(), x[1].contiguous()) if unfused else None
    rows = []

    def row(name, ms, **extra):
        r = {"variant": name, "ms_per_block": ms,
             "device": device.type, **extra}
        rows.append(r)
        emit(r)

    stages = UNFUSED_STAGES if unfused else FUSED_STAGES

    def prefix_ms(upto, iso=""):
        if unfused:
            step = lambda st: chain_prefix(cfg, co, st, xp, upto)
        else:
            step = lambda st: fused_prefix(cfg, co, st, x, upto, iso)
        return _timed(step, st0, n_blocks, repeats, device)

    prev, t = 0.0, {}
    for upto, name in enumerate(stages):
        if k3only and upto not in (2, 3):
            continue
        ms = prefix_ms(upto)
        t[upto] = ms
        row(name, ms, delta_ms=ms - prev)
        prev = ms
    if k3iso and not unfused:
        for iso, expl in K3ISO:
            ms = prefix_ms(3, iso)
            base = t.get(3 if iso == "twice" else 2)
            row(f"k3iso:{iso}", ms,
                delta_ms=None if base is None else ms - base, what=expl)
    if k3only:
        return rows
    step = lambda st: _full(cfg, co, st, x)
    ms = _timed(step, st0, n_blocks, repeats, device)
    row("full demod_block (+mix, probes)", ms,
        msps=channels * block / ms / 1e3)
    return rows


def _full(cfg, co, st, x):
    st, outs = demod_block(cfg, co, st, x)
    return st, torch.sum(outs["audio"]) + torch.sum(outs["rds_pred"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("channels", type=int, nargs="?", default=None)
    ap.add_argument("block", type=int, nargs="?", default=None)
    ap.add_argument("n_blocks", type=int, nargs="?", default=None)
    for flag in ("--unfused", "--packed", "--planes", "--k3iso",
                 "--k3only"):
        ap.add_argument(flag, action="store_true")
    ap.add_argument("--iters", type=int, default=3,
                    help="timed runs of n_blocks blocks (best of)")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = _probe.device_of(args.device)
    cpu = dev.type == "cpu"
    c = args.channels or (8 if cpu else 256)
    b = args.block or (16384 if cpu else 1 << 20)
    n = args.n_blocks or (2 if cpu else 8)
    kind = "packed" if args.packed else "planes" if args.planes else "i8"
    _probe.header("chain_probe", dev, channels=c, block=b, n_blocks=n,
                  mode="unfused" if args.unfused else "fused",
                  ingest="planes" if args.unfused else kind)
    run(c, b, n, kind, args.unfused, args.k3iso, args.k3only, args.iters,
        dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
