"""Time the cells and the redesigned kernels of one checkout of the port,
so that two checkouts (a commit and its parent) can be compared in turns
on one card within one call.

    python fm_radio_tpu_torch/probes/ab_time.py [--root DIR] [--label L]
        [--reps N] [--k2-only]

Run as a script: it imports ``fm_radio_tpu_torch`` and ``chip_smoke``
from DIR (the checkout that holds this file by default), builds that
checkout's kernels and prints one JSON row per case:

- every cell end to end in ms a block (CUDA events over 8 blocks, 4 for
  the chunked PLL, after one; bench.py's signal made by
  ``chip_smoke.split_input``): pre-split (C = 2,048, B = 131,072 int8
  planes, ``frontend_int8=True``), f32w, complex, k12off, i16
  (``interstage_i16=True``), chain, the chunked PLL (C = 256, B =
  1,048,576, ``pll_time_chunks=8``) and the wideband cell at splits 1, 2
  and 3 (``chip_smoke.wideband_path`` on bench.py's captures);
- K2 in int16 (``kernels/midend.py::midend`` on the arguments
  ``demod_block`` recorded at the i16 cell) and the chunked PLL
  (``kernels/pll.py::pilot_pll_chunked`` on those of the chunked cell);
- the exact channelizer (splits=3, the library default) at the wideband
  cell (below) and at the M = 16 lens (W = 128, K = 16, T = 2^21, out
  "i8"); the megakernel (``kernels/chain.py::chain``) at the chain cell
  (C = 2,048, B = 131,072, ``probes/chain_phases.py::bench_words``,
  ``DemodConfig(assume_integer_input=True, chain_fusion="auto")``);
- the channelizer at splits=1 (``channelize(..., splits=1)``) at bench.py's
  wideband cell (W = 64 captures, M = 32, K = 16, T = 2^22, out "i8ps",
  words as ``chip_smoke.wideband_words`` makes them), at splits=2 there too,
  and at splits=1 at its edge shapes (T = 16,384 on W = 1 and 3) and at
  the receiver's smallest block at M = 32 (W = 1, T = 262,144: B = 8,192
  a channel), random words, each output form, there also the device time
  of its kernels (``torch.profiler``: a call's wall time is mostly the
  host's);
- end to end at splits=1, in ms a block (CUDA events over 8 blocks after
  one): ``chip_smoke.wideband_path``'s W = 1 cell (one loud capture, M =
  32, B = 8,192 a channel: 16 tiles of 128 columns), and the stereo+RDS
  station of ``chip_smoke.station_splits_words`` (one capture, M = 32,
  blocks of 32,768 a channel: 64 tiles) through ``wideband_demod_block``;
- BPSK (``bpsk_sync``) on the arguments ``demod_block`` recorded at the
  pre-split cell (C = 2,048, B = 131,072, ``chip_smoke.bench_planes``, the
  second block) and ``wideband_demod_block`` at the wideband cell
  (splits=1, bench.py's captures), and on zeros of that shape with the
  pre-split cell's gain;
- K1 with int8 taps (``kernels/frontend.py::frontend``) on packed words,
  float32 planes and complex64 at C = 2,048 x B = 131,072, float32 and
  int16 stores (the ``LoadI8`` forms of ``ds4_i8_blocked_kernel``);
- the K1 engine probe (``probes/frontend_probe.py``) at its default shape
  (C = 1,024 x B = 262,144): ``split``'s rows on words and planes,
  ``dbuf``'s (``full:double-buf:tile=8x2048`` among them) and the
  engines' ``full:no=128:f32`` (each the probe's best of 3 over chained
  calls);
- the streaming probe kernels, into outputs made once: the staged copy
  (``probes/hbm_sweep.py::dma_copy``) on every variant ``dma{1,2}:{16,
  32,64,128}KiB`` that fits, on a 256 MiB float32 array; the K1 probe's
  tile sums (stream and unpack) on each ingest form at its default shape
  and tiles; k3's stream1, stream, phasor and stream31 at C = 1,024 x
  B8 = 32,768, t = 1,024;
- the K2 probe's block recurrences (``probes/k2_probe.py::variant``):
  restruct:li and restruct:li:stk for li = 64, 128, 256, 512 at C = 1,024
  x B4 = 65,536, and restruct:128 at the chunked cell's width, C = 256 x
  B4 = 262,144: the variant (CUDA events) and the device time of each of
  its four launches (``torch.profiler``: ``fir_decimate_kernel``,
  ``k2_deemph_block_kernel``, ``k12_hilbert_kernel``,
  ``k2_peak_block_kernel``).  ``--k2-only`` runs just these rows.

Each time is the mean of ``--reps`` calls after one (CUDA events), beside
the card's name and power limit.  Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


# the cells: (label, input kind of chip_smoke.split_input, DemodConfig
# kwargs, channels, block, counted blocks)
CELLS = (
    ("presplit", "i8", {"frontend_int8": True}, 2048, 131072, 8),
    ("f32w", "words", {"assume_integer_input": True}, 2048, 131072, 8),
    ("complex", "complex", {}, 2048, 131072, 8),
    ("k12off", "i8", {"frontend_int8": True, "k12_fusion": "off"}, 2048,
     131072, 8),
    ("i16", "i8", {"assume_integer_input": True, "frontend_int8": True,
                   "interstage_i16": True}, 2048, 131072, 8),
    ("chain", "words", {"assume_integer_input": True,
                        "chain_fusion": "auto"}, 2048, 131072, 8),
    ("pll_chunked", "i8", {"frontend_int8": True, "pll_time_chunks": 8},
     256, 1048576, 4),
)


def _ms(fn, reps: int) -> float:
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps: int, key: str) -> float:
    """Device time per call of the CUDA kernels whose names contain
    ``key`` (``torch.profiler``, ``reps`` calls after one): the kernel
    alone, without the host's share of a call."""
    return _device_ms_by(fn, reps, (key,))[key]


def _device_ms_by(fn, reps: int, keys) -> dict:
    """:func:`_device_ms` for several keys from one profiled window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda").add_(1.0)  # the window's first kernel
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = dict.fromkeys(keys, 0.0)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for key in keys:
            if key in e.key:
                t = getattr(e, "self_device_time_total", None)
                us[key] += float(e.self_cuda_time_total if t is None else t)
    return {k: v / 1e3 / reps for k, v in us.items()}


# restruct's launches, in order (csrc/k2_probe.cu::fmt_k2_restruct)
K2_LAUNCHES = ("fir_decimate_kernel", "k2_deemph_block_kernel",
               "k12_hilbert_kernel", "k2_peak_block_kernel")


def k2_rows(row, reps: int, dev) -> None:
    """The K2 probe's restruct variants (module docstring): one row each,
    the variant's ms and its launches' device ms."""
    from fm_radio_tpu_torch.probes import k2_probe as k2

    every = [f"restruct:{li}{s}" for li in (64, 128, 256, 512)
             for s in ("", ":stk")]
    for c, b4, modes in ((1024, 65536, every), (256, 262144,
                                                ["restruct:128"])):
        x = k2.make_input(c, b4, dev)
        co = k2.coeffs(dev)
        for mode in modes:
            mats = k2.block_mats(int(mode.split(":")[1]), dev, co)

            def call():
                return k2.variant(mode, x, 1024, co, mats)

            row("k2_restruct", f"probe {mode} C={c} B4={b4}",
                _ms(call, reps), launches_ms=_device_ms_by(call, reps,
                                                           K2_LAUNCHES))
        del x


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--label", default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--k2-only", action="store_true",
                    help="only the K2 probe's restruct rows")
    a = ap.parse_args(argv)
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ab_time: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.kernels import _build
    from fm_radio_tpu_torch.kernels import bpsk as kb
    from fm_radio_tpu_torch.kernels import chain as kc
    from fm_radio_tpu_torch.kernels import channelizer as kch
    from fm_radio_tpu_torch.models.demod import (
        INT8_CONFIG, demod_block, demod_init_state, make_coeffs)
    from fm_radio_tpu_torch.models.wideband import (
        wideband_demod_block, wideband_init_state)
    from fm_radio_tpu_torch.parallel.channelizer import make_channelizer_taps
    from fm_radio_tpu_torch.probes.chain_phases import bench_words

    _build.build()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    label = a.label or root
    rows = []

    def row(kernel, case, ms, **kw):
        r = {"label": label, "kernel": kernel, "case": case, "ms": ms,
             "card": smi, **kw}
        rows.append(r)
        print(json.dumps(r), flush=True)

    if a.k2_only:
        k2_rows(row, a.reps, dev)
        return 0

    # the cells end to end, and the two kernels on their cells' arguments
    from fm_radio_tpu_torch.kernels import midend as km
    from fm_radio_tpu_torch.kernels import pll as kp

    recorded = {}
    for cell, kind, kw, c, b, blocks in CELLS:
        cfg = DemodConfig(**kw)
        co = make_coeffs(cfg, dev)
        st = demod_init_state(cfg, c, dev)
        x = chip_smoke.split_input(kind, c, b, 0, dev)
        st, _ = demod_block(cfg, co, st, x)  # warm-up
        calls = {}
        chip_smoke.reset_counts()

        def run():
            nonlocal st
            for _ in range(blocks):
                st, _ = demod_block(cfg, co, st, x, record=calls)

        row("demod_block", f"cell {cell} C={c} B={b}", _ms(run, 1) / blocks,
            launches={k: v for k, v in chip_smoke.read_counts().items()
                      if v})
        recorded[cell] = calls
        del x, st
    for sp in (1, 2, 3):
        wb = chip_smoke.wideband_path(64, 32, 131072, 8, splits=sp,
                                      time_kernels=False, device=dev)
        row("wideband_demod_block", f"cell wideband splits={sp}",
            wb["ms_per_block"], launches={
                k: v for k, v in wb["launches"].items() if v})
    mid = recorded["i16"]["midend"]
    row("midend_i16", "i16 cell", _ms(lambda: km.midend(*mid), a.reps))
    pc = recorded["pll_chunked"]["pll_chunked"]
    row("pll_chunked", "chunked cell",
        _ms(lambda: kp.pilot_pll_chunked(*pc), a.reps))
    del recorded, mid, pc

    # the megakernel at the chain cell
    ccfg = DemodConfig(assume_integer_input=True, chain_fusion="auto")
    cco, cst = make_coeffs(ccfg, dev), demod_init_state(ccfg, 2048, dev)
    cx = bench_words(2048, 131072, dev)
    row("chain", "cell C=2048 B=131072 words",
        _ms(lambda: kc.chain(cco, ccfg, cst, cx), a.reps))
    del cx, cst

    # the exact channelizer at the M = 16 lens; the channelizer at the
    # cell (exact, then splits=1), then splits=1's edge shapes
    m, k = 16, 16
    tab = kch.make_tables(make_channelizer_taps(m, k), m, dev)
    words = chip_smoke.wideband_words(128, m, 131072, seed=0, device=dev,
                                      amp=chip_smoke.BENCH_AMP)
    st = (torch.zeros((128, (k - 1) * m), device=dev),) * 2
    row("channelizer", "M=16 W=128 T=2097152 i8",
        _ms(lambda: kch.channelize(tab, st, words, m, "i8", 3), a.reps))
    m = 32
    tab = kch.make_tables(make_channelizer_taps(m, k), m, dev)
    words = chip_smoke.wideband_words(64, m, 131072, seed=0, device=dev,
                                      amp=chip_smoke.BENCH_AMP)
    st = (torch.zeros((64, (k - 1) * m), device=dev),) * 2
    row("channelizer", "cell W=64 T=4194304 i8ps",
        _ms(lambda: kch.channelize(tab, st, words, m, "i8ps", 3), a.reps))
    row("channelizer_i8mat", "cell W=64 T=4194304 i8ps",
        _ms(lambda: kch.channelize(tab, st, words, m, "i8ps", 1), a.reps))
    row("channelizer_bf16mat", "cell W=64 T=4194304 i8ps",
        _ms(lambda: kch.channelize(tab, st, words, m, "i8ps", 2), a.reps))
    del words
    rng = np.random.default_rng(11)
    for n_w, t in ((1, 16384), (3, 16384), (1, 262144)):
        w = torch.from_numpy(
            rng.integers(0, 256, (n_w, t)).astype(np.float32) * 256.0
            + rng.integers(0, 256, (n_w, t)).astype(np.float32)).to(dev)
        s0 = (torch.zeros((n_w, (k - 1) * m), device=dev),) * 2
        for out in ("i8ps", "f32", "i8"):
            def call():
                return kch.channelize(tab, s0, w, m, out, 1)
            row("channelizer_i8mat", f"edge W={n_w} T={t} {out}",
                _ms(call, 5 * a.reps),
                device_ms=_device_ms(call, 5 * a.reps, "chan_"))

    # end to end at splits=1: the W = 1 cell and the station
    cfg = INT8_CONFIG
    co = make_coeffs(cfg, dev)
    cell = chip_smoke.wideband_path(1, m, 8192, 8,
                                    amp=chip_smoke.loud_amp(m), splits=1,
                                    time_kernels=False, device=dev)
    row("wideband_demod_block", "W=1 splits=1 B=8192 loud",
        cell["ms_per_block"], launches=cell["launches"])
    sw = torch.from_numpy(chip_smoke.station_splits_words(m)).to(dev)
    t_blk = 32768 * m
    blocks = [sw[:, i * t_blk : (i + 1) * t_blk].contiguous()
              for i in range(9)]
    stab = kch.make_tables(make_channelizer_taps(m), m, dev)
    ss = wideband_init_state(cfg, m, 1, device=dev)
    ss, _ = wideband_demod_block(cfg, co, stab, ss, blocks[0], m, splits=1)
    chip_smoke.reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for xb in blocks[1:]:
        ss, _ = wideband_demod_block(cfg, co, stab, ss, xb, m, splits=1)
    end.record()
    torch.cuda.synchronize()
    row("wideband_demod_block", "station W=1 splits=1 B=32768",
        start.elapsed_time(end) / 8, launches=chip_smoke.read_counts())
    del sw, blocks

    # BPSK on the cells' recorded arguments and on zeros
    x = chip_smoke.bench_planes(2048, 131072, seed=0, device=dev)
    sd = demod_init_state(cfg, 2048, dev)
    sd, _ = demod_block(cfg, co, sd, x)
    calls = {}
    demod_block(cfg, co, sd, x, record=calls)
    pre = calls["bpsk"]
    del x
    wtab = kch.make_tables(make_channelizer_taps(m, 16), m, dev)
    sw = wideband_init_state(cfg, m, 64, 16, dev)
    xw = chip_smoke.wideband_words(64, m, 131072, seed=0, device=dev,
                                   amp=chip_smoke.BENCH_AMP)
    xw = xw.reshape(64, -1, 128)
    sw, _ = wideband_demod_block(cfg, co, wtab, sw, xw, m, splits=1)
    calls = {}
    wideband_demod_block(cfg, co, wtab, sw, xw, m, splits=1, record=calls)
    wide = calls["bpsk"]
    del xw
    xr, xi = pre[2]
    zeros = (pre[0], pre[1], (torch.zeros_like(xr), torch.zeros_like(xi)),
             pre[3])
    for case, args in (("presplit", pre), ("wideband splits=1", wide),
                       ("zeros", zeros)):
        planes = torch.stack(list(args[2]))
        row("bpsk", case, _ms(lambda: kb.bpsk_sync(*args), a.reps),
            zero_share=float((planes == 0).double().mean()),
            gain_range=[float(args[3].min()), float(args[3].max())])
    del pre, wide, zeros

    # K1 with int8 taps on its float forms, both stores
    from fm_radio_tpu_torch.kernels import frontend as kf

    k1cfg = DemodConfig()
    k1co = make_coeffs(k1cfg, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    k1st = chip_smoke._ds4_state(k1cfg, k1co, 2048, g, dev)
    k1x = {kind: chip_smoke.split_input(kind, 2048, 131072, 0, dev)
           for kind in ("words", "planes_int", "complex")}
    for form, x in k1x.items():
        for i16 in (False, True):
            row("frontend_int8_taps", f"{form} {'int16' if i16 else 'f32'}"
                " C=2048 B=131072",
                _ms(lambda: kf.frontend(k1co, k1cfg, k1st, x, True, i16),
                    a.reps))
    del k1x

    # the K1 engine probe's staged FIR and its split
    from fm_radio_tpu_torch.probes import frontend_probe as fp

    for r in fp.run(1024, 262144, {"split", "dbuf", "engines"}, a.reps, dev,
                    check=False, emit=lambda r: None):
        if r["variant"].startswith(("split:", "full:", "dots:")):
            row(r["kernel"], f"probe {r['variant']}", r["ms"])

    # the streaming probe kernels, each writing into outputs made once: the
    # staged copy's variants on the sweep's 256 MiB array, the K1 probe's
    # stream and unpack on every form (C = 1,024 x B = 262,144, 128 x 2,048
    # tiles), k3's stream-style modes (C = 1,024 x B8 = 32,768, t = 1,024)
    from fm_radio_tpu_torch.probes import hbm_sweep as hs
    from fm_radio_tpu_torch.probes import k3_probe as k3

    x = torch.randn((65536, hs.LANES), device=dev)
    y = torch.empty_like(x)
    for kib in hs.DMA_CHUNKS_KIB:
        for nbuf in (1, 2):
            if nbuf * kib * 1024 > hs.SMEM_BYTES:
                continue
            row("hbm_dma_copy", f"dma{nbuf}:{kib}KiB 256 MiB",
                _ms(lambda: hs.dma_copy(x, kib * 1024, nbuf, out=y), a.reps))
    del x, y
    c, b = 1024, 262144
    inp = fp.make_inputs(c, b, dev)
    outs = (torch.empty((c, 128), device=dev),
            torch.empty((c, b // 2048), device=dev))
    for form in fp.FORMS:
        for mode in ("stream", "unpack"):
            row("fp_sum", f"probe {mode}:{form}:tile=128x2048",
                _ms(lambda: fp.tile_sum(inp[form], form, mode == "unpack",
                                        128, 2048, out=outs), a.reps))
    del inp
    xs = k3.make_inputs(1024, 32768, dev)
    x3 = k3.stack31(xs, k3.C_BLK)
    for mode in ("stream1", "stream", "phasor", "stream31"):
        planes = (x3,) if mode == "stream31" else xs
        n_rows = 3 * 1024 if mode == "stream31" else 1024
        outs = (torch.empty((1024, 128), device=dev),
                torch.empty((n_rows, 32), device=dev))
        row("k3_stream31" if mode == "stream31" else "k3_sum",
            f"probe {mode}:t=1024",
            _ms(lambda: k3.tile_sum(mode, planes, 1024, k3.C_BLK, out=outs),
                a.reps))
    del xs, x3
    k2_rows(row, a.reps, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
