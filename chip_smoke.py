#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA device.  Phases:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: nvcc builds the kernel libraries of fm_radio_tpu_torch/csrc/,
   the default build and the bounds-checked one (``-DFMT_CHECKED``), one
   nvcc per source and build, all started together;
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
2c. the engine probes (tools/frontend_probe.py, k2_probe.py, k3_probe.py
   and chain_probe.py as fm_radio_tpu_torch/probes/): every variant of
   each probe kernel against its plain version at small shapes where
   every section's tiles apply (K1: C=1024 x B=16,384; max abs error 0:
   the same float32 operations in the same order); then each probe's
   sections at its default shape (K1: C=1024 x B=262,144; K2: 1024 x
   65,536; K3: 1024 x 32,768; the chain: 256 x 1,048,576, 8 blocks, with
   --k3iso, and --unfused at 256 x 16,384) with few iterations, every
   variant again against its plain version, and the launch counters set
   to 0 just before and read just after; each kernel's representative
   variant beside its plain version and, for the per-tile sums, one
   PyTorch call (``x.view(C, n_tt, t_blk).sum(-1)``);
2d. four probe kernels in turns with the one PyTorch call of the same
   function (probes/vs_library.py, 25 rounds of 10 calls: the staged copy
   against ``Tensor.copy_``, the K1 probe's and k3's tile sums against
   ``sum(-1)``, the read against ``x.view(-1, 8, 128).sum((0, 1))``), each
   with the paired sign test's verdict, put on the kernels line
   (``library_ms``, ``rounds_kernel_slower``, ``loses``, ``wins``);
3a. K12 (and the PLL, extract, BPSK) against their plain versions at
   C=8 x B=16,384, the int8-matrix channelizer at W=2 x T=32,768
   (:func:`compare_i8mat_small`) and the ds x4 kernels at C=8 x B=16,384
   (:func:`compare_ds4_edges`), five times on fresh seeds, the
   allocator's free memory filled with 0xFF bytes before each
   (compute-sanitizer refused the card it was tried on: PERF.md), then
   the five again on the bounds-checked build
   (``_build.checked_build()``: every index of K12's, the PLL's,
   extract's, BPSK's and the matrix channelizer's device code checked, a
   trap fails the run naming the kernel), and five more there at C=40
   (not a multiple of 32); the channelizer's int8- and bf16-matrix modes
   (splits 1 and 2, one wgmma kernel) against their plain versions on the
   arguments ``wideband_demod_block`` recorded from W=4 loud captures, two
   blocks with carried state: M=32 words -> i8ps and -> f32, M=16 words ->
   i8; both modes at their edge shapes (T = 16,384 on W = 1 and 3, all
   three forms; :func:`compare_wgmma_edges`) and the count of the wgmma
   kernel's float and integer wgmma, mma.sync and bulk-copy instructions
   (``cuobjdump -sass``); K12 flat, phase-split and K2 (in its four
   formats: float32 or int16 fm_demod, float32 or int16 outputs, each a
   counted launch of the fused route) on their fused mid end at C=40, B =
   512, 8,192 and 8,320, max abs error 0, on the default and the
   bounds-checked build, and the mid end's route on the card against its
   host copy (:func:`compare_mid_edges`); the sequential PLL at C = 40
   and 5, N = 16, 32, 48 and 16,384 on both forms, the chunked PLL at C =
   5 and 40, G = 2, 4, 8, W = 0, 7, 4,096 and chunk lengths a multiple of
   its 16-step batch and not (:func:`compare_pll_chunked_edges`), extract
   at C = 40, N = 1,024 and
   2,048 on its three forms, on its blocked and tiled routes, and BPSK at
   C = 40 and 5, N = 16, 32, 48 and 2,048, with a gain and without, on
   random input and zeros, max abs error 0, on the default and the
   bounds-checked build (there the sequential PLL and BPSK at N <= 48),
   and extract's route on the card against its host copy
   (:func:`compare_pll_edges`, :func:`compare_extract_edges`,
   :func:`compare_bpsk_edges`); the PLLs' (sequential and chunked) and
   BPSK's SASS saved for their dependent chains (:func:`pll_sass`,
   :func:`bpsk_sass`); the
   redesigned ds x4 kernels at their edge shapes on both builds, max abs
   error 0 (:func:`compare_ds4_edges`: C = 1, 5, 40, B = 8,192, 8,320,
   16,384; K12 flat and phase-split, K1 on every load form with both
   taps and stores), and
   their SASS (:func:`ds4_sass`: saved as chiprun_out/ds4_sass_*.txt; no
   FFMA in the float K1 beyond atan2's division, no spills); the K1
   probe's staged FIR kernels on both builds, max abs error 0
   (:func:`compare_fp_edges`: C = 16 x B = 16,384, fp_fir on every form,
   both taps, dots and full, rows and tile-major, both rasters at tiles
   1 x 512 ... 2 x 8,192; fp_dbuf with one and two buffers, a tile over
   the shared memory refused; the dbuf layout's C side against its host
   copy); the streaming probe kernels on both builds, max abs error 0,
   outputs poisoned first (:func:`compare_stream_edges`: the staged copy
   on every variant at fewer chunks than issuers and with the last round
   partial, its C plan against the host copy; the tile sums on every
   form, stream and unpack, rows and tile-major, both rasters, and k3's
   four modes, at tile lengths compiled and not, on grids larger and
   smaller than the work); the K2 probe's block recurrences on both
   builds, max abs error 0 on re, im, theta and power, outputs filled with
   NaN first (:func:`compare_k2_edges`: restruct:li[:stk] at every li, one
   block, a ragged last chunk, C = 1 and 3; the layout's C side against
   its host copy); the exact
   channelizer at every M it is instantiated for and its edge shapes on
   both builds (:func:`compare_chan_edges`: K = 1 and 17, T = 4,096,
   12,288 and 1,572,864 (more tiles than CTAs), every out form, words and
   planes, max abs error 0); the
   megakernel against its plain version and the f32w split path at C = 8
   and 40 inside the repeats above (:func:`compare_chain_small`), at other
   filter orders (its per-output stages) on both builds, and at the chain
   cell's full width on the bounds-checked build
   (:func:`chain_cell_checked`), max abs error 0;
3b. the split path (``DemodConfig()``'s K1 -> K2) against the plain
   versions on the card, at C=256 x B=131,072, two blocks with carried
   state, on the arguments ``demod_block`` recorded: K1 on each of its
   eight forms (float32 planes off the u8 grid; integer planes with int8
   taps; packed words with float and with int8 taps; int8 planes with float
   taps; the int8-direct entry; complex64 with float and with int8 taps),
   K2 with de-emphasis off and on; each
   input's statistics, failing on a constant one; ``demod_block(
   k12_fusion="off")`` against the fused K12 on the same int8 planes,
   outputs and state bit for bit; and the wideband float32 bridge
   (channelizer -> f32 planes -> K1 -> K2) at W=4 loud captures, M=32;
3c. the full-chain megakernel against its plain version on the card, on
   the arguments ``demod_block(chain_fusion="auto")`` recorded, at C=256 x
   B=131,072, two blocks with carried state, on packed words, float32
   planes (de-emphasis off and on) and complex64, with BPSK without a gain
   after it; the chunked PLL (``pll_time_chunks=8``, after K12) at C=256 x
   B=1,048,576 and at C=5, two blocks; each input's statistics, failing on
   a constant one;
4. the pre-split main path at the bench cell (C=2048, B=131,072, int8
   planes made as bench.py makes them): one warm-up block, then 8 blocks
   through ``demod_block`` with the launch counters set to 0 just before
   and read just after; then each kernel and its plain version timed alone
   on the arguments ``demod_block`` gave it in the last block, and
   compared there with the tolerances of phase 3; BPSK also timed on
   zeros of its input's shape, beside its input's statistics
   (:func:`bpsk_alone`); the ds x4 stage's issue floors at the recorded
   shape (:func:`ds4_floors`; its time is the profile's); the
   cell profiled (its profile must show the blocked ds x4, the fused mid
   end's three kernels, the PLL's, the blocked extract's and BPSK's; so
   must bench.py's wideband lens at splits=1, with the phase-split ds x4's
   and the matrix channelizer's);
4b. the three split cells at C=2048 x B=131,072 (bench.py's signal):
   f32w (packed words, ``DemodConfig(assume_integer_input=True)``),
   complex (complex64, ``DemodConfig()``) and k12off (int8 planes,
   ``DemodConfig(frontend_int8=True, k12_fusion="off")``): one warm-up
   block, 8 counted blocks, then K1 and K2 timed alone beside their plain
   versions on the last block's arguments, and K1's issue floors at the
   recorded shape; the complex cell's K1 given the block itself (its
   complex64 storage, which the kernel reads in place); each profiled: K1
   one launch (f32w and complex ``k1_tile_kernel``, k12off the blocked
   ds x4) and no ``k12_disc_kernel`` (the complex cell's
   ``CatArrayBatchedCopy`` time beside f32w's is logged);
4c. the chain cell (C=2048 x B=131,072 packed words,
   ``DemodConfig(assume_integer_input=True, chain_fusion="auto")``: one
   warm-up block, 8 counted blocks, one ``chain`` and one ``bpsk`` launch
   each), the megakernel timed alone beside its plain version, the same
   words through the f32w split cell (audio and the state before the RDS
   AGC bit for bit), profiled; and the chunked-PLL cell (C=256 x
   B=1,048,576 int8 planes, ``pll_time_chunks=8``, beside G=1; 4 counted
   blocks each), the chunked and the sequential PLL alone on the same
   theta, their serial steps and the chunked dt's deviation, the G=8 cell
   profiled (its profile must show the chunked kernel);
4d. the i16 cell (C=2048 x B=131,072 int8 planes,
   ``interstage_i16=True``: the int8-direct K1 -> K2 -> PLL -> extract in
   the int16 format) with counted launches, each int16 kernel alone
   beside its plain version and its float32 twin, profiled (its profile
   must show the fused mid end's three kernels and none of the launches
   route's ds x2 and Hilbert, nor the removed serial peak IIR and
   quantising pass);
5. the wideband main path at its cell (bench.py's FMTPU_BENCH_WIDEBAND=32
   cell: 2048 stations = 64 captures x M=32, K=16 taps per phase, B=131,072
   per channel, packed words made on the card as bench.py makes them): one
   warm-up block, then 8 blocks through ``wideband_demod_block`` with the
   counters set to 0 just before and read just after; then the channelizer
   and the phase-split K12 timed alone beside their plain versions on the
   last block's arguments, and compared there, with the phase-split
   ds x4's issue floors at the recorded shape.  bench.py's
   amplitude (2.8
   per channel) falls below half an LSB at the int8 bridge, so the same
   cell runs again on loud captures (2.8*M per channel), whose bridge
   output is not constant.  Then the M=16 bridge (stations' default: 128
   captures x 16, loud) and the float32 bridge (64 x 32, loud, K1 -> K2)
   for 2 counted blocks each (the exact channelizer timed alone at M=16,
   beside its plain version and its issue floor); then the cell at
   splits=1 (bench.py's own
   lens, FMTPU_WB_SPLITS=1, on its captures), and at splits 1 and 2 on
   loud captures, 8 counted blocks each, the matrix kernel and the
   phase-split K12 timed alone beside their plain versions, and the
   product alone as one PyTorch call (``torch._int_mm``, ``torch.bmm``;
   the exact mode at the loud M=32 cell: ``torch.bmm`` in float32 on its
   fused operators), and the kernel's operator bytes; at splits=1 on bench.py's captures
   BPSK timed alone as at the pre-split cell; the splits=1, 2 and 3
   cells on bench.py's captures profiled;
6. the selftest station through the port's App on the card and through
   the plain versions on the host CPU: selftest gates, identical RDS
   bytes, audio SNR >= 75 dB;
6b. the selftest station (1 s) on the split path, on the card and with
   the plain versions on the host CPU: through App on complex64
   (``process_u8``, ``DemodConfig()``) and through ``demod --ingest f32w``
   (identical RDS bytes, audio SNR >= 75 dB, PI decoded), then the
   ``demod`` command itself on the card;
6c. the selftest station through App with ``pll_time_chunks=4`` (block
   262,144) and with ``chain_fusion="auto"`` on 8 channels of packed
   words, on the card and with the plain versions on the host CPU:
   identical RDS bytes, audio SNR >= 75 dB, PI 1234;
7. wideband stations through ``StationsApp``: ``selftest --stations 4``
   (M=8, flat int8 bridge, 2 s; every station's PI and name) and 3
   stations on an M=32 grid (phase-split bridge, 1.5 s; every station's
   PI, names reported) on the card; and the first 0.5 s of both through
   the card and through the plain versions on the host CPU: identical RDS
   bytes, audio SNR >= 75 dB;
7b. a stereo+RDS station (PI 0x5005) on channel 3 of an M=32 capture
   through ``wideband_demod_block`` at splits 3, 2 and 1 on the card (the
   JAX package's hardware gate, tests/test_tpu_accuracy.py:200-278): PI at
   every split, audio of splits 2 and 1 >= 30 dB against splits 3; and
   its first 0.5 s at splits=1 on the card and with the plain versions on
   the host CPU: identical RDS bytes, audio SNR >= 75 dB.

Any failed phase raises and the script exits non-zero.  Every line it
logs is also written to chiprun_out/chip_smoke.log beside the script.
The last lines of standard output are the nvidia-smi line, one JSON object with the
per-kernel results (launches on every path, errors, kernel and plain ms,
the bound of :func:`bound`; ``library_ms`` is the product alone as one
PyTorch call for the three channelizer modes, :func:`mat_library_ms`, and
null for the others: no single PyTorch call computes their functions),
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import threading
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
SPLIT_KERNELS = (
    ("frontend", "fm_radio_tpu_torch/csrc/frontend.cu",
     "fm_radio_tpu/kernels/frontend_pallas.py:223"),
    ("frontend_i8", "fm_radio_tpu_torch/csrc/frontend.cu",
     "fm_radio_tpu/kernels/frontend_pallas.py:448"),
    ("midend", "fm_radio_tpu_torch/csrc/midend.cu",
     "fm_radio_tpu/kernels/midend_pallas.py:225"),
)
CHAIN_KERNELS = (
    ("chain", "fm_radio_tpu_torch/csrc/chain.cu",
     "fm_radio_tpu/kernels/chain_pallas.py:74"),
    ("pll_chunked", "fm_radio_tpu_torch/csrc/pll.cu",
     "fm_radio_tpu/kernels/pll_pallas.py:382"),
)
# the channelizer's quantised-matrix modes: one wgmma kernel templated on
# the mode
MAT_KERNELS = (
    ("channelizer_i8mat", "fm_radio_tpu_torch/csrc/channelizer_wgmma.cu",
     "fm_radio_tpu/kernels/channelizer_pallas.py:104"),
    ("channelizer_bf16mat", "fm_radio_tpu_torch/csrc/channelizer_wgmma.cu",
     "fm_radio_tpu/kernels/channelizer_pallas.py:133"),
)
# the int16 inter-stage format's kernels (interstage_i16): the same
# sources, templated on the format; each counts apart
I16_KERNELS = (
    ("frontend_i16", "fm_radio_tpu_torch/csrc/frontend.cu",
     "fm_radio_tpu/kernels/frontend_pallas.py:223"),
    ("frontend_i8_i16", "fm_radio_tpu_torch/csrc/frontend.cu",
     "fm_radio_tpu/kernels/frontend_pallas.py:448"),
    ("midend_i16", "fm_radio_tpu_torch/csrc/midend.cu",
     "fm_radio_tpu/kernels/midend_pallas.py:225"),
    ("pll_i16", "fm_radio_tpu_torch/csrc/pll.cu",
     "fm_radio_tpu/kernels/pll_pallas.py:80"),
    ("extract_i16", "fm_radio_tpu_torch/csrc/extract.cu",
     "fm_radio_tpu/kernels/extract_pallas.py:122"),
    ("extract_i16_f32dt", "fm_radio_tpu_torch/csrc/extract.cu",
     "fm_radio_tpu/kernels/extract_pallas.py:122"),
)
# the kernel (and its recorded name) each int16 variant is a form of (the
# same as probes/replay.py's I16_VARIANTS, which this script imports only
# from inside its functions)
I16_BASE = {"frontend_i16": "frontend", "frontend_i8_i16": "frontend_i8",
            "midend_i16": "midend", "pll_i16": "pll",
            "extract_i16": "extract", "extract_i16_f32dt": "extract"}
# the engine probes (tools/*_probe.py as probes/*_probe.py): name, CUDA
# source, the TPU kernel function it replaces (its pallas_call in PERF.md)
ENGINE_KERNELS = (
    ("fp_sum", "fm_radio_tpu_torch/csrc/frontend_probe.cu",
     "tools/frontend_probe.py:52"),
    ("fp_fir", "fm_radio_tpu_torch/csrc/frontend_probe.cu",
     "tools/frontend_probe.py:52"),
    ("fp_dbuf", "fm_radio_tpu_torch/csrc/frontend_probe.cu",
     "tools/frontend_probe.py:250"),
    ("fp_i8d", "fm_radio_tpu_torch/csrc/frontend_probe.cu",
     "tools/frontend_probe.py:340"),
    ("fp_i8man", "fm_radio_tpu_torch/csrc/frontend_probe.cu",
     "tools/frontend_probe.py:442"),
    ("k2_engine", "fm_radio_tpu_torch/csrc/k2_probe.cu",
     "tools/k2_probe.py:69"),
    ("k2_full", "fm_radio_tpu_torch/csrc/k2_probe.cu",
     "tools/k2_probe.py:69"),
    ("k2_restruct", "fm_radio_tpu_torch/csrc/k2_probe.cu",
     "tools/k2_probe.py:69"),
    ("k3_stream31", "fm_radio_tpu_torch/csrc/k3_probe.cu",
     "tools/k3_probe.py:61"),
    # k3_probe's stream kernel is also chain_probe's stream3
    ("k3_sum", "fm_radio_tpu_torch/csrc/k3_probe.cu",
     "tools/k3_probe.py:92, tools/chain_probe.py:44"),
    ("k3_value", "fm_radio_tpu_torch/csrc/k3_probe.cu",
     "tools/k3_probe.py:92"),
    ("k3_full", "fm_radio_tpu_torch/csrc/extract.cu",
     "tools/k3_probe.py:92"),
)
# the K1 probe's sections (all of them) and the engine probes' shapes:
# small ones where every section's tiles apply (C a multiple of the K1
# probe's largest c_blk, 1024), and the TPU tools' defaults, both compared
# with the plain versions; the defaults also timed
FP_SECTIONS = {"ingest", "tm", "engines", "split", "tiles", "dbuf", "i8d",
               "i8x", "man", "sem"}
PROBE_SMALL = {"fp": (1024, 16384), "k2": (64, 8192), "k3": (128, 8192)}
PROBE_FULL = {"fp": (1024, 262144), "k2": (1024, 65536), "k3": (1024, 32768),
              "chain": (256, 1 << 20, 8), "unfused": (256, 16384, 1)}
PROBE_ITERS = 5
# the device-memory probes (tools/hbm_sweep.py as probes/hbm_sweep.py)
PROBE_KERNELS = (
    ("hbm_copy", "fm_radio_tpu_torch/csrc/hbm_sweep.cu",
     "tools/hbm_sweep.py:57"),
    ("hbm_dma_copy", "fm_radio_tpu_torch/csrc/hbm_sweep.cu",
     "tools/hbm_sweep.py:75"),
    ("hbm_read", "fm_radio_tpu_torch/csrc/hbm_sweep.cu",
     "tools/hbm_sweep.py:149"),
)
# the channelizer kernel that runs each precision mode (``splits``)
CHANNELIZER_BY_SPLITS = {3: "channelizer", 1: "channelizer_i8mat",
                         2: "channelizer_bf16mat"}
# kernel vs plain on the card: both evaluate the same float32 operations in
# the same order (the kernels are built with -fmad=false), so they agree to
# rounding; the power sums differ only in summation order.  K1 (every load
# form, both taps and stores; its float taps summed in ds4_float's order),
# K12 (flat and phase-split) and K2 admit no slack on either route of their mid end: the
# fused route sums every FIR output in the plain version's tap order; nor
# do the PLL (sequential and chunked: the chunked lanes' masks change no
# value), extract (on both of its routes) and BPSK (its branch
# changes no value: it skips only what no lane uses).  The channelizer
# has no power sum and its int8 outputs admit no slack: it must be exact,
# and so must the int8-matrix channelizer (integer products, then the plain
# version's float epilogue).  The bf16-matrix channelizer's tensor cores sum
# in another order than its plain version: its float32 output is held to
# BF16MAT_F32_REL of the output's rms, its int8 outputs to 1 LSB on at most
# BF16MAT_I8_SHARE of the samples (a value that lies on a rounding boundary
# may move); its carried state is exact.
TOL = {"k12": 0.0, "pll": 0.0, "extract": 0.0, "bpsk": 0.0,
       "k12_ps": 0.0, "channelizer": 0.0, "frontend": 0.0,
       "frontend_i8": 0.0, "midend": 0.0, "chain": 0.0,
       "pll_chunked": 0.0, "channelizer_i8mat": 0.0,
       "channelizer_bf16mat": 1.0,
       # the int16 format: quantised stores leave no slack
       **dict.fromkeys(I16_BASE, 0.0)}
BF16MAT_F32_REL = 1e-5
BF16MAT_I8_SHARE = 1e-3
POWER_RTOL = 1e-5
SNR_MIN_DB = 75.0
# the int16 station: card against the host's plain versions (the kernels
# equal them bit for bit), and against the float32 route (the JAX
# package's own bar for the format, tests/test_e2e.py:312-368)
STATION_I16_CPU_DB = 100.0
STATION_I16_FLOAT_DB = 55.0
# the int16 kernels one channel takes: its PLL tile (1) is not
# channel-major, so theta is dequantised and dt stays float32
I16_STATION = ("frontend_i8_i16", "midend_i16", "extract_i16_f32dt")
# the JAX package's hardware gate for splits 1 and 2 against splits 3
# (tests/test_tpu_accuracy.py:278)
STATION_SPLITS_SNR_DB = 30.0
# per-channel amplitude of bench.py's wideband synthesis (bench.py:311-334)
BENCH_AMP = 2.8


# The card's published peaks (NVIDIA H100 SXM data sheet, dense, at the
# full 700 W): device memory 3.35 TB/s, float32 outside the tensor cores
# 67 TFLOP/s, int8 on the tensor cores 1,979 TOP/s, bf16 on the tensor
# cores 989 TFLOP/s.  A kernel's bound is the larger of its bytes (each
# input read once, each output written once) over the memory rate and its
# operations over their peaks (float32, int8 and bf16 times added); see
# work().  The memory rates are the data sheet's until phase 2b's sweep
# (probes/hbm_sweep.py) measures the best copy rate and the best read rate
# this card reaches, and those from then on (set_rates; HBM_RATE_FROM and
# HBM_READ_RATE_FROM say which): a read-only kernel's bytes (READ_ONLY)
# over the read rate, every other kernel's over the copy rate.  A
# read-only probe kernel that reads faster than the sweep's best read
# raises the read rate to its own (note_read).
DATASHEET_HBM_BYTES_S = 3.35e12
HBM_BYTES_S = DATASHEET_HBM_BYTES_S
HBM_RATE_FROM = "data sheet"
HBM_READ_BYTES_S = DATASHEET_HBM_BYTES_S
HBM_READ_RATE_FROM = "data sheet"
# the kernels that read their input and write next to nothing: the
# per-tile sums of the engine probes and the sweep's read
READ_ONLY = frozenset({"fp_sum", "k3_sum", "k3_stream31", "hbm_read"})
F32_FLOP_S = 67e12
I8_OP_S = 1979e12
BF16_FLOP_S = 989e12  # bf16 on the tensor cores, dense
ATAN2_FLOPS = 25  # abs x2, max, min, clamp, div, 8 Horner steps, selects
PLL_STEP_FLOPS = 30
BPSK_STEP_FLOPS = 60


def loud_amp(m: int) -> float:
    """A per-channel amplitude that survives the int8 bridge's 1/M descale
    (the u8 words clip; the bridge output takes several values)."""
    return BENCH_AMP * m


# main() keeps every logged line also in this file (under DUMP_DIR), so the
# whole log survives where only the end of standard output is kept
LOG_FILE = None


def log(msg: str) -> None:
    print(msg, flush=True)
    if LOG_FILE is not None:
        with open(LOG_FILE, "a") as f:
            f.write(msg + "\n")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _modules():
    from fm_radio_tpu_torch.kernels import (
        bpsk,
        chain,
        channelizer,
        extract,
        frontend,
        k12,
        midend,
        pll,
    )

    return {"k12": k12, "pll": pll, "extract": extract, "bpsk": bpsk,
            "channelizer": channelizer, "frontend": frontend,
            "midend": midend, "chain": chain}


# (kernel name, module key, counter): the counters besides each module's
# ``launches`` (K12's flat and phase-split entries count apart, as do K1's
# and its int8-direct entry, the sequential and chunked PLL, the
# channelizer's three modes, and every int16 variant)
COUNTERS = (
    ("k12_ps", "k12", "launches_ps"),
    ("frontend_i8", "frontend", "launches_i8"),
    ("pll_chunked", "pll", "launches_chunked"),
    ("channelizer_i8mat", "channelizer", "launches_i8mat"),
    ("channelizer_bf16mat", "channelizer", "launches_bf16mat"),
    ("frontend_i16", "frontend", "launches_i16"),
    ("frontend_i8_i16", "frontend", "launches_i8_i16"),
    ("midend_i16", "midend", "launches_i16"),
    # the mid end's fused route, launched by K12 or K2 (each counts too)
    ("midend_fused", "midend", "launches_fused"),
    ("pll_i16", "pll", "launches_i16"),
    ("extract_i16", "extract", "launches_i16"),
    ("extract_i16_f32dt", "extract", "launches_i16_f32dt"),
    # extract's blocked route, at the receiver's filter orders (each form
    # counts too)
    ("extract_blocked", "extract", "launches_blocked"),
)


def reset_counts() -> None:
    """Every kernel's launch count to 0."""
    m = _modules()
    for mod in m.values():
        mod.launches = 0
    for _, key, attr in COUNTERS:
        setattr(m[key], attr, 0)


def read_counts() -> dict:
    m = _modules()
    counts = {name: mod.launches for name, mod in m.items()}
    counts.update({name: getattr(m[key], attr)
                   for name, key, attr in COUNTERS})
    return counts


def check_counts(counts: dict, want: dict, what: str) -> None:
    """Raise unless each kernel launched as often as ``want`` says (and
    every kernel ``want`` leaves out, not at all)."""
    want = {k: want.get(k, 0) for k in counts}
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
# every state key the megakernel writes (agc_pilot apart: "rel")
CHAIN_KEYS = K12_KEYS + ("pll",) + EXTRACT_KEYS


def _stages():
    """Each kernel's (wrapper, plain version), by the names under which
    ``demod_block`` records their arguments, and the int16 variants by
    theirs (probes/replay.py)."""
    from fm_radio_tpu_torch.probes.replay import stages

    return stages()


def variant(name: str, args) -> str:
    """The kernel that a recorded call of ``name`` runs: its int16 variant
    where the arguments carry the format (:data:`I16_KERNELS`)."""
    from fm_radio_tpu_torch.kernels.pll import channel_major

    i16 = torch.int16
    if name == "frontend" and len(args) > 5 and args[5]:
        return "frontend_i16"
    if name == "frontend_i8" and len(args) > 4 and args[4]:
        return "frontend_i8_i16"
    if name == "midend" and (args[3].dtype == i16
                             or (len(args) > 4 and args[4])):
        return "midend_i16"
    if name == "pll" and args[2].dtype == i16 and channel_major(
            args[2].shape[0]):
        return "pll_i16"
    if name == "extract" and args[3][0].dtype == i16:
        return "extract_i16" if args[4].dtype == i16 else "extract_i16_f32dt"
    return name


# where a kernel's disagreement with its plain version is saved for
# probes/replay.py: chiprun_out/, the run-output directory .gitignore lists;
# a case larger than DUMP_MAX_BYTES is reported, not saved
DUMP_DIR = os.path.join(HERE, "chiprun_out")
DUMP_MAX_BYTES = 48 << 20
DUMPS: list = []


def dump_mismatch(name: str, args, kout, pout, e: dict):
    """Save the kernel's recorded arguments (state included) and both
    outputs as one .npz under DUMP_DIR where ``e`` shows a difference
    (max abs error above 0 or not finite, or a BPSK decision apart; for
    the bf16-matrix channelizer, whose tensor cores sum in their own order,
    outside its tolerances), print the path and return it (None where
    there was nothing to save).  main() fails at its end on any saved
    case."""
    from fm_radio_tpu_torch.probes import replay

    exact = name != "channelizer_bf16mat"
    if (e["err"] == 0.0 and not e.get("valid_mismatch")) if exact \
            else _verdict(name, e)["ok"]:
        return None
    nbytes = replay.case_nbytes(args, kout, pout)
    if nbytes > DUMP_MAX_BYTES:
        log(f"[dump] {name}: mismatch {e}, case of {nbytes} bytes not saved "
            f"(over {DUMP_MAX_BYTES})")
        return None
    os.makedirs(DUMP_DIR, exist_ok=True)
    path = os.path.join(DUMP_DIR, f"mismatch_{name}_{time.time_ns()}.npz")
    replay.save_case(path, name, args, kout, pout,
                     {k: float(v) for k, v in e.items()})
    DUMPS.append(path)
    log(f"[dump] {name}: mismatch {e} saved to {path} (replay: python -m "
        f"fm_radio_tpu_torch.probes.replay {path})")
    return path


def compare_stage(acc: dict, name: str, args, stages=None) -> tuple:
    """Kernel ``name`` (or its recorded base) and its plain version on
    ``args``: the errors merged into ``acc`` under ``name``, a mismatch
    saved (:func:`dump_mismatch`).  Returns (kernel out, plain out)."""
    kern, plain = (stages or _stages())[name]
    kout, pout = kern(*args), plain(*args)
    e = stage_errors(I16_BASE.get(name, name), kout, pout)
    _merge(acc, name, e)
    dump_mismatch(name, args, kout, pout, e)
    return kout, pout


def stage_errors(name: str, kout, pout) -> dict:
    """A kernel's outputs against its plain version's on the same inputs:
    the max abs error over outputs and state ("err"), the relative error of
    the power sums ("rel") and, for BPSK, the count of differing ``valid``
    decisions ("valid_mismatch"; pred and sym compared where both are
    valid)."""
    if name.startswith("channelizer"):
        (sk, yk), (sp, yp) = kout, pout
        ys = list(zip(yk, yp) if isinstance(yk, tuple) else [(yk, yp)])
        e = {"err": _max_err(ys + list(zip(sk, sp))),
             "state_err": _max_err(zip(sk, sp))}
        if isinstance(yk, tuple):  # float32 out: the error over the rms
            rms = max(float(b.double().pow(2).mean().sqrt()) for _, b in ys)
            e["f32_rel_rms"] = _max_err(ys) / max(rms, 1e-30)
        else:  # int8 out: the share of samples that differ
            e["i8_share"] = float((yk != yp).double().mean())
        return e
    if name in ("frontend", "frontend_i8"):
        (sk, yk), (sp, yp) = kout, pout
        return {"err": max(_max_err([(yk, yp)]),
                           _state_err(sk, sp, ("ds_fm_in", "disc_prev_theta")))}
    if name in ("k12", "k12_ps", "midend"):
        (sk, iq_k, th_k), (sp, iq_p, th_p) = kout, pout
        th_err = (_max_err([(th_k, th_p)]) if th_k.dtype == torch.int16
                  else _wrapped_err(th_k, th_p))  # int16: no wrap
        return {"err": max(_max_err(zip(iq_k, iq_p)), th_err,
                           _state_err(sk, sp, K12_KEYS)),
                "rel": _rel(sk["agc_pilot"], sp["agc_pilot"])}
    if name in ("pll", "pll_chunked"):
        (sk, dt_k), (sp, dt_p) = kout, pout
        return {"err": max(_max_err([(dt_k, dt_p)]), _max_err(zip(sk, sp)))}
    if name == "chain":
        (sk, lk, mk, rk), (sp, lp, mp, rp) = kout, pout
        return {"err": max(_max_err([(lk, lp), *zip(mk, mp), *zip(rk, rp)]),
                           _state_err(sk, sp, CHAIN_KEYS)),
                "rel": _rel(sk["agc_pilot"], sp["agc_pilot"])}
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
    row = {"name": name, "max_abs_err": e["err"], "tol": TOL[name],
           "power_rel_err": e.get("rel"),
           "valid_mismatch": e.get("valid_mismatch"), "ok": ok}
    if name == "channelizer_bf16mat":
        # TOL is 1 LSB on the int8 outputs; the float32 output and the
        # share of int8 samples that differ have their own bounds
        row.update(f32_rel_rms=e.get("f32_rel_rms"),
                   i8_share=e.get("i8_share"), state_err=e["state_err"],
                   tol_f32_rel_rms=BF16MAT_F32_REL,
                   tol_i8_share=BF16MAT_I8_SHARE)
        row["ok"] = (ok and e["state_err"] == 0.0
                     and e.get("f32_rel_rms", 0.0) <= BF16MAT_F32_REL
                     and e.get("i8_share", 0.0) <= BF16MAT_I8_SHARE)
    return row


def compare_kernels(channels: int = 256, block: int = 131072, blocks: int = 2,
                    device="cuda", seed: int = 1) -> list[dict]:
    """Each kernel against its plain version on the card: every block goes
    through ``demod_block`` (state carried), and each kernel and its plain
    version run again on the arguments ``demod_block`` gave that kernel;
    K12 also with de-emphasis on, on the same input.  A kernel off its
    plain version has its case saved (:func:`dump_mismatch`).  Returns one
    row per kernel with its max abs error, tolerance and verdict."""
    from fm_radio_tpu_torch.models.demod import (
        INT8_CONFIG, demod_block, demod_init_state, make_coeffs)

    stages = _stages()
    cfg = INT8_CONFIG
    co = make_coeffs(cfg, device)
    cfg_de = dataclasses.replace(cfg, use_deemphasis_filter=True,
                                 deemphasis_cutoff_us=50)
    co_de = make_coeffs(cfg_de, device)
    st = demod_init_state(cfg, channels, device)
    x = bench_planes(channels, block * blocks, seed=seed, device=device)
    acc = {}
    for blk in range(blocks):
        calls = {}
        xb = x[:, :, blk * block : (blk + 1) * block].contiguous()
        st, _ = demod_block(cfg, co, st, xb, record=calls)
        # the de-emphasis stage (off in the slice config) on the same input
        calls_de = {"k12": (co_de, cfg_de) + calls["k12"][2:]}
        for rec in (calls, calls_de):
            for name, args in rec.items():
                compare_stage(acc, name, args, stages)
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
    (kernel ms, plain ms, verdict rows, bounds), keyed by kernel name;
    each bound is :func:`bound` of those arguments."""
    stages = _stages()
    kernel_ms, plain_ms, rows, bounds = {}, {}, [], {}
    for name, args in calls.items():
        kern, plain = stages[name]
        base = I16_BASE.get(name, name)
        kern(*args)
        kout, kernel_ms[name] = _cuda_ms(lambda: kern(*args), reps=5)
        pout, plain_ms[name] = _cuda_ms(lambda: plain(*args), reps=1)
        e = stage_errors(base, kout, pout)
        dump_mismatch(name, args, kout, pout, e)
        rows.append(_verdict(name, e))
        bounds[name] = bound(name, args)
    return kernel_ms, plain_ms, rows, bounds


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _mid_flops(cfg, co, c: int, n8: int) -> float:
    """K2's float32 operations on [C, n8] outputs: ds x2, de-emphasis,
    Hilbert, two order-2 IIRs, atan2, theta scale, power."""
    de = 5 if cfg.use_deemphasis_filter else 0
    per = (2 * co.taps_fm_out.shape[0] + de + 2 * co.taps_hilbert.shape[0]
           + 2 * 9 + ATAN2_FLOPS + 1 + 3)
    return float(c) * n8 * per


def _k1_ops(co, c: int, n4: int, int8_taps: bool, words: bool):
    """K1's (float32, int8) operations on [C, n4] outputs: the 64-tap
    window on two planes (int8: two quantized tap planes), the combine,
    atan2 and the discriminator (and, for words, the unpack per input)."""
    nn = co.taps_fm_in.shape[0]
    f32_per = ATAN2_FLOPS + 4 + (6 if int8_taps else 4 * nn)
    i8_per = 2 * 2 * 2 * nn if int8_taps else 0
    unpack = 5 * 4 * float(c) * n4 if words else 0.0
    return float(c) * n4 * f32_per + unpack, float(c) * n4 * i8_per


def _ext_flops(co, c: int, n: int) -> float:
    """Extract's float32 operations on [C, n] analytic samples: the two
    harmonics and the mix per sample, the L+R and L-R (two planes) ds x4
    and the RDS (two planes) ds x8 FIRs per output."""
    taps = co.taps_audio_lpr.shape[0]
    return float(c) * (n * (2 * 15 + 8) + n // 4 * (2 + 4) * taps
                       + n // 8 * 4 * taps)


def work(name: str, args) -> tuple:
    """(bytes, float32 operations, int8 operations) of one call of kernel
    ``name`` on its recorded arguments: each input read once and each
    output written once (carried state included), and the arithmetic the
    function needs, counted per output from its filter orders.  The int16
    variants count their tensors' own bytes (2 per sample)."""
    name = I16_BASE.get(name, name)
    if name in ("k12", "k12_ps"):
        co, cfg, st, x = args
        c = x.shape[-2]
        b = x.shape[-1] * (4 if name == "k12_ps" else 1)
        f, i8 = _k1_ops(co, c, b // 4, True, False)
        return (_nbytes(x) + 3 * 4 * c * (b // 8) + 4 * c,
                f + _mid_flops(cfg, co, c, b // 8), i8)
    if name in ("frontend", "frontend_i8"):
        co, cfg, st, x = args[:4]
        int8_taps = name == "frontend_i8" or args[4]
        out_i16 = args[5 if name == "frontend" else 4] if len(args) > (
            5 if name == "frontend" else 4) else False
        c, b = x.shape[-2], x.shape[-1]
        words = x.dtype == torch.float32 and x.ndim == 2
        f, i8 = _k1_ops(co, c, b // 4, int8_taps, words)
        return (_nbytes(x) + (2 if out_i16 else 4) * c * (b // 4) + 4 * c, f,
                i8)
    if name == "midend":
        co, cfg, st, fmd = args[:4]
        out_b = 2 if len(args) > 4 and args[4] else 4
        c, n8 = fmd.shape[0], fmd.shape[1] // 2
        return (_nbytes(fmd) + 3 * out_b * c * n8 + 4 * c,
                _mid_flops(cfg, co, c, n8), 0.0)
    if name == "pll":
        from fm_radio_tpu_torch.kernels.pll import channel_major

        theta = args[2]
        dt_b = 2 if (theta.dtype == torch.int16
                     and channel_major(theta.shape[0])) else 4
        return (_nbytes(theta) + dt_b * theta.numel(),
                float(theta.numel()) * PLL_STEP_FLOPS, 0.0)
    if name == "pll_chunked":
        cfg, theta = args[0], args[2]
        c, n = theta.shape
        g, w = cfg.pll_time_chunks, cfg.pll_chunk_warmup
        # chunk 0 runs its L steps, every other chunk L + W
        steps = c * (n + (g - 1) * w)
        return 2 * _nbytes(theta), float(steps) * PLL_STEP_FLOPS, 0.0
    if name == "extract":
        co, cfg, st, (re, im), dt = args
        c, n = re.shape
        out = 4 * c * (n // 4) * 3 + 4 * c * (n // 8) * 2 + 4 * c
        return _nbytes(re, im, dt) + out, _ext_flops(co, c, n), 0.0
    if name == "chain":
        co, cfg, st, x = args
        c, b = x.shape[-2], x.shape[-1]
        n = b // 8
        f, _ = _k1_ops(co, c, b // 4, False,
                       x.dtype == torch.float32 and x.ndim == 2)
        flops = (f + _mid_flops(cfg, co, c, n) + float(c) * n * PLL_STEP_FLOPS
                 + _ext_flops(co, c, n))
        out = 4 * c * (b // 32) * 3 + 4 * c * (b // 64) * 2
        return _nbytes(x) + out, flops, 0.0
    if name == "bpsk":
        rds_p = args[2]
        c, n = rds_p[0].shape
        return (_nbytes(*rds_p) + (4 + 8 + 1) * c * n,
                float(c) * n * BPSK_STEP_FLOPS, 0.0)
    if name.startswith("channelizer"):
        tab, state, xp, m, out = args[:5]
        x0 = xp[0] if isinstance(xp, tuple) else xp
        w, t = x0.shape[0], x0.numel() // x0.shape[0]
        k = state[0].shape[-1] // m + 1
        out_b = 8 if out == "f32" else 2
        nbytes = (_nbytes(*(xp if isinstance(xp, tuple) else (xp,)))
                  + out_b * w * t + 2 * _nbytes(*state))
        if name == "channelizer":
            return nbytes, float(w) * t * (4 * k + 8 * m), 0.0
        # the fused products: per sample, 4 (int8) or 3 (bf16) groups of
        # 128 * n_c multiply-adds per 128 samples, the tables read once
        qt = _modules()["channelizer"].quant_tables(tab, args[5], out)
        n_c = qt.mats.shape[1]
        int8 = name.startswith("channelizer_i8mat")
        ops = float(w) * t * (4 if int8 else 3) * 2 * n_c * 128
        nbytes += _nbytes(qt.mats) + (_nbytes(qt.aux) if qt.aux is not None
                                      else 0)
        if int8:
            return nbytes, 0.0, ops
        return nbytes, 0.0, 0.0, ops
    raise KeyError(name)


def serial_steps(name: str, args):
    """The steps of the recursion that kernel ``name`` runs in time order
    on its recorded arguments (the PLL over theta, the BPSK loop over the
    RDS planes, K2's order-2 peak IIR over its outputs), or None."""
    name = I16_BASE.get(name, name)
    if name == "pll":
        return args[2].shape[-1]
    if name == "pll_chunked":  # one lane's L + W steps
        cfg, theta = args[0], args[2]
        return theta.shape[-1] // cfg.pll_time_chunks + cfg.pll_chunk_warmup
    if name == "chain":  # the PLL's (and the peak IIR's) steps
        return args[3].shape[-1] // 8
    if name == "bpsk":
        return args[2][0].shape[-1]
    if name in ("k12", "k12_ps"):
        return args[3].shape[-1] * (4 if name == "k12_ps" else 1) // 8
    if name == "midend":
        return args[3].shape[-1] // 2
    return None


def bound_of(nbytes: float, f32_ops: float = 0.0, i8_ops: float = 0.0,
             bf16_ops: float = 0.0, read_only: bool = False) -> dict:
    """The least time the card could take to move ``nbytes`` and do the
    operations: the larger of the bytes over the memory rate (the read
    rate for a ``read_only`` kernel, else the copy rate) and the
    operations over their peaks."""
    rate, src = ((HBM_READ_BYTES_S, HBM_READ_RATE_FROM) if read_only
                 else (HBM_BYTES_S, HBM_RATE_FROM))
    t_bytes = nbytes / rate * 1e3
    t_ops = (f32_ops / F32_FLOP_S + i8_ops / I8_OP_S
             + bf16_ops / BF16_FLOP_S) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "f32_ops": f32_ops, "i8_ops": i8_ops,
            "bf16_ops": bf16_ops, "hbm_bytes_s": rate,
            "hbm_rate": "read" if read_only else "copy",
            "hbm_rate_from": src}


def note_read(bytes_s: float, what: str) -> None:
    """A read measured in this run at ``bytes_s``: where it is faster than
    the best read so far it becomes the read rate (no bound is then under
    a read the card was seen to make)."""
    global HBM_READ_BYTES_S, HBM_READ_RATE_FROM
    if bytes_s > HBM_READ_BYTES_S:
        HBM_READ_BYTES_S = bytes_s
        HBM_READ_RATE_FROM = (f"{what} in this run, "
                              f"{bytes_s / 1e9:.1f} GB/s")


def set_rates(sweep: dict) -> None:
    """The byte rates of every bound from here on: the sweep's best copy
    and best read (``probes/hbm_sweep.py::sweep``, its "best_copy" and
    "best_read" rows)."""
    global HBM_BYTES_S, HBM_RATE_FROM, HBM_READ_BYTES_S, HBM_READ_RATE_FROM
    c, r = sweep["best_copy"], sweep["best_read"]
    HBM_BYTES_S = c["gbps"] * 1e9
    HBM_RATE_FROM = (f"probes/hbm_sweep.py in this run: best copy "
                     f"{c['variant']}, {c['gbps']:.1f} GB/s")
    HBM_READ_BYTES_S = r["gbps"] * 1e9
    HBM_READ_RATE_FROM = (f"probes/hbm_sweep.py in this run: best read "
                          f"{r['variant']}, {r['gbps']:.1f} GB/s")


def bound(name: str, args) -> dict:
    """:func:`bound_of` ``work(name, args)``, with its serial steps."""
    nbytes, f32_ops, i8_ops, *rest = work(name, args)
    return dict(bound_of(nbytes, f32_ops, i8_ops, rest[0] if rest else 0.0),
                serial_steps=serial_steps(name, args))


def bench_u8(channels: int, block: int, seed: int, device):
    """(u8 values [2, C, B] float32 of bench.py's FM-like signal, and its
    phase walk [C, B]), made on the device from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    phase = torch.cumsum(
        torch.randn((channels, block), generator=g, device=device) * 0.5,
        dim=-1)
    u8 = torch.stack([torch.round(100.0 * torch.cos(phase) + 127.0),
                      torch.round(100.0 * torch.sin(phase) + 127.0)])
    return u8, phase


def split_input(kind: str, channels: int, block: int, seed: int, device):
    """bench.py's signal in the ingest form ``kind``: "planes_float"
    (float32 planes off the u8 grid), "planes_int" (u8 - 127 float32
    planes), "words" (packed u8 words), "i8" (u8 - 128 int8 planes) or
    "complex" (u8 - 127 complex64, as App.process_u8 makes it)."""
    u8, phase = bench_u8(channels, block, seed, device)
    if kind == "planes_float":
        return torch.stack([100.0 * torch.cos(phase),
                            100.0 * torch.sin(phase)])
    if kind == "planes_int":
        return u8 - 127.0
    if kind == "words":
        return u8[0] * 256.0 + u8[1]
    if kind == "i8":
        return (u8 - 128.0).to(torch.int8)
    if kind == "complex":
        return torch.complex(u8[0] - 127.0, u8[1] - 127.0)
    raise KeyError(kind)


def input_stats(x) -> dict:
    """An input's centred planes (u8 - 127 for integer forms): mean |v|,
    the share of samples at 0 (the u8 centre), and whether it is constant
    (a comparison on a constant input proves nothing)."""
    from fm_radio_tpu_torch.kernels.frontend import input_planes

    if x.is_complex():
        planes = torch.stack([x.real, x.imag])
    else:
        planes = torch.stack(input_planes(x))
    planes = planes.double()
    return {"mean_abs": float(planes.abs().mean()),
            "centre_share": float((planes == 0).double().mean()),
            "constant": bool(planes.max() == planes.min())}


# (label, input kind, DemodConfig kwargs): each K1 form demod_block takes
SPLIT_FORMS = (
    ("planes_float", "planes_float", {}),
    ("planes_int_int8", "planes_int",
     {"frontend_int8": True, "assume_integer_input": True}),
    ("words_float", "words", {"assume_integer_input": True}),
    ("words_int8", "words", {"frontend_int8": True}),
    ("i8_float", "i8", {}),
    ("i8_direct", "i8", {"frontend_int8": True, "k12_fusion": "off"}),
    ("complex_float", "complex", {}),
    ("complex_int8", "complex",
     {"frontend_int8": True, "assume_integer_input": True}),
)
# the split cells at full width: (label, input kind, DemodConfig kwargs)
SPLIT_CELLS = (
    ("f32w", "words", {"assume_integer_input": True}),
    ("complex", "complex", {}),
    ("k12off", "i8", {"frontend_int8": True, "k12_fusion": "off"}),
)


def _leaf_max_diff(sa, sb) -> float:
    """Max |a - b| over two states' leaves (dicts, tuples, tensors)."""
    if isinstance(sa, dict):
        return max((_leaf_max_diff(sa[k], sb[k]) for k in sa), default=0.0)
    if isinstance(sa, tuple):
        return max((_leaf_max_diff(a, b) for a, b in zip(sa, sb)),
                   default=0.0)
    if sa.is_complex():
        sa, sb = torch.view_as_real(sa), torch.view_as_real(sb)
    return float((sa.double() - sb.double()).abs().max())


def compare_split(channels: int = 256, block: int = 131072, blocks: int = 2,
                  device="cuda"):
    """K1 (each of its eight forms) and K2 against their plain versions on
    the card, on the arguments ``demod_block`` recorded, ``blocks`` blocks
    with carried state; K2 also with de-emphasis on, on the same fm_demod.
    Then ``demod_block(k12_fusion="off")`` against the fused K12 on the
    same int8 planes: every output and state leaf.  Returns (verdict rows
    with each form's input statistics under "inputs", the max difference
    of the split int8 path from K12)."""
    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.models.demod import (
        INT8_CONFIG, demod_block, demod_init_state, make_coeffs)

    stages = _stages()
    acc, stats = {}, {}
    for label, kind, kw in SPLIT_FORMS:
        cfg = DemodConfig(**kw)
        co = make_coeffs(cfg, device)
        cfg_de = dataclasses.replace(cfg, use_deemphasis_filter=True,
                                     deemphasis_cutoff_us=50)
        co_de = make_coeffs(cfg_de, device)
        st = demod_init_state(cfg, channels, device)
        x = split_input(kind, channels, block * blocks, 3, device)
        stats[label] = input_stats(x)
        for blk in range(blocks):
            calls = {}
            xb = x[..., blk * block : (blk + 1) * block].contiguous()
            st, _ = demod_block(cfg, co, st, xb, record=calls)
            if label == "planes_float":
                calls["midend_de"] = (co_de, cfg_de) + calls["midend"][2:]
            for name, args in calls.items():
                key = "midend" if name == "midend_de" else name
                if key in ("frontend", "frontend_i8", "midend"):
                    kern, plain = stages[key]
                    _merge(acc, key, stage_errors(key, kern(*args),
                                                  plain(*args)))
            torch.cuda.synchronize(device)

    off = dataclasses.replace(INT8_CONFIG, k12_fusion="off")
    co = make_coeffs(INT8_CONFIG, device)
    st_f = st_s = demod_init_state(INT8_CONFIG, channels, device)
    x = split_input("i8", channels, block * blocks, 4, device)
    k12_diff = 0.0
    for blk in range(blocks):
        xb = x[..., blk * block : (blk + 1) * block].contiguous()
        st_f, o_f = demod_block(INT8_CONFIG, co, st_f, xb)
        st_s, o_s = demod_block(off, co, st_s, xb)
        k12_diff = max(k12_diff, _leaf_max_diff(o_f, o_s),
                       _leaf_max_diff(st_f, st_s))
    torch.cuda.synchronize(device)
    rows = [dict(_verdict(name, acc[name]), inputs=stats)
            for name, _, _ in SPLIT_KERNELS]
    return rows, k12_diff


# the int16 cell: bench.py's FMTPU_BENCH_I16=1 lens (bench.py:66-91), int8
# planes, the int8-direct K1 -> K2 -> PLL -> extract in the int16 format
I16_CELL = ("i16", "i8", {"assume_integer_input": True,
                          "frontend_int8": True, "interstage_i16": True})


def _dq_args(name: str, args):
    """A recorded call's arguments with its int16 tensors dequantised: the
    float32 twin of an int16 launch on the same values."""
    from fm_radio_tpu_torch.kernels.qformat import (
        FM_SCALE, IQ_SCALE, PH_SCALE, dq_if_i16)

    if name == "frontend":
        return args[:5] + (False,)
    if name == "frontend_i8":
        return args[:4] + (False,)
    if name == "midend":
        return args[:3] + (dq_if_i16(args[3], FM_SCALE), False)
    if name == "pll":
        return args[:2] + (dq_if_i16(args[2], PH_SCALE),)
    if name == "extract":
        planes = tuple(dq_if_i16(p, IQ_SCALE) for p in args[3])
        return args[:3] + (planes, dq_if_i16(args[4], PH_SCALE))
    raise KeyError(name)


def compare_i16(channels: int = 256, block: int = 131072, blocks: int = 2,
                odd_channels: int = 5, device="cuda"):
    """The int16 format's kernels against their plain versions on the card,
    on the arguments ``demod_block(interstage_i16=True)`` recorded,
    ``blocks`` blocks with carried state: K1 on each of SPLIT_FORMS (the
    int8-direct entry; float32 planes, integer planes and packed words with
    float and int8 taps; int8 planes with float taps), K2 with int16 in and
    out (also with de-emphasis on, on the float planes' fm_demod); on the
    int8-direct form the PLL (int16 theta and dt) and extract on its three
    type combinations (int16 planes and dt as recorded; int16 planes with
    the dequantised dt; both dequantised).  Then the int8-direct form at
    C = ``odd_channels``, whose channel tile the PLL's int16 layout refuses:
    the PLL dequantises and runs in float32, extract takes int16 planes and
    float32 dt.  A mismatch is saved (:func:`dump_mismatch`).  Returns
    (verdict rows by kernel variant with each form's input statistics under
    "inputs"; the dtypes each form's route handed K2, the PLL and extract;
    the C = ``odd_channels`` route's launches)."""
    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.models.demod import (
        demod_block, demod_init_state, make_coeffs)

    stages = _stages()
    acc, stats, routes, odd_launches = {}, {}, {}, {}
    forms = [(label, kind, kw, channels) for label, kind, kw in SPLIT_FORMS]
    forms.append((f"i8_direct_c{odd_channels}", "i8",
                  dict(SPLIT_FORMS[-1][2]), odd_channels))
    for label, kind, kw, c in forms:
        cfg = DemodConfig(interstage_i16=True, **kw)
        co = make_coeffs(cfg, device)
        cfg_de = dataclasses.replace(cfg, use_deemphasis_filter=True,
                                     deemphasis_cutoff_us=50)
        co_de = make_coeffs(cfg_de, device)
        st = demod_init_state(cfg, c, device)
        x = split_input(kind, c, block * blocks, 7, device)
        stats[label] = input_stats(x)
        for blk in range(blocks):
            calls = {}
            xb = x[..., blk * block : (blk + 1) * block].contiguous()
            reset_counts()
            st, _ = demod_block(cfg, co, st, xb, record=calls)
            torch.cuda.synchronize(device)
            if c == odd_channels:
                for k, n in read_counts().items():
                    odd_launches[k] = odd_launches.get(k, 0) + n
            routes[label] = {
                "midend": str(calls["midend"][3].dtype),
                "pll": str(calls["pll"][2].dtype),
                "extract": [str(calls["extract"][3][0].dtype),
                            str(calls["extract"][4].dtype)],
                "kernels": [variant(n, a) for n, a in calls.items()]}
            todo = [(variant(n, calls[n]), calls[n])
                    for n in ("frontend", "frontend_i8", "midend")
                    if n in calls]
            if label == "planes_float":
                todo.append(("midend_i16",
                             (co_de, cfg_de) + calls["midend"][2:]))
            if label.startswith("i8_direct"):
                for n in ("pll", "extract"):
                    todo.append((variant(n, calls[n]), calls[n]))
                if c == channels:
                    ext = calls["extract"]
                    dq = _dq_args("extract", ext)
                    todo += [("extract_i16_f32dt", ext[:4] + dq[4:]),
                             ("extract", dq),
                             ("pll", _dq_args("pll", calls["pll"]))]
            for name, args in todo:
                compare_stage(acc, name, args, stages)
            torch.cuda.synchronize(device)
    rows = [dict(_verdict(name, acc[name]), inputs=stats) for name in acc]
    return rows, routes, odd_launches


def i16_path(channels: int = 2048, block: int = 131072, blocks: int = 8,
             device="cuda") -> dict:
    """The i16 cell (:data:`I16_CELL`) through demod_block with counted
    launches (one warm-up block first); then each int16 kernel timed alone
    beside its plain version on the last block's arguments, and compared
    (and extract on int16 planes with float32 dt, from the same planes and
    the dequantised dt; and K1 on the same signal as packed words, float
    taps, from one counted block of ``DemodConfig(assume_integer_input=
    True, interstage_i16=True)``); and each beside its float32 twin on the
    same values dequantised (:func:`_dq_args`), the kernel alone."""
    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.models.demod import (
        demod_block, demod_init_state, make_coeffs)

    label, kind, kw = I16_CELL
    cfg = DemodConfig(**kw)
    co = make_coeffs(cfg, device)
    st = demod_init_state(cfg, channels, device)
    x = split_input(kind, channels, block, 0, device)
    st, _ = demod_block(cfg, co, st, x)  # warm-up
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
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
    check_counts(launches, {"frontend_i8_i16": blocks, "midend_i16": blocks,
                            "midend_fused": blocks, "pll_i16": blocks,
                            "extract_i16": blocks, "extract_blocked": blocks,
                            "bpsk": blocks},
                 "i16 cell")
    if tuple(outs["audio"].shape) != (channels, block // 32, 2):
        raise RuntimeError(f"i16: audio shape {tuple(outs['audio'].shape)}")
    for k in ("audio", "rds_pred"):
        if not bool(torch.isfinite(outs[k]).all()):
            raise RuntimeError(f"i16: non-finite {k}")
    res = {"cell": label, "config": kw, "input": kind, "channels": channels,
           "block": block, "blocks": blocks, "inputs": input_stats(x),
           "launches": launches, "ms_per_block": ms / blocks,
           "msps": channels * block * blocks / (ms / 1e3) / 1e6,
           "peak_mib": torch.cuda.max_memory_allocated(device) / 2 ** 20}
    cfg_w = DemodConfig(assume_integer_input=True, interstage_i16=True)
    calls_w = {}
    reset_counts()
    demod_block(cfg_w, make_coeffs(cfg_w, device),
                demod_init_state(cfg_w, channels, device),
                split_input("words", channels, block, 0, device),
                record=calls_w)
    torch.cuda.synchronize(device)
    res["launches_words"] = read_counts()
    src = {n: calls[n] for n in ("frontend_i8", "midend", "pll", "extract")}
    src["frontend"] = calls_w["frontend"]
    timed = {variant(n, a): a for n, a in src.items()}
    ext = calls["extract"]
    timed["extract_i16_f32dt"] = ext[:4] + _dq_args("extract", ext)[4:]
    (res["kernel_ms"], res["plain_ms"], res["compare"],
     res["bound"]) = time_stages(timed)
    stages = _stages()
    res["float_twin_ms"] = {}
    for n, a in src.items():
        kern = stages[n][0]
        args = _dq_args(n, a)
        kern(*args)
        res["float_twin_ms"][n] = _cuda_ms(lambda: kern(*args), reps=5)[1]
    return res


def station_i16(device="cuda", seconds: float = 0.5) -> dict:
    """The selftest station (``seconds`` of it, int8 planes) through App
    with ``interstage_i16=True`` (the int8-direct K1 -> K2 -> PLL ->
    extract in the int16 format) on the card and, with the plain versions,
    on the host CPU; and the float32 route (``DemodConfig(
    frontend_int8=True)``: K12) on the card.  RDS bytes and audio SNR of
    the card against the CPU, and of the int16 route against the float32
    one, the PI on each, and each card run's launches."""
    from fm_radio_tpu_torch.apps.cli import selftest_checks, selftest_planes
    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.models.app import App

    block = 65536
    x8 = selftest_planes(seconds, block)
    runs = {}
    for key, dev, kw in (
            ("card_i16", device, {"frontend_int8": True,
                                  "interstage_i16": True}),
            ("cpu_i16", "cpu", {"frontend_int8": True,
                                "interstage_i16": True}),
            ("card_float", device, {"frontend_int8": True})):
        reset_counts()
        t0 = time.perf_counter()
        app = App(block_size=block, cfg=DemodConfig(**kw), channels=1,
                  device=dev)
        app.process(x8)
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize(dev)
        runs[key] = (app, time.perf_counter() - t0, read_counts())
    settle = int(0.15 * runs["card_i16"][0].demod.fs_audio)

    def vs(a, b):
        (ga, _, _), (gb, _, _) = runs[a], runs[b]
        return {"rds_bytes": int(ga.rds_bytes(0).size),
                "rds_identical": bool(np.array_equal(ga.rds_bytes(0),
                                                     gb.rds_bytes(0))),
                "snr_db": _snr_db(ga.audio[0, settle:], gb.audio[0, settle:])}

    return {"seconds_audio": x8.shape[-1] / 1_024_000, "block": block,
            "card_vs_cpu": vs("card_i16", "cpu_i16"),
            "i16_vs_float_route": vs("card_i16", "card_float"),
            "rds_pi": {k: selftest_checks(r[0])["rds_pi"]["value"]
                       for k, r in runs.items()},
            "launches": {k: r[2] for k, r in runs.items() if k != "cpu_i16"},
            "seconds": {k: r[1] for k, r in runs.items()}}


def hbm_phase(device="cuda", mib: int = 256, iters: int = 20) -> dict:
    """The device-memory sweep (probes/hbm_sweep.py) with counted launches;
    then for each probe kernel (the grid copy, the staged copy, the read)
    its fastest variant, its plain version timed once, and one PyTorch call
    of the same function (``Tensor.copy_``; for the read, the sum of every
    column into its lane, ``x.view(-1, 8, 128).sum((0, 1))``, and beside it
    the column reduction ``x.view(-1, 128).sum(0)``) on the same array.
    Returns the sweep with {"kernels": {name: (variant, ms, plain ms,
    library ms, max abs error, bytes, float32 operations)}, "launches"}."""
    from fm_radio_tpu_torch.probes import hbm_sweep as hs

    hs.reset_counts()
    res = hs.sweep(mib, iters, device)
    res["launches"] = {"hbm_copy": hs.launches_copy,
                       "hbm_dma_copy": hs.launches_dma,
                       "hbm_read": hs.launches_read}
    rows = res["array"]["shape"][0]
    g = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((rows, hs.LANES), generator=g, device=device)
    nbytes = x.numel() * 4
    y = torch.empty_like(x)
    _, copy_lib = _cuda_ms(lambda: y.copy_(x), 5)
    _, clone_ms = _cuda_ms(lambda: hs.grid_copy_plain(x, 1, 1), 1)
    kernels = {}
    for name, prefix in (("hbm_copy", "copy:"), ("hbm_dma_copy", "dma")):
        best = max((r for r in res["rows"] if r["kind"] == "copy"
                    and r["variant"].startswith(prefix)),
                   key=lambda r: r["gbps"])
        kernels[name] = {"variant": best["variant"], "ms": best["ms"],
                         "plain_ms": clone_ms, "library_ms": copy_lib,
                         "max_abs_err": 0.0 if best["ok"] else math.inf,
                         "bytes": 2 * nbytes, "f32_ops": 0.0}
    best = max((r for r in res["rows"] if r["variant"].startswith("read:")
                and r["route"] == "cuda"), key=lambda r: r["gbps"])
    bm = int(best["variant"].split(":")[1].split("x")[0])
    kout = hs.read_sum(x, bm)
    pout, plain_ms = _cuda_ms(lambda: hs.read_sum_plain(x, bm), 1)
    # the same function in one call, and the column reduction that stood
    # as the library call before (a pathological reduction over 2 M rows)
    _, read_lib = _cuda_ms(lambda: x.view(-1, 8, 128).sum((0, 1)), 5)
    _, read_lib_cols = _cuda_ms(lambda: x.view(-1, 128).sum(0), 5)
    kernels["hbm_read"] = {
        "variant": best["variant"], "ms": best["ms"], "plain_ms": plain_ms,
        "library_ms": read_lib, "library_ms_view128_sum0": read_lib_cols,
        "max_abs_err": float((kout - pout).abs().max()),
        "bytes": nbytes + 4 * 128, "f32_ops": float(x.numel())}
    res["kernels"] = kernels
    return res


# each kernel's representative row at the default shape (the one timed
# beside its plain version and bound on the kernels line)
PROBE_REP = {"fp_sum": "stream:no=128:f32", "fp_fir": "full:no=128:f32",
             "fp_dbuf": "full:double-buf:tile=8x2048",
             "fp_i8d": "full:i8direct", "fp_i8man": "full:i8man:tile=8x4096",
             "k2_engine": "hilb", "k2_full": "full",
             "k2_restruct": "restruct:128", "k3_stream31": "stream31:t=1024",
             "k3_sum": "stream:t=1024", "k3_value": "value:run=16 (no tile)",
             "k3_full": "full:t=1024"}


def probe_inputs(device) -> dict:
    """The engine probes' inputs at their default shapes (numpy seeds, as
    the probes make them)."""
    from fm_radio_tpu_torch.probes import frontend_probe as fp
    from fm_radio_tpu_torch.probes import k2_probe as k2
    from fm_radio_tpu_torch.probes import k3_probe as k3

    return {"fp": fp.make_inputs(*PROBE_FULL["fp"], device),
            "k2": k2.make_input(*PROBE_FULL["k2"], device),
            "k3": k3.make_inputs(*PROBE_FULL["k3"], device)}


def _probe_work(name: str, inputs: dict, device) -> dict:
    """For one engine-probe kernel at its default shape: its work (bytes
    each input read once and each output written once, float32 and int8
    operations per output from the filters' orders), serial steps, and
    callables for its plain version and, for the per-tile sums, the one
    PyTorch call of the same work."""
    from fm_radio_tpu_torch.probes import frontend_probe as fp
    from fm_radio_tpu_torch.probes import k2_probe as k2
    from fm_radio_tpu_torch.probes import k3_probe as k3

    w = {"serial_steps": None, "library": None, "i8_ops": 0.0}
    if name.startswith("fp"):
        c, b = PROBE_FULL["fp"]
        x = inputs["fp"]
        t_blk = fp.default_tiles(c, b)[1]
        n4 = float(c) * b / 4
        if name == "fp_sum":
            xw = x["f32w"]
            w.update(bytes=4.0 * c * b + 4 * c * (b // t_blk + 128),
                     f32_ops=float(c) * b,
                     plain=lambda: fp.sum_plain(xw, "f32w", False, t_blk),
                     library=lambda: xw.view(c, -1, t_blk).sum(-1))
        elif name in ("fp_fir", "fp_dbuf"):
            xw = x["f32w"]
            w.update(bytes=4.0 * c * b + 4 * n4,
                     f32_ops=n4 * (4 * fp.NN + ATAN2_FLOPS + 5)
                     + 5.0 * c * b,
                     plain=(lambda: fp.fir_plain(xw, "f32w", False, True,
                                                 t_blk))
                     if name == "fp_fir"
                     else lambda: fp.dbuf_plain(xw, True, 2048))
        else:
            x8 = x["u8"]
            plain = ((lambda: fp.i8d_plain(x8, True, t_blk))
                     if name == "fp_i8d"
                     else lambda: fp.i8man_plain(x8, True, 4096))
            w.update(bytes=2.0 * c * b + 4 * n4,
                     f32_ops=n4 * (4 + ATAN2_FLOPS + 5),
                     i8_ops=n4 * 2 * 2 * 2 * fp.NN, plain=plain)
        return w
    if name.startswith("k2"):
        c, b4 = PROBE_FULL["k2"]
        x = inputs["k2"]
        co = k2.coeffs(device)
        l = b4 // 2
        nn2, nh = co.taps_fm_out.shape[0], co.taps_hilbert.shape[0]
        out = 3 * 4.0 * c * l
        mode = PROBE_REP[name]
        per = 2 * nn2 + 2 * nh
        if name == "k2_full":
            per += 5 + 2 * 9 + ATAN2_FLOPS + 1 + 3
            w["serial_steps"] = l
        elif name == "k2_restruct":
            # the function's work is full's (the recurrences need 5 and 2 x
            # 9 operations per output); the blocked design's own in-block
            # sums (li/2 multiply-adds per output on average, 3 chains) are
            # kept apart, outside the bound
            li = int(mode.split(":")[1])
            w["design_f32_ops"] = float(c) * l * (per + 3 * li + 2 * 9
                                                  + ATAN2_FLOPS + 1 + 3)
            per += 5 + 2 * 9 + ATAN2_FLOPS + 1 + 3
            w["serial_steps"] = l // li
        w.update(bytes=4.0 * c * b4 + out + (4 * c if name != "k2_engine"
                                              else 0),
                 f32_ops=float(c) * l * per,
                 plain=lambda: k2.variant_plain(mode, x, 1024, co))
        return w
    c, b8 = PROBE_FULL["k3"]
    xs = inputs["k3"]
    inb = 3 * 4.0 * c * b8
    if name in ("k3_sum", "k3_stream31"):
        mode = "stream" if name == "k3_sum" else "stream31"
        cb = min(c, k3.C_BLK)
        planes = (k3.stack31(xs, cb),) if name == "k3_stream31" else xs
        w.update(bytes=inb + 4 * planes[0].shape[0] * (b8 // 1024)
                 + 4 * c * 128, f32_ops=3.0 * c * b8,
                 plain=lambda: k3.sum_plain(mode, planes, 1024, cb))
        if name == "k3_stream31":
            x3 = planes[0]
            w["library"] = lambda: x3.view(3 * c, -1, 1024).sum(-1)
        return w
    co = k3.coeffs(device)
    w.update(bytes=inb + 4.0 * c * (3 * (b8 // 4) + 2 * (b8 // 8)),
             f32_ops=_ext_flops(co, c, b8),
             plain=lambda: k3.extract_plain(xs, co))
    return w


def probe_phase(device) -> dict:
    """The engine probes (phase 2c): every variant against its plain
    version at the small shapes, then the sections at the default shapes
    with counted launches, each again against its plain version, then each
    kernel's representative row beside its plain version (1 call), the one
    PyTorch call where there is one, and its bound.  Returns {"small":
    rows, "rows": {probe: rows}, "launches", "kernels": {name: numbers}};
    raises if a kernel disagrees with its plain version or a variant of the
    default shapes was not compared at the small ones."""
    from fm_radio_tpu_torch.probes import _probe
    from fm_radio_tpu_torch.probes import chain_probe as cp
    from fm_radio_tpu_torch.probes import frontend_probe as fp
    from fm_radio_tpu_torch.probes import k2_probe as k2
    from fm_radio_tpu_torch.probes import k3_probe as k3

    quiet = lambda r: None
    small = {"fp": fp.run(*PROBE_SMALL["fp"], FP_SECTIONS, 1, device,
                          emit=quiet),
             "k2": k2.run(*PROBE_SMALL["k2"], 1, device, emit=quiet),
             "k3": k3.run(*PROBE_SMALL["k3"], 1, device, emit=quiet)}
    planes = k3.make_inputs(128, 8192, device, seed=1)
    small["k3"].append(_probe.row(
        "chain_probe stream3", "k3_sum", None, 3 * planes[0].numel() * 4,
        _probe.max_err(cp.stream3(planes[:2], planes[2]),
                       k3.sum_plain("stream", planes, 1024, 128)[0])))
    for m in (fp, k2, k3):
        m.reset_counts()
    reset_counts()
    rows = {"fp": fp.run(*PROBE_FULL["fp"], FP_SECTIONS, PROBE_ITERS, device,
                         emit=quiet),
            "k2": k2.run(*PROBE_FULL["k2"], PROBE_ITERS, device, emit=quiet),
            "k3": k3.run(*PROBE_FULL["k3"], PROBE_ITERS, device, emit=quiet)}
    # k3's full is the production extract kernel, counted by its wrapper
    full_launches = read_counts()["extract"]
    rows["chain"] = cp.run(*PROBE_FULL["chain"], "i8", False, True, False, 2,
                           device, emit=quiet)
    rows["chain_unfused"] = cp.run(*PROBE_FULL["unfused"], "planes", True,
                                   False, False, 2, device, emit=quiet)
    launches = {**fp.counts(), **k2.counts(), **k3.counts(),
                "k3_full": full_launches}
    names = {n for n, _, _ in ENGINE_KERNELS}
    errs = {}
    for p in ("fp", "k2", "k3"):
        untested = ({r["variant"] for r in rows[p]}
                    - {r["variant"] for r in small[p]})
        if untested:
            raise RuntimeError(f"{p} probe variants not compared at the "
                               f"small shape: {sorted(untested)}")
        for r in small[p] + rows[p]:
            errs.setdefault(r["kernel"], []).append(r["max_abs_err"])
    # a row with no comparison (None) fails as a disagreement does
    err = {n: None if None in v else max(v) for n, v in errs.items()}
    bad = {n: e for n, e in err.items() if e != 0.0}
    if bad or set(err) != names:
        raise RuntimeError(f"engine probes disagree with their plain "
                           f"versions: {bad}; compared {sorted(err)}")
    kernels = {}
    by_tag = {(p, r["variant"]): r for p in ("fp", "k2", "k3")
              for r in rows[p]}
    inputs = probe_inputs(device)
    for name, _, _ in ENGINE_KERNELS:
        w = _probe_work(name, inputs, device)
        variant = PROBE_REP[name]
        rep = by_tag[(name.split("_")[0], variant)]
        if rep["kernel"] != name:
            raise RuntimeError(f"{name}: representative row {variant} ran "
                               f"{rep['kernel']}")
        _, plain_ms = _cuda_ms(w["plain"], 1)
        lib_ms = None
        if w["library"] is not None:
            w["library"]()
            _, lib_ms = _cuda_ms(w["library"], 5)
        kernels[name] = {"variant": variant, "ms": rep["ms"],
                         "plain_ms": plain_ms, "library_ms": lib_ms,
                         "max_abs_err": err[name],
                         "serial_steps": w["serial_steps"], "w": w}
        if name in READ_ONLY:  # a read faster than the sweep's raises it
            note_read(w["bytes"] / rep["ms"] * 1e3,
                      f"{name} {variant} (phase 2c)")
    for name, k in kernels.items():
        w = k.pop("w")
        k.update(bound_of(w["bytes"], w["f32_ops"], w["i8_ops"],
                          read_only=name in READ_ONLY))
        if "design_f32_ops" in w:
            k["design_f32_ops"] = w["design_f32_ops"]
    return {"small": [dict(r, probe=p) for p, rs in small.items()
                      for r in rs],
            "rows": rows, "launches": launches, "kernels": kernels}


def split_path(label: str, kind: str, kw: dict, channels: int = 2048,
               block: int = 131072, blocks: int = 8, device="cuda") -> dict:
    """One split cell through demod_block with counted launches (one
    warm-up block first), bench.py's signal in the form ``kind`` under
    ``DemodConfig(**kw)``; then K1 and K2 timed alone beside their plain
    versions on the last block's arguments, and compared (complex64 goes
    to K1 as it is: the kernel reads its float pairs in place, which the
    recorded argument shows)."""
    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.kernels.frontend import readable
    from fm_radio_tpu_torch.models.demod import (
        demod_block, demod_init_state, make_coeffs)

    cfg = DemodConfig(**kw)
    co = make_coeffs(cfg, device)
    st = demod_init_state(cfg, channels, device)
    x = split_input(kind, channels, block, 0, device)
    st, _ = demod_block(cfg, co, st, x)  # warm-up
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
    k1 = "frontend_i8" if label == "k12off" else "frontend"
    check_counts(launches, {k1: blocks, "midend": blocks, "pll": blocks,
                            "extract": blocks, "bpsk": blocks,
                            "midend_fused": blocks,
                            "extract_blocked": blocks},
                 f"split cell {label}")
    audio = outs["audio"]
    if tuple(audio.shape) != (channels, block // 32, 2):
        raise RuntimeError(f"{label}: audio shape {tuple(audio.shape)}")
    for k in ("audio", "rds_pred"):
        if not bool(torch.isfinite(outs[k]).all()):
            raise RuntimeError(f"{label}: non-finite {k}")
    x1 = calls[k1][3]
    if x.dtype == torch.complex64 and not (
            x1.dtype == torch.complex64 and x1.data_ptr() == x.data_ptr()
            and readable(x1) is x1):
        raise RuntimeError(f"{label}: K1 was given {x1.dtype} "
                           f"{tuple(x1.shape)}, not the complex64 block it "
                           f"reads in place")
    res = {"cell": label, "config": kw, "input": kind, "channels": channels,
           "block": block, "blocks": blocks, "inputs": input_stats(x),
           "launches": launches, "ms_per_block": ms / blocks,
           "msps": channels * block * blocks / (ms / 1e3) / 1e6,
           "peak_mib": torch.cuda.max_memory_allocated(device) / 2 ** 20}
    (res["kernel_ms"], res["plain_ms"], res["compare"],
     res["bound"]) = time_stages({k: calls[k] for k in (k1, "midend")})
    res["ds4_floors"] = ds4_floors(x1)
    return res


def _profile(label: str, step, blocks: int, device) -> dict:
    """Device time per block of each CUDA kernel (``torch.profiler``) over
    ``blocks`` calls of ``step`` after two warm-up calls, the host wall
    time per block, and the device's idle share (1 - kernel time /
    wall).  A one-element marker kernel runs first inside the profiler's
    window: the profiler records no device time for the first kernel
    launched there (measured: the wideband step, whose first launch is
    the channelizer, showed it at two thirds of its time over 3 blocks).
    The profiler has also dropped one launch's record inside the window
    now and then (a port kernel counted twice in 3 blocks; not on a rerun
    of the same window alone): a window where a port kernel's count is
    not a multiple of ``blocks`` is profiled again, up to three times in
    all, and the row says how many it took and what was still lost."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step()
    torch.cuda.synchronize(device)
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.zeros(1, device=device).add_(1.0)
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            for _ in range(blocks):
                step()
            torch.cuda.synchronize(device)
            wall = (time.perf_counter() - t0) * 1e3 / blocks
        per, lost = {}, {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                us = getattr(e, "self_device_time_total", None)
                if us is None:
                    us = e.self_cuda_time_total
                key = e.key[:60]  # kernels whose names share it are summed
                per[key] = per.get(key, 0.0) + float(us) / 1e3 / blocks
                if "fmt::" in e.key and e.count % blocks:
                    lost[key] = e.count
        if not lost:
            break
    busy = sum(per.values())
    top = dict(sorted(per.items(), key=lambda kv: -kv[1])[:12])
    return {"cell": label, "device_ms_per_block": top,
            "device_busy_ms": busy, "wall_ms": wall,
            "idle_share": 1.0 - busy / wall if busy else None,
            "attempts": attempt, "lost_records": lost}


def profile_split(label: str, kind: str, kw: dict, channels: int = 2048,
                  block: int = 131072, blocks: int = 3,
                  device="cuda") -> dict:
    """:func:`_profile` of a split cell (bench.py's signal in the form
    ``kind`` under ``DemodConfig(**kw)``)."""
    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.models.demod import (
        demod_block, demod_init_state, make_coeffs)

    cfg = DemodConfig(**kw)
    co = make_coeffs(cfg, device)
    state = [demod_init_state(cfg, channels, device)]
    x = split_input(kind, channels, block, 0, device)

    def step():
        state[0], _ = demod_block(cfg, co, state[0], x)

    return _profile(label, step, blocks, device)


def profile_wideband(splits: int, n_captures: int = 64, m: int = 32,
                     block: int = 131072, blocks: int = 3,
                     amp: float = BENCH_AMP, device="cuda") -> dict:
    """:func:`_profile` of the wideband cell (the int8 bridge) with the
    channelizer in mode ``splits``, on captures of amplitude ``amp``."""
    from fm_radio_tpu_torch.kernels.channelizer import make_tables
    from fm_radio_tpu_torch.models.demod import INT8_CONFIG, make_coeffs
    from fm_radio_tpu_torch.models.wideband import (
        wideband_demod_block, wideband_init_state)
    from fm_radio_tpu_torch.parallel.channelizer import make_channelizer_taps

    cfg = INT8_CONFIG
    co = make_coeffs(cfg, device)
    tab = make_tables(make_channelizer_taps(m, 16), m, device)
    state = [wideband_init_state(cfg, m, n_captures, 16, device)]
    x = wideband_words(n_captures, m, block, seed=0, device=device,
                       amp=amp).reshape(n_captures, -1, 128)

    def step():
        state[0], _ = wideband_demod_block(cfg, co, tab, state[0], x, m,
                                           splits=splits)

    return _profile(f"wideband_m{m}_splits{splits}", step, blocks, device)


# the pre-split cell (bench.py's default), profiled as the split cells
PRESPLIT_CELL = ("presplit", "i8", {"frontend_int8": True})
# the fused mid end's kernels (csrc/k12_stages.cuh), which K12 launches on
# the pre-split cell
FUSED_KERNELS = ("k12_mid_fused_kernel", "k12_peak_rec_kernel",
                 "k12_theta_kernel")
# the launches route's ds x2 and Hilbert, and the peak IIR and quantising
# pass the int16 forms took before they moved onto the fused route: none
# runs at the i16 cell
MID_LAUNCHES = ("fir_decimate_kernel", "k12_hilbert_kernel",
                "k12_peak_kernel", "q_i16_kernel")
# the chunked-PLL cell (``python bench.py 256 8``), profiled as the split
# cells at C = 256 x B = 1,048,576, and its kernel
PLL_CHUNKED_CELL = ("pll_chunked", "i8", {"frontend_int8": True,
                                          "pll_time_chunks": 8})
PLL_CHUNKED = "pll_chunked_kernel"
# the redesigned PLL, extract and BPSK kernels (csrc/pll.cu,
# csrc/extract.cu, csrc/bpsk.cu), which the pre-split cell and bench.py's
# wideband lens (splits=1) launch; and the matrix channelizer, which the
# lens launches too
REDESIGNED_KERNELS = ("pll_kernel", "extract_blocked_kernel", "bpsk_kernel")
MAT_KERNEL = "chan_wgmma_kernel"
# the redesigned ds x4 kernels (csrc/k12_stages.cuh, csrc/k12.cu,
# csrc/frontend.cu): K12's first launch and the int8-tap K1 (flat), K12's
# first launch on phase planes, and the float K1's staged tile; the
# launches the split cells no longer make (the second K1 launch, the
# complex64 plane split)
DS4_FLAT = "ds4_i8_blocked_kernel"
DS4_PS = "k12_ds4_ps_blocked_kernel"
K1_TILE = "k1_tile_kernel"
DS4_KERNELS = (DS4_FLAT, DS4_PS, K1_TILE)
K1_DISC = "k12_disc_kernel"
PLANE_COPY = "CatArrayBatchedCopy"
# what each split cell's profile must show
SPLIT_CELL_DS4 = {"f32w": K1_TILE, "complex": K1_TILE, "k12off": DS4_FLAT}
# the ds x4 kernel of each kernel line's entry (the f32w cell's K1: float
# taps)
DS4_OF = {"k12": DS4_FLAT, "k12_ps": DS4_PS, "frontend": K1_TILE,
          "frontend_i8": DS4_FLAT}


def lacking(prof: dict, names) -> list:
    """The kernels of ``names`` that have no device time in the profile
    ``prof`` (:func:`_profile`)."""
    return [k for k in names
            if not any(key.startswith(k) or f"::{k}" in key
                       for key in prof["device_ms_per_block"])]

# the megakernel's forms: (label, input kind, DemodConfig kwargs)
CHAIN_FORMS = (
    ("words", "words", {"assume_integer_input": True,
                        "chain_fusion": "auto"}),
    ("planes", "planes_float", {"chain_fusion": "auto"}),
    ("planes_deemph", "planes_float",
     {"chain_fusion": "auto", "use_deemphasis_filter": True,
      "deemphasis_cutoff_us": 50}),
    ("complex", "complex", {"chain_fusion": "auto"}),
)
# the chain cell and the split cell it is held against
CHAIN_CELL = ("chain_f32w", "words", {"assume_integer_input": True,
                                      "chain_fusion": "auto"})


def compare_chain(channels: int = 256, block: int = 131072, blocks: int = 2,
                  device="cuda"):
    """The megakernel against its plain version on the card, on the
    arguments ``demod_block(chain_fusion="auto")`` recorded, ``blocks``
    blocks with carried state, on each of CHAIN_FORMS (packed words, float32
    planes with de-emphasis off and on, complex64); and BPSK without a gain
    (the megakernel's route) on its recorded arguments.  Returns the verdict
    rows (chain, then BPSK without a gain) with each form's input
    statistics under "inputs"."""
    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.models.demod import (
        demod_block, demod_init_state, make_coeffs)

    stages = _stages()
    acc, stats = {}, {}
    for label, kind, kw in CHAIN_FORMS:
        cfg = DemodConfig(**kw)
        co = make_coeffs(cfg, device)
        st = demod_init_state(cfg, channels, device)
        x = split_input(kind, channels, block * blocks, 5, device)
        stats[label] = input_stats(x)
        for blk in range(blocks):
            calls = {}
            xb = x[..., blk * block : (blk + 1) * block].contiguous()
            st, _ = demod_block(cfg, co, st, xb, record=calls)
            if list(calls) != ["chain", "bpsk"] or calls["bpsk"][3] is not None:
                raise RuntimeError(f"chain form {label}: route {list(calls)}")
            for name in ("chain", "bpsk"):
                kern, plain = stages[name]
                _merge(acc, name, stage_errors(name, kern(*calls[name]),
                                               plain(*calls[name])))
            torch.cuda.synchronize(device)
    return [dict(_verdict("chain", acc["chain"]), inputs=stats),
            dict(_verdict("bpsk", acc["bpsk"]), gain=None)]


def compare_pll_chunked(channels: int = 256, block: int = 1048576,
                        chunks: int = 8, blocks: int = 2,
                        odd_channels: int = 5, device="cuda") -> list[dict]:
    """The chunked PLL against its plain version on the card, on the
    arguments ``demod_block(frontend_int8=True, pll_time_chunks=chunks)``
    recorded after K12, ``blocks`` blocks with carried state of bench.py's
    int8 planes, at ``channels`` and at an odd channel count (C * G lanes
    not a multiple of 32).  Returns one verdict row with the recorded
    theta's statistics under "inputs"."""
    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.models.demod import (
        demod_block, demod_init_state, make_coeffs)

    kern, plain = _stages()["pll_chunked"]
    cfg = DemodConfig(frontend_int8=True, pll_time_chunks=chunks)
    co = make_coeffs(cfg, device)
    acc, stats = {}, {}
    for c in (channels, odd_channels):
        st = demod_init_state(cfg, c, device)
        x = bench_planes(c, block * blocks, seed=6 + c, device=device)
        for blk in range(blocks):
            calls = {}
            xb = x[..., blk * block : (blk + 1) * block].contiguous()
            st, _ = demod_block(cfg, co, st, xb, record=calls)
            if "pll_chunked" not in calls:
                raise RuntimeError(f"chunked PLL not taken: {list(calls)}")
            args = calls["pll_chunked"]
            theta = args[2].double()
            stats[f"c{c}_block{blk}"] = {
                "mean_abs": float(theta.abs().mean()),
                "constant": bool(theta.max() == theta.min())}
            _merge(acc, "pll_chunked",
                   stage_errors("pll_chunked", kern(*args), plain(*args)))
            torch.cuda.synchronize(device)
    return [dict(_verdict("pll_chunked", acc["pll_chunked"]), inputs=stats)]


def chain_path(channels: int = 2048, block: int = 131072, blocks: int = 8,
               vs_split_blocks: int = 2, device="cuda") -> dict:
    """The chain cell (CHAIN_CELL: bench.py's ``FMTPU_BENCH_CHAIN=1
    FMTPU_BENCH_FMT=f32w`` lens) through demod_block with counted launches
    (one warm-up block first); the megakernel timed alone beside its plain
    version on the last block's arguments, and compared; then the same
    words through the f32w split cell from one start state for
    ``vs_split_blocks`` blocks: audio and every state leaf before the RDS
    AGC (max abs difference, expected 0), agc_rds (relative), the BPSK
    decisions that differ and pred where both are valid."""
    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.models.demod import (
        demod_block, demod_init_state, make_coeffs)

    label, kind, kw = CHAIN_CELL
    cfg = DemodConfig(**kw)
    co = make_coeffs(cfg, device)
    st = demod_init_state(cfg, channels, device)
    x = split_input(kind, channels, block, 0, device)
    st, _ = demod_block(cfg, co, st, x)  # warm-up
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
    check_counts(launches, {"chain": blocks, "bpsk": blocks}, "chain cell")
    if tuple(outs["audio"].shape) != (channels, block // 32, 2):
        raise RuntimeError(f"chain: audio shape {tuple(outs['audio'].shape)}")
    for k in ("audio", "rds_pred"):
        if not bool(torch.isfinite(outs[k]).all()):
            raise RuntimeError(f"chain: non-finite {k}")
    res = {"cell": label, "config": kw, "input": kind, "channels": channels,
           "block": block, "blocks": blocks, "inputs": input_stats(x),
           "launches": launches, "ms_per_block": ms / blocks,
           "msps": channels * block * blocks / (ms / 1e3) / 1e6,
           "peak_mib": torch.cuda.max_memory_allocated(device) / 2 ** 20}
    (res["kernel_ms"], res["plain_ms"], res["compare"],
     res["bound"]) = time_stages({"chain": calls["chain"]})

    cfg_s = DemodConfig(assume_integer_input=True)
    st_c = st_s = demod_init_state(cfg, channels, device)
    diff = {"audio": 0.0, "state_before_rds_agc": 0.0, "agc_rds_rel": 0.0,
            "valid_mismatch": 0, "pred": 0.0}
    for _ in range(vs_split_blocks):
        st_c, o_c = demod_block(cfg, co, st_c, x)
        st_s, o_s = demod_block(cfg_s, co, st_s, x)
        pre = [k for k in st_c if k not in ("agc_rds", "bpsk")]
        v = o_c["rds_valid"] & o_s["rds_valid"]
        diff["audio"] = max(diff["audio"], _leaf_max_diff(o_c["audio"],
                                                          o_s["audio"]))
        diff["state_before_rds_agc"] = max(
            diff["state_before_rds_agc"],
            _leaf_max_diff({k: st_c[k] for k in pre},
                           {k: st_s[k] for k in pre}))
        diff["agc_rds_rel"] = max(diff["agc_rds_rel"],
                                  _rel(st_c["agc_rds"], st_s["agc_rds"]))
        diff["valid_mismatch"] += int((o_c["rds_valid"]
                                       != o_s["rds_valid"]).sum())
        diff["pred"] = max(diff["pred"], _max_err(
            [(o_c["rds_pred"][v], o_s["rds_pred"][v])]))
    torch.cuda.synchronize(device)
    res["vs_split_f32w"] = diff
    return res


def _wrapped_dev(a, b):
    """(max, rms) of two phase tracks' difference in cycles, wrapped."""
    d = a.double() - b.double()
    d = (d - torch.round(d)).abs()
    return float(d.max()), float(d.pow(2).mean().sqrt())


def chunked_pll_path(channels: int = 256, block: int = 1048576,
                     chunks: int = 8, blocks: int = 4,
                     device="cuda") -> dict:
    """The chunked-PLL cell (bench.py's ``python bench.py 256 8``: int8
    planes, ``DemodConfig(frontend_int8=True, pll_time_chunks=8)``) and the
    same with G = 1 beside it, each through demod_block with counted
    launches after a warm-up block; then, on the G = 8 run's last recorded
    theta and state, the chunked kernel and the sequential kernel alone
    (serial steps L + W against N), the chunked dt's deviation from the
    sequential one (chunk 0 exact; max and rms over the rest), and the
    chunked kernel timed beside its plain version and compared."""
    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.kernels.pll import (
        pilot_pll_chunked, pilot_pll_theta)
    from fm_radio_tpu_torch.models.demod import (
        demod_block, demod_init_state, make_coeffs)

    x = bench_planes(channels, block, seed=0, device=device)
    res, recorded = {"channels": channels, "block": block, "blocks": blocks,
                     "inputs": plane_stats(x)}, {}
    for g in (chunks, 1):
        cfg = DemodConfig(frontend_int8=True, pll_time_chunks=g)
        co = make_coeffs(cfg, device)
        st = demod_init_state(cfg, channels, device)
        st, _ = demod_block(cfg, co, st, x)  # warm-up
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
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
        pll = "pll_chunked" if g > 1 else "pll"
        check_counts(launches, {"k12": blocks, pll: blocks, "extract": blocks,
                                "bpsk": blocks, "midend_fused": blocks,
                                "extract_blocked": blocks},
                     f"PLL cell G={g}")
        for k in ("audio", "rds_pred"):
            if not bool(torch.isfinite(outs[k]).all()):
                raise RuntimeError(f"PLL cell G={g}: non-finite {k}")
        res[f"g{g}"] = {"launches": launches, "ms_per_block": ms / blocks,
                        "msps": channels * block * blocks / (ms / 1e3) / 1e6,
                        "peak_mib": torch.cuda.max_memory_allocated(device)
                        / 2 ** 20}
        recorded[g] = calls
    args = recorded[chunks]["pll_chunked"]
    cfg, state, theta = args
    seq_cfg = DemodConfig(frontend_int8=True)
    pilot_pll_chunked(*args)
    (_, dt_c), chunked_ms = _cuda_ms(lambda: pilot_pll_chunked(*args), 5)
    pilot_pll_theta(seq_cfg, state, theta)
    (_, dt_s), seq_ms = _cuda_ms(
        lambda: pilot_pll_theta(seq_cfg, state, theta), 5)
    n = theta.shape[-1]
    l = n // chunks
    dev_max, dev_rms = _wrapped_dev(dt_c[:, l:], dt_s[:, l:])
    res["pll_alone"] = {
        "chunked_ms": chunked_ms, "sequential_ms": seq_ms,
        "serial_steps": {"chunked": l + cfg.pll_chunk_warmup,
                         "sequential": n},
        "chunk0_exact": bool(torch.equal(dt_c[:, :l], dt_s[:, :l])),
        "dt_dev_later_chunks": {"max": dev_max, "rms": dev_rms}}
    (res["kernel_ms"], res["plain_ms"], res["compare"],
     res["bound"]) = time_stages({"pll_chunked": args})
    return res


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
        INT8_CONFIG, demod_block, demod_init_state, make_coeffs)
    from fm_radio_tpu_torch.models.wideband import (
        wideband_demod_block, wideband_init_state)
    from fm_radio_tpu_torch.parallel.channelizer import make_channelizer_taps
    from fm_radio_tpu_torch.utils.transfer import unpack_iq_words

    m_ = _modules()
    stages = _stages()
    cfg = INT8_CONFIG
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
            st, _ = wideband_demod_block(cfg, co, tab, st, xb, m, splits=3,
                                         record=calls)
            _, (sr, si), words, _, out, _ = calls["channelizer"]
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


def compare_wideband_f32(block: int = 131072, blocks: int = 2,
                         n_captures: int = 4, m: int = 32, device="cuda"):
    """The float32 bridge under ``DemodConfig()`` against the plain
    versions on the card: ``blocks`` blocks with carried state of W =
    ``n_captures`` loud captures at M, the channelizer (words -> f32), K1
    on the bridged planes and K2 on the arguments ``wideband_demod_block``
    recorded.  Returns verdict rows with the bridged planes' statistics."""
    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.kernels.channelizer import make_tables
    from fm_radio_tpu_torch.models.demod import make_coeffs
    from fm_radio_tpu_torch.models.wideband import (
        wideband_demod_block, wideband_init_state)
    from fm_radio_tpu_torch.parallel.channelizer import make_channelizer_taps

    stages = _stages()
    cfg = DemodConfig()
    co = make_coeffs(cfg, device)
    tab = make_tables(make_channelizer_taps(m), m, device)
    st = wideband_init_state(cfg, m, n_captures, device=device)
    x = wideband_words(n_captures, m, block * blocks, seed=m, device=device,
                       amp=loud_amp(m))
    acc, stats = {}, {}
    for blk in range(blocks):
        calls = {}
        xb = x[:, blk * m * block : (blk + 1) * m * block].contiguous()
        st, _ = wideband_demod_block(cfg, co, tab, st, xb, m, bridge="f32",
                                     record=calls)
        stats = input_stats(calls["frontend"][3])
        for name in ("channelizer", "frontend", "midend"):
            kern, plain = stages[name]
            args = calls[name]
            _merge(acc, name, stage_errors(name, kern(*args), plain(*args)))
        torch.cuda.synchronize(device)
    return [dict(_verdict(name, acc[name]), inputs=stats)
            for name in ("channelizer", "frontend", "midend")]


def compare_channelizer_mat(block: int = 131072, blocks: int = 2,
                            n_captures: int = 4, device="cuda") -> list[dict]:
    """The channelizer's matrix kernels (splits 1 and 2) against their
    plain versions on the card, on the arguments ``wideband_demod_block``
    recorded from W = ``n_captures`` loud captures, ``blocks`` blocks with
    carried state: at M = 32 words -> i8ps (as recorded) and -> f32, at
    M = 16 words -> i8.  Returns one verdict row per kernel, with the
    int8 planes' :func:`plane_stats` (i8ps, i8) under "planes"."""
    from fm_radio_tpu_torch.kernels.channelizer import make_tables
    from fm_radio_tpu_torch.models.demod import INT8_CONFIG, make_coeffs
    from fm_radio_tpu_torch.models.wideband import (
        wideband_demod_block, wideband_init_state)
    from fm_radio_tpu_torch.parallel.channelizer import make_channelizer_taps

    stages = _stages()
    cfg = INT8_CONFIG
    co = make_coeffs(cfg, device)
    acc, stats = {}, {}
    for splits in (1, 2):
        name = CHANNELIZER_BY_SPLITS[splits]
        kern, plain = stages[name]
        for m in (32, 16):
            tab = make_tables(make_channelizer_taps(m), m, device)
            st = wideband_init_state(cfg, m, n_captures, device=device)
            x = wideband_words(n_captures, m, block * blocks, seed=40 + m,
                               device=device, amp=loud_amp(m))
            for blk in range(blocks):
                calls = {}
                xb = x[:, blk * m * block : (blk + 1) * m * block].contiguous()
                st, _ = wideband_demod_block(cfg, co, tab, st, xb, m,
                                             splits=splits, record=calls)
                args = calls["channelizer"]
                if args[5] != splits:
                    raise RuntimeError(f"M={m}: splits={splits} ran as "
                                       f"{args[5]}")
                outs = [args[4]] + (["f32"] if m == 32 else [])
                for out in outs:
                    a = args[:4] + (out, splits)
                    kout, pout = kern(*a), plain(*a)
                    _merge(acc, name, stage_errors(name, kout, pout))
                    if out != "f32":
                        stats.setdefault(name, {})[f"m{m}_{out}_b{blk}"] = (
                            plane_stats(pout[1]))
                torch.cuda.synchronize(device)
    return [dict(_verdict(name, acc[name]), planes=stats[name])
            for name in (CHANNELIZER_BY_SPLITS[1], CHANNELIZER_BY_SPLITS[2])]


def poison_free_memory(device, nbytes: int = 1 << 30) -> None:
    """Fill memory the caching allocator holds free with 0xFF bytes (NaN
    as float32, -1 as int8): one large block and many small ones are
    allocated, filled and released, so that the next ``torch.empty``
    calls return poisoned memory and a kernel that reads an output or
    scratch element it never wrote shows it."""
    big = torch.full((nbytes,), 255, dtype=torch.uint8, device=device)
    small = [torch.full((1 << 19,), 255, dtype=torch.uint8, device=device)
             for _ in range(64)]
    torch.cuda.synchronize(device)
    del big, small


def compare_i8mat_small(seed: int, device="cuda") -> list[dict]:
    """The int8-matrix channelizer against its plain version at a small
    shape: W = 2 captures of T = 32,768 random packed words (every u8
    value) from ``seed``, M = 32, K = 16, out i8ps and f32, two blocks
    with carried state each.  Returns one verdict row."""
    from fm_radio_tpu_torch.kernels import channelizer as kch
    from fm_radio_tpu_torch.parallel.channelizer import make_channelizer_taps

    stages = _stages()
    m, k, t, n_w = 32, 16, 32768, 2
    tab = kch.make_tables(make_channelizer_taps(m, k), m, device)
    rng = np.random.default_rng(seed)
    words = torch.from_numpy(
        rng.integers(0, 256, (n_w, 2 * t)).astype(np.float32) * 256.0
        + rng.integers(0, 256, (n_w, 2 * t)).astype(np.float32)).to(device)
    rows = []
    name = "channelizer_i8mat"
    kern, plain = stages[name]
    acc = {}
    for out in ("i8ps", "f32"):
        st = (torch.zeros((n_w, (k - 1) * m), device=device),) * 2
        for blk in range(2):
            a = (tab, st, words[:, blk * t : (blk + 1) * t].contiguous(),
                 m, out, 1)
            kout, pout = kern(*a), plain(*a)
            e = stage_errors(name, kout, pout)
            dump_mismatch(name, a, kout, pout, e)
            _merge(acc, name, e)
            st = kout[0]
    torch.cuda.synchronize(device)
    return [_verdict(name, acc[name])]


def k12_repeats(repeats: int = 5, channels: int = 8, block: int = 16384,
                device="cuda") -> list[dict]:
    """The small on-card comparison of K12 (and the PLL, extract, BPSK)
    with its plain version, :func:`compare_kernels` at C = ``channels``, B
    = ``block``, both int8-matrix channelizers'
    (:func:`compare_i8mat_small`), the ds x4 kernels' (K12 flat and
    phase-split, K1 on every form: :func:`compare_ds4_edges` at that
    shape) and the megakernel's (against its plain version and the split
    path, :func:`compare_chain_small`), ``repeats`` times on fresh
    seeds, the
    allocator's free memory poisoned before each
    (:func:`poison_free_memory`): the shape at which K12 once disagreed
    with its plain version (PERF.md).  Returns one row per repeat: the
    seed and each kernel's verdict."""
    rows = []
    for i in range(repeats):
        poison_free_memory(device)
        seed = 100 + i
        kernels = compare_kernels(channels, block, 2, device, seed=seed)
        poison_free_memory(device)
        kernels += compare_i8mat_small(seed, device)
        poison_free_memory(device)
        kernels += compare_ds4_edges(device, ((channels, block),), seed=seed)
        poison_free_memory(device)
        kernels.append(compare_chain_small(seed, channels, block,
                                           device=device))
        rows.append({"seed": seed, "kernels": kernels})
    return rows


# the exact channelizer's instantiations (csrc/channelizer.cu: one per
# power of two M in [2, 128], the phase-split form at M = 32) and its edge
# shapes: K = 1 and 17 (no carried state; the largest), T of one tile a
# capture and of three (a grid of W or 3 W CTAs, one tile each), and of
# 384 tiles: W = 3 captures then hold 1,152 tiles, more than the grid of
# any occupancy (at most 8 CTAs of 256 threads an SM), so every CTA of the
# persistent walk takes a second tile, past the barrier at its top, on the
# z buffer that overlays the staging buffer and the tables loaded once
CHAN_EDGE_MS = (2, 4, 8, 16, 32, 64, 128)
CHAN_EDGE_KS = (1, 17)
CHAN_EDGE_TS = (4096, 3 * 4096, 384 * 4096)


def compare_chan_edges(device="cuda", seed: int = 0) -> list[dict]:
    """The exact channelizer against ``channelize_plain`` at every M it is
    instantiated for, at each of CHAN_EDGE_KS and CHAN_EDGE_TS (the
    longest makes every CTA of the grid take several tiles), on W = 3
    captures of random packed words (every u8 value) and of random float
    planes, in every out form, two blocks with the carried state: max abs
    error 0.  Returns one row per case."""
    from fm_radio_tpu_torch.kernels import channelizer as kch
    from fm_radio_tpu_torch.parallel.channelizer import make_channelizer_taps

    kern, plain = _stages()["channelizer"]
    rng = np.random.default_rng(seed)
    n_w, rows = 3, []
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if n_w * max(CHAN_EDGE_TS) // kch.T_MULTIPLE <= 2048 // 256 * sms:
        raise RuntimeError(f"the channelizer's edge shapes do not walk "
                           f"past the grid on {sms} SMs")

    def dev(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    for m in CHAN_EDGE_MS:
        for k in CHAN_EDGE_KS:
            tab = kch.make_tables(make_channelizer_taps(m, k), m, device)
            for t in CHAN_EDGE_TS:
                for packed in (True, False):
                    for out in kch.OUTS if m == 32 else ("f32", "i8"):
                        acc = {}
                        st = tuple(dev(rng.normal(0, 40, (n_w, (k - 1) * m)))
                                   for _ in range(2))
                        for _ in range(2):
                            x = (dev(rng.integers(0, 256, (n_w, t)) * 256
                                     + rng.integers(0, 256, (n_w, t)))
                                 if packed else
                                 tuple(dev(rng.normal(0, 40 * m, (n_w, t)))
                                       for _ in range(2)))
                            a = (tab, st, x, m, out, 3)
                            kout, pout = kern(*a), plain(*a)
                            e = stage_errors("channelizer", kout, pout)
                            dump_mismatch("channelizer", a, kout, pout, e)
                            _merge(acc, "channelizer", e)
                            st = kout[0]
                        v = _verdict("channelizer", acc["channelizer"])
                        rows.append(dict(v, m=m, k=k, t=t, packed=packed,
                                         out=out))
    torch.cuda.synchronize(device)
    return rows


# filter orders off the megakernel's blocked stages (ds x4 and the extract
# FIRs then sum each output by itself)
CHAIN_OTHER_ORDERS = {"order_poly_ds_lpf_fm_out": 48,
                      "order_poly_ds_lpf_audio": 96,
                      "order_poly_ds_lpf_rds": 96}


def compare_chain_small(seed: int, channels: int = 8, block: int = 16384,
                        blocks: int = 2, device="cuda",
                        orders: dict | None = None) -> dict:
    """The megakernel on CHAIN_CELL's configuration (with ``orders``, those
    filter orders) at C = ``channels``, B = ``block``: against its plain
    version on the arguments ``demod_block`` recorded, and the same packed
    words through the f32w split path (K1 -> K2 -> PLL -> extract kernels)
    from one start state, ``blocks`` blocks: audio and every state leaf
    before the RDS AGC.  Returns one verdict row (max abs error 0 on both
    counts)."""
    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.models.demod import (
        demod_block, demod_init_state, make_coeffs)

    _, kind, kw = CHAIN_CELL
    cfg = DemodConfig(**kw, **(orders or {}))
    cfg_s = DemodConfig(assume_integer_input=True, **(orders or {}))
    co = make_coeffs(cfg, device)
    st_c = st_s = demod_init_state(cfg, channels, device)
    x = split_input(kind, channels, block * blocks, seed, device)
    acc, vs = {}, 0.0
    for blk in range(blocks):
        xb = x[..., blk * block : (blk + 1) * block].contiguous()
        calls = {}
        st_c, o_c = demod_block(cfg, co, st_c, xb, record=calls)
        st_s, o_s = demod_block(cfg_s, co, st_s, xb)
        if "chain" not in calls:
            raise RuntimeError(f"chain not taken at C = {channels}: "
                               f"{list(calls)}")
        compare_stage(acc, "chain", calls["chain"])
        pre = [k for k in st_c if k not in ("agc_rds", "bpsk")]
        vs = max(vs, _leaf_max_diff(o_c["audio"], o_s["audio"]),
                 _leaf_max_diff({k: st_c[k] for k in pre},
                                {k: st_s[k] for k in pre}))
    torch.cuda.synchronize(device)
    row = _verdict("chain", acc["chain"])
    row.update(channels=channels, block=block, vs_split_f32w=vs,
               orders=orders, ok=row["ok"] and vs == 0.0)
    return row


def chain_cell_checked(channels: int = 2048, block: int = 131072,
                       device="cuda") -> dict:
    """One block of CHAIN_CELL at full width on the bounds-checked build
    (every index of the megakernel's global loads and stores checked; a
    trap fails the run): the megakernel against its plain version on the
    arguments ``demod_block`` recorded, and against the f32w split path on
    the same words (audio and the state before the RDS AGC), on poisoned
    memory.  Returns one verdict row."""
    from fm_radio_tpu_torch.kernels import _build

    poison_free_memory(device)
    with _build.checked_build():
        row = compare_chain_small(7, channels, block, 1, device)
    return dict(row, build="checked")


def allocator_counts(device) -> dict:
    """The caching allocator's counters on ``device``: its cudaMalloc and
    cudaFree calls, its retries (a cudaMalloc that failed, after which it
    frees every cached block and tries again), and the GiB it reserves
    and the GiB of it that live tensors hold."""
    s = torch.cuda.memory_stats(device)
    return {"device_allocs": s.get("num_device_alloc", 0),
            "device_frees": s.get("num_device_free", 0),
            "alloc_retries": s.get("num_alloc_retries", 0),
            "reserved_gib": s.get("reserved_bytes.all.current", 0) / 2 ** 30,
            "allocated_gib": s.get("allocated_bytes.all.current", 0) / 2 ** 30}


def chan_floor(args) -> dict:
    """The exact channelizer's issue floor on its recorded arguments, ms:
    4K + 8M float32 operations an input sample, each its own FMUL or FADD
    (-fmad=false) at 128 a clock an SM, at the SM count and highest SM
    clock of this card."""
    tab, state, xp, m = args[:4]
    x0 = xp[0] if isinstance(xp, tuple) else xp
    k = tab.w_rev.shape[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    hz = _sm_clock_hz()
    ops = float(x0.numel()) * (4 * k + 8 * m)
    return {"fmul_fadd_ms": ops / (128 * sms * hz) * 1e3, "ops": ops,
            "sms": sms, "sm_clock_hz": hz}


def wideband_path(n_captures: int = 64, m: int = 32, block: int = 131072,
                  blocks: int = 8, amp: float = BENCH_AMP,
                  time_kernels: bool = True, bridge: str = "i8",
                  splits: int = 3, time_bpsk: bool = False,
                  library: bool = True, device="cuda") -> dict:
    """The wideband cell through wideband_demod_block with counted
    launches (one warm-up block first), on captures of per-channel
    amplitude ``amp``, the channelizer in mode ``splits``: each block's
    time by CUDA events and the caching allocator's counters over the
    timed blocks (:func:`allocator_counts`); the
    :func:`plane_stats` of the last block's int8 bridge output; then, if
    ``time_kernels``, the channelizer and the phase-split K12 (at M=32)
    timed alone beside their plain versions on the last block's
    arguments, and compared (with ``library``, also the product alone as
    one PyTorch call, :func:`mat_library_ms`; a matrix mode's operator
    bytes);
    with ``time_bpsk``, :func:`bpsk_alone` on the last block's BPSK
    arguments.  ``bridge="f32"`` runs the float32 bridge under
    ``DemodConfig()`` (K1 on planes, then K2).  The exact mode's kernel
    also has its issue floor (:func:`chan_floor`)."""
    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.kernels.channelizer import (
        make_tables, wgmma_operator_bytes)
    from fm_radio_tpu_torch.models.demod import INT8_CONFIG, make_coeffs
    from fm_radio_tpu_torch.models.wideband import (
        wideband_demod_block, wideband_init_state)
    from fm_radio_tpu_torch.parallel.channelizer import make_channelizer_taps

    cfg = INT8_CONFIG if bridge == "i8" else DemodConfig()
    co = make_coeffs(cfg, device)
    tab = make_tables(make_channelizer_taps(m, 16), m, device)
    st = wideband_init_state(cfg, m, n_captures, 16, device)
    # the pre-flattened [W, T/128, 128] view that bench.py passes
    x = wideband_words(n_captures, m, block, seed=0, device=device, amp=amp)
    x = x.reshape(n_captures, -1, 128)
    st, _ = wideband_demod_block(cfg, co, tab, st, x, m, bridge=bridge,
                                 splits=splits)  # warm-up
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)

    calls = {}
    alloc = allocator_counts(device)
    reset_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(blocks + 1)]
    ev[0].record()
    for i in range(blocks):
        st, outs = wideband_demod_block(cfg, co, tab, st, x, m,
                                        bridge=bridge, splits=splits,
                                        record=calls)
        ev[i + 1].record()
    torch.cuda.synchronize(device)
    launches = read_counts()
    ms = ev[0].elapsed_time(ev[-1])
    after = allocator_counts(device)
    alloc = {k: (after[k] if k.endswith("_gib") else after[k] - alloc[k])
             for k in after} | {"reserved_gib_before": alloc["reserved_gib"],
                                "allocated_gib_before": alloc["allocated_gib"]}
    ps = m == 32 and bridge == "i8"
    chan = CHANNELIZER_BY_SPLITS[calls["channelizer"][5]]
    want = {chan: blocks, "pll": blocks, "extract": blocks, "bpsk": blocks,
            "midend_fused": blocks, "extract_blocked": blocks}
    if bridge == "f32":
        want.update(frontend=blocks, midend=blocks)
    else:
        want["k12_ps" if ps else "k12"] = blocks
    check_counts(launches, want, f"wideband path (M={m}, {bridge} bridge, "
                                 f"splits={splits})")
    c = n_captures * m
    audio = outs["audio"]
    if tuple(audio.shape) != (c, block // 32, 2):
        raise RuntimeError(f"wideband audio shape {tuple(audio.shape)}")
    for k in ("audio", "rds_pred"):
        if not bool(torch.isfinite(outs[k]).all()):
            raise RuntimeError(f"wideband: non-finite {k}")
    bridged = calls["frontend" if bridge == "f32" else
                    "k12_ps" if ps else "k12"][3]
    res = {"m": m, "captures": n_captures, "channels": c, "block": block,
           "blocks": blocks, "amp": amp, "bridge": bridge,
           "splits": splits, "channelizer": chan,
           "planes": (input_stats(bridged) if bridge == "f32"
                      else plane_stats(bridged)),
           "launches": launches,
           "ms_per_block": ms / blocks,
           "block_ms": [a.elapsed_time(b) for a, b in zip(ev, ev[1:])],
           "allocator": alloc,
           "msps": c * block * blocks / (ms / 1e3) / 1e6,
           "peak_mib": torch.cuda.max_memory_allocated(device) / 2 ** 20}
    if time_kernels:
        timed = {chan: calls["channelizer"]}
        if ps:
            timed["k12_ps"] = calls["k12_ps"]
        (res["kernel_ms"], res["plain_ms"], res["compare"],
         res["bound"]) = time_stages(timed)
        if ps:
            res["ds4_floors"] = ds4_floors(calls["k12_ps"][3])
        if chan == "channelizer":
            res["chan_floor"] = chan_floor(calls["channelizer"])
        if library:
            res["library_ms"] = mat_library_ms(calls["channelizer"])
        if chan in ("channelizer_i8mat", "channelizer_bf16mat"):
            tab, _, words, m, _, sp = calls["channelizer"]
            res["operator_bytes"] = wgmma_operator_bytes(
                words.shape[0], words.numel() // words.shape[0],
                tab.w_rev.shape[0], m, sp)
    if time_bpsk:
        res["bpsk_alone"] = bpsk_alone(calls["bpsk"])
    return res


def _sass(lib: str):
    """(the SASS of a built library by cuobjdump -sass, None), or (None,
    the reason) where the toolkit has no cuobjdump."""
    from fm_radio_tpu_torch.kernels import _build

    exe = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    if not os.path.isfile(exe):
        return None, f"no cuobjdump beside {_build.nvcc()}"
    so = str(_build.build_dir() / f"lib{lib}.so")
    return subprocess.run([exe, "-sass", so], capture_output=True,
                          text=True, timeout=120).stdout, None


def sass_counts(lib: str = "channelizer_wgmma") -> dict:
    """Counts of the warpgroup MMA (HGMMA float, IGMMA integer), the
    warp-level integer MMA (IMMA, mma.sync) and bulk-copy (UTMALDG tensor,
    UBLKCP plain) instructions in a built library's SASS, or {"error"}
    where the toolkit has no cuobjdump."""
    sass, err = _sass(lib)
    if err:
        return {"error": err}
    ops = _opcodes(sass)
    return {op: ops.count(op)
            for op in ("HGMMA", "IGMMA", "IMMA", "UTMALDG", "UBLKCP")}


def _opcodes(sass: str) -> list:
    """The opcode (without its modifiers) of every instruction of SASS
    text, in order (a guard predicate @P0 skipped)."""
    ops = []
    for ln in sass.splitlines():
        text = ln.split("*/", 1)[1] if ln.strip().startswith("/*") else ""
        words = text.split(";", 1)[0].split()
        if words and words[0].startswith("@"):
            words = words[1:]
        if words:
            ops.append(words[0].split(".")[0])
    return ops


def compare_wgmma_edges(device="cuda") -> list[dict]:
    """The matrix kernel (wgmma) in both modes against its plain version at
    its edge shapes: T = 16,384 (one tile of 128 columns, the smallest T
    the kernel takes) on W = 1 (one tile, one CTA) and W = 3, M = 32, K =
    16, all three output forms, two blocks with carried state, on random
    packed words (every u8 value).  Returns one verdict row per mode and
    W."""
    from fm_radio_tpu_torch.kernels import channelizer as kch
    from fm_radio_tpu_torch.parallel.channelizer import make_channelizer_taps

    stages = _stages()
    m, k, t = 32, 16, kch.WGMMA_TILE
    tab = kch.make_tables(make_channelizer_taps(m, k), m, device)
    rows = []
    for name, sp in (("channelizer_i8mat", 1), ("channelizer_bf16mat", 2)):
        kern, plain = stages[name]
        rng = np.random.default_rng(11)
        for n_w in (1, 3):
            words = torch.from_numpy(
                rng.integers(0, 256, (n_w, 2 * t)).astype(np.float32) * 256.0
                + rng.integers(0, 256, (n_w, 2 * t)).astype(np.float32)).to(
                    device)
            acc = {}
            for out in ("i8ps", "f32", "i8"):
                st = (torch.zeros((n_w, (k - 1) * m), device=device),) * 2
                for blk in range(2):
                    xb = words[:, blk * t : (blk + 1) * t].contiguous()
                    a = (tab, st, xb, m, out, sp)
                    kout, pout = kern(*a), plain(*a)
                    e = stage_errors(name, kout, pout)
                    dump_mismatch(name, a, kout, pout, e)
                    _merge(acc, name, e)
                    st = kout[0]
            torch.cuda.synchronize(device)
            rows.append(dict(_verdict(name, acc[name]), captures=n_w, t=t))
    return rows


# K2's formats at the fused mid end's edges: (row label, kernel name,
# in_i16, out_i16)
MID_EDGE_FORMS = (("midend", "midend", False, False),
                  ("midend_in_i16", "midend_i16", True, False),
                  ("midend_out_i16", "midend_i16", False, True),
                  ("midend_i16_both", "midend_i16", True, True))


def compare_mid_edges(device="cuda") -> dict:
    """K12 (flat and phase-split) and K2 on their fused route against the
    plain versions at edge shapes, two blocks with carried state, bench
    planes (K2 on fm_demod drawn as N(0, 0.3^2), float32 or int16 at
    FM_SCALE): C = 40 (not a multiple of the peak IIR's 8 channels a
    block) at B = 512 (the smallest block whose carried tails the fused
    route holds: one partial tile), 8,192 (one whole tile of 1024 outputs)
    and 8,320 (a whole tile and a partial one); K2 in its four formats
    (:data:`MID_EDGE_FORMS`), each launch counted on the fused route; and
    the host's route (kernels/midend.py::midend_route) against the C
    entry's (fmt_midend_route) over de-emphasis, filter orders and
    block lengths.  Returns {"rows": verdict rows (K2's with their
    "form"), "route_mismatch": [...], "not_fused": K2 calls that did not
    count as fused launches}."""
    from fm_radio_tpu_torch.kernels import _build
    from fm_radio_tpu_torch.kernels import k12 as kk
    from fm_radio_tpu_torch.kernels import midend as km
    from fm_radio_tpu_torch.kernels.qformat import FM_SCALE, q_i16
    from fm_radio_tpu_torch.models.demod import (
        INT8_CONFIG, demod_init_state, make_coeffs)

    cfg = INT8_CONFIG
    co = make_coeffs(cfg, device)
    acc, not_fused = {}, []
    c = 40
    g = torch.Generator(device=device).manual_seed(7)
    cases = [("k12", "k12", kk.k12, kk.k12_plain, False),
             ("k12_ps", "k12_ps", kk.k12_ps, kk.k12_ps_plain, False)]
    cases += [(label, name, km.midend, km.midend_plain, (in16, out16))
              for label, name, in16, out16 in MID_EDGE_FORMS]
    for b in (512, 8192, 8320):
        if km.midend_route(co, cfg, b // 4) != "fused":
            raise RuntimeError(f"B = {b} does not take the fused route")
        st = {label: demod_init_state(cfg, c, device)
              for label, *_ in cases}
        x = bench_planes(c, 2 * b, seed=5, device=device)
        for blk in range(2):
            xb = x[:, :, blk * b : (blk + 1) * b].contiguous()
            x4 = xb.reshape(2, c, b // 4, 4).permute(0, 3, 1, 2).contiguous()
            fmd = 0.3 * torch.randn((c, b // 4), generator=g, device=device)
            for label, name, fn, plain, fmt in cases:
                if name == "k12":
                    args = (co, cfg, st[label], xb)
                elif name == "k12_ps":
                    args = (co, cfg, st[label], x4)
                else:
                    in16, out16 = fmt
                    arg = q_i16(fmd, FM_SCALE) if in16 else fmd
                    args = (co, cfg, st[label], arg, out16)
                fused = km.launches_fused
                kout = fn(*args)
                if fmt and km.launches_fused != fused + 1:
                    not_fused.append((label, b))
                pout = plain(*args)
                e = stage_errors(I16_BASE.get(name, name), kout, pout)
                dump_mismatch(name, args, kout, pout, e)
                _merge(acc, label, e)
                st[label] = kout[0]
        torch.cuda.synchronize(device)
    fn = _build.function("midend", "fmt_midend_route", km.ROUTE_ARGTYPES)
    bad = []
    for de, cd in ((False, co), (True, make_coeffs(dataclasses.replace(
            cfg, use_deemphasis_filter=True, deemphasis_cutoff_us=50),
            device))):
        cf = dataclasses.replace(cfg, use_deemphasis_filter=de,
                                 deemphasis_cutoff_us=50)
        for nn2, nh in ((64, 65), (48, 65), (64, 33)):
            cx = cd._replace(taps_fm_out=cd.taps_fm_out[:nn2],
                             taps_hilbert=cd.taps_hilbert[:nh])
            for n4 in (64, 96, 128, 4096, 32768):
                host = km.midend_route(cx, cf, n4)
                card = fn(int(de), nn2, nh, n4)
                if (host == "fused") != (card == 1):
                    bad.append((de, nn2, nh, n4, host, card))
    rows = [dict(_verdict(name, acc[label]), form=label)
            for label, name, *_ in cases]
    return {"rows": rows, "route_mismatch": bad, "not_fused": not_fused}


def _pll_theta(c: int, n: int, seed: int, device):
    """A pilot phase track [c, n] (cycles) the loop can lock on: a 19 kHz
    ramp at the PLL's rate with a per-channel offset and small noise,
    wrapped to [-0.5, 0.5), made on the card from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    i = torch.arange(n, device=device, dtype=torch.float64)
    ramp = (i * (19000.0 / 16000.0)).remainder(1.0)[None]
    off = torch.rand((c, 1), generator=g, device=device, dtype=torch.float64)
    x = (ramp + off + 0.01 * torch.randn((c, n), generator=g, device=device,
                                         dtype=torch.float64))
    return (x - torch.round(x)).float()


def compare_pll_edges(device="cuda",
                      steps=(16, 32, 48, 16384)) -> list[dict]:
    """The sequential PLL kernel (``kernels/pll.py::pilot_pll_seq``) against
    its plain version at edge shapes, max abs error 0: C = 40 and 5 (not a
    multiple of its 8 lanes a block) at N = 16, 32 and 48 (fewer batches
    than the three it keeps in flight) and 16,384 (the cell's), or the N of
    ``steps``, on float32 theta and on int16 theta and dt, two blocks with
    carried state each.  Returns one verdict row per (form, C, N)."""
    from fm_radio_tpu_torch.kernels import pll as kp
    from fm_radio_tpu_torch.kernels.qformat import PH_SCALE, q_i16
    from fm_radio_tpu_torch.models.demod import INT8_CONFIG
    from fm_radio_tpu_torch.models.pilot_pll import pilot_pll_init_state

    cfg = INT8_CONFIG
    rows = []
    for c in (40, 5):
        for n in steps:
            th = _pll_theta(c, 2 * n, seed=c + n, device=device)
            for form in ("pll", "pll_i16"):
                x = q_i16(th, PH_SCALE) if form == "pll_i16" else th
                st = pilot_pll_init_state(c, device)
                acc = {}
                for blk in range(2):
                    xb = x[:, blk * n : (blk + 1) * n].contiguous()
                    a = (cfg, st, xb)
                    kout, pout = kp.pilot_pll_seq(*a), kp.pll_plain(*a)
                    e = stage_errors("pll", kout, pout)
                    dump_mismatch(form, a, kout, pout, e)
                    _merge(acc, form, e)
                    st = kout[0]
                torch.cuda.synchronize(device)
                rows.append(dict(_verdict(form, acc[form]), channels=c,
                                 steps=n, dt_dtype=str(kout[1].dtype)))
    return rows


# the chunked PLL's edge shapes: chunk counts G, warm-ups W and chunk
# lengths L (a multiple of the kernel's 16-step batch and not; W = 4,096
# with the two past it, where the gate admits it: L > W)
PLL_CHUNK_EDGE_GS = (2, 4, 8)
PLL_CHUNK_EDGE_WLS = {0: (48, 37), 7: (48, 37), 4096: (4112, 4099)}


def compare_pll_chunked_edges(device="cuda",
                              channels=(5, 40)) -> list[dict]:
    """The chunked PLL kernel (``kernels/pll.py::pilot_pll_chunked``)
    against its plain version at edge shapes, max abs error 0: C = 5 and
    40 (lanes C * G not a multiple of its 8 lanes a block; flat arrays
    whose length is not a multiple of its 16-step batch), G =
    :data:`PLL_CHUNK_EDGE_GS`, each W of :data:`PLL_CHUNK_EDGE_WLS` with
    its chunk lengths L (windows that start off the batch grid, chunks
    whose kept range shares a batch with the next), two blocks with
    carried state on a pilot track the loop locks on.  Returns one verdict
    row per (C, G, W, L)."""
    from fm_radio_tpu_torch.kernels import pll as kp
    from fm_radio_tpu_torch.models.demod import INT8_CONFIG
    from fm_radio_tpu_torch.models.pilot_pll import pilot_pll_init_state

    rows = []
    for c in channels:
        for g in PLL_CHUNK_EDGE_GS:
            for w, ls in PLL_CHUNK_EDGE_WLS.items():
                for l in ls:
                    cfg = dataclasses.replace(INT8_CONFIG, pll_time_chunks=g,
                                              pll_chunk_warmup=w)
                    n = g * l
                    if not kp.chunk_gate(cfg, n):
                        raise RuntimeError(f"G = {g}, W = {w}, L = {l} fail "
                                           f"the chunk gate")
                    th = _pll_theta(c, 2 * n, seed=c + g + w + l,
                                    device=device)
                    st = pilot_pll_init_state(c, device)
                    acc = {}
                    for blk in range(2):
                        a = (cfg, st, th[:, blk * n : (blk + 1) * n]
                             .contiguous())
                        kout = kp.pilot_pll_chunked(*a)
                        pout = kp.pll_chunked_plain(*a)
                        e = stage_errors("pll_chunked", kout, pout)
                        dump_mismatch("pll_chunked", a, kout, pout, e)
                        _merge(acc, "pll_chunked", e)
                        st = kout[0]
                    torch.cuda.synchronize(device)
                    rows.append(dict(_verdict("pll_chunked",
                                              acc["pll_chunked"]),
                                     channels=c, chunks=g, warmup=w,
                                     chunk_len=l, steps=n))
    return rows


def _extract_state(cfg, co, c: int, g: torch.Generator, device) -> dict:
    """``demod_init_state`` with extract's carried tails (matching the
    filters of ``co``) and L-R offset drawn from ``g``."""
    from fm_radio_tpu_torch.models.demod import demod_init_state

    st = demod_init_state(cfg, c, device)

    def tail(n):
        return torch.complex(*(0.3 * torch.randn((c, n), generator=g,
                                                 device=device)
                               for _ in range(2)))

    st["ds_audio_lpr"] = tail(co.taps_audio_lpr.shape[0] - 4)
    st["ds_audio_lmr"] = tail(co.taps_audio_lmr.shape[0] - 4)
    st["ds_rds"] = tail(co.taps_rds.shape[0] - 8)
    st["lmr_phase_err"] = torch.rand((c,), generator=g, device=device) - 0.5
    return st


def _extract_inputs(form: str, c: int, n: int, g: torch.Generator, device):
    """(re, im), dt [c, n] of ``form`` ("extract", "extract_i16" or
    "extract_i16_f32dt"): N(0, 0.25) planes and dt uniform in [-0.5, 0.5),
    quantised where the form is int16."""
    from fm_radio_tpu_torch.kernels.qformat import IQ_SCALE, PH_SCALE, q_i16

    re, im = (0.5 * torch.randn((c, n), generator=g, device=device)
              for _ in range(2))
    dt = torch.rand((c, n), generator=g, device=device) - 0.5
    if form != "extract":
        re, im = q_i16(re, IQ_SCALE), q_i16(im, IQ_SCALE)
    if form == "extract_i16":
        dt = q_i16(dt, PH_SCALE)
    return (re, im), dt


def compare_extract_edges(device="cuda") -> dict:
    """Extract against its plain version at edge shapes, max abs error 0
    (the RDS power within POWER_RTOL: the plain version sums it in another
    order), two blocks with carried state from random tails, on random
    planes and dt: C = 40 at N = 1,024 (one tile, whose halo is all
    carried tail) and 2,048, on its three forms (float32; int16 planes and
    dt; int16 planes and float32 dt), on the receiver's filters (the
    blocked route) and on filters of other orders within the halos (64
    taps for L+R and L-R, 96 for RDS: the tiled route), each call's route
    read on the counters; and the C entry's route
    (``fmt_extract_route``) against its host copy
    (``kernels/extract.py::extract_route``) over filter orders.  Returns
    {"rows": verdict rows, "route_mismatch": [...]}."""
    from fm_radio_tpu_torch.kernels import _build
    from fm_radio_tpu_torch.kernels import extract as ke
    from fm_radio_tpu_torch.models.demod import INT8_CONFIG, make_coeffs

    cfg = INT8_CONFIG
    co = make_coeffs(cfg, device)
    g = torch.Generator(device=device).manual_seed(13)

    def taps(nn):
        t = torch.rand((nn,), generator=g, device=device)
        return t / t.sum()

    co_other = co._replace(taps_audio_lpr=taps(64), taps_audio_lmr=taps(64),
                           taps_rds=taps(96))
    c = 40
    rows = []
    for label, cx in (("blocked", co), ("tiled", co_other)):
        if ke.extract_route(cx) != label:
            raise RuntimeError(f"extract: {label} filters take the "
                               f"{ke.extract_route(cx)} route")
        for n in (1024, 2048):
            for form in ("extract", "extract_i16", "extract_i16_f32dt"):
                st = _extract_state(cfg, cx, c, g, device)
                acc = {}
                for blk in range(2):
                    a = (cx, cfg, st, *_extract_inputs(form, c, n, g, device))
                    before = ke.launches_blocked
                    kout = ke.extract(*a)
                    pout = ke.extract_plain(*a)
                    took = ("blocked" if ke.launches_blocked > before
                            else "tiled")
                    if took != label:
                        raise RuntimeError(f"extract {form} at C = {c}, N = "
                                           f"{n}: took the {took} route, not "
                                           f"{label}")
                    e = stage_errors("extract", kout, pout)
                    dump_mismatch(form, a, kout, pout, e)
                    _merge(acc, form, e)
                    st = kout[0]
                torch.cuda.synchronize(device)
                rows.append(dict(_verdict(form, acc[form]), route=label,
                                 channels=c, samples=n))
    fn = _build.function("extract", "fmt_extract_route", ke.ROUTE_ARGTYPES)
    bad = []
    for nn_a in (64, 124, 128, 132):
        for nn_r in (64, 96, 128, 136):
            cx = co._replace(taps_audio_lpr=co.taps_audio_lpr.new_zeros(nn_a),
                             taps_rds=co.taps_rds.new_zeros(nn_r))
            host, card = ke.extract_route(cx), fn(nn_a, nn_r)
            if (host == "blocked") != (card == 1):
                bad.append((nn_a, nn_r, host, card))
    return {"rows": rows, "route_mismatch": bad}


def pll_sass() -> dict:
    """The PLL kernels' SASS: each function (the sequential kernel's two
    forms, the chunked kernel) saved as chiprun_out/pll_sass_<form>.txt
    (the loop's dependent chain is read from there, PERF.md), and its
    counts of the opcodes the steps run; {"error"} where the toolkit has
    no cuobjdump."""
    sass, err = _sass("pll")
    if err:
        return {"error": err}
    res, usage = {}, _res_usage("pll")
    for part in sass.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if "pll_chunked_kernel" in name:
            form = "chunked"
        elif "pll_kernel" in name:
            form = ("i16" if "IsE" in name.split("pll_kernel", 1)[1][:4]
                    else "f32")
        else:
            continue
        os.makedirs(DUMP_DIR, exist_ok=True)
        with open(os.path.join(DUMP_DIR, f"pll_sass_{form}.txt"), "w") as f:
            f.write(part)
        ops = _opcodes(part)
        res[form] = {"function": name, "instructions": len(ops),
                     **{op: ops.count(op) for op in (
                         "FADD", "FMUL", "FMNMX", "FRND", "LDG", "STG")},
                     "res_usage": usage.get(name)}
    return res


def _res_usage(lib: str) -> dict:
    """Registers (and stack and local memory bytes: spills) of each kernel
    of a built library by ``cuobjdump -res-usage``, keyed by mangled name;
    {} where the toolkit has no cuobjdump."""
    from fm_radio_tpu_torch.kernels import _build

    exe = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    if not os.path.isfile(exe):
        return {}
    so = str(_build.build_dir() / f"lib{lib}.so")
    out = subprocess.run([exe, "-res-usage", so], capture_output=True,
                         text=True, timeout=120).stdout
    res, name = {}, None
    for ln in out.splitlines():
        if "Function" in ln:
            name = ln.split("Function", 1)[1].strip().rstrip(":").strip()
        elif name and "REG:" in ln:
            kv = dict(w.split(":", 1) for w in ln.split() if ":" in w)
            res[name] = {"reg": int(kv.get("REG", -1)),
                         "stack": int(kv.get("STACK", -1)),
                         "local": int(kv.get("LOCAL", -1))}
            name = None
    return res


def bpsk_sass() -> dict:
    """BPSK's SASS, as :func:`pll_sass` reads the PLL's: the kernel's
    function saved as chiprun_out/bpsk_sass.txt (the loop's dependent
    chain, and the branch around the divisions, are read from there:
    PERF.md); the counts of the opcodes the steps run over the unrolled
    loop body and the registers a thread; {"error"} where the toolkit has
    no cuobjdump."""
    sass, err = _sass("bpsk")
    if err:
        return {"error": err}
    usage = _res_usage("bpsk")
    res = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if "bpsk_kernel" not in name:
            continue
        os.makedirs(DUMP_DIR, exist_ok=True)
        with open(os.path.join(DUMP_DIR, "bpsk_sass.txt"), "w") as f:
            f.write(part)
        ops = _opcodes(part)
        res = {"function": name, "instructions": len(ops),
               **usage.get(name, {}),
               **{op: ops.count(op) for op in (
                   "FADD", "FMUL", "FFMA", "FMNMX", "FRND", "FSETP", "FSEL",
                   "MUFU", "VOTE", "BRA", "CALL", "LDG", "STG")}}
    return res


def _bpsk_inputs(kind: str, c: int, n: int, g: torch.Generator, device):
    """(re, im) [c, n] for BPSK: "random" a BPSK-like baseband (N(0, 0.5)
    on both axes) or "zeros"."""
    if kind == "zeros":
        return (torch.zeros((c, n), device=device),
                torch.zeros((c, n), device=device))
    return tuple(0.5 * torch.randn((c, n), generator=g, device=device)
                 for _ in range(2))


def compare_bpsk_edges(device="cuda",
                       steps=(16, 32, 48, 2048)) -> list[dict]:
    """BPSK (``kernels/bpsk.py::bpsk_sync``) against its plain version at
    edge shapes, max abs error 0 and no ``valid`` apart: C = 40 and 5 (not
    a multiple of its lanes a block; the last warp partial) at N = 16, 32
    and 48 (fewer batches than it keeps in flight) and 2,048 (the cell's),
    or the N of ``steps``; with a gain and without; on random input and on
    zeros; two blocks with carried state each.  Returns one verdict row
    per (C, N, gain, input)."""
    from fm_radio_tpu_torch.kernels import bpsk as kb
    from fm_radio_tpu_torch.models.bpsk import bpsk_init_state
    from fm_radio_tpu_torch.models.demod import INT8_CONFIG

    cfg = INT8_CONFIG
    g = torch.Generator(device=device).manual_seed(17)
    rows = []
    for c in (40, 5):
        for n in steps:
            for kind in ("random", "zeros"):
                xr, xi = _bpsk_inputs(kind, c, 2 * n, g, device)
                for with_gain in (True, False):
                    gain = (0.5 + 1.5 * torch.rand((c,), generator=g,
                                                   device=device)
                            if with_gain else None)
                    st = bpsk_init_state(c, device)
                    acc = {}
                    for blk in range(2):
                        sl = slice(blk * n, (blk + 1) * n)
                        a = (cfg, st, (xr[:, sl].contiguous(),
                                       xi[:, sl].contiguous()), gain)
                        kout, pout = kb.bpsk_sync(*a), kb.bpsk_plain(*a)
                        e = stage_errors("bpsk", kout, pout)
                        dump_mismatch("bpsk", a, kout, pout, e)
                        _merge(acc, "bpsk", e)
                        st = kout[0]
                    torch.cuda.synchronize(device)
                    rows.append(dict(_verdict("bpsk", acc["bpsk"]),
                                     channels=c, steps=n, input=kind,
                                     gain=with_gain))
    return rows


def bpsk_alone(args, reps: int = 20) -> dict:
    """BPSK on a cell's recorded arguments (cfg, state, (re, im), gain):
    its input's statistics (the share of samples exactly zero, the mean
    |x|, the gain's range and the share of steps the TED clock fires), and
    the kernel timed (CUDA events, mean of ``reps`` after one) on the
    arguments and on zeros of their shape (with their gain)."""
    from fm_radio_tpu_torch.kernels import bpsk as kb

    cfg, state, (xr, xi), gain = args
    valid = kb.bpsk_sync(*args)[1]["valid"]
    x = torch.stack([xr, xi])
    res = {"channels": xr.shape[0], "steps": xr.shape[1],
           "zero_share": float((x == 0).double().mean()),
           "mean_abs": float(x.abs().double().mean()),
           "gain_range": (None if gain is None else
                          [float(gain.min()), float(gain.max())]),
           "fire_share": float(valid.double().mean())}
    _, res["ms"] = _cuda_ms(lambda: kb.bpsk_sync(*args), reps)
    zargs = (cfg, state, (torch.zeros_like(xr), torch.zeros_like(xi)), gain)
    kb.bpsk_sync(*zargs)
    _, res["ms_zeros"] = _cuda_ms(lambda: kb.bpsk_sync(*zargs), reps)
    return res


def _ds4_state(cfg, co, c: int, g: torch.Generator, device) -> dict:
    """``demod_init_state`` with a random carried ds x4 tail (u8 - 127
    integers, as an integer capture leaves it) and discriminator phase."""
    from fm_radio_tpu_torch.models.demod import demod_init_state

    st = demod_init_state(cfg, c, device)
    t = (torch.randint(0, 256, (2,) + tuple(st["ds_fm_in"].shape),
                       generator=g, device=device).float() - 127.0)
    st["ds_fm_in"] = torch.complex(t[0], t[1])
    st["disc_prev_theta"] = (torch.rand((c,), generator=g, device=device)
                             * 6.0 - 3.0)
    return st


def _k1_inputs(u8: torch.Tensor) -> dict:
    """Every K1 load form of the u8 values [2, C, B] (float32): float32
    planes (also off the u8 grid), packed words, complex64, int8 planes."""
    off = torch.sin(u8 * 0.37) * 0.49
    return {"planes": u8 - 127.0, "planes_off_grid": u8 - 127.0 + off,
            "words": u8[0] * 256.0 + u8[1],
            "complex": torch.complex(u8[0] - 127.0, u8[1] - 127.0),
            "i8": (u8 - 128.0).to(torch.int8)}


# (C, B[, K1's other B]) of the ds x4 edges: C = 1 and odd C; the
# smallest block (two tiles of 1,024 outputs); a last tile of 32 outputs
# (K1 also at B + 4: a last tile of one output, rows of an odd length);
# C = 40 at B = 16,384
DS4_EDGES = ((1, 8192), (5, 8192), (5, 8320, 8324), (40, 16384))


def compare_ds4_edges(device="cuda", shapes=DS4_EDGES,
                      seed: int = 11) -> list[dict]:
    """The redesigned ds x4 kernels against their plain versions at edge
    shapes, max abs error 0, two blocks with carried state each (a random
    carried tail and phase to start; full-range u8 input): K12 and K12
    phase-split whole; K1 on every load form with float and int8 taps,
    float32 and int16 stores; the int8-direct K1 in both stores.  Returns
    one verdict row per (kernel, form, C, B)."""
    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.models.demod import INT8_CONFIG, make_coeffs

    stages = _stages()
    cfg12, cfg1 = INT8_CONFIG, DemodConfig()
    co12, co1 = make_coeffs(cfg12, device), make_coeffs(cfg1, device)
    g = torch.Generator(device=device).manual_seed(seed)
    rows = []
    for c, b, *more in shapes:
        st0 = _ds4_state(cfg12, co12, c, g, device)
        u8 = torch.randint(0, 256, (2, c, 2 * b + 8), generator=g,
                           device=device).float()
        acc = {}
        # K12 whole, flat and phase-split
        st = {"k12": st0, "k12_ps": st0}
        for blk in range(2):
            xb = (u8[:, :, blk * b : (blk + 1) * b] - 128.0).to(
                torch.int8).contiguous()
            x4 = xb.reshape(2, c, b // 4, 4).permute(0, 3, 1, 2).contiguous()
            for name, x in (("k12", xb), ("k12_ps", x4)):
                kout, _ = compare_stage(acc, name, (co12, cfg12, st[name], x),
                                        stages)
                st[name] = kout[0]
        torch.cuda.synchronize(device)
        for key, e in acc.items():
            rows.append(dict(_verdict(key, e), case=key, channels=c,
                             samples=b))
        # K1, every form; the int8-direct K1
        xs = _k1_inputs(u8)
        for bk in (b, *more):
            cases = [(f"frontend{'_i16' if i16 else ''}", form, x, (i8t, i16))
                     for form, x in xs.items() for i8t in (False, True)
                     for i16 in (False, True) if not (form == "i8" and i8t)]
            cases += [(f"frontend_i8{'_i16' if i16 else ''}", "i8",
                       xs["i8"], (i16,)) for i16 in (False, True)]
            for name, form, x, flags in cases:
                e, s1 = {}, st0
                for blk in range(2):
                    xb = x[..., blk * bk : (blk + 1) * bk].contiguous()
                    kout, _ = compare_stage(e, name,
                                            (co1, cfg1, s1, xb, *flags),
                                            stages)
                    s1 = kout[0]
                taps = "int8" if name.startswith("frontend_i8") or flags[0] \
                    else "float"
                rows.append(dict(_verdict(name, e[name]),
                                 case=f"{name}:{form}:{taps}_taps",
                                 channels=c, samples=bk))
            torch.cuda.synchronize(device)
    return rows


# the K1 probe's edge shapes (C, B): fp_fir at the shortest tile (512:
# eight rows a CTA, two a warp), the longest the sections take (4,096) and
# a longer one (8,192: a row's tile in two CTAs, the second's difference
# from the theta before it), c_blk 1 and 16; fp_dbuf at those and at its
# sections' tiles, with one buffer and two (a tile that does not fit is
# refused before any launch)
FP_EDGE_SHAPE = (16, 16384)
FP_EDGE_TILES = ((1, 512), (16, 512), (1, 4096), (16, 4096), (2, 8192))
DBUF_EDGE_TILES = ((1, 512), (16, 512), (1, 4096), (4, 4096), (16, 1024),
                   (8, 2048), (2, 8192), (16, 4096))


def compare_fp_edges(device="cuda", seed: int = 5) -> list[dict]:
    """The K1 probe's staged FIR kernels against their plain versions at
    the edge shapes, max abs error 0: fp_fir on every ingest form, float
    and int8 taps, dots and full, rows and tile-major, both rasters, at
    each tile of FP_EDGE_TILES; fp_dbuf dots and full with one and two
    buffers at each tile of DBUF_EDGE_TILES that fits
    (``frontend_probe.dbuf_layout`` on the card: the C side's formula; one
    that does not must be refused); and that C side against its host copy
    over tiles and buffers.  Returns one row per case (kernel, case, max_abs_err, ok)."""
    from fm_radio_tpu_torch.probes import frontend_probe as fp

    c, b = FP_EDGE_SHAPE
    inp = fp.make_inputs(c, b, device, seed=seed)
    tb = fp.tables(device)
    rows = []

    def row(kernel, case, kout, pout):
        e = float((kout - pout).abs().max())
        rows.append({"kernel": kernel, "case": case, "max_abs_err": e,
                     "ok": e == 0.0})

    for c_blk, t_blk in FP_EDGE_TILES:
        for form in fp.FORMS:
            for tm in (False, True):
                x = fp.tile_major(inp[form], form, t_blk) if tm else inp[form]
                for int8 in (False, True):
                    for full in (False, True):
                        pout = fp.fir_plain(x, form, int8, full, t_blk, tm,
                                            tb=tb)
                        for raster in (0, 1):
                            kout = fp.fir(x, form, int8, full, c_blk, t_blk,
                                          tm, raster, tb)
                            row("fp_fir", f"{'full' if full else 'dots'}:"
                                f"{form}:{'int8' if int8 else 'f32'}:tile="
                                f"{c_blk}x{t_blk}:{'TM' if tm else 'rows'}:"
                                f"raster={raster}", kout, pout)
    xw = inp["f32w"]
    for c_blk, t_blk in DBUF_EDGE_TILES:
        for full in (False, True):
            pout = fp.dbuf_plain(xw, full, t_blk, tb)
            for nbuf in (1, 2):
                case = (f"{'full' if full else 'dots'}:nbuf={nbuf}:tile="
                        f"{c_blk}x{t_blk}")
                if fp.dbuf_layout(c_blk, t_blk, nbuf, device)["smem"] \
                        > fp.SMEM_BYTES:
                    try:
                        fp.dbuf(xw, full, c_blk, t_blk, nbuf, tb)
                        refused = False
                    except ValueError:
                        refused = True
                    rows.append({"kernel": "fp_dbuf", "case": case,
                                 "refused": refused, "max_abs_err": None,
                                 "ok": refused})
                    continue
                row("fp_dbuf", case, fp.dbuf(xw, full, c_blk, t_blk, nbuf,
                                             tb), pout)
    torch.cuda.synchronize(device)
    for c_blk in (1, 2, 3, 4, 8, 16, 32):
        for t_blk in (512, 1024, 2048, 4096, 8192, 16384, 32768):
            for nbuf in (1, 2):
                host = fp.dbuf_layout(c_blk, t_blk, nbuf)
                card = fp.dbuf_layout(c_blk, t_blk, nbuf, device)
                same = host == card
                rows.append({"kernel": "fp_dbuf_layout",
                             "case": f"tile={c_blk}x{t_blk}:nbuf={nbuf}",
                             "host": host, "card": card, "max_abs_err": None,
                             "ok": same})
    return rows


# the streaming probe kernels' edge cases (compare_stream_edges): the tile
# sums at (C, B, c_blk) shapes whose items are fewer than the persistent
# grid's warps, and many more with a partial last round; at every tile
# length the lane loop is compiled for (1,024-4,096) and two it is not
STREAM_EDGE_SHAPES = ((16, 8192, 8), (1000, 16384, 40))
STREAM_EDGE_TBLKS = (512, 1024, 2048, 4096, 8192)


def compare_stream_edges(device="cuda", seed: int = 7) -> list[dict]:
    """The redesigned streaming probe kernels against their plain versions
    at their edges, max abs error 0, outputs poisoned with NaN first: the
    staged copy (``hbm_sweep.dma_copy``) on every dma variant at 5 chunks
    (fewer than its issuers) and at 2.5 rounds of them plus one (the last
    round partial), with the C side's plan against its host copy; the
    tile sums on every K1-probe form, stream and unpack, rows and
    tile-major, both rasters, and k3's four modes, at STREAM_EDGE_SHAPES x
    STREAM_EDGE_TBLKS.  One row a case (kernel, case, max_abs_err, ok)."""
    from fm_radio_tpu_torch.probes import _probe
    from fm_radio_tpu_torch.probes import frontend_probe as fp
    from fm_radio_tpu_torch.probes import hbm_sweep as hs
    from fm_radio_tpu_torch.probes import k3_probe as k3

    rows = []

    def row(kernel, case, kout, pout, **kw):
        e = _probe.max_err(kout, pout)
        rows.append({"kernel": kernel, "case": case, "max_abs_err": e,
                     "ok": e == 0.0, **kw})

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    g = torch.Generator(device=device).manual_seed(seed)
    for kib in hs.DMA_CHUNKS_KIB:
        for nbuf in (1, 2):
            chunk = kib * 1024
            if nbuf * chunk > hs.DMA_SMEM:
                continue
            _, per_cta = hs.dma_plan(chunk, chunk, nbuf, sms)
            issuers = sms * per_cta
            for n_chunks in (5, 2 * issuers + issuers // 2 + 1):
                nbytes = n_chunks * chunk
                plan = hs.dma_plan(nbytes, chunk, nbuf, sms)
                x = torch.randn((nbytes // (4 * hs.LANES), hs.LANES),
                                generator=g, device=device)
                y = torch.full_like(x, math.nan)
                row("hbm_dma_copy", f"dma{nbuf}:{kib}KiB:chunks={n_chunks}",
                    hs.dma_copy(x, chunk, nbuf, out=y), x, plan=plan,
                    plan_card=hs.dma_plan_card(nbytes, chunk, nbuf, sms))
                rows[-1]["ok"] &= rows[-1]["plan"] == rows[-1]["plan_card"]
                del x, y

    def poisoned(c, rows_, t_blk, b):
        return (torch.full((c, 128), math.nan, device=device),
                torch.full((rows_, b // t_blk), math.nan, device=device))

    for c, b, c_blk in STREAM_EDGE_SHAPES:
        inp = fp.make_inputs(c, b, device, seed=seed)
        xs = k3.make_inputs(c, b, device, seed=seed)
        x3 = k3.stack31(xs, c_blk)
        for t_blk in STREAM_EDGE_TBLKS:
            if b % t_blk:
                continue
            shape = f"C={c}:B={b}:tile={c_blk}x{t_blk}"
            for form in fp.FORMS:
                for tm in (False, True):
                    x = fp.tile_major(inp[form], form, t_blk) if tm \
                        else inp[form]
                    for unpack in (False, True):
                        pout = fp.sum_plain(x, form, unpack, t_blk, tm)
                        for raster in (0, 1):
                            kout = fp.tile_sum(
                                x, form, unpack, c_blk, t_blk, tm, raster,
                                out=poisoned(c, c, t_blk, b))
                            row("fp_sum", f"{'unpack' if unpack else 'stream'}"
                                f":{form}:{'TM' if tm else 'rows'}:raster="
                                f"{raster}:{shape}", kout, pout)
            for mode in ("stream1", "stream", "phasor", "stream31"):
                planes = (x3,) if mode == "stream31" else xs
                rows_ = 3 * c if mode == "stream31" else c
                kout = k3.tile_sum(mode, planes, t_blk, c_blk,
                                   out=poisoned(c, rows_, t_blk, b))
                row("k3_stream31" if mode == "stream31" else "k3_sum",
                    f"{mode}:{shape}", kout,
                    k3.sum_plain(mode, planes, t_blk, c_blk))
        del inp, xs, x3
    torch.cuda.synchronize(device)
    return rows


# the K2 probe's block recurrences at their edges (compare_k2_edges): (C,
# blocks a channel): one block, a ragged last chunk (35: 32 + 3 de-emphasis
# and stk blocks, 16 + 16 + 3 of the peak's), a chunk cut short, whole
# chunks
K2_EDGE_SHAPES = ((1, 1), (3, 35), (1, 17), (3, 64))


def compare_k2_edges(device="cuda", seed: int = 3) -> list[dict]:
    """restruct:li[:stk] (k2_deemph_block_kernel, k2_peak_block_kernel, and
    the ds x2 and Hilbert launches between them) against its plain version
    at every compiled li, both forms, at K2_EDGE_SHAPES, the outputs filled
    with NaN first, max abs error 0 on each of re, im, theta and power; and
    the layout's C side against its host copy for every li and kind.  One
    row a case (kernel, case, max_abs_err, ok)."""
    from fm_radio_tpu_torch.probes import _probe
    from fm_radio_tpu_torch.probes import k2_probe as k2

    co = k2.coeffs(device)
    rows = []
    for li in k2.LI:
        mats = k2.block_mats(li, device, co)
        for c, nblk in K2_EDGE_SHAPES:
            x = k2.make_input(c, 2 * li * nblk, device, seed=seed + nblk)
            pout = k2.restruct_plain(x, li, co, mats)
            for stk in ("", ":stk"):
                mode = f"restruct:{li}{stk}"
                out = (*(torch.full((c, li * nblk), math.nan, device=device)
                         for _ in range(3)),
                       torch.full((c,), math.nan, device=device))
                kout = k2.variant(mode, x, 1024, co, mats, out=out)
                errs = [_probe.max_err(a, b) for a, b in zip(kout, pout)]
                rows.append({"kernel": "k2_restruct",
                             "case": f"{mode}:C={c}:blocks={nblk}",
                             "max_abs_err": max(errs),
                             "errs_re_im_theta_power": errs,
                             "ok": all(e == 0.0 for e in errs)})
            del x, pout
        for kind in k2.BLOCK_KINDS:
            host = k2.block_layout(li, kind)
            card = k2.block_layout(li, kind, device)
            rows.append({"kernel": "k2_block_layout",
                         "case": f"li={li}:{kind}", "host": host,
                         "card": card, "max_abs_err": None,
                         "ok": host == card})
    torch.cuda.synchronize(device)
    return rows


def restruct_floor(c: int, l: int, li: int, sms: int | None = None,
                   hz: float | None = None) -> dict:
    """restruct:li's two block kernels' FMUL+FADD issue floor, ms
    (computed, not measured): an output of the de-emphasis costs li + 1
    (its in-block sum: (li + 1) / 2 multiply-adds on average, each an FMUL
    and an FADD under -fmad=false) and 4 for the carries; of the peak IIR
    li + 1 and 8 for each of its two chains, ATAN2_FLOPS for theta and 3
    for the power; at 128 a clock an SM, at this card's SM count and
    highest SM clock (or those given)."""
    if sms is None:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
    if hz is None:
        hz = _sm_clock_hz()
    per = {"deemph": li + 1 + 4,
           "peak": 2 * (li + 1 + 8) + ATAN2_FLOPS + 3}
    rate = 128.0 * sms * hz
    ms = {k: float(c) * l * v / rate * 1e3 for k, v in per.items()}
    return {"fmul_fadd_floor_ms": ms["deemph"] + ms["peak"],
            "deemph_ms": ms["deemph"], "peak_ms": ms["peak"],
            "instructions_an_output": per, "li": li, "sms": sms,
            "sm_clock_hz": hz}


def fp_floor(c: int, b: int, nn: int = 132) -> dict:
    """The K1 probe FIR's issue floor, ms (computed, not measured): nn
    FMUL and nn FADD on each of the two planes an output (-fmad=false), at
    128 a clock an SM, at this card's SM count and highest SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    hz = _sm_clock_hz()
    out = float(c) * b / 4
    return {"fmul_fadd_floor_ms": out * 4 * nn / (128 * sms * hz) * 1e3,
            "instructions_an_output": 4 * nn, "sms": sms, "sm_clock_hz": hz}


def _sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


# clocks a dependent float32 instruction takes on this card: the PLL's
# chain read from its SASS, 17 dependent instructions in 68 clocks a step
# (PERF.md)
DEP_CLOCKS = 4


def peak_floor(n8: int) -> dict:
    """The peak IIR recurrence's chain floor, ms (computed, not measured):
    n8 steps of one biquad's dependent chain y1 * a1 -> f - . -> . - y2 *
    a2, three float32 operations (-fmad=false) at DEP_CLOCKS each (the two
    planes run side by side, the power's double sum beside them), at this
    card's highest SM clock."""
    hz = _sm_clock_hz()
    return {"chain_floor_ms": n8 * 3 * DEP_CLOCKS / hz * 1e3, "steps": n8,
            "sm_clock_hz": hz}


def ds4_floors(x: torch.Tensor) -> dict:
    """The ds x4 stage's issue floors on a recorded input x (flat [.., C,
    B], or int8 phase planes [2, 4, C, B/4]), ms: 64 IDP4A an output
    (both int8 tap planes, both IQ planes, 16 words each) at 64 a clock
    an SM; the float taps' 64 FMUL and 64 FADD a plane (-fmad=false) at
    128 a clock an SM; at the SM count and highest SM clock of this card."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    hz = _sm_clock_hz()
    ps = x.ndim == 4 and x.dtype == torch.int8
    out = float(x.shape[-2]) * (x.shape[-1] if ps else x.shape[-1] // 4)
    return {"idp4a_ms": out * 64 / (64 * sms * hz) * 1e3,
            "fmul_fadd_ms": out * 256 / (128 * sms * hz) * 1e3,
            "sms": sms, "sm_clock_hz": hz}


def ds4_sass() -> dict:
    """The redesigned ds x4 kernels' SASS (``cuobjdump -sass``): each
    library's ds x4 functions saved as chiprun_out/ds4_sass_<lib>.txt, and
    for each function its instruction count, the counts of IDP4A (``IDP``),
    FFMA, FMUL, FADD, LDS, STS and LDG, its registers and its stack and
    local bytes (spills); {"error"} where the toolkit has no cuobjdump."""
    res = {}
    for lib in ("k12", "frontend"):
        sass, err = _sass(lib)
        if err:
            return {"error": err}
        usage = _res_usage(lib)
        keep = []
        for part in sass.split("Function : ")[1:]:
            name = part.split("\n", 1)[0].strip()
            if not any(k in name for k in DS4_KERNELS):
                continue
            keep.append(part)
            ops = _opcodes(part)
            res[name] = {"lib": lib, "instructions": len(ops),
                         **usage.get(name, {}),
                         **{op: ops.count(op) for op in (
                             "IDP", "FFMA", "FMUL", "FADD", "LDS", "STS",
                             "LDG")}}
        os.makedirs(DUMP_DIR, exist_ok=True)
        with open(os.path.join(DUMP_DIR, f"ds4_sass_{lib}.txt"), "w") as f:
            f.write("Function : " + "Function : ".join(keep))
    return res


def ds4_sass_faults(sass: dict) -> list:
    """What the SASS read forbids: an FFMA in the float K1's sums (they are
    rounded apart, -fmad=false), no IDP4A in an int8-tap kernel, and any
    spill (stack or local bytes) in a ds x4 kernel.  atan2_poly's IEEE
    division refines its MUFU.RCP with FFMAs (exact by construction), so
    the float K1 may hold as many FFMAs as the int8-tap kernel with the
    same store (the same atan2 and discriminator, no float sum), and no
    more."""
    if "error" in sass:
        return []
    bad = []
    for name, r in sass.items():
        if K1_TILE in name:
            store = name.partition("Ds4Disc")[2][:3]
            div = [q["FFMA"] for n, q in sass.items()
                   if DS4_FLAT in n and q["lib"] == "frontend"
                   and n.partition("Ds4Disc")[2][:3] == store]
            if not div or r["FFMA"] > min(div):
                bad.append((name, "FFMA beyond the division's", r["FFMA"],
                            div))
        if K1_TILE not in name and not r["IDP"]:
            bad.append((name, "no IDP4A"))
        if r.get("stack", 0) > 0 or r.get("local", 0) > 0:
            bad.append((name, "spills", r.get("stack"), r.get("local")))
    if not any(K1_TILE in n for n in sass) or not any(DS4_PS in n
                                                       for n in sass):
        bad.append(("ds4 kernels missing from the SASS", sorted(sass)))
    return bad


def mat_library_ms(args, reps: int = 5) -> dict:
    """The matrix channelizer's product alone as one PyTorch call, on the
    recorded arguments (tables, state, words, M, out, splits), with its B
    operand expanded beforehand (not timed): column j of capture w is the
    128 n_c ring samples from 128 j, so X [W*J, 128 n_c] is a strided view
    of the ring copied once.  splits 1: ``torch._int_mm`` of [X_r; X_i]
    (int8, u8 - 128) and [A_re; A_im], the four integer products in one
    call; splits 2: ``torch.bmm`` of the three Karatsuba planes (bf16) and
    their matrices; splits 3 (the exact mode): the same ``torch.bmm`` in
    float32, TF32 off, on the exact fused operators
    (``kernels/channelizer.py::fused_operators``).  Each in both operand
    orders (X A^T and A X^T), the faster one reported as "ms".  The product alone, not the function: no
    unpacking, no epilogue, no output form.  Returns {"ms", "call",
    "by_order", "shape"} or {"ms": None, "error"}."""
    from fm_radio_tpu_torch.kernels import channelizer as kch

    tab, state, words, m, out, splits = args
    if splits == 3:  # the fused operators in float32 (re, im, re + im)
        mats = np.swapaxes(np.stack(kch.fused_operators(
            tab.taps, m, out != "f32")), 2, 3)
        mats = torch.from_numpy(np.ascontiguousarray(
            np.concatenate([mats, mats[:1] + mats[1:]]), np.float32)).to(
                words.device)
    else:
        mats = kch.quant_tables(tab, splits, out).mats
    n_c = mats.shape[1]
    k = state[0].shape[-1] // m + 1
    res = {"what": "the product alone, not the function"}
    with torch.no_grad():
        rings, _ = kch._mat_ring(state, words, m, k)
        n_w, cols = rings[0].shape[0], rings[0].shape[1] - (n_c - 1)

        def expand(r):  # [W, J + n_c - 1, 128] -> [W*J, 128 n_c]
            return torch.as_strided(r, (n_w, cols, 128 * n_c),
                                    (r.stride(0), 128, 1)).reshape(
                                        n_w * cols, 128 * n_c)

        # A as [planes, 128 (o), 128 n_c (c, s)]
        a = mats.permute(0, 2, 1, 3).reshape(mats.shape[0], 128, -1)
        try:
            if splits == 1:
                x = torch.cat([expand((r - 1.0).to(torch.int8))
                               for r in rings])
                a2 = torch.cat([a[0], a[1]])
                at = a2.t().contiguous()
                del rings
                call = "torch._int_mm"
                orders = {"x_at": lambda: torch._int_mm(x, at),
                          "a_xt": lambda: torch._int_mm(a2, x.t())}
            else:
                xr, xi = rings
                dt = torch.float32 if splits == 3 else torch.bfloat16
                x = torch.stack([expand(v.to(dt)) for v in (xr, xi, xr + xi)])
                at = a.transpose(1, 2).contiguous()
                del rings, xr, xi
                call = "torch.bmm"
                orders = {"x_at": lambda: torch.bmm(x, at),
                          "a_xt": lambda: torch.bmm(a, x.transpose(1, 2))}
            res.update(call=call, shape=[list(x.shape), list(a.shape)],
                       dtype=str(x.dtype), by_order={})
            # float32 products in full float32 (no TF32), as the kernel sums
            tf32 = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
            res["allow_tf32"] = False
            try:
                for name, fn in orders.items():
                    try:
                        fn()
                        res["by_order"][name] = _cuda_ms(fn, reps)[1]
                    except RuntimeError as e:
                        res["by_order"][name] = f"refused: {str(e)[:200]}"
                    torch.cuda.empty_cache()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = tf32
            times = [v for v in res["by_order"].values()
                     if isinstance(v, float)]
            res["ms"] = min(times) if times else None
        except (RuntimeError, torch.cuda.OutOfMemoryError) as e:
            res.update(ms=None, error=str(e)[:300])
        x = a = a2 = at = mats = None
        torch.cuda.empty_cache()
    return res


def main_path(channels: int = 2048, block: int = 131072, blocks: int = 8,
              device="cuda") -> dict:
    """The bench cell through demod_block, with counted launches; then each
    kernel and its plain version, timed alone on the arguments
    ``demod_block`` gave that kernel in the last block, and compared."""
    from fm_radio_tpu_torch.models.demod import (
        INT8_CONFIG, demod_block, demod_init_state, make_coeffs)

    cfg = INT8_CONFIG
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
                            "bpsk": blocks, "k12_ps": 0, "channelizer": 0,
                            "midend_fused": blocks,
                            "extract_blocked": blocks},
                 "pre-split main path")
    audio = outs["audio"]
    if tuple(audio.shape) != (channels, block // 32, 2):
        raise RuntimeError(f"audio shape {tuple(audio.shape)}")
    for k in ("audio", "rds_pred"):
        if not bool(torch.isfinite(outs[k]).all()):
            raise RuntimeError(f"non-finite {k}")

    kernel_ms, plain_ms, rows, bounds = time_stages(calls)
    return {
        "launches": launches,
        "ms_per_block": ms / blocks,
        "msps": channels * block * blocks / (ms / 1e3) / 1e6,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "compare": rows,
        "bound": bounds,
        "bpsk_alone": bpsk_alone(calls["bpsk"]),
        "ds4_floors": ds4_floors(calls["k12"][3]),
    }


def station(device="cuda") -> dict:
    """The selftest station through the port's App on the card and,
    with the plain versions, on the host CPU."""
    from fm_radio_tpu_torch.apps.cli import (
        power_ceil, selftest_checks, selftest_planes)
    from fm_radio_tpu_torch.models.app import App
    from fm_radio_tpu_torch.models.demod import INT8_CONFIG

    block = power_ceil(65536)
    x8 = selftest_planes(2.0, block)
    apps = {}
    for dev in (device, "cpu"):
        app = App(block_size=block, cfg=INT8_CONFIG, channels=1, device=dev)
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


def station_split(device="cuda", seconds: float = 1.0) -> list[dict]:
    """The selftest station (``seconds`` of it) on the default
    configuration's split path, on the card and, with the plain versions,
    on the host CPU: through App on complex64 (``process_u8``,
    ``DemodConfig()``) and through ``demod --ingest f32w`` (packed words,
    integer input; ``demod_app``, then the command itself on the card).
    Each row: RDS bytes identical, audio SNR of the card against the CPU,
    the selftest gates on the card's output, the launches of the card's
    run."""
    from fm_radio_tpu_torch.apps.cli import (
        build_parser, demod_app, selftest_checks, selftest_u8)
    from fm_radio_tpu_torch.kernels import _build
    from fm_radio_tpu_torch.models.app import App

    block = 65536
    u8 = selftest_u8(seconds, block)
    smoke = _build.BUILD_ROOT / "smoke"
    smoke.mkdir(parents=True, exist_ok=True)
    pcm = smoke / "station.pcm"
    u8.tofile(pcm)
    rows = []
    for path in ("app_complex64", "demod_f32w"):
        apps, counts = {}, {}
        for dev in (device, "cpu"):
            reset_counts()
            t0 = time.perf_counter()
            if path == "app_complex64":
                app = App(block_size=block, channels=1, device=dev)
                app.process_u8(u8)
            else:
                args = build_parser().parse_args(
                    ["demod", "-i", str(pcm), "--ingest", "f32w", "-b",
                     str(block), "--device", str(dev)])
                app = demod_app(args, torch.device(dev))
            if torch.device(dev).type == "cuda":
                torch.cuda.synchronize(dev)
            apps[str(dev)] = (app, time.perf_counter() - t0)
            counts[str(dev)] = read_counts()
        gpu, cpu = apps[str(device)][0], apps["cpu"][0]
        settle = int(0.15 * gpu.demod.fs_audio)
        checks = selftest_checks(gpu)
        rows.append({
            "path": path, "seconds_audio": u8.shape[0] / 1_024_000,
            "cfg": {k: getattr(gpu.cfg, k) for k in (
                "frontend_int8", "assume_integer_input", "k12_fusion")},
            "launches": counts[str(device)],
            "rds_bytes": int(gpu.rds_bytes(0).size),
            "rds_identical": bool(np.array_equal(gpu.rds_bytes(0),
                                                 cpu.rds_bytes(0))),
            "snr_vs_cpu_db": _snr_db(gpu.audio[0, settle:],
                                     cpu.audio[0, settle:]),
            "rds_pi": checks["rds_pi"]["value"],
            "seconds": {k: v[1] for k, v in apps.items()}})
    # the command itself on the card: its exit code and RDS summary line
    wav = smoke / "station.wav"
    out = subprocess.run(
        [sys.executable, "-m", "fm_radio_tpu_torch.apps.cli", "demod", "-i",
         str(pcm), "-o", str(wav), "--ingest", "f32w", "-b", str(block)],
        capture_output=True, text=True, timeout=300, cwd=HERE)
    summary = json.loads(out.stdout.strip().splitlines()[-1]) \
        if out.returncode == 0 else {}
    rows.append({"path": "cli_demod_f32w", "rc": out.returncode,
                 "pi_code": summary.get("pi_code"),
                 "wav_bytes": wav.stat().st_size if wav.exists() else 0,
                 "stderr_tail": out.stderr[-400:] if out.returncode else ""})
    return rows


def station_loops(device="cuda", seconds: float = 1.0) -> list[dict]:
    """The selftest station (``seconds`` of it) through App with each of
    the two loop options, on the card and, with the plain versions, on the
    host CPU: ``pll_time_chunks=4`` on int8 planes at block 262,144 (N / G
    = 8192 > W: the chunked PLL), and ``chain_fusion="auto"`` on packed
    words copied to 8 channels (the megakernel's gate needs C % 8 == 0) at
    block 65,536.  Each row: RDS bytes identical on every channel, the
    lowest audio SNR of the card against the CPU, channel 0's PI on the
    card, the card run's launches."""
    from fm_radio_tpu_torch.apps.cli import selftest_checks, selftest_u8
    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.models.app import App
    from fm_radio_tpu_torch.utils.transfer import pack_iq_u8, split_iq_i8

    rows = []
    for path, block, c, kw in (
            ("app_pll_chunked", 262144, 1,
             {"frontend_int8": True, "pll_time_chunks": 4}),
            ("app_chain_8ch", 65536, 8,
             {"assume_integer_input": True, "chain_fusion": "auto"})):
        u8 = selftest_u8(seconds, block)
        x = (split_iq_i8(u8)[:, None, :] if c == 1
             else np.repeat(pack_iq_u8(u8)[None, :], c, axis=0))
        apps, counts, secs = {}, {}, {}
        for dev in (device, "cpu"):
            reset_counts()
            t0 = time.perf_counter()
            app = App(block_size=block, cfg=DemodConfig(**kw), channels=c,
                      device=dev)
            app.process(x)
            if torch.device(dev).type == "cuda":
                torch.cuda.synchronize(dev)
            apps[str(dev)], secs[str(dev)] = app, time.perf_counter() - t0
            counts[str(dev)] = read_counts()
        gpu, cpu = apps[str(device)], apps["cpu"]
        settle = int(0.15 * gpu.demod.fs_audio)
        rows.append({
            "path": path, "cfg": kw, "channels": c, "block": block,
            "seconds_audio": u8.shape[0] / 1_024_000,
            "launches": counts[str(device)],
            "rds_bytes": min(int(gpu.rds_bytes(i).size) for i in range(c)),
            "rds_identical": all(np.array_equal(gpu.rds_bytes(i),
                                                cpu.rds_bytes(i))
                                 for i in range(c)),
            "snr_vs_cpu_db": min(_snr_db(gpu.audio[i, settle:],
                                         cpu.audio[i, settle:])
                                 for i in range(c)),
            "rds_pi": selftest_checks(gpu)["rds_pi"]["value"],
            "seconds": secs})
    return rows


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


def station_splits_words(m: int = 32, channel: int = 3, block: int = 32768,
                         blocks: int = 24) -> np.ndarray:
    """[1, blocks * block * M] packed words of a stereo+RDS station (PI
    0x5005, 1 kHz left, 3 kHz right) on ``channel`` of an M-channel
    capture, peak amplitude 100, as tests/test_tpu_accuracy.py:221-232
    makes it."""
    from fm_radio_tpu_torch.io.synth import (
        FMModulator, ModulatorConfig, make_wideband)
    from fm_radio_tpu_torch.utils.transfer import pack_iq_u8

    groups = [(0x5005, (0 << 12) | (1 << 10), 0xE101, 0x4242)]
    iq = FMModulator(ModulatorConfig()).generate(
        block * blocks, left_hz=1000.0, right_hz=3000.0, rds_groups=groups)
    wide = make_wideband({channel: iq}, m)
    wide *= 100.0 / np.abs(wide).max()
    u8 = np.clip(np.stack([np.round(wide.real + 127.0),
                           np.round(wide.imag + 127.0)], axis=-1),
                 0, 255).astype(np.uint8)
    return pack_iq_u8(u8)[None]


def station_splits(device="cuda", m: int = 32, channel: int = 3,
                   block: int = 32768, blocks: int = 24,
                   cpu_blocks: int = 16) -> dict:
    """The JAX package's hardware gate for the precision modes
    (tests/test_tpu_accuracy.py:200-278) on the port: the station of
    :func:`station_splits_words` through ``wideband_demod_block`` (int8
    bridge, phase-split at M = 32) at splits 3, 2 and 1 on the card, its
    PI decoded at each, the audio of splits 2 and 1 against splits 3 (SNR
    over the last three quarters); then the first ``cpu_blocks`` blocks at
    splits=1 on the card and with the plain versions on the host CPU: RDS
    bytes and audio SNR.  Each card run's launches are counted."""
    from fm_radio_tpu_torch.kernels.channelizer import make_tables
    from fm_radio_tpu_torch.models.demod import INT8_CONFIG, make_coeffs
    from fm_radio_tpu_torch.models.wideband import (
        wideband_demod_block, wideband_init_state)
    from fm_radio_tpu_torch.parallel.channelizer import make_channelizer_taps
    from fm_radio_tpu_torch.rds.chain import make_rds_chain

    words = station_splits_words(m, channel, block, blocks)
    t = m * block

    def run(dev, splits, n_blocks):
        dev = torch.device(dev)
        cfg = INT8_CONFIG
        co = make_coeffs(cfg, dev)
        tab = make_tables(make_channelizer_taps(m), m, dev)
        st = wideband_init_state(cfg, m, 1, device=dev)
        x = torch.from_numpy(words).to(dev)
        audio, pred, valid = [], [], []
        reset_counts()
        t0 = time.perf_counter()
        for blk in range(n_blocks):
            xb = x[:, blk * t : (blk + 1) * t].contiguous()
            st, o = wideband_demod_block(cfg, co, tab, st, xb, m,
                                         splits=splits)
            audio.append(o["audio"][channel].cpu().numpy())
            pred.append(o["rds_pred"][channel].cpu().numpy())
            valid.append(o["rds_valid"][channel].cpu().numpy())
        secs = time.perf_counter() - t0
        pred, valid = np.concatenate(pred), np.concatenate(valid)
        chain = make_rds_chain()
        chain.process_symbols(pred[valid.astype(bool)])
        rds = (np.concatenate(chain.rds_bytes) if chain.rds_bytes
               else np.zeros(0, np.uint8))
        return {"audio": np.concatenate(audio), "rds": rds,
                "pi": f"{chain.db.pi_code:04X}", "launches": read_counts(),
                "seconds": secs}

    runs = {sp: run(device, sp, blocks) for sp in (3, 2, 1)}
    res = {"m": m, "channel": channel, "block": block, "blocks": blocks,
           "seconds_audio": blocks * block / 1_024_000, "splits": {}}
    a3 = runs[3]["audio"]
    for sp, r in runs.items():
        tail = r["audio"][r["audio"].shape[0] // 4 :]
        res["splits"][sp] = {
            "pi": r["pi"], "rds_bytes": int(r["rds"].size),
            "audio_rms": float(np.sqrt(np.mean(tail.astype(np.float64) ** 2))),
            "snr_vs_splits3_db": (None if sp == 3 else _snr_db(
                tail, a3[a3.shape[0] // 4 :])),
            "launches": r["launches"],
            "seconds": r["seconds"]}
    gpu, cpu = run(device, 1, cpu_blocks), run("cpu", 1, cpu_blocks)
    settle = int(0.15 * 32000)
    res["splits1_card_vs_cpu"] = {
        "blocks": cpu_blocks, "seconds_audio": cpu_blocks * block / 1_024_000,
        "rds_bytes": int(gpu["rds"].size),
        "rds_identical": bool(np.array_equal(gpu["rds"], cpu["rds"])),
        "snr_db": _snr_db(gpu["audio"][settle:], cpu["audio"][settle:]),
        "seconds": {"card": gpu["seconds"], "cpu": cpu["seconds"]}}
    return res


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

    global LOG_FILE
    os.makedirs(DUMP_DIR, exist_ok=True)
    LOG_FILE = os.path.join(DUMP_DIR, "chip_smoke.log")
    open(LOG_FILE, "w").close()

    # 1. device
    smi = nvidia_smi_line()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(dev)
    log(f"[device] {smi} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | {name}")

    # 2. build (one nvcc per source and build, all started together)
    t0 = time.perf_counter()
    checked = threading.Thread(target=_build.build, kwargs={"checked": True})
    checked.start()
    _build.build()
    checked.join()
    _build.build(checked=True)  # raises here if the checked build failed
    log(f"[build] nvcc {_build.build_dir().name}, checked "
        f"{_build.build_dir(checked=True).name}: "
        f"{time.perf_counter() - t0:.1f} s")

    # 2b. the device-memory sweep: its best copy and read rates become the
    # byte rates of every bound
    t0 = time.perf_counter()
    hbm = hbm_phase(dev)
    for r in hbm["rows"]:
        log(f"[hbm] {json.dumps(r)}")
    best = hbm["best_copy"]
    bad = [r["variant"] for r in hbm["rows"] if not r["ok"]]
    if bad or not all(k["max_abs_err"] == 0.0
                      for k in hbm["kernels"].values()):
        raise RuntimeError(f"HBM probes wrong: {bad}, {hbm['kernels']}")
    set_rates(hbm)
    rd = hbm["best_read"]
    log(f"[hbm] best copy {best['variant']} {best['gbps']:.1f} GB/s "
        f"({100 * HBM_BYTES_S / DATASHEET_HBM_BYTES_S:.1f}% of the "
        f"{DATASHEET_HBM_BYTES_S / 1e12:.2f} TB/s data sheet), best read "
        f"{rd['variant']} {rd['gbps']:.1f} GB/s: the byte rates of every "
        f"bound below (the read rate for {sorted(READ_ONLY)}); "
        f"{time.perf_counter() - t0:.1f} s")

    # 2c. the engine probes: each kernel against its plain version, then
    # the probes' sections at their default shapes, compared and counted
    t0 = time.perf_counter()
    eng = probe_phase(dev)
    for r in eng["small"]:
        log(f"[probe] small {json.dumps(r)}")
    for probe, prow in eng["rows"].items():
        for r in prow:
            log(f"[probe] {probe} {json.dumps(r)}")
    for n, k in eng["kernels"].items():
        if n in ("fp_fir", "fp_dbuf"):
            # the staged FIR's launches and its computed issue floor beside
            # its bound
            k = dict(k, launches=eng["launches"][n],
                     **fp_floor(*PROBE_FULL["fp"]))
        elif n == "k2_restruct":
            # the block kernels' computed issue floor at every li
            c, b4 = PROBE_FULL["k2"]
            k = dict(k, launches=eng["launches"][n], floors={
                li: restruct_floor(c, b4 // 2, li)["fmul_fadd_floor_ms"]
                for li in (64, 128, 256, 512)},
                **restruct_floor(c, b4 // 2, 128))
        log(f"[probe] kernel {n} {json.dumps(k)}")
    log(f"[probe] launches {json.dumps(eng['launches'])}; "
        f"{time.perf_counter() - t0:.1f} s")
    idle = [n for n, _, _ in ENGINE_KERNELS if not eng["launches"].get(n)]
    if idle:
        raise RuntimeError(f"engine probe kernels not launched by their "
                           f"sections: {idle}")

    # 2d. four probe kernels against the one PyTorch call of the same
    # function, in turns (probes/vs_library.py: 25 rounds of 10 calls, the
    # paired sign test)
    t0 = time.perf_counter()
    from fm_radio_tpu_torch.probes import vs_library

    turns = {r["case"]: r for r in vs_library.run(dev)}
    for r in turns.values():
        log(f"[vs_library] {json.dumps(r)}")
    log(f"[vs_library] {time.perf_counter() - t0:.1f} s")

    def in_turns_keys(n: str) -> dict:
        """The kernels line's keys from the in-turns case of kernel n: the
        PyTorch call's median (its library_ms), the paired verdict and
        both sides' numbers."""
        r = turns.get(n)
        if r is None:
            return {}
        return {"library_ms": r["library"]["median_ms"],
                "rounds_kernel_slower": r["rounds_kernel_slower"],
                "loses": r["loses"], "wins": r["wins"],
                "in_turns": {k: r[k] for k in (
                    "what", "kernel", "library", "median_diff_ms",
                    "rounds_kernel_faster", "rounds_needed", "rounds",
                    "calls_a_round")}}

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

    # 3a. K12's small comparison again, on fresh seeds and poisoned memory
    # (compute-sanitizer refused the card it was tried on: PERF.md), and the
    # channelizer's
    # matrix kernels against their plain versions
    t0 = time.perf_counter()
    reps = k12_repeats(5, 8, 16384, dev)
    for r in reps:
        log(f"[compare] k12 repeat: {json.dumps(r)}")
    bad = [(r["seed"], k["name"]) for r in reps for k in r["kernels"]
           if not k["ok"]]
    if bad:
        raise RuntimeError(f"small-shape repeats disagree: {bad}")
    # the same repeats on the bounds-checked build: an index out of bounds
    # traps (the device prints the function and line), its C entry
    # reports it and the wrapper raises naming the kernel
    try:
        with _build.checked_build():
            creps = k12_repeats(5, 8, 16384, dev)
            # a channel count that is not a multiple of 32 (ROADMAP queue 3)
            creps += k12_repeats(5, 40, 16384, dev)
    except RuntimeError as e:
        raise RuntimeError(f"K12 repeats on the bounds-checked build: {e}")
    for r in creps:
        log(f"[compare] k12 repeat, checked build: {json.dumps(r)}")
    bad = [(r["seed"], k["name"]) for r in creps for k in r["kernels"]
           if not k["ok"]]
    if bad:
        raise RuntimeError(f"checked-build repeats disagree: {bad}")
    reps += creps
    mrows = compare_channelizer_mat(131072, 2, 4, dev)
    for r in mrows:
        log(f"[compare] {json.dumps(r)}")
    log(f"[compare] k12 repeats, matrix channelizers: "
        f"{time.perf_counter() - t0:.1f} s")
    bad = [r["name"] for r in mrows if not r["ok"]]
    silent = [(r["name"], k) for r in mrows for k, v in r["planes"].items()
              if v["centre_share"] >= 1.0]
    if bad or silent:
        raise RuntimeError(f"matrix channelizers disagree {bad} or were "
                           f"compared on constant planes {silent}")
    # the redesigned kernels at their edge shapes, the mid end's route on
    # the card against its host copy, and the wgmma kernel's instructions
    t0 = time.perf_counter()
    wedge = compare_wgmma_edges(dev)
    for r in wedge:
        log(f"[compare] matrix kernel edge: {json.dumps(r)}")
    medge = compare_mid_edges(dev)
    try:
        with _build.checked_build():
            cm = compare_mid_edges(dev)
    except RuntimeError as e:
        raise RuntimeError(f"fused mid end edges on the bounds-checked "
                           f"build: {e}")
    medge["rows"] += [dict(r, build="checked") for r in cm["rows"]]
    medge["route_mismatch"] += cm["route_mismatch"]
    medge["not_fused"] += cm["not_fused"]
    for r in medge["rows"]:
        log(f"[compare] fused mid end edge: {json.dumps(r)}")
    sass = sass_counts()
    log(f"[build] channelizer_wgmma SASS: {json.dumps(sass)}; route "
        f"mismatches {medge['route_mismatch']}; K2 calls off the fused "
        f"route {medge['not_fused']}; {time.perf_counter() - t0:.1f} s")
    bad = [(r["name"], r.get("form"), r.get("build")) for r in
           wedge + medge["rows"] if not r["ok"]]
    if bad or medge["route_mismatch"] or medge["not_fused"]:
        raise RuntimeError(f"edge shapes disagree {bad} or the mid end's "
                           f"route differs on the card "
                           f"{medge['route_mismatch']} or K2 left the fused "
                           f"route {medge['not_fused']}")
    if "error" not in sass and not (
            sass["HGMMA"] and sass["IGMMA"] and not sass["IMMA"]
            and sass["UTMALDG"] + sass["UBLKCP"]):
        raise RuntimeError(f"channelizer_wgmma lacks its float or integer "
                           f"wgmma or bulk copies, or has mma.sync, in its "
                           f"SASS: {sass}")
    # the PLL, extract and BPSK at their edge shapes, on the default and
    # the bounds-checked build (every global index of the three kernels
    # checked), extract's other route, the PLL's and BPSK's SASS
    t0 = time.perf_counter()
    pedge = compare_pll_edges(dev)
    pedge += compare_pll_chunked_edges(dev)
    eedge = compare_extract_edges(dev)
    bedge = compare_bpsk_edges(dev)
    try:
        with _build.checked_build():
            # the short blocks: the plain loops over the cell's 16,384
            # (PLL) and 2,048 (BPSK) steps ran on the default build
            pedge += [dict(r, build="checked")
                      for r in compare_pll_edges(dev, steps=(16, 32, 48))]
            pedge += [dict(r, build="checked")
                      for r in compare_pll_chunked_edges(dev)]
            ce = compare_extract_edges(dev)
            bedge += [dict(r, build="checked")
                      for r in compare_bpsk_edges(dev, steps=(16, 32, 48))]
    except RuntimeError as e:
        raise RuntimeError(f"PLL / extract / BPSK edges on the "
                           f"bounds-checked build: {e}")
    eedge["rows"] += [dict(r, build="checked") for r in ce["rows"]]
    eedge["route_mismatch"] += ce["route_mismatch"]
    for r in pedge + eedge["rows"] + bedge:
        log(f"[compare] pll / extract / bpsk edge: {json.dumps(r)}")
    psass = pll_sass()
    bsass = bpsk_sass()
    log(f"[build] pll SASS: {json.dumps(psass)}; bpsk SASS: "
        f"{json.dumps(bsass)}; extract route mismatches "
        f"{eedge['route_mismatch']}; {time.perf_counter() - t0:.1f} s")
    if "error" not in bsass and not (bsass.get("VOTE") and bsass.get("BRA")):
        raise RuntimeError(f"BPSK's SASS lacks the warp vote and branch "
                           f"around its phase error: {bsass}")
    bad = [(r["name"], r.get("channels"), r.get("steps", r.get("samples")),
            r.get("route", r.get("input"))) for r in
           pedge + eedge["rows"] + bedge if not r["ok"]]
    if bad or eedge["route_mismatch"]:
        raise RuntimeError(f"PLL / extract / BPSK edge shapes disagree "
                           f"{bad} or extract's route differs on the card "
                           f"{eedge['route_mismatch']}")
    # the redesigned ds x4 kernels (K12 flat and phase-split, K1 on every
    # form) at their edge shapes on the default and the bounds-checked build, and their
    # SASS (no FFMA in the float K1, no spills)
    t0 = time.perf_counter()
    dedge = compare_ds4_edges(dev)
    try:
        with _build.checked_build():
            dedge += [dict(r, build="checked")
                      for r in compare_ds4_edges(dev)]
    except RuntimeError as e:
        raise RuntimeError(f"ds4 edges on the bounds-checked build: {e}")
    for r in dedge:
        log(f"[compare] ds4 edge: {json.dumps(r)}")
    # the K1 probe's staged FIR kernels at their edge shapes on both builds
    fedge = compare_fp_edges(dev)
    try:
        with _build.checked_build():
            fedge += [dict(r, build="checked")
                      for r in compare_fp_edges(dev, seed=6)]
    except RuntimeError as e:
        raise RuntimeError(f"K1 probe edges on the bounds-checked build: {e}")
    bad = [r for r in fedge if not r["ok"]]
    log(f"[compare] K1 probe edges: {len(fedge)} cases on both builds, "
        f"{len(bad)} off; "
        f"{sorted({r['kernel'] for r in fedge})}")
    if bad:
        for r in bad:
            log(f"[compare] K1 probe edge off: {json.dumps(r)}")
        cases = [(r["kernel"], r["case"], r.get("build")) for r in bad]
        raise RuntimeError(f"K1 probe edge shapes disagree: {cases}")
    # the streaming probe kernels (the staged copy, the tile sums) at
    # their edges on both builds
    sedge = compare_stream_edges(dev)
    try:
        with _build.checked_build():
            sedge += [dict(r, build="checked")
                      for r in compare_stream_edges(dev, seed=8)]
    except RuntimeError as e:
        raise RuntimeError(f"stream edges on the bounds-checked build: {e}")
    bad = [r for r in sedge if not r["ok"]]
    log(f"[compare] stream edges: {len(sedge)} cases on both builds, "
        f"{len(bad)} off; {sorted({r['kernel'] for r in sedge})}")
    for r in bad:
        log(f"[compare] stream edge off: {json.dumps(r)}")
    if bad:
        raise RuntimeError(f"stream edge cases disagree: "
                           f"{[(r['kernel'], r['case'], r.get('build')) for r in bad]}")
    # the K2 probe's block recurrences at their edges on both builds
    kedge = compare_k2_edges(dev)
    try:
        with _build.checked_build():
            kedge += [dict(r, build="checked")
                      for r in compare_k2_edges(dev, seed=4)]
    except RuntimeError as e:
        raise RuntimeError(f"K2 block edges on the bounds-checked build: {e}")
    bad = [r for r in kedge if not r["ok"]]
    log(f"[compare] K2 block edges: {len(kedge)} cases on both builds, "
        f"{len(bad)} off; {sorted({r['kernel'] for r in kedge})}")
    for r in bad:
        log(f"[compare] K2 block edge off: {json.dumps(r)}")
    if bad:
        raise RuntimeError(f"K2 block edge cases disagree: "
                           f"{[(r['case'], r.get('build')) for r in bad]}")
    # the exact channelizer at every M instantiation and its edge shapes,
    # on both builds; the megakernel at the chain cell's shape on the
    # checked build (its small shapes are in the repeats above)
    t1 = time.perf_counter()
    cedge = compare_chan_edges(dev)
    # the megakernel off its blocked stages (other filter orders)
    corders = [compare_chain_small(11, device=dev,
                                   orders=CHAIN_OTHER_ORDERS)]
    try:
        with _build.checked_build():
            cedge += [dict(r, build="checked")
                      for r in compare_chan_edges(dev, seed=1)]
            corders.append(dict(compare_chain_small(
                12, device=dev, orders=CHAIN_OTHER_ORDERS), build="checked"))
        chk = chain_cell_checked(device=dev)
    except RuntimeError as e:
        raise RuntimeError(f"channelizer edges or the chain cell on the "
                           f"bounds-checked build: {e}")
    for r in cedge:
        log(f"[compare] channelizer edge: {json.dumps(r)}")
    for r in corders:
        log(f"[compare] chain, other orders: {json.dumps(r)}")
    log(f"[compare] chain cell, checked build: {json.dumps(chk)}; "
        f"{time.perf_counter() - t1:.1f} s")
    bad = [(r["m"], r["k"], r["t"], r["packed"], r["out"], r.get("build"))
           for r in cedge if not r["ok"]]
    if bad or not chk["ok"] or not all(r["ok"] for r in corders):
        raise RuntimeError(f"channelizer edge shapes disagree {bad}, or the "
                           f"chain at other orders {corders} or at the "
                           f"cell on the checked build {chk}")
    dsass = ds4_sass()
    log(f"[build] ds4 SASS: {json.dumps(dsass)}; "
        f"{time.perf_counter() - t0:.1f} s")
    bad = [(r["case"], r["channels"], r["samples"], r.get("build"))
           for r in dedge if not r["ok"]]
    if bad or ds4_sass_faults(dsass):
        raise RuntimeError(f"ds4 edge shapes disagree {bad} or the SASS "
                           f"shows {ds4_sass_faults(dsass)}")

    # 3b. the split path's kernels against plain on the card
    t0 = time.perf_counter()
    srows, k12_diff = compare_split(256, 131072, 2, dev)
    for r in srows:
        log(f"[compare] {json.dumps(r)}")
    log(f"[compare] split int8 path (k12_fusion='off') vs fused K12: max "
        f"abs diff {k12_diff}; {time.perf_counter() - t0:.1f} s")
    bad = [r["name"] for r in srows if not r["ok"]]
    if bad or k12_diff != 0.0:
        raise RuntimeError(f"split kernels disagree: {bad}, split int8 path "
                           f"vs K12 {k12_diff}")
    const = [k for k, v in srows[0]["inputs"].items() if v["constant"]]
    if const:
        raise RuntimeError(f"split kernels compared on constant input: "
                           f"{const}")
    t0 = time.perf_counter()
    frows = compare_wideband_f32(131072, 2, 4, 32, dev)
    for r in frows:
        log(f"[compare] f32 bridge: {json.dumps(r)}")
    log(f"[compare] f32 bridge: {time.perf_counter() - t0:.1f} s")
    bad = [r["name"] for r in frows if not r["ok"]]
    if bad or frows[0]["inputs"]["constant"]:
        raise RuntimeError(f"f32 bridge kernels disagree or constant "
                           f"input: {bad}")

    # 3c. the megakernel and the chunked PLL against plain on the card
    t0 = time.perf_counter()
    crows = compare_chain(256, 131072, 2, dev)
    crows += compare_pll_chunked(256, 1048576, 8, 2, 5, dev)
    for r in crows:
        log(f"[compare] {json.dumps(r)}")
    log(f"[compare] chain, pll_chunked: {time.perf_counter() - t0:.1f} s")
    bad = [r["name"] for r in crows if not r["ok"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: {bad}")
    const = [k for r in crows for k, v in r.get("inputs", {}).items()
             if v["constant"]]
    if const:
        raise RuntimeError(f"chain / pll_chunked compared on constant input: "
                           f"{const}")

    # 3d. the int16 format's kernels against plain on the card
    t0 = time.perf_counter()
    irows, iroutes, i16_c5_launches = compare_i16(256, 131072, 2, 5, dev)
    for r in irows:
        log(f"[compare] i16: {json.dumps(r)}")
    log(f"[compare] i16 routes: {json.dumps(iroutes)}; "
        f"{time.perf_counter() - t0:.1f} s")
    bad = [r["name"] for r in irows if not r["ok"]]
    if bad:
        raise RuntimeError(f"int16 kernels disagree: {bad}")
    want = {"i8_direct": ["frontend_i8_i16", "midend_i16", "pll_i16",
                          "extract_i16", "bpsk"],
            "i8_direct_c5": ["frontend_i8_i16", "midend_i16", "pll",
                             "extract_i16_f32dt", "bpsk"]}
    missing = {n for n, _, _ in I16_KERNELS} - {r["name"] for r in irows}
    if missing or any(iroutes[k]["kernels"] != v for k, v in want.items()):
        raise RuntimeError(f"int16 route: {iroutes}, not compared {missing}")
    const = [k for k, v in irows[0]["inputs"].items() if v["constant"]]
    if const:
        raise RuntimeError(f"int16 kernels compared on constant input: "
                           f"{const}")

    # 4. main path at the bench cell
    t0 = time.perf_counter()
    mp = main_path(2048, 131072, 8, dev)
    torch.cuda.synchronize(dev)
    log(f"[main] {json.dumps(mp)}")
    prof = profile_split(*PRESPLIT_CELL, device=dev)
    log(f"[profile] {json.dumps(prof)}")
    log(f"[main] {time.perf_counter() - t0:.1f} s")
    bad = [r["name"] for r in mp["compare"] if not r["ok"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions at "
                           f"the bench cell: {bad}")
    fused = lacking(prof, FUSED_KERNELS + REDESIGNED_KERNELS + (DS4_FLAT,))
    if fused:
        raise RuntimeError(f"the pre-split cell's profile lacks the fused "
                           f"mid end's or the redesigned kernels {fused}: "
                           f"{list(prof['device_ms_per_block'])}")

    # 4b. the split cells at full width
    t0 = time.perf_counter()
    cells = {}
    for label, kind, kw in SPLIT_CELLS:
        torch.cuda.reset_peak_memory_stats(dev)
        cells[label] = split_path(label, kind, kw, 2048, 131072, 8, dev)
        log(f"[split] {json.dumps(cells[label])}")
    cat_ms = {}
    for label, kind, kw in SPLIT_CELLS:
        prof = profile_split(label, kind, kw, device=dev)
        log(f"[profile] {json.dumps(prof)}")
        # K1 in one launch: its kernel, and no second launch
        gone = [k for k in (K1_DISC,) if not lacking(prof, (k,))]
        if lacking(prof, (SPLIT_CELL_DS4[label],)) or gone:
            raise RuntimeError(f"the {label} cell's profile lacks "
                               f"{SPLIT_CELL_DS4[label]} or shows {gone}: "
                               f"{list(prof['device_ms_per_block'])}")
        cat_ms[label] = sum(v for k, v in prof["device_ms_per_block"].items()
                            if PLANE_COPY in k)
    # the glue's own stacks (the audio's among them) copy in every cell;
    # that the complex cell splits no planes is split_path's check
    log(f"[split] {PLANE_COPY} ms/block by cell {json.dumps(cat_ms)}; "
        f"{time.perf_counter() - t0:.1f} s")
    bad = [(label, r["name"]) for label, c in cells.items()
           for r in c["compare"] if not r["ok"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions at "
                           f"the split cells: {bad}")

    # 4c. the chain cell and the chunked-PLL cell
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    ch = chain_path(2048, 131072, 8, 2, dev)
    log(f"[chain] {json.dumps(ch)}")
    prof = profile_split(*CHAIN_CELL, device=dev)
    log(f"[profile] {json.dumps(prof)}")
    pc = chunked_pll_path(256, 1048576, 8, 4, dev)
    pc["launches"] = pc["g8"]["launches"]
    log(f"[pll_chunked] {json.dumps(pc)}")
    pa = pc["pll_alone"]
    steps, n_seq = (pa["serial_steps"][k] for k in ("chunked", "sequential"))
    log(f"[pll_chunked] chain floor (computed, not measured): {steps} "
        f"steps x the sequential kernel's "
        f"{pa['sequential_ms'] / n_seq * 1e6:.2f} ns a step = "
        f"{steps * pa['sequential_ms'] / n_seq:.4f} ms")
    prof = profile_split(*PLL_CHUNKED_CELL, channels=256, block=1048576,
                         device=dev)
    log(f"[profile] {json.dumps(prof)}")
    log(f"[chain] [pll_chunked] {time.perf_counter() - t0:.1f} s")
    if lacking(prof, (PLL_CHUNKED,)):
        raise RuntimeError(f"the chunked-PLL cell's profile lacks "
                           f"{PLL_CHUNKED}: "
                           f"{list(prof['device_ms_per_block'])}")
    bad = [r["name"] for r in ch["compare"] + pc["compare"] if not r["ok"]]
    vs = ch["vs_split_f32w"]
    if bad or vs["audio"] != 0.0 or vs["state_before_rds_agc"] != 0.0:
        raise RuntimeError(f"chain / chunked PLL cells: kernels {bad}, chain "
                           f"vs f32w split {vs}")
    if vs["agc_rds_rel"] > POWER_RTOL or not pc["pll_alone"]["chunk0_exact"]:
        raise RuntimeError(f"chain RDS AGC {vs} or chunk 0 "
                           f"{pc['pll_alone']} out of bounds")

    # 4d. the i16 cell, beside k12off (the same launches in float32)
    t0 = time.perf_counter()
    i16c = i16_path(2048, 131072, 8, dev)
    log(f"[i16] {json.dumps(i16c)}")
    log(f"[i16] {i16c['ms_per_block']:.3f} ms/block, {i16c['msps']:.0f} "
        f"Msps, peak {i16c['peak_mib']:.0f} MiB; k12off "
        f"{cells['k12off']['ms_per_block']:.3f} ms/block, "
        f"{cells['k12off']['peak_mib']:.0f} MiB")
    prof = profile_split(*I16_CELL, device=dev)
    log(f"[profile] {json.dumps(prof)}")
    log(f"[i16] {time.perf_counter() - t0:.1f} s")
    log(f"[i16] the peak IIR's chain floor (computed, not measured; the "
        f"float32 and int16 mid end alike): "
        f"{json.dumps(peak_floor(i16c['bound']['midend_i16']['serial_steps']))}")
    bad = [r["name"] for r in i16c["compare"] if not r["ok"]]
    if bad:
        raise RuntimeError(f"int16 kernels disagree at the i16 cell: {bad}")
    # K2 in int16 on the fused route: its three kernels, none of the
    # launches route's
    gone = [k for k in MID_LAUNCHES if not lacking(prof, (k,))]
    if lacking(prof, FUSED_KERNELS) or gone:
        raise RuntimeError(f"the i16 cell's profile lacks "
                           f"{lacking(prof, FUSED_KERNELS)} or shows {gone}: "
                           f"{list(prof['device_ms_per_block'])}")

    # 5. the wideband main path at its cell, then the M=16 and f32 bridges
    t0 = time.perf_counter()
    wb_bench = wideband_path(64, 32, 131072, 8, library=False, device=dev)
    log(f"[wideband] {json.dumps(wb_bench)}")
    wb = wideband_path(64, 32, 131072, 8, amp=loud_amp(32), device=dev)
    log(f"[wideband] {json.dumps(wb)}")
    wb16 = wideband_path(128, 16, 131072, 2, amp=loud_amp(16), device=dev)
    log(f"[wideband] {json.dumps(wb16)}")
    log(f"[wideband] the exact channelizer's FMUL/FADD issue floor "
        f"(computed, not measured): M = 32 {wb['chan_floor']}, M = 16 "
        f"{wb16['chan_floor']}")
    wbf = wideband_path(64, 32, 131072, 2, amp=loud_amp(32),
                        time_kernels=False, bridge="f32", device=dev)
    log(f"[wideband] {json.dumps(wbf)}")
    # the precision modes: bench.py's own lens (FMTPU_WB_SPLITS=1 on its
    # captures), and splits 1 and 2 on loud captures
    wb_i8_bench = wideband_path(64, 32, 131072, 8, splits=1,
                                time_bpsk=True, device=dev)
    log(f"[wideband] {json.dumps(wb_i8_bench)}")
    wb_i8 = wideband_path(64, 32, 131072, 8, amp=loud_amp(32), splits=1,
                          device=dev)
    log(f"[wideband] {json.dumps(wb_i8)}")
    wb_bf16 = wideband_path(64, 32, 131072, 8, amp=loud_amp(32), splits=2,
                            device=dev)
    log(f"[wideband] {json.dumps(wb_bf16)}")
    # bench.py's lens, the bf16 mode and the exact mode beside them
    for sp in (1, 2, 3):
        prof = profile_wideband(sp, device=dev)
        log(f"[profile] {json.dumps(prof)}")
        want = (REDESIGNED_KERNELS + (MAT_KERNEL,) if sp == 1
                else (MAT_KERNEL,) if sp == 2 else ()) + (DS4_PS,)
        if lacking(prof, want):
            raise RuntimeError(f"the wideband profile at splits={sp} lacks "
                               f"{lacking(prof, want)}: "
                               f"{list(prof['device_ms_per_block'])}")
    log(f"[wideband] {time.perf_counter() - t0:.1f} s")
    bad = [r["name"] for c in (wb_bench, wb, wb16, wb_i8_bench, wb_i8,
                               wb_bf16)
           for r in c["compare"] if not r["ok"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions at "
                           f"the wideband cell: {bad}")
    if any(c["planes"]["centre_share"] >= 1.0 for c in (wb, wb_i8, wb_bf16)):
        raise RuntimeError("a loud wideband cell reached K12 silent")

    # 6. station on the card and on the host CPU
    t0 = time.perf_counter()
    stn = station(dev)
    log(f"[station] {json.dumps(stn)}")
    log(f"[station] {time.perf_counter() - t0:.1f} s")
    if not (stn["checks_pass"] and stn["rds_identical"]
            and stn["snr_vs_cpu_db"] >= SNR_MIN_DB and stn["rds_bytes"] > 0):
        raise RuntimeError("station phase failed its gates")

    # 6b. the station on the default configuration's split path
    t0 = time.perf_counter()
    sst = station_split(dev)
    log(f"[station] split path: {json.dumps(sst)}")
    log(f"[station] split path: {time.perf_counter() - t0:.1f} s")
    for r in sst[:2]:
        if not (r["rds_identical"] and r["rds_bytes"] > 0
                and r["snr_vs_cpu_db"] >= SNR_MIN_DB
                and r["rds_pi"] == "1234"):
            raise RuntimeError(f"split-path station failed its gates: {r}")
    if sst[2]["rc"] != 0 or sst[2]["pi_code"] != "1234":
        raise RuntimeError(f"demod --ingest f32w failed: {sst[2]}")

    # 6c. the station with the chunked PLL and on the megakernel
    t0 = time.perf_counter()
    lst = station_loops(dev)
    log(f"[station] loops: {json.dumps(lst)}")
    log(f"[station] loops: {time.perf_counter() - t0:.1f} s")
    for r in lst:
        want = ("pll_chunked" if r["path"] == "app_pll_chunked" else "chain")
        if not (r["rds_identical"] and r["rds_bytes"] > 0
                and r["snr_vs_cpu_db"] >= SNR_MIN_DB
                and r["rds_pi"] == "1234" and r["launches"][want] > 0):
            raise RuntimeError(f"station {r['path']} failed its gates: {r}")

    # 6d. the station in the int16 format
    t0 = time.perf_counter()
    si = station_i16(dev)
    log(f"[station] i16: {json.dumps(si)}")
    log(f"[station] i16: {time.perf_counter() - t0:.1f} s")
    cv, fv = si["card_vs_cpu"], si["i16_vs_float_route"]
    if not (cv["rds_identical"] and cv["rds_bytes"] > 0
            and cv["snr_db"] >= STATION_I16_CPU_DB and fv["rds_identical"]
            and fv["snr_db"] >= STATION_I16_FLOAT_DB
            and set(si["rds_pi"].values()) == {"1234"}
            and all(si["launches"]["card_i16"][k] > 0 for k in I16_STATION)):
        raise RuntimeError(f"int16 station failed its gates: {si}")

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

    # 7b. a station through the three precision modes
    t0 = time.perf_counter()
    sps = station_splits(dev)
    log(f"[stations] splits: {json.dumps(sps)}")
    log(f"[stations] splits: {time.perf_counter() - t0:.1f} s")
    vs = sps["splits1_card_vs_cpu"]
    for sp, r in sps["splits"].items():
        chan = CHANNELIZER_BY_SPLITS[sp]
        if r["pi"] != "5005" or not r["launches"].get(chan) or (
                sp != 3 and r["snr_vs_splits3_db"] < STATION_SPLITS_SNR_DB):
            raise RuntimeError(f"station at splits={sp} failed its gates: "
                               f"{r}")
    if not (vs["rds_identical"] and vs["rds_bytes"] > 0
            and vs["snr_db"] >= SNR_MIN_DB):
        raise RuntimeError(f"station at splits=1, card vs CPU: {vs}")

    # the kernels line: each kernel's numbers from its cell (pre-split:
    # k12, pll, extract, bpsk; the loud wideband cell: channelizer, k12_ps;
    # f32w: frontend, midend; k12off: frontend_i8), its errors at C=256 (or
    # W=4) and at full width, and its launches on every path
    err_small, err_full = {}, {}
    rep_rows = [k for r in reps for k in r["kernels"]]
    for r in (rows + wrows + srows + frows + crows + mrows + rep_rows + irows
              + wedge + medge["rows"] + pedge + eedge["rows"] + bedge
              + dedge + cedge + corders + [chk]):
        err_small[r["name"]] = max(err_small.get(r["name"], 0.0),
                                   r["max_abs_err"])
    for r in (mp["compare"] + wb_bench["compare"] + wb["compare"]
              + wb16["compare"]
              + [r for c in cells.values() for r in c["compare"]]
              + ch["compare"] + pc["compare"] + wb_i8_bench["compare"]
              + wb_i8["compare"] + wb_bf16["compare"] + i16c["compare"]):
        err_full[r["name"]] = max(err_full.get(r["name"], 0.0),
                                  r["max_abs_err"])
    paths = {"presplit": mp["launches"],
             "wideband_m32": wb_bench["launches"],
             "wideband_m32_loud": wb["launches"],
             "wideband_m16_loud": wb16["launches"],
             "wideband_m32_f32_bridge": wbf["launches"],
             "wideband_m32_splits1": wb_i8_bench["launches"],
             "wideband_m32_splits1_loud": wb_i8["launches"],
             "wideband_m32_splits2_loud": wb_bf16["launches"],
             **{f"station_splits{sp}": r["launches"]
                for sp, r in sps["splits"].items()},
             **{f"split_{k}": c["launches"] for k, c in cells.items()},
             **{f"station_{r['path']}": r["launches"] for r in sst[:2]},
             "chain_f32w": ch["launches"],
             "pll_cell_g8": pc["g8"]["launches"],
             "pll_cell_g1": pc["g1"]["launches"],
             **{f"station_{r['path']}": r["launches"] for r in lst},
             "i16": i16c["launches"],
             "i16_route_c5": {k: i16_c5_launches.get(k, 0)
                              for k in i16c["launches"]},
             "i16_words": i16c["launches_words"],
             "station_i16": si["launches"]["card_i16"]}
    home = {"k12": mp, "pll": mp, "extract": mp, "bpsk": mp,
            "channelizer": wb, "k12_ps": wb, "frontend": cells["f32w"],
            "midend": cells["f32w"], "frontend_i8": cells["k12off"],
            "chain": ch, "pll_chunked": pc, "channelizer_i8mat": wb_i8,
            "channelizer_bf16mat": wb_bf16,
            **{n: i16c for n, _, _ in I16_KERNELS}}
    # a kernel that its cell does not launch: the path that does
    launch_path = {"extract_i16_f32dt": "i16_route_c5",
                   "frontend_i16": "i16_words"}
    kernels = []
    for n, src, rep in (KERNELS + WIDEBAND_KERNELS + SPLIT_KERNELS
                        + CHAIN_KERNELS + MAT_KERNELS + I16_KERNELS):
        cell = home[n]
        b = cell["bound"][n]
        lib = cell.get("library_ms") if n.startswith("channelizer") else None
        launches = (paths[launch_path[n]][n] if n in launch_path
                    else cell["launches"][n])
        k = {"name": n, "route": "cuda", "source": src, "replaces": rep,
             "launches": launches,
             "launches_by_path": {p: c[n] for p, c in paths.items()},
             "max_abs_err": max(err_small[n], err_full[n]),
             "max_abs_err_full_width": err_full[n],
             "max_abs_err_small": err_small[n],
             "ms": cell["kernel_ms"][n], "plain_ms": cell["plain_ms"][n],
             "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
             "library_ms": lib["ms"] if lib else None,
             "hbm_bytes_s": b["hbm_bytes_s"],
             "work": {key: b[key] for key in ("bytes", "f32_ops", "i8_ops",
                                              "bf16_ops")}}
        if lib:
            k["library"] = lib
        if b["serial_steps"] is not None:
            k["serial_steps"] = b["serial_steps"]
        kernels.append(k)
    # the wideband kernels also on bench.py's captures (silent at the int8
    # bridge), and the planes they were compared on
    planes = {r["name"]: r["planes"] for r in wrows}
    for k in kernels:
        n = k["name"]
        if n in ("channelizer", "k12_ps"):
            k.update(ms_bench_input=wb_bench["kernel_ms"][n],
                     plain_ms_bench_input=wb_bench["plain_ms"][n],
                     planes_small=planes[n], planes_full_width=wb["planes"],
                     planes_full_width_bench_input=wb_bench["planes"])
        if n == "channelizer":
            # the M = 16 lens and the edge shapes (the issue floors, which
            # are computed and not measured, are logged with the cells)
            k.update(m16={"ms": wb16["kernel_ms"][n],
                          "plain_ms": wb16["plain_ms"][n],
                          "bound": wb16["bound"][n],
                          "library": wb16["library_ms"]},
                     edge_shapes={
                         "cases": len(cedge),
                         "max_abs_err": max(r["max_abs_err"] for r in cedge),
                         "m_values": list(CHAN_EDGE_MS),
                         "k_values": list(CHAN_EDGE_KS),
                         "t_values": list(CHAN_EDGE_TS)})
        if n == "chain":
            k.update(checked_cell=chk, other_orders=corders, small=[
                kk for r in reps for kk in r["kernels"]
                if kk["name"] == "chain"])
        if n == "midend":
            k.update(ms_by_cell={c: cells[c]["kernel_ms"]["midend"]
                                 for c in cells})
        if n == "pll_chunked":
            k.update(pll_alone=pc["pll_alone"],
                     sass=psass.get("chunked", psass),
                     edge_shapes=[r for r in pedge if r["name"] == n])
        if n == "midend_i16":
            k.update(edge_shapes=[r for r in medge["rows"]
                                  if r["name"] == n])
        if n in ("channelizer_i8mat", "channelizer_bf16mat"):
            mr = next(r for r in mrows if r["name"] == n)
            cell = home[n]
            k.update(planes_small=mr["planes"], planes_full_width=cell["planes"])
            if n == "channelizer_bf16mat":
                full = next(r for r in cell["compare"] if r["name"] == n)
                k.update(f32_rel_rms=mr["f32_rel_rms"],
                         i8_share_small=mr["i8_share"],
                         i8_share_full_width=full["i8_share"],
                         tol_f32_rel_rms=BF16MAT_F32_REL,
                         tol_i8_share=BF16MAT_I8_SHARE)
            if n == "channelizer_i8mat":
                k.update(ms_bench_input=wb_i8_bench["kernel_ms"][n],
                         plain_ms_bench_input=wb_i8_bench["plain_ms"][n])
        if n in I16_BASE and n != "extract_i16_f32dt":
            k.update(float_twin_ms=i16c["float_twin_ms"][I16_BASE[n]])
        if n in ("k12", "k12_ps", "midend", "midend_i16"):
            # the mid end's fused route: its launches on the kernel's path
            # (each also counted by the kernel)
            k["launches_fused_route"] = home[n]["launches"]["midend_fused"]
        if n in ("channelizer_i8mat", "channelizer_bf16mat"):
            k.update(sass=sass, operator_bytes=home[n]["operator_bytes"])
        if n.startswith("channelizer_") and n != "channelizer":
            k.update(edge_shapes=[r for r in wedge if r["name"] == n])
        if n == "bpsk":
            k.update(sass=bsass, edge_shapes=bedge,
                     alone={"presplit": mp["bpsk_alone"],
                            "wideband_m32_splits1":
                                wb_i8_bench["bpsk_alone"]})
        if n in ("pll", "pll_i16"):
            k.update(sass=psass.get("i16" if n == "pll_i16" else "f32",
                                    psass),
                     edge_shapes=[r for r in pedge if r["name"] == n])
        if n in ("extract", "extract_i16", "extract_i16_f32dt"):
            # extract's blocked route: its launches on the kernel's path
            # (each also counted by its form)
            k.update(launches_blocked_route=(
                paths[launch_path[n]] if n in launch_path
                else home[n]["launches"])["extract_blocked"],
                edge_shapes=[r for r in eedge["rows"] if r["name"] == n])
        if n in DS4_OF:
            # the redesigned ds x4 stage: its kernel, the SASS and the edge
            # shapes
            kern = DS4_OF[n]
            k.update(ds4_kernel=kern, ds4_sass={
                f: r for f, r in dsass.items() if kern in f}
                if "error" not in dsass else dsass,
                edge_shapes=[r for r in dedge if r["name"] == n])
        if n in launch_path:
            k["launches_path"] = launch_path[n]
    # the device-memory probes: each at its fastest variant of the sweep
    for n, src, rep in PROBE_KERNELS:
        pk = hbm["kernels"][n]
        b = bound_of(pk["bytes"], pk["f32_ops"], read_only=n in READ_ONLY)
        kernels.append({
            "name": n, "route": "cuda", "source": src, "replaces": rep,
            "launches": hbm["launches"][n],
            "launches_by_path": {"hbm_sweep": hbm["launches"][n]},
            "max_abs_err": pk["max_abs_err"], "ms": pk["ms"],
            "plain_ms": pk["plain_ms"], "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "library_ms": pk["library_ms"],
            "variant": pk["variant"], "hbm_bytes_s": b["hbm_bytes_s"],
            "hbm_rate": b["hbm_rate"], "hbm_rate_from": b["hbm_rate_from"],
            "work": {"bytes": pk["bytes"], "f32_ops": pk["f32_ops"]},
            **{k: v for k, v in pk.items() if k.startswith("library_ms_")},
            **in_turns_keys(n)})
    # the engine probes: each at its representative row of its sections
    for n, src, rep in ENGINE_KERNELS:
        pk = eng["kernels"][n]
        kernels.append({
            "name": n, "route": "cuda", "source": src, "replaces": rep,
            "launches": eng["launches"][n],
            "launches_by_path": {"probes": eng["launches"][n]},
            "max_abs_err": pk["max_abs_err"], "ms": pk["ms"],
            "plain_ms": pk["plain_ms"], "bound_ms": pk["bound_ms"],
            "bound_by": pk["bound_by"], "library_ms": pk["library_ms"],
            "variant": pk["variant"], "hbm_bytes_s": pk["hbm_bytes_s"],
            "hbm_rate": pk["hbm_rate"], "hbm_rate_from": pk["hbm_rate_from"],
            **in_turns_keys(n),
            "work": {key: pk[key] for key in ("bytes", "f32_ops", "i8_ops",
                                              "design_f32_ops") if key in pk},
            **({"serial_steps": pk["serial_steps"]}
               if pk["serial_steps"] is not None else {})})
    if DUMPS:
        raise RuntimeError(f"mismatches saved (passed their tolerances): "
                           f"{DUMPS}")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
