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
   PyTorch call (``x.view(C, n_tt, t_blk).sum(-1)``); the int8-window
   rows (fp_i8d's variants on K12's staged ds x4 tile, fp_i8man's
   tiles) with their IDP4A issue
   floor (:func:`i8_floor`); the K2 probe's ds2 and hilb with their
   FMUL+FADD issue floors (:func:`engine_floor`), hilb's Hilbert launch
   also alone (``k2_probe.hilb_launch``);
2d. six probe kernels and the mid end's split route's two tiled
   kernels in turns with the one PyTorch call of the same function
   (probes/vs_library.py, 25 rounds of 10 calls: the staged copy against
   ``Tensor.copy_``, the K1 probe's and k3's tile sums against
   ``sum(-1)``, the read against ``x.view(-1, 8, 128).sum((0, 1))``, ds x2
   and Hilbert, the mid end's and the K2 probe's, against ``F.conv1d``),
   each with the paired sign test's
   verdict, put on the kernels line (``library_ms``,
   ``rounds_kernel_slower``, ``loses``, ``wins``); and ``F.conv1d`` alone
   at the K2 probe's ds2 and the K1 probe's dots shapes;
3a. K12 (and the PLL, extract, BPSK) against their plain versions at
   C=8 x B=16,384, the int8-matrix channelizer at W=2 x T=32,768
   (:func:`compare_i8mat_small`) and the ds x4 kernels at C=8 x B=16,384
   (:func:`compare_ds4_edges`), three times on fresh seeds
   (:data:`K12_REPEATS`), the
   allocator's free memory filled with 0xFF bytes before each
   (compute-sanitizer refused the card it was tried on: PERF.md), then
   twice on the bounds-checked build
   (``_build.checked_build()``: every index of K12's, the PLL's,
   extract's, BPSK's and the matrix channelizer's device code checked, a
   trap fails the run naming the kernel), and twice more there at C=40
   (not a multiple of 32); the channelizer's int8- and bf16-matrix modes
   (splits 1 and 2, one wgmma kernel) against their plain versions on the
   arguments ``wideband_demod_block`` recorded from W=4 loud captures, two
   blocks with carried state: M=32 words -> i8ps and -> f32, M=16 words ->
   i8; both modes at their edge shapes (T = 16,384 on W = 1 and 3, all
   three forms; :func:`compare_wgmma_edges`) and the count of the wgmma
   kernel's float and integer wgmma, mma.sync and bulk-copy instructions
   (``cuobjdump -sass``); K12 flat, phase-split and K2 (in its four
   formats: float32 or int16 fm_demod, float32 or int16 outputs, each a
   counted launch of its route) on the mid end's split route with
   de-emphasis off at C=40 and on at C = 1 and 40 (there also its ds x2
   and Hilbert kernels alone), B = 512, 8,192 and 8,320, and at the other
   filter orders of MID_ANY_ORDERS (the any-order kernels; C = 40, the
   smallest block that holds the tails and 8,320; K12 where its ds x4
   takes the order), memory NaN-filled first, max abs error 0, on the
   default and the bounds-checked build, and the mid end's route on the
   card against its host copy, past the halo too
   (:func:`compare_mid_edges`); K12 and K2 in its four formats on three
   blocks shorter than a carried tail (the launches route), then one of
   the split route, the state carried through them, de-emphasis off and
   on, on both builds (:func:`compare_mid_short_blocks`); the sequential PLL at C = 40
   and 5, N = 16, 32, 48, and at C = 5 16,384 (the default build), on
   both forms, the chunked PLL at C =
   5 and 40, G = 2, 4, 8, W = 0, 7, 4,096 and chunk lengths a multiple of
   its 16-step batch and not (:func:`compare_pll_chunked_edges`), extract
   at C = 40, N = 1,024 and 2,048 on its three forms at every order of
   EXTRACT_EDGE_ORDERS (the receiver's 128 taps on
   ``extract_blocked_kernel``, the others on
   ``extract_blocked_any_kernel``), and BPSK at
   C = 40 and 5, N = 16, 32, 48, and at C = 5 2,048 (the default
   build), with a gain and without, on
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
   FFMA in the float K1 beyond atan2's division, no spills); the float
   K1 at every other order check_state admits (``k1_tile_any_kernel``,
   nn % 4 == 0 from 4 to 132 but 64) on every float-tap form with both
   stores at C = 8, B = 8,324 and C = 40, B = 4,160, on both builds, max
   abs error 0 (:func:`compare_k1_any_orders`); the K1
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
   its host copy; the engine's ds2 and hilb at C = 1 and 5, at B4 of a
   partial tile and whole tiles, hilb at every t_blk of K2_ENGINE_TBLK,
   and hilb's Hilbert launch alone); the de-emphasis recurrence against
   ``iir_filter`` on both builds, max abs error 0 on the outputs and the
   state, memory NaN-filled first (:func:`compare_deemph_edges`: C = 1,
   40 and 2,048 at 13, 14, 15, 65, 195 and 229 batches of 16 steps (one
   chunk of the lanes' rings and several, the last short), the lenses'
   2,048 x 16,384 and the K2 probe's 1,024 x 32,768, in place and out of
   place); the K1 probe's manual pipeline against ``i8man_plain`` on
   both builds (:func:`compare_man_edges`: the lens's tiles 8 x 2,048 and
   8 x 4,096 and others, dots and full, no at its least, the lens's and its
   most; a tile too large refused; its shared memory's C side against
   the host copy); the K1 probe's int8-direct forms on K12's staged
   tile against ``i8d_plain`` on both builds (:func:`compare_i8d_edges`:
   dots and full, K12's windows and noasm at every no, t_blk 512-4,096,
   and K12's windows at tiles that straddle a CTA's 1,024 outputs (8,192,
   3,584) and at 48, C = 5 and 40, B = 16,384 and 14,336, poisoned
   memory; full at 8,192 one launch by the profiler; the tiles and no the
   entry refuses, refused before any launch); the exact
   channelizer at every M it is instantiated for and its edge shapes on
   both builds (:func:`compare_chan_edges`: K = 1 and 17, T = 4,096,
   12,288 and 1,572,864 (more tiles than CTAs), every out form, words and
   planes, max abs error 0); the
   megakernel against its plain version and the f32w split path at C = 8
   and 40 inside the repeats above (:func:`compare_chain_small`), at every
   other order set of CHAIN_ANY_ORDERS (``chain_any_kernel``) at C = 8 and
   40 and on the bounds-checked build at C = 40
   (:func:`compare_chain_orders`), and at the chain cell's full width on
   the bounds-checked build (:func:`chain_cell_checked`), max abs error
   0;
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
   B=131,072, on packed words and float32 planes with de-emphasis (two
   blocks with carried state), float32 planes and complex64 (one block),
   with BPSK without a gain after it on the words; the chunked PLL
   (``pll_time_chunks=8``, after K12) at C=256 x B=1,048,576 and at C=5,
   two blocks; each input's statistics, failing on a constant one;
4. the pre-split main path at the bench cell (C=2048, B=131,072, int8
   planes made as bench.py makes them): one warm-up block, then 8 blocks
   through ``demod_block`` with the launch counters set to 0 just before
   and read just after; then each kernel and its plain version timed alone
   on the arguments ``demod_block`` gave it in the last block, and
   compared there with the tolerances of phase 3; BPSK also timed on
   zeros of its input's shape, beside its input's statistics
   (:func:`bpsk_alone`); the ds x4 stage's issue floors at the recorded
   shape (:func:`ds4_floors`; its time is the profile's); the
   cell profiled (its profile must show the blocked ds x4, the split mid
   end's four kernels and neither the fused kernel it replaced nor the
   de-emphasis, the PLL's, the blocked extract's and BPSK's; so must
   bench.py's wideband lens at splits=1, with the phase-split ds x4's and
   the matrix channelizer's, and the mid end's at every splits);
4b. the three split cells at C=2048 x B=131,072 (bench.py's signal):
   f32w (packed words, ``DemodConfig(assume_integer_input=True)``),
   complex (complex64, ``DemodConfig()``) and k12off (int8 planes,
   ``DemodConfig(frontend_int8=True, k12_fusion="off")``): one warm-up
   block, 8 counted blocks, then K1 and K2 timed alone beside their plain
   versions on the last block's arguments, and K1's issue floors at the
   recorded shape; the complex cell's K1 given the block itself (its
   complex64 storage, which the kernel reads in place); each profiled: K1
   one launch (f32w and complex ``k1_tile_kernel``, k12off the blocked
   ds x4), no ``k12_disc_kernel``, the split mid end (the complex cell's
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
   must show the split mid end's four kernels and none of the launches
   route's ds x2 and Hilbert, the de-emphasis, the fused kernel the split
   route replaced, nor the removed serial peak IIR and quantising pass);
4e. the two de-emphasis lenses (``demod --deemphasis-us 50``: pre-split
   and f32w with ``use_deemphasis_filter=True, deemphasis_cutoff_us=50``,
   C=2048 x B=131,072, bench.py's signal): one warm-up block, 8 counted
   blocks (every mid end launch on the split route, with its
   de-emphasis), K12 or K2
   timed alone beside its plain version on the last block's arguments,
   and the route's ds x2, de-emphasis and Hilbert kernels alone beside
   theirs, with their bounds and floors (computed: the FIRs' FMUL+FADD
   issue floors, the de-emphasis's chain floor, :func:`deemph_floor`);
   the de-emphasis launch's grid and block read from a profiler trace
   against the host's plan; each lens profiled (its profile must show
   the route's three kernels and none of the launches route's ds x2 and
   Hilbert, nor K12's discriminator launch);
4f. extract's other-order lens presplit_o96 (pre-split at
   ``order_poly_ds_lpf_audio = order_poly_ds_lpf_rds = 96``, C=2048 x
   B=131,072, bench.py's signal): one warm-up block, 8 counted blocks
   (every extract launch on ``extract_blocked_any_kernel``), extract
   timed alone beside its plain version on the last block's arguments
   and compared, with its bound and FMUL+FADD issue floor
   (:func:`ext_floor`), and profiled (its profile must show
   ``extract_blocked_any_kernel`` and neither ``extract_kernel`` nor
   ``extract_blocked_kernel``);
4g. the mid end's other-order lens presplit_mo96 (pre-split at
   ``order_poly_ds_lpf_fm_out = 96, order_fir_hilbert = 97``, C=2048 x
   B=131,072, bench.py's signal): one warm-up block, 8 counted blocks
   (every K12 launch on the split route's ``k12_mid_ds2_any_kernel`` and
   ``k12_mid_hilb_any_kernel``), K12 and the two kernels timed alone
   beside their plain versions on the last block's arguments and
   compared, with their bounds, FMUL+FADD issue floors (:func:`mid_floor`)
   and one ``F.conv1d`` call each (:func:`mid_library_ms`), and profiled
   (its profile must show both any-order kernels and none of the tiled
   kernels built for 64 / 65 taps, the launches route's ds x2, Hilbert
   and discriminator, the fused kernel or the de-emphasis);
4h. the float K1's other-order lens f32w_mo96 (f32w's words at
   ``order_poly_ds_lpf_fm_out = 96, order_fir_hilbert = 97``: K1's ds x4
   at 96 taps too, C=2048 x B=131,072, bench.py's signal): one warm-up
   block, 8 counted blocks (every K1 launch on ``k1_tile_any_kernel``, the
   mid end on its any-order kernels), K1 and K2 timed alone beside their
   plain versions on the last block's arguments and compared, K1 with its
   bound, FMUL+FADD issue floor (:func:`fp_floor`) and one ``F.conv1d``
   call for its ds x4 (:func:`k1_library_ms`), also with the int16 store
   and on complex64, and profiled (its profile must show
   ``k1_tile_any_kernel`` and the mid end's any-order kernels and none of
   ``k1_tile_kernel``, the 64 / 65-tap mid end or the launches route);
4i. the megakernel's other-order lens chain_o96 (the chain cell at
   orders 96 / 97 / 96 / 96, the audio and RDS orders too): one warm-up
   block, 8 counted blocks (every launch on ``chain_any_kernel``), the
   megakernel timed alone beside its plain version on the last block's
   arguments and compared, with its bound and its FIR stages' FMUL+FADD
   issue floor (:func:`chain_floor`), and profiled (its profile must show
   ``chain_any_kernel`` and not ``chain_kernel``); the registers, spills
   and shared memory of both kernels and their receiver's-order twins;
4j. the stream path (models/app.py::demod_stream: one CUDA graph a
   call) on the pre-split cell (8 blocks a call) and the f32w and chain
   cells (2), each on one block of bench.py's signal repeated in time on
   the card: the first call captures (its ms and the bytes of the graph's
   pool; the launch counters, set to 0 just before, count the capture's
   wrapper calls), a second replays the cached graph (no counted launch),
   a call after ``update_controls`` captures anew, each bit for bit a
   host loop of ``demod_block`` over the same blocks; the wall ms a block
   of both (best of 3) and their device-busy ms a block (profiled); the
   three cells again on the bounds-checked build at C=64 x B=16,384; a
   checkpoint round trip (``utils/checkpoint.py``, C=40 x B=16,384: the
   resumed blocks bit for bit) on both builds;
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
7. wideband stations through ``StationsApp`` (the loop around
   ``wideband_demod_block``, bench.py's wideband path; no command uses it
   since the commands run the JAX commands' pipeline, 7c): 4 stations on
   an M=8 grid (flat int8 bridge, 2 s; every station's PI and name) and 3
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
7c. the commands at their own width on the card (:func:`commands_phase`,
   each with its launches counted from 0 and its path's kernels required,
   its wall seconds logged): ``stations --auto`` on M = 16 with 6
   stations on the carrier grid, 1.5 s, ``-b 65536`` (every PI and name;
   its wall and the device's idle share from its one run, profiled),
   ``stations --rds-native`` (the same summaries), ``scan`` (exactly the
   6 channels), ``channelize``, ``scrape`` on a 2 s station (both ingests,
   batch and ``--stream``: the same artifacts), ``tune`` at ``-r
   2048000`` and ``-r 8192000`` (1 s each: PI and both tones); the same
   capture through ``StationsApp`` for the record; then each against the
   plain versions on the host CPU on the first 0.5 s of its input
   (channelize: the whole capture): RDS bytes identical, audio SNR >= 75
   dB, scan's JSON (powers within 0.1 dB), channelize's bytes within 1.
   The host CPU's runs of phases 6-7c start together, before phase 6, in
   worker processes (:func:`station_cpu_pool`, one a core but two), and
   each phase waits for its own while the card's runs go on.

Any failed phase raises and the script exits non-zero.  Every line it
logs is also written to chiprun_out/chip_smoke.log beside the script.
It logs each phase's wall seconds as the phase ends ("[phase]"), and
before the last lines all of them in one summary line ("[phases]") and
its own wall time.  The last lines of standard
output are the nvidia-smi line, one JSON object with the
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
    ("k2_stream", "fm_radio_tpu_torch/csrc/k2_probe.cu",
     "tools/k2_probe.py:69"),
    ("k2_ds2", "fm_radio_tpu_torch/csrc/k2_probe.cu",
     "tools/k2_probe.py:69"),
    ("k2_hilb", "fm_radio_tpu_torch/csrc/k2_probe.cu",
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
# the mid end's split route's three kernels (kernel-line name, CUDA
# kernel, source, the TPU kernels whose parts they run: K12's and K2's,
# the de-emphasis's use_deemph at k12_pallas.py:69 and
# midend_pallas.py:147-161)
DEEMPH_NEW_KERNELS = (
    ("mid_ds2", "k12_mid_ds2_kernel", "fm_radio_tpu_torch/csrc/k12_stages.cuh",
     "fm_radio_tpu/kernels/k12_pallas.py:59, "
     "fm_radio_tpu/kernels/midend_pallas.py:225"),
    ("deemph", "k12_deemph_kernel", "fm_radio_tpu_torch/csrc/k12_stages.cuh",
     "fm_radio_tpu/kernels/k12_pallas.py:69, "
     "fm_radio_tpu/kernels/midend_pallas.py:147"),
    ("mid_hilb", "k12_mid_hilb_kernel",
     "fm_radio_tpu_torch/csrc/k12_stages.cuh",
     "fm_radio_tpu/kernels/k12_pallas.py:59, "
     "fm_radio_tpu/kernels/midend_pallas.py:225"),
)
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
# form, both taps and stores; its float taps summed in fir_dot's order),
# K12 (flat and phase-split) and K2 admit no slack on either route of their mid end: the
# split route sums every FIR output in the plain version's tap order; nor
# do the PLL (sequential and chunked: the chunked lanes' masks change no
# value), extract (at every order, on both of its kernels) and BPSK (its branch
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
       "channelizer_bf16mat": 1.0, "mid_ds2": 0.0, "mid_hilb": 0.0,
       "deemph": 0.0,
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
    # the mid end's split route, launched by K12 or K2 (each counts too),
    # and its three kernels alone (their comparisons and timings)
    ("midend_split", "midend", "launches_split"),
    ("mid_ds2", "midend", "launches_ds2"),
    ("deemph", "midend", "launches_de"),
    ("mid_hilb", "midend", "launches_hilb"),
    # the split route's any-order kernels, every launch (by K12, K2 or
    # alone): the filter orders other than the receiver's 64 / 65 taps
    ("mid_ds2_any", "midend", "launches_ds2_any"),
    ("mid_hilb_any", "midend", "launches_hilb_any"),
    # the float K1's and the megakernel's kernels at other filter orders
    # than the receiver's (k1_tile_any_kernel, chain_any_kernel), every
    # launch (each counts in its module's own counter too)
    ("frontend_any", "frontend", "launches_any"),
    ("chain_any", "chain", "launches_any"),
    ("pll_i16", "pll", "launches_i16"),
    ("extract_i16", "extract", "launches_i16"),
    ("extract_i16_f32dt", "extract", "launches_i16_f32dt"),
    # extract's blocked route, every launch (each form counts too), and its
    # launches at other orders than the receiver's (extract_blocked_any_kernel)
    ("extract_blocked", "extract", "launches_blocked"),
    ("extract_any", "extract", "launches_any"),
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
    """The max abs difference over the pairs of tensors; a NaN on one side
    only counts as inf (where both are NaN, as 0), so an output a kernel
    left unwritten over NaN-filled memory is never read as agreement."""
    def err(a, b):
        a, b = a.double(), b.double()
        d = (a - b).abs()
        d = torch.where(torch.isnan(a) & torch.isnan(b), 0.0, d)
        return float(torch.nan_to_num(d, nan=math.inf).max())

    return max((err(a, b) for a, b in pairs if a.numel()), default=0.0)


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
        elif a.numel():  # a tail of no samples (a 4-tap ds x4) holds none
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
    if name in ("mid_ds2", "mid_hilb"):  # tuples of planes
        return {"err": _max_err(zip(kout, pout))}
    if name == "deemph":  # (state, y)
        (sk, yk), (sp, yp) = kout, pout
        return {"err": max(_max_err([(yk, yp)]),
                           _max_err((sk[k], sp[k]) for k in sp))}
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
    nn_a, nn_r = co.taps_audio_lpr.shape[0], co.taps_rds.shape[0]
    return float(c) * (n * (2 * 15 + 8) + n // 4 * (2 + 4) * nn_a
                       + n // 8 * 4 * nn_r)


def ext_floor(nn_a: int, nn_r: int, c: int, n: int) -> dict:
    """Extract's FMUL+FADD issue floor on [C, n] analytic samples, ms
    (computed, not measured): an FMUL and an FADD a tap an output
    (-fmad=false) of the three ds x4 planes (nn_a taps) and the two ds x8
    planes (nn_r), at 128 a clock an SM, at this card's SM count and
    highest SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    hz = _sm_clock_hz()
    per_row = 2 * (3 * (n // 4) * nn_a + 2 * (n // 8) * nn_r)
    return {"fmul_fadd_floor_ms": float(c) * per_row / (128 * sms * hz) * 1e3,
            "orders": [nn_a, nn_r], "sms": sms, "sm_clock_hz": hz}


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
    if name == "mid_ds2":  # (w2_rev, tail2, src[, prev_theta, scale])
        src, tail2 = args[2], args[1]
        c, n4 = src.shape
        disc = 5.0 * c * n4 if len(args) > 3 else 0.0
        return (_nbytes(src, *args[3:4]) + 4 * c * (n4 // 2)
                + 2 * _nbytes(tail2),
                float(c) * (n4 // 2) * 2 * args[0].shape[0] + disc, 0.0)
    if name == "deemph":  # (b, a, state, x): y = the recurrence over x
        x = args[3]
        return (2 * _nbytes(x) + 4 * 4 * x.shape[0],
                5.0 * x.numel(), 0.0)
    if name == "mid_hilb":  # (wh_rev, htail, fm_out[, out_i16])
        fm_out, htail = args[2], args[1]
        out_b = 12 if len(args) > 3 and args[3] else 8
        return (_nbytes(fm_out, htail) + out_b * fm_out.numel(),
                float(fm_out.numel()) * 2 * args[0].shape[0], 0.0)
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
    if name == "deemph":
        return args[3].shape[-1]
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
    if not sa.numel():  # a tail of no samples (a filter without a halo)
        return 0.0
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
                odd_channels: int = 5, device="cuda", full: bool = True):
    """The int16 format's kernels against their plain versions on the card,
    on the arguments ``demod_block(interstage_i16=True)`` recorded,
    ``blocks`` blocks with carried state: K1 on each of SPLIT_FORMS (the
    int8-direct entry; float32 planes, integer planes and packed words with
    float and int8 taps; int8 planes with float taps), K2 with int16 in and
    out (also with de-emphasis on, on the float planes' fm_demod); on the
    int8-direct form the PLL (int16 theta and dt) and extract on its three
    type combinations (int16 planes and dt as recorded; int16 planes with
    the dequantised dt; both dequantised) and, when ``full``, the float
    PLL on the dequantised theta.  Then the int8-direct form at
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
                             ("extract", dq)]
                    if full:
                        todo.append(("pll", _dq_args("pll", calls["pll"])))
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
                            "midend_split": blocks, "pll_i16": blocks,
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


# phase 6d's station: its length, s, and block; the int16 route's keywords
STATION_I16_SECONDS, STATION_I16_BLOCK = 0.5, 65536
STATION_I16_CFG = {"frontend_int8": True, "interstage_i16": True}


def _station_i16_run(dev, kw: dict):
    """Phase 6d's run on ``dev``: the selftest station
    (:data:`STATION_I16_SECONDS`, int8 planes) through App with
    ``DemodConfig(**kw)``.  Returns the App, the seconds of its
    ``process`` and the input's samples."""
    from fm_radio_tpu_torch.apps.cli import selftest_planes
    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.models.app import App

    x8 = selftest_planes(STATION_I16_SECONDS, STATION_I16_BLOCK)
    t0 = time.perf_counter()
    app = App(block_size=STATION_I16_BLOCK, cfg=DemodConfig(**kw),
              channels=1, device=dev)
    app.process(x8)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)
    return app, time.perf_counter() - t0, x8.shape[-1]


def station_i16(device="cuda", legs=None) -> dict:
    """The selftest station (:data:`STATION_I16_SECONDS` of it, int8
    planes) through App with ``interstage_i16=True`` (the int8-direct K1
    -> K2 -> PLL -> extract in the int16 format) on the card and, with the
    plain versions, on the host CPU (the leg ``i16``); and the float32
    route (``DemodConfig(frontend_int8=True)``: K12) on the card.  RDS
    bytes and audio SNR of the card against the CPU, and of the int16
    route against the float32 one, the PI on each, and each card run's
    launches."""
    from fm_radio_tpu_torch.apps.cli import selftest_checks

    runs = {}
    for key, kw in (("card_i16", STATION_I16_CFG),
                    ("card_float", {"frontend_int8": True})):
        reset_counts()
        app, secs, n = _station_i16_run(device, kw)
        runs[key] = (app, secs, read_counts())
    cpu = cpu_leg(legs, "i16")
    runs["cpu_i16"] = (cpu, cpu.seconds, None)
    settle = int(0.15 * runs["card_i16"][0].demod.fs_audio)

    def vs(a, b):
        (ga, _, _), (gb, _, _) = runs[a], runs[b]
        return {"rds_bytes": int(ga.rds_bytes(0).size),
                "rds_identical": bool(np.array_equal(ga.rds_bytes(0),
                                                     gb.rds_bytes(0))),
                "snr_db": _snr_db(ga.audio[0, settle:], gb.audio[0, settle:])}

    return {"seconds_audio": n / 1_024_000, "block": STATION_I16_BLOCK,
            "card_vs_cpu": vs("card_i16", "cpu_i16"),
            "i16_vs_float_route": vs("card_i16", "card_float"),
            "rds_pi": {k: (cpu.pi if k == "cpu_i16"
                           else selftest_checks(r[0])["rds_pi"]["value"])
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
             "fp_i8d": "full:i8d:noasm",
             "fp_i8man": "full:i8man:tile=8x4096",
             "k2_stream": "stream", "k2_ds2": "ds2", "k2_hilb": "hilb",
             "k2_full": "full",
             "k2_restruct": "restruct:128", "k3_stream31": "stream31:t=1024",
             "k3_sum": "stream:t=1024",
             "k3_value": "value:run={run} (no tile)",
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
            plain = ((lambda: fp.i8d_plain(x8, True, t_blk, noasm=True))
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
        # FMUL + FADD an output of each FIR (-fmad=false)
        per = {"k2_stream": 0, "k2_ds2": 2 * nn2}.get(name,
                                                      2 * nn2 + 2 * nh)
        if name == "k2_hilb":
            # the Hilbert launch alone on the variant's fm_out: its bytes
            # (fm_out in, three planes out) and sums
            fm = k2.ds2_plain(x, co)[0]
            w.update(alone=lambda: k2.hilb_launch(fm, 1024, co),
                     alone_plain=lambda: k2.hilb_launch_plain(fm, 1024, co),
                     alone_bytes=4.0 * c * l + out,
                     alone_f32_ops=float(c) * l * 2 * nh)
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
        w.update(bytes=4.0 * c * b4 + out + (4 * c if name in ("k2_full",
                                                           "k2_restruct")
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
        variant = PROBE_REP[name].format(run=k3.VALUE_RUN)
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
        if "alone" in w:  # one launch of the variant, alone: compared,
            # then timed (5 calls after one) beside its plain version
            aout = w["alone"]()
            pout, alone_plain_ms = _cuda_ms(w["alone_plain"], 1)
            alone_err = _probe.max_err(aout, pout)
            if alone_err != 0.0:
                raise RuntimeError(f"{name}: its launch alone disagrees "
                                   f"with its plain version: {alone_err}")
            _, alone_ms = _cuda_ms(w["alone"], 5)
            kernels[name]["launch_alone"] = {
                "ms": alone_ms, "plain_ms": alone_plain_ms,
                "max_abs_err": alone_err,
                **bound_of(w["alone_bytes"], w["alone_f32_ops"])}
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
                            "midend_split": blocks,
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


# the launches that open every profiler window (:func:`open_window`): the
# trace has kept no record of a window's first launches on the card's
# hosts (the first 19 of each window in launch_grids' "[trace]" lines, the
# first block's first kernels in _profile's windows), so these one-element
# spin kernels (``torch.cuda._sleep``, which no step launches) take that
# loss, and every sum of device time leaves them out
PROFILE_PAD = 64
PAD_KERNEL = "spin_kernel"


def open_window(device) -> None:
    """The :data:`PROFILE_PAD` launches that open a profiler window, and a
    synchronise."""
    for _ in range(PROFILE_PAD):
        torch.cuda._sleep(1)
    torch.cuda.synchronize(device)


def _profile(label: str, step, blocks: int, device,
             per_step: int = 1) -> dict:
    """Device time per block of each CUDA kernel (``torch.profiler``) over
    ``blocks`` calls of ``step`` after two warm-up calls, the host wall
    time per block, and the device's idle share (1 - kernel time /
    wall).  The window opens with :func:`open_window`'s launches, which
    take the profiler's loss of a window's first records.  A window where
    a port kernel's count is still not a multiple of ``blocks`` (times
    ``per_step``, the launches of a kernel in one call of ``step``) is
    profiled again, up to three times in all, and the row says how many
    it took and what was still lost."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step()
    torch.cuda.synchronize(device)
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            open_window(device)
            t0 = time.perf_counter()
            for _ in range(blocks):
                step()
            torch.cuda.synchronize(device)
            wall = (time.perf_counter() - t0) * 1e3 / blocks
        per, lost = {}, {}
        for e in prof.key_averages():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and PAD_KERNEL not in e.key):
                us = getattr(e, "self_device_time_total", None)
                if us is None:
                    us = e.self_cuda_time_total
                key = e.key[:60]  # kernels whose names share it are summed
                per[key] = per.get(key, 0.0) + float(us) / 1e3 / blocks
                if "fmt::" in e.key and e.count % (blocks * per_step):
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


# the de-emphasis lenses (demod --deemphasis-us 50): bench.py's signal at
# the split cells' shape with the de-emphasis on, as int8 planes through
# K12 (pre-split) and as packed words through K1 -> K2 (f32w); and the
# wrapper each one's mid end runs in
DEEMPH = {"use_deemphasis_filter": True, "deemphasis_cutoff_us": 50}
DEEMPH_LENSES = (
    ("presplit_de", "i8", {"frontend_int8": True, **DEEMPH}),
    ("f32w_de", "words", {"assume_integer_input": True, **DEEMPH}),
)
DEEMPH_MID = {"presplit_de": "k12", "f32w_de": "midend"}
# the split route's kernels with the de-emphasis (csrc/k12_stages.cuh),
# which each lens's profile must show, and the launches it must not: the
# launches route's ds x2 and Hilbert, and (pre-split) K12's discriminator
# launch
DEEMPH_KERNELS = ("k12_mid_ds2_kernel", "k12_deemph_kernel",
                  "k12_mid_hilb_kernel")
DEEMPH_GONE = {"presplit_de": ("fir_decimate_kernel", "k12_hilbert_kernel",
                               "k12_disc_kernel", "k12_mid_ds2_any_kernel",
                               "k12_mid_hilb_any_kernel"),
               "f32w_de": ("fir_decimate_kernel", "k12_hilbert_kernel",
                           "k12_mid_ds2_any_kernel",
                           "k12_mid_hilb_any_kernel")}


def mid_floor(name: str, args) -> dict:
    """The floor of the split route's kernel ``name`` on its
    arguments, ms (computed, not measured): for "mid_ds2" and "mid_hilb"
    the FMUL+FADD issue floor, an FMUL and an FADD a tap an output
    (-fmad=false), at 128 a clock an SM, at this card's SM count and
    highest SM clock; for "deemph" the recurrence's chain floor
    (:func:`deemph_floor`)."""
    if name == "deemph":
        return deemph_floor(args[3].shape[-1])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    hz = _sm_clock_hz()
    taps = args[0].shape[0]
    outs = float(args[2].numel()) / (2 if name == "mid_ds2" else 1)
    return {"fmul_fadd_floor_ms": outs * 2 * taps / (128 * sms * hz) * 1e3,
            "instructions_an_output": 2 * taps, "outputs": outs, "sms": sms,
            "sm_clock_hz": hz}


def mid_alone_args(mid: str, calls: dict) -> dict:
    """The split route's kernels' arguments on a lens's recorded block
    (``calls``; ``mid`` the mid end's wrapper, "k12" or "midend"): ds x2
    on theta1 (K12, made by the plain ds x4 from the block) or on fm_demod
    (K2) with the carried ds x2 tail; where it is on, the de-emphasis on
    that block's fm_out (the plain ds x2, which the kernel equals bit for
    bit) with the carried de-emphasis state; Hilbert on the (de-emphasised)
    fm_out with the carried Hilbert tail."""
    from fm_radio_tpu_torch.kernels import midend as km
    from fm_radio_tpu_torch.kernels.frontend import _scale, ds4_theta_plain
    from fm_radio_tpu_torch.ops.iir import iir_filter

    co, cfg, st, x = calls[mid][:4]
    a = km.mid_args("lens", co, cfg, st, x.shape[-2], x.device)
    if mid == "k12":
        theta1, _ = ds4_theta_plain(co, st, x, True)
        ds2 = (a["w2_rev"], a["tail2"], theta1.contiguous(),
               st["disc_prev_theta"].contiguous(), _scale(cfg))
    else:
        ds2 = (a["w2_rev"], a["tail2"], x)
    fm_out, _ = km.mid_ds2_plain(*ds2)
    out = {"mid_ds2": ds2}
    if cfg.use_deemphasis_filter:
        out["deemph"] = (co.deemph_b, co.deemph_a, st["deemph"],
                         fm_out.contiguous())
        _, fm_out = iir_filter(*out["deemph"])
    out["mid_hilb"] = (a["wh_rev"], a["htail"], fm_out.contiguous())
    return out


def lens_run(label: str, kind: str, kw: dict, channels: int, block: int,
             blocks: int, want: dict, device) -> tuple[dict, dict]:
    """A lens as the split cells run: bench.py's signal in the form
    ``kind`` under ``DemodConfig(**kw)``, one warm-up block, then
    ``blocks`` blocks through ``demod_block`` with the launch counters set
    to 0 just before and read just after (each kernel of ``want`` launched
    that many times a block, every other not at all), the outputs' shape
    and finiteness checked.  Returns (the row: launches, ms/block, Msps,
    peak memory; the last block's recorded arguments; the block)."""
    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.models.demod import (
        demod_block, demod_init_state, make_coeffs)

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
    check_counts(launches, {k: n * blocks for k, n in want.items()},
                 f"lens {label}")
    if tuple(outs["audio"].shape) != (channels, block // 32, 2):
        raise RuntimeError(f"{label}: audio shape "
                           f"{tuple(outs['audio'].shape)}")
    for k in ("audio", "rds_pred"):
        if not bool(torch.isfinite(outs[k]).all()):
            raise RuntimeError(f"{label}: non-finite {k}")
    res = {"cell": label, "config": kw, "input": kind, "channels": channels,
           "block": block, "blocks": blocks, "inputs": input_stats(x),
           "launches": launches, "ms_per_block": ms / blocks,
           "msps": channels * block * blocks / (ms / 1e3) / 1e6,
           "peak_mib": torch.cuda.max_memory_allocated(device) / 2 ** 20}
    return res, calls, x


# the receiver's launches after the mid end, once a block on every lens
LENS_TAIL = {"pll": 1, "extract": 1, "extract_blocked": 1, "bpsk": 1}


def deemph_lens(label: str, kind: str, kw: dict, channels: int = 2048,
                block: int = 131072, blocks: int = 8, device="cuda") -> dict:
    """One de-emphasis lens (:data:`DEEMPH_LENSES`) as the split cells run
    (:func:`lens_run`: every launch of the mid end on the split route,
    with its de-emphasis), then the mid end's wrapper (K12 or K2) timed
    alone beside its plain version on the last block's arguments and
    compared, and the route's three kernels alone beside theirs
    (:func:`mid_alone_args`), with their bounds and issue and chain
    floors (:func:`mid_floor`); the de-emphasis launch's grid against the
    host's plan."""
    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.kernels import midend as km
    from fm_radio_tpu_torch.models.demod import (
        demod_block, demod_init_state, make_coeffs)

    mid = DEEMPH_MID[label]
    front = {"k12": 1} if mid == "k12" else {"frontend": 1, "midend": 1}
    res, calls, x = lens_run(label, kind, kw, channels, block, blocks,
                             {**front, "midend_split": 1, **LENS_TAIL},
                             device)
    alone = mid_alone_args(mid, calls)
    (res["kernel_ms"], res["plain_ms"], res["compare"],
     res["bound"]) = time_stages({mid: calls[mid], **alone})
    res["floors"] = {n: mid_floor(n, a) for n, a in alone.items()}
    # the de-emphasis launch's grid and block as the card ran them, against
    # the host's plan (kernels/midend.py::midend_plan, DEEMPH_LANES)
    cfg = DemodConfig(**kw)
    co = make_coeffs(cfg, device)
    st0 = demod_init_state(cfg, channels, device)
    grids = launch_grids(lambda: demod_block(cfg, co, st0, x),
                         ("k12_deemph_kernel",), device)["k12_deemph_kernel"]
    plan = dict(km.midend_plan(co, cfg, channels, block // 4))
    want = [[plan["k12_deemph_kernel"][0], 1, 1], [km.DEEMPH_LANES, 1, 1]]
    res["deemph_grid"] = {"launches": grids, "plan": want}
    if grids != [want]:
        raise RuntimeError(f"{label}: k12_deemph_kernel ran on {grids}, not "
                           f"the plan's grid and block {want}")
    return res


# extract's other-order lens (not a bench.py cell: users who change the
# filter orders, DemodConfig.order_poly_ds_lpf_audio / _rds, take
# extract_blocked_any_kernel): the pre-split cell at extract orders 96 /
# 96; the kernel its profile must show, and the ones it must not
ORDER_LENSES = (("presplit_o96", "i8",
               {"frontend_int8": True, "order_poly_ds_lpf_audio": 96,
                "order_poly_ds_lpf_rds": 96}),)
EXT_ANY = "extract_blocked_any_kernel"
EXT_GONE = ("extract_kernel", "extract_blocked_kernel")


def order_lens(label: str, kind: str, kw: dict, channels: int = 2048,
               block: int = 131072, blocks: int = 8, device="cuda") -> dict:
    """The other-order lens (:data:`ORDER_LENSES`) as the cells run
    (:func:`lens_run`: every extract launch on extract_blocked_any_kernel),
    then extract timed alone beside its plain version on the last block's
    arguments and compared, with its bound and its FMUL+FADD issue floor
    (:func:`ext_floor`)."""
    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.models.demod import make_coeffs

    res, calls, _ = lens_run(label, kind, kw, channels, block, blocks,
                             {"k12": 1, "midend_split": 1, "extract_any": 1,
                              **LENS_TAIL}, device)
    co = make_coeffs(DemodConfig(**kw), device)
    (res["kernel_ms"], res["plain_ms"], res["compare"],
     res["bound"]) = time_stages({"extract": calls["extract"]})
    res["floor"] = ext_floor(co.taps_audio_lpr.shape[0],
                             co.taps_rds.shape[0], channels, block // 8)
    return res


# the mid end's other-order lens (not a bench.py cell: users who want a
# sharper 76 kHz decimation and Hilbert filter set
# DemodConfig.order_poly_ds_lpf_fm_out and order_fir_hilbert): the
# pre-split cell at 96 ds x2 taps and a 97-tap Hilbert filter (K12's ds x4,
# of the same order, keeps its register-blocked code: 96 % 16 == 0); the
# kernels its profile must show (the split route's any-order forms), and
# the ones it must not (the receiver's tiled kernels, the launches route's
# ds x2, Hilbert and discriminator, the fused kernel, the de-emphasis)
MID_ORDER_LENSES = (("presplit_mo96", "i8",
                     {"frontend_int8": True, "order_poly_ds_lpf_fm_out": 96,
                      "order_fir_hilbert": 97}),)
MID_ANY = ("k12_mid_ds2_any_kernel", "k12_mid_hilb_any_kernel")
MID_ANY_GONE = ("k12_mid_ds2_kernel", "k12_mid_hilb_kernel",
                "fir_decimate_kernel", "k12_hilbert_kernel", "k12_disc_kernel",
                "k12_mid_fused_kernel", "k12_deemph_kernel")


def mid_order_lens(label: str, kind: str, kw: dict, channels: int = 2048,
                   block: int = 131072, blocks: int = 8,
                   device="cuda") -> dict:
    """The mid end's other-order lens (:data:`MID_ORDER_LENSES`) as the
    cells run (:func:`lens_run`: every K12 launch on the split route's
    any-order kernels), then K12 timed alone beside its plain version on
    the last block's arguments and compared, and the route's two kernels
    alone beside theirs (:func:`mid_alone_args`: ds x2 on theta1), with
    their bounds and FMUL+FADD issue floors (:func:`mid_floor`)."""
    res, calls, _ = lens_run(label, kind, kw, channels, block, blocks,
                             {"k12": 1, "midend_split": 1, "mid_ds2_any": 1,
                              "mid_hilb_any": 1, **LENS_TAIL}, device)
    from fm_radio_tpu_torch.kernels import midend as km
    from fm_radio_tpu_torch.kernels.qformat import FM_SCALE, q_i16
    from fm_radio_tpu_torch.ops.discriminator import discriminate_theta

    alone = mid_alone_args("k12", calls)
    (res["kernel_ms"], res["plain_ms"], res["compare"],
     res["bound"]) = time_stages({"k12": calls["k12"], **alone})
    res["floors"] = {n: mid_floor(n, a) for n, a in alone.items()}
    res["library"] = {n: mid_library_ms(n, a) for n, a in alone.items()}
    # the route's other forms at the lens's orders, alone on the same
    # block: K2's ds x2 on float32 and int16 fm_demod (the plain
    # discriminator's output), Hilbert with the int16 outputs
    w2, tail2, theta1, prev, scale = alone["mid_ds2"]
    _, fmd = discriminate_theta(prev, theta1, scale)
    forms = {"mid_ds2:f32": (w2, tail2, fmd.contiguous()),
             "mid_ds2:i16": (w2, tail2, q_i16(fmd, FM_SCALE)),
             "mid_hilb:out_i16": (*alone["mid_hilb"], True)}
    res["forms"] = {}
    for key, args in forms.items():
        name = key.split(":")[0]
        kern, plain = ((km.mid_ds2, km.mid_ds2_plain) if name == "mid_ds2"
                       else (km.mid_hilb, km.mid_hilb_plain))
        kern(*args)
        kout, ms = _cuda_ms(lambda: kern(*args), reps=5)
        e = stage_errors(name, kout, plain(*args))
        row = dict(_verdict(name, e), form=key.split(":")[1])
        res["compare"].append(row)
        res["forms"][key] = {"ms": ms, "max_abs_err": row["max_abs_err"],
                             "bound_ms": bound(name, args)["bound_ms"]}
    return res


def mid_library_ms(name: str, args) -> dict:
    """One PyTorch call that computes the FIR of the split route's kernel
    ``name`` (``mid_ds2`` or ``mid_hilb``) on its arguments, timed (CUDA
    events, mean of 5 after one) and used nowhere in the port:
    ``F.conv1d`` over the carried tail and the source, made once
    beforehand, with the kernel's reversed taps, stride 2 for ds x2 and 1
    for Hilbert (its im; re is the delayed input).  On theta1 (K12's form)
    it runs over theta1 as it stands: the discriminator is not in it.
    cuDNN runs in float32 (the port turns TF32 off)."""
    return conv1d_ms(*args[:3], 2 if name == "mid_ds2" else 1)


def conv1d_ms(w, tail, src, stride: int) -> dict:
    """``F.conv1d`` over [tail | src] (rows [N, L], one input channel each,
    made once beforehand) with the reversed taps ``w`` at ``stride``, timed
    (CUDA events, mean of 5 after one)."""
    import torch.nn.functional as fnn

    x = torch.cat([tail, src], dim=-1).unsqueeze(1).contiguous()
    fnn.conv1d(x, w.view(1, 1, -1), stride=stride)
    _, ms = _cuda_ms(lambda: fnn.conv1d(x, w.view(1, 1, -1), stride=stride),
                     reps=5)
    return {"library_ms": ms,
            "library": f"F.conv1d([tail | src], w_rev, stride={stride})"}


# the float K1's and the megakernel's other-order lenses (not bench.py's
# cells: users who want a sharper 76 kHz decimation set
# DemodConfig.order_poly_ds_lpf_fm_out, which sizes K1's ds x4 as well as
# the ds x2, models/demod.py:134, the reference's quirk): f32w at 96 ds x4
# and ds x2 taps and a 97-tap Hilbert filter (K1 on k1_tile_any_kernel,
# the mid end on the split route's any-order kernels), and the chain cell
# at 96 / 97 / 96 / 96 with the audio and RDS orders too
# (chain_any_kernel); the kernel each profile must show, and the ones it
# must not (the kernels built for the receiver's orders)
K1_ORDER_LENSES = (("f32w_mo96", "words",
                    {"assume_integer_input": True,
                     "order_poly_ds_lpf_fm_out": 96,
                     "order_fir_hilbert": 97}),)
K1_ANY = "k1_tile_any_kernel"
K1_ANY_GONE = ("k1_tile_kernel", "k12_mid_ds2_kernel", "k12_mid_hilb_kernel",
               "fir_decimate_kernel", "k12_hilbert_kernel")
CHAIN_ORDER_LENSES = (("chain_o96", "words",
                       {"assume_integer_input": True, "chain_fusion": "auto",
                        "order_poly_ds_lpf_fm_out": 96,
                        "order_fir_hilbert": 97,
                        "order_poly_ds_lpf_audio": 96,
                        "order_poly_ds_lpf_rds": 96}),)
CHAIN_ANY = "chain_any_kernel"
CHAIN_ANY_GONE = ("chain_kernel",)


def k1_library_ms(args) -> dict:
    """One PyTorch call that computes K1's ds x4 FIR on its recorded
    arguments, used nowhere in the port (row 13a's yardstick for the K1
    probe): :func:`conv1d_ms` over the carried tail and the block as 2C
    rows (the re planes, then the im planes, unpacked beforehand), the
    reversed taps, stride 4.  cuDNN runs in float32 (the port turns TF32
    off)."""
    from fm_radio_tpu_torch.kernels.frontend import input_planes

    co, _, st, x = args[:4]
    tail = st["ds_fm_in"]
    rows = [torch.stack(p).reshape(-1, p[0].shape[-1])
            for p in ((tail.real, tail.imag), input_planes(x))]
    return dict(conv1d_ms(co.taps_fm_in.flip(0).contiguous(), *rows, 4),
                taps=co.taps_fm_in.shape[0])


def chain_floor(co, c: int, b: int) -> dict:
    """The megakernel's FIR stages' FMUL+FADD issue floor on [C, B], ms
    (computed, not measured): an FMUL and an FADD a tap an output
    (-fmad=false) of ds x4 (both planes), ds x2, Hilbert and extract's five
    FIRs (the RDS pair at its own order), at 128 a clock an SM, at this
    card's SM count and highest SM clock; each stage's share beside it."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    hz = _sm_clock_hz()
    n4, n8 = b // 4, b // 8
    nn1, nn2, nh = (co.taps_fm_in.shape[0], co.taps_fm_out.shape[0],
                    co.taps_hilbert.shape[0])
    nn_a, nn_r = co.taps_audio_lpr.shape[0], co.taps_rds.shape[0]
    per_row = {"ds4": 2 * 2 * n4 * nn1, "ds2": 2 * n8 * nn2,
               "hilbert": 2 * n8 * nh,
               "extract": 2 * (3 * (n8 // 4) * nn_a + 2 * (n8 // 8) * nn_r)}
    ms = {k: float(c) * v / (128 * sms * hz) * 1e3 for k, v in per_row.items()}
    return {"fmul_fadd_floor_ms": sum(ms.values()), "stages_ms": ms,
            "orders": [nn1, nn2, nh, nn_a, nn_r], "sms": sms,
            "sm_clock_hz": hz}


def k1_order_lens(label: str, kind: str, kw: dict, channels: int = 2048,
                  block: int = 131072, blocks: int = 8,
                  device="cuda") -> dict:
    """The float K1's other-order lens (:data:`K1_ORDER_LENSES`) as the
    cells run (:func:`lens_run`: every K1 launch on k1_tile_any_kernel, the
    mid end on the split route's any-order kernels), then K1 and K2 timed
    alone beside their plain versions on the last block's arguments and
    compared, with their bounds, K1's FMUL+FADD issue floor
    (:func:`fp_floor` at the lens's order) and one ``F.conv1d`` call
    (:func:`k1_library_ms`); K1 also with the int16 store and on the
    block as complex64 (``input_planes``' samples, read in place), alone
    beside their plain versions."""
    from fm_radio_tpu_torch.kernels import frontend as kf

    res, calls, x = lens_run(label, kind, kw, channels, block, blocks,
                             {"frontend": 1, "frontend_any": 1, "midend": 1,
                              "midend_split": 1, "mid_ds2_any": 1,
                              "mid_hilb_any": 1, **LENS_TAIL}, device)
    k1 = calls["frontend"]
    (res["kernel_ms"], res["plain_ms"], res["compare"],
     res["bound"]) = time_stages({"frontend": k1, "midend": calls["midend"]})
    nn = k1[0].taps_fm_in.shape[0]
    res["floor"] = fp_floor(channels, block, nn)
    res["library"] = k1_library_ms(k1)
    xr, xi = kf.input_planes(x)
    forms = {"out_i16": (*k1[:4], False, True),
             "complex": (*k1[:3], torch.complex(xr, xi), False)}
    res["forms"] = {}
    for form, args in forms.items():
        name = "frontend_i16" if form == "out_i16" else "frontend"
        kf.frontend(*args)
        kout, ms = _cuda_ms(lambda: kf.frontend(*args), reps=5)
        e = stage_errors("frontend", kout, kf.frontend_plain(*args))
        row = dict(_verdict(name, e), form=form)
        res["compare"].append(row)
        res["forms"][form] = {"ms": ms, "max_abs_err": row["max_abs_err"],
                              "bound_ms": bound(name, args)["bound_ms"]}
    return res


def chain_order_lens(label: str, kind: str, kw: dict, channels: int = 2048,
                     block: int = 131072, blocks: int = 8,
                     device="cuda") -> dict:
    """The megakernel's other-order lens (:data:`CHAIN_ORDER_LENSES`) as
    the cells run (:func:`lens_run`: every launch on chain_any_kernel),
    then the megakernel timed alone beside its plain version on the last
    block's arguments and compared, with its bound and its FIR stages'
    FMUL+FADD issue floor (:func:`chain_floor`)."""
    res, calls, _ = lens_run(label, kind, kw, channels, block, blocks,
                             {"chain": 1, "chain_any": 1, "bpsk": 1},
                             device)
    (res["kernel_ms"], res["plain_ms"], res["compare"],
     res["bound"]) = time_stages({"chain": calls["chain"]})
    res["floor"] = chain_floor(calls["chain"][0], channels, block)
    return res


def launch_grids(step, names, device, reps: int = 3) -> dict:
    """The (grid, block) pairs of the launches of the kernels ``names`` in
    ``reps`` calls of ``step`` (after one unprofiled call) inside one
    profiler window that :func:`open_window` opens, as the trace records
    them (its kernel events' "grid" and "block"): {name: the distinct
    pairs, in order}.  Each window's launches that have no kernel record
    (a runtime launch event whose correlation id no kernel event carries)
    are logged ("[trace]": how many of the opening launches, how many of
    the steps' and their places among them), and a trace without one of
    ``names`` is taken again, up to three in all."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize(device)
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            open_window(device)
            for _ in range(reps):
                step()
            torch.cuda.synchronize(device)
        path = os.path.join(DUMP_DIR, "launch_grids_trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(path)
        kernels = [ev for ev in events if ev.get("cat") == "kernel"]
        launches = sorted((ev for ev in events
                           if ev.get("cat") == "cuda_runtime"
                           and "Launch" in ev.get("name", "")),
                          key=lambda ev: ev.get("ts", 0))
        recorded = {ev.get("args", {}).get("correlation") for ev in kernels}
        lost = [i for i, ev in enumerate(launches)
                if ev.get("args", {}).get("correlation") not in recorded]
        lost_pad = sum(i < PROFILE_PAD for i in lost)
        lost = [i - PROFILE_PAD for i in lost if i >= PROFILE_PAD]
        out = {n: [] for n in names}
        for ev in kernels:
            for n in names:
                if n in ev.get("name", ""):
                    gb = [ev["args"].get("grid"), ev["args"].get("block")]
                    if gb not in out[n]:
                        out[n].append(gb)
        log(f"[trace] launch_grids {list(names)}, window {attempt}: "
            f"without a kernel record {lost_pad} of the {PROFILE_PAD} "
            f"opening launches, {len(lost)} of the steps' "
            f"{len(launches) - PROFILE_PAD}, at places {lost[:12]}"
            f"{' ... ' + str(lost[-1]) if len(lost) > 12 else ''}; found "
            f"{[n for n in names if out[n]]}")
        if all(out.values()):
            break
    return out


def floors_ms(f: dict) -> dict:
    """The floors (every "*_floor_ms" key) of a floor's dict."""
    return {k: v for k, v in f.items() if k.endswith("_floor_ms")}


def profile_wideband(splits: int, n_captures: int = 64, m: int = 32,
                     block: int = 131072, blocks: int = 3,
                     amp: float = BENCH_AMP, bridge: str = "i8",
                     device="cuda") -> dict:
    """:func:`_profile` of the wideband cell with the channelizer in mode
    ``splits``, on captures of amplitude ``amp``, through the int8 bridge
    (``INT8_CONFIG``) or, with ``bridge="f32"``, the float32 one
    (``DemodConfig()``: K1 then K2), as :func:`wideband_path` runs it."""
    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.kernels.channelizer import make_tables
    from fm_radio_tpu_torch.models.demod import INT8_CONFIG, make_coeffs
    from fm_radio_tpu_torch.models.wideband import (
        wideband_demod_block, wideband_init_state)
    from fm_radio_tpu_torch.parallel.channelizer import make_channelizer_taps

    cfg = INT8_CONFIG if bridge == "i8" else DemodConfig()
    co = make_coeffs(cfg, device)
    tab = make_tables(make_channelizer_taps(m, 16), m, device)
    state = [wideband_init_state(cfg, m, n_captures, 16, device)]
    x = wideband_words(n_captures, m, block, seed=0, device=device,
                       amp=amp).reshape(n_captures, -1, 128)

    def step():
        state[0], _ = wideband_demod_block(cfg, co, tab, state[0], x, m,
                                           bridge=bridge, splits=splits)

    label = f"wideband_m{m}_splits{splits}" + ("_f32" if bridge == "f32"
                                                else "")
    return _profile(label, step, blocks, device)


# the pre-split cell (bench.py's default), profiled as the split cells
PRESPLIT_CELL = ("presplit", "i8", {"frontend_int8": True})
# the mid end's split route without the de-emphasis (csrc/k12_stages.cuh),
# which K12 launches on the pre-split cell: what every cell's profile but
# chain's and the de-emphasis lenses' must show
SPLIT_MID = ("k12_mid_ds2_kernel", "k12_mid_hilb_kernel",
             "k12_peak_rec_kernel", "k12_theta_kernel")
# what none of those profiles may show: the fused kernel the split route
# replaced, the launches route's ds x2 and Hilbert, the peak IIR and
# quantising pass the int16 forms once took, the de-emphasis, and the
# split route's any-order kernels (other filter orders than the cells')
SPLIT_MID_GONE = ("k12_mid_fused_kernel", "fir_decimate_kernel",
                  "k12_hilbert_kernel", "k12_peak_kernel", "q_i16_kernel",
                  "k12_deemph_kernel", "k12_mid_ds2_any_kernel",
                  "k12_mid_hilb_any_kernel")
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
# the float K1's tile at the receiver's order and at any other
FLOAT_K1 = (K1_TILE, K1_ANY)
DS4_KERNELS = (DS4_FLAT, DS4_PS) + FLOAT_K1
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


def showing(prof: dict, names) -> list:
    """The kernels of ``names`` that do have device time in ``prof``."""
    gone = lacking(prof, names)
    return [k for k in names if k not in gone]


def device_ms(prof: dict, name: str) -> float:
    """Kernel ``name``'s device ms a block in the profile ``prof`` (every
    instantiation summed)."""
    return sum(v for key, v in prof["device_ms_per_block"].items()
               if key.startswith(name) or f"::{name}" in key)

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
                  device="cuda", full: bool = True):
    """The megakernel against its plain version on the card, on the
    arguments ``demod_block(chain_fusion="auto")`` recorded, ``blocks``
    blocks with carried state on each of CHAIN_FORMS (packed words, float32
    planes with de-emphasis off and on, complex64), and BPSK without a gain
    (the megakernel's route) on each form's recorded arguments.  Not
    ``full``: the carried blocks and BPSK only on packed words (the chain
    cell's form), the carried blocks also on the de-emphasis (its own
    state), one block on the float32 planes and complex64 (the same body
    and state, another load).  Returns the verdict rows (chain, then BPSK
    without a gain) with each form's input statistics under "inputs"."""
    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.models.demod import (
        demod_block, demod_init_state, make_coeffs)

    stages = _stages()
    acc, stats = {}, {}
    for label, kind, kw in CHAIN_FORMS:
        cfg = DemodConfig(**kw)
        co = make_coeffs(cfg, device)
        st = demod_init_state(cfg, channels, device)
        carried = full or label in ("words", "planes_deemph")
        x = split_input(kind, channels, block * blocks, 5, device)
        stats[label] = input_stats(x)
        for blk in range(blocks if carried else 1):
            calls = {}
            xb = x[..., blk * block : (blk + 1) * block].contiguous()
            st, _ = demod_block(cfg, co, st, xb, record=calls)
            if list(calls) != ["chain", "bpsk"] or calls["bpsk"][3] is not None:
                raise RuntimeError(f"chain form {label}: route {list(calls)}")
            for name in (("chain", "bpsk") if full or label == "words"
                         else ("chain",)):
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
                                "bpsk": blocks, "midend_split": blocks,
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


# phase 3a's repeats on fresh seeds: the default build's, and each of the
# bounds-checked build's two channel counts' (few, so that the whole run
# keeps within its time limit)
K12_REPEATS, K12_REPEATS_CHECKED = 3, 2


def k12_repeats(repeats: int = K12_REPEATS, channels: int = 8,
                block: int = 16384,
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


# the megakernel's other filter orders (chain_any_kernel), as
# (order_poly_ds_lpf_fm_out: the ds x4 and ds x2, order_fir_hilbert,
# order_poly_ds_lpf_audio, order_poly_ds_lpf_rds): the lens chain_o96's;
# one of each filter off the receiver's; the receiver's ds x4 with other
# extract orders and the reverse; the shortest and the longest every halo
# admits; odd extract orders (their extra phase steps) and planes shifted
# down (ch_shift < 0)
CHAIN_ORDER_KEYS = ("order_poly_ds_lpf_fm_out", "order_fir_hilbert",
                    "order_poly_ds_lpf_audio", "order_poly_ds_lpf_rds")
CHAIN_ANY_ORDERS = tuple(dict(zip(CHAIN_ORDER_KEYS, o)) for o in (
    (96, 97, 96, 96), (48, 33, 64, 72), (64, 65, 96, 96),
    (96, 97, 128, 128), (4, 3, 4, 8), (128, 129, 132, 136),
    (124, 65, 97, 131), (28, 63, 61, 93)))


def compare_chain_small(seed: int, channels: int = 8, block: int = 16384,
                        blocks: int = 2, device="cuda",
                        orders: dict | None = None) -> dict:
    """The megakernel on CHAIN_CELL's configuration (with ``orders``, those
    filter orders) at C = ``channels``, B = ``block``: against its plain
    version on the arguments ``demod_block`` recorded, and the same packed
    words through the f32w split path (K1 -> K2 -> PLL -> extract kernels)
    from one start state, ``blocks`` blocks: audio and every state leaf
    before the RDS AGC; every block a launch of the kernel its orders take
    (chain_any_kernel off the receiver's).  Returns one verdict row (max
    abs error 0 on both counts)."""
    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.kernels import chain as kc
    from fm_radio_tpu_torch.models.demod import (
        demod_block, demod_init_state, make_coeffs)

    _, kind, kw = CHAIN_CELL
    cfg = DemodConfig(**kw, **(orders or {}))
    cfg_s = DemodConfig(assume_integer_input=True, **(orders or {}))
    co = make_coeffs(cfg, device)
    st_c = st_s = demod_init_state(cfg, channels, device)
    x = split_input(kind, channels, block * blocks, seed, device)
    acc, vs = {}, 0.0
    any_kernel = kc.chain_orders(co) != kc.RECEIVER_ORDERS
    off_route = 0
    for blk in range(blocks):
        xb = x[..., blk * block : (blk + 1) * block].contiguous()
        calls = {}
        before = kc.launches_any
        st_c, o_c = demod_block(cfg, co, st_c, xb, record=calls)
        off_route += kc.launches_any - before != int(any_kernel)
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
               orders=orders, any_kernel=any_kernel, off_route=off_route,
               ok=row["ok"] and vs == 0.0 and not off_route)
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


def compare_chain_orders(device="cuda", seed: int = 11,
                         channels=(8, 40)) -> list[dict]:
    """:func:`compare_chain_small` at every order set of
    :data:`CHAIN_ANY_ORDERS` (chain_any_kernel) and each C of
    ``channels``, B = 16,384 (32 tiles), two blocks, the allocator's free
    memory poisoned before each: one verdict row each."""
    rows = []
    for i, orders in enumerate(CHAIN_ANY_ORDERS):
        for c in channels:
            poison_free_memory(device)
            rows.append(compare_chain_small(seed + i, c, 16384,
                                            device=device, orders=orders))
    return rows


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
            "midend_split": blocks, "extract_blocked": blocks}
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


# K2's formats at the tiled mid end's edges: (row label, kernel name,
# in_i16, out_i16)
MID_EDGE_FORMS = (("midend", "midend", False, False),
                  ("midend_in_i16", "midend_i16", True, False),
                  ("midend_out_i16", "midend_i16", False, True),
                  ("midend_i16_both", "midend_i16", True, True))
# the mid end's split route at its edges, with de-emphasis off (the
# receiver's default) and on: the DemodConfig changes that take each, and
# its channel counts (40: not a multiple of the peak IIR's 8 channels a
# block); the blocks: the smallest whose carried tails the route holds
# (one partial tile), one whole tile of 1,024 outputs, a whole and a
# partial one
MID_EDGE_ROUTES = {"split": ({}, (40,)),
                   "split_deemph": ({"use_deemphasis_filter": True,
                                     "deemphasis_cutoff_us": 50}, (1, 40))}
MID_EDGE_BLOCKS = (512, 8192, 8320)
# the filter orders (ds x2 taps, Hilbert taps) at the edges: the
# receiver's, on the kernels built for them; and others across the halo
# on the any-order kernels (short and the longest, odd and even ds x2
# orders, one filter of the receiver's order beside one of another), each
# at C = 40 and the smallest block that holds its tails and 8,320 (a
# whole tile and a partial one); K12 flat where its ds x4 (of the same
# order) takes it, nn % 4 == 0, phase-split where nn % 16 == 0
MID_EDGE_ORDERS = ((64, 65),)
MID_ANY_ORDERS = ((4, 3), (48, 33), (62, 63), (63, 67), (66, 97), (96, 127),
                  (128, 129), (130, 129), (64, 97), (130, 65))


def mid_edge_blocks(nn2: int, nh: int) -> tuple:
    """The block lengths B at which :func:`compare_mid_edges` runs the
    orders (nn2, nh): :data:`MID_EDGE_BLOCKS` at the receiver's; else the
    smallest multiple of 128 (K12's and the theta pass's step) whose B/4
    and B/8 hold the ds x2 and Hilbert tails, and 8,320."""
    if (nn2, nh) in MID_EDGE_ORDERS:
        return MID_EDGE_BLOCKS
    least = max(4 * (nn2 - 2), 8 * (nh - 1), 128)
    return (-(-least // 128) * 128, 8320)


def _mid_alone(acc: dict, st: dict, fmd, g, device) -> None:
    """The split route's two tiled kernels alone against their plain
    versions on a block's arguments (the carried tails of ``st``; fm_demod
    ``fmd``, float32 and int16, and theta1 drawn uniform with its previous
    phase), into outputs filled with NaN (int16: -32768, which q_i16 never
    stores), merged into ``acc`` under "mid_ds2:<form>" and
    "mid_hilb:<form>"."""
    from fm_radio_tpu_torch.kernels import midend as km
    from fm_radio_tpu_torch.kernels.qformat import FM_SCALE, q_i16

    c, n4 = fmd.shape
    nn2 = st["w2_rev"].shape[0]
    w2 = st["w2_rev"]
    theta = (torch.rand((c, n4), generator=g, device=device) * 2 - 1) * math.pi
    prev = (torch.rand((c,), generator=g, device=device) * 2 - 1) * math.pi
    srcs = {"f32": (fmd,), "i16": (q_i16(fmd, FM_SCALE),),
            "theta1": (theta, prev, 0.37)}

    def nan(*shape, dtype=torch.float32):
        if dtype == torch.int16:
            return torch.full(shape, -32768, dtype=dtype, device=device)
        return torch.full(shape, math.nan, dtype=dtype, device=device)

    fm_out = None
    for form, src in srcs.items():
        args = (w2, st["tail2"], *src)
        kout = km.mid_ds2(*args, out=(nan(c, n4 // 2), nan(c, nn2 - 2)))
        pout = km.mid_ds2_plain(*args)
        e = stage_errors("mid_ds2", kout, pout)
        dump_mismatch("mid_ds2", args, kout, pout, e)
        _merge(acc, f"mid_ds2:{form}", e)
        fm_out = pout[0] if fm_out is None else fm_out
    for form, i16 in (("f32", False), ("out_i16", True)):
        args = (st["wh_rev"], st["htail"], fm_out, i16)
        dts = (torch.float32,) * 2 + ((torch.int16,) * 2 if i16 else ())
        kout = km.mid_hilb(*args, out=tuple(nan(c, n4 // 2, dtype=d)
                                            for d in dts))
        pout = km.mid_hilb_plain(*args)
        e = stage_errors("mid_hilb", kout, pout)
        dump_mismatch("mid_hilb", args, kout, pout, e)
        _merge(acc, f"mid_hilb:{form}", e)


def compare_mid_edges(device="cuda", routes=tuple(MID_EDGE_ROUTES),
                      orders=MID_EDGE_ORDERS) -> dict:
    """K12 (flat and phase-split) and K2 on the mid end's split route
    (:data:`MID_EDGE_ROUTES`: with de-emphasis off, and on) against the
    plain versions at edge shapes, two blocks with carried state, bench
    planes (K2 on fm_demod drawn as N(0, 0.3^2), float32 or int16 at
    FM_SCALE), the allocator's free memory filled with NaN before each
    block: at each filter order of ``orders`` (:data:`MID_EDGE_ORDERS`,
    :data:`MID_ANY_ORDERS`; K12 only where its ds x4 takes the order), at
    each case's channel counts (other orders than the receiver's at C =
    40) and B of :func:`mid_edge_blocks`; K2 in its four formats
    (:data:`MID_EDGE_FORMS`), every K12 and K2 call counted as a launch of
    the route and of the any-order kernels its orders take; with the
    de-emphasis on also its two tiled kernels alone (:func:`_mid_alone`);
    and the host's route (kernels/midend.py::midend_route) against the C
    entry's (fmt_midend_route) over de-emphasis, filter orders within the
    halo and past it, and block lengths.  Returns {"rows": verdict rows
    (each with its "route" case, "form" and "orders"), "route_mismatch":
    [...], "off_route": the calls that did not count as a launch of the
    route and of its kernels}."""
    from fm_radio_tpu_torch.kernels import _build
    from fm_radio_tpu_torch.kernels import k12 as kk
    from fm_radio_tpu_torch.kernels import midend as km
    from fm_radio_tpu_torch.kernels.qformat import FM_SCALE, q_i16
    from fm_radio_tpu_torch.models.demod import (
        INT8_CONFIG, demod_init_state, make_coeffs)

    device = torch.device(device)
    if device.index is None:  # the wrappers check tensors against it
        device = torch.device("cuda", torch.cuda.current_device())
    off_route, rows = [], []
    g = torch.Generator(device=device).manual_seed(7)
    k12_cases = [("k12", "k12", kk.k12, kk.k12_plain, False),
                 ("k12_ps", "k12_ps", kk.k12_ps, kk.k12_ps_plain, False)]
    k2_cases = [(label, name, km.midend, km.midend_plain, (in16, out16))
                for label, name, in16, out16 in MID_EDGE_FORMS]
    for route in routes:
        kw, chans = MID_EDGE_ROUTES[route]
        for nn2, nh in orders:
            cfg = dataclasses.replace(
                INT8_CONFIG, order_poly_ds_lpf_fm_out=nn2,
                order_fir_hilbert=nh, **kw)
            co = make_coeffs(cfg, device)
            cases = [cs for cs in k12_cases
                     if nn2 % (16 if cs[0] == "k12_ps" else 4) == 0]
            cases += k2_cases
            any_kernels = (nn2 != km.TILED_TAPS[0], nh != km.TILED_TAPS[1])
            acc = {}
            for c in chans if (nn2, nh) in MID_EDGE_ORDERS else (40,):
                for b in mid_edge_blocks(nn2, nh):
                    if km.midend_route(co, b // 4) != "split":
                        raise RuntimeError(f"B = {b} does not take the split "
                                           f"route at orders {(nn2, nh)}")
                    st = {label: demod_init_state(cfg, c, device)
                          for label, *_ in cases}
                    x = bench_planes(c, 2 * b, seed=5, device=device)
                    for blk in range(2):
                        poison_free_memory(device, 64 << 20)
                        xb = x[:, :, blk * b : (blk + 1) * b].contiguous()
                        x4 = xb.reshape(2, c, b // 4, 4).permute(
                            0, 3, 1, 2).contiguous()
                        fmd = 0.3 * torch.randn((c, b // 4), generator=g,
                                                device=device)
                        for label, name, fn, plain, fmt in cases:
                            if name == "k12":
                                args = (co, cfg, st[label], xb)
                            elif name == "k12_ps":
                                args = (co, cfg, st[label], x4)
                            else:
                                in16, out16 = fmt
                                arg = q_i16(fmd, FM_SCALE) if in16 else fmd
                                args = (co, cfg, st[label], arg, out16)
                            before = (km.launches_split, km.launches_ds2_any,
                                      km.launches_hilb_any)
                            kout = fn(*args)
                            after = (km.launches_split, km.launches_ds2_any,
                                     km.launches_hilb_any)
                            if [a - b_ for a, b_ in zip(after, before)] != [
                                    1, *map(int, any_kernels)]:
                                off_route.append((route, label, nn2, nh, c,
                                                  b))
                            pout = plain(*args)
                            e = stage_errors(I16_BASE.get(name, name), kout,
                                             pout)
                            dump_mismatch(name, args, kout, pout, e)
                            _merge(acc, label, e)
                            st[label] = kout[0]
                        if cfg.use_deemphasis_filter:
                            _mid_alone(acc, km.mid_args(
                                "edges", co, cfg, st["midend"], c, device),
                                fmd, g, device)
                    torch.cuda.synchronize(device)
            chan_list = list(chans if (nn2, nh) in MID_EDGE_ORDERS else (40,))
            rows += [dict(_verdict(name, acc[label]), form=label,
                          route=route, orders=[nn2, nh], channels=chan_list)
                     for label, name, *_ in cases]
            rows += [dict(_verdict(key.split(":")[0], e),
                          form=key.split(":")[1], route=route,
                          orders=[nn2, nh], channels=chan_list)
                     for key, e in acc.items() if key.startswith("mid_")]
    fn = _build.function("midend", "fmt_midend_route", km.ROUTE_ARGTYPES)
    code = {"refused": -1, "launches": 0, "split": 1}
    bad = []
    for de in (False, True):
        cf = dataclasses.replace(INT8_CONFIG, use_deemphasis_filter=de,
                                 deemphasis_cutoff_us=50)
        cd = make_coeffs(cf, device)
        for nn2, nh in ((64, 65), (48, 65), (64, 33), (2, 1), (130, 129),
                        (131, 65), (64, 130), (1, 65), (63, 128)):
            cx = cd._replace(taps_fm_out=torch.ones(nn2, device=device),
                             taps_hilbert=torch.ones(nh, device=device))
            for n4 in (32, 64, 96, 126, 128, 254, 256, 4096, 32768):
                host = km.midend_route(cx, n4)
                card = fn(nn2, nh, n4)
                if code[host] != card:
                    bad.append((de, nn2, nh, n4, host, card))
    return {"rows": rows, "route_mismatch": bad, "off_route": off_route}


def compare_mid_any_orders(device="cuda", channels: int = 5) -> list[dict]:
    """The split route's ds x2 and Hilbert kernels alone
    (:func:`_mid_alone`: ds x2 on float32 and int16 fm_demod and on theta1,
    Hilbert with and without the int16 outputs, into NaN-filled outputs)
    against their plain versions at every order the halo admits: ds x2
    taps nn2 = 2 .. 130, each beside the odd Hilbert order nh = nn2 - 1 or
    nn2 (1 .. 129), at B/4 = 2,080 (a whole tile and a partial one of
    each kernel; :func:`compare_mid_edges` holds the shortest blocks),
    random taps and tails.  One verdict row a kernel and form."""
    device = torch.device(device)
    if device.index is None:  # the wrappers check tensors against it
        device = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=device).manual_seed(9)

    def randn(*shape, scale=0.3):
        return scale * torch.randn(shape, generator=g, device=device)

    acc = {}
    for nn2 in range(2, 131):
        nh = nn2 - 1 if nn2 % 2 == 0 else nn2
        st = {"w2_rev": randn(nn2, scale=0.1), "wh_rev": randn(nh, scale=0.1),
              "tail2": randn(channels, nn2 - 2),
              "htail": randn(channels, nh - 1)}
        _mid_alone(acc, st, randn(channels, 2080), g, device)
    torch.cuda.synchronize(device)
    return [dict(_verdict(key.split(":")[0], e), form=key.split(":")[1],
                 orders="nn2 2-130, nh 1-129 odd", channels=channels)
            for key, e in acc.items()]


# blocks B shorter than a carried tail at the receiver's orders (the
# launches route: B/4 = 32 < 62, the ds x2 tail, and B/8 = 16 < 64, the
# Hilbert tail; B/4 = 96, B/8 = 48 < 64), then a block of the split route
MID_SHORT_BLOCKS = (128, 384, 128, 16384)


def compare_mid_short_blocks(device="cuda", channels: int = 40,
                             seed: int = 19) -> list[dict]:
    """K12 (flat) and K2 in its four formats on blocks shorter than a
    carried tail (:data:`MID_SHORT_BLOCKS`: the launches route, then a
    block of the split route), de-emphasis off and on, against the plain
    versions, max abs error 0 on the outputs and on the carried state
    (each tail the last samples of concat(old tail, block)), the state
    carried from block to block, the allocator's free memory filled with
    NaN before each block.  One verdict row a case and de-emphasis."""
    from fm_radio_tpu_torch.kernels import k12 as kk
    from fm_radio_tpu_torch.kernels import midend as km
    from fm_radio_tpu_torch.kernels.qformat import FM_SCALE, q_i16
    from fm_radio_tpu_torch.models.demod import (
        INT8_CONFIG, demod_init_state, make_coeffs)

    device = torch.device(device)
    if device.index is None:  # the wrappers check tensors against it
        device = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=device).manual_seed(seed)
    cases = [("k12", "k12", kk.k12, kk.k12_plain, None)]
    cases += [(label, name, km.midend, km.midend_plain, (in16, out16))
              for label, name, in16, out16 in MID_EDGE_FORMS]
    rows = []
    for route, (kw, _) in MID_EDGE_ROUTES.items():
        cfg = dataclasses.replace(INT8_CONFIG, **kw)
        co = make_coeffs(cfg, device)
        st = {label: demod_init_state(cfg, channels, device)
              for label, *_ in cases}
        x = bench_planes(channels, sum(MID_SHORT_BLOCKS), seed=seed,
                         device=device)
        acc, at = {}, 0
        for b in MID_SHORT_BLOCKS:
            poison_free_memory(device, 64 << 20)
            xb = x[:, :, at : at + b].contiguous()
            at += b
            fmd = 0.3 * torch.randn((channels, b // 4), generator=g,
                                    device=device)
            for label, name, fn, plain, fmt in cases:
                if fmt is None:
                    args = (co, cfg, st[label], xb)
                else:
                    in16, out16 = fmt
                    arg = q_i16(fmd, FM_SCALE) if in16 else fmd
                    args = (co, cfg, st[label], arg, out16)
                kout = fn(*args)
                pout = plain(*args)
                e = stage_errors(I16_BASE.get(name, name), kout, pout)
                dump_mismatch(name, args, kout, pout, e)
                _merge(acc, label, e)
                st[label] = kout[0]
        torch.cuda.synchronize(device)
        rows += [dict(_verdict(name, acc[label]), form=label,
                      route=route.replace("split", "launches"),
                      blocks=list(MID_SHORT_BLOCKS), channels=channels,
                      routes=[km.midend_route(co, b // 4)
                              for b in MID_SHORT_BLOCKS])
                 for label, name, *_ in cases]
    return rows


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


# the sequential kernels' edge shapes (C, N): C = 40 and 5 (not a multiple
# of the lanes a block takes) at N = 16, 32 and 48 (fewer batches than the
# kernels keep in flight); with the cells' N (the PLL's 16,384, BPSK's
# 2,048) at both C, or at C = 5 alone (the plain loops take seconds a block
# there, and C = 40's tiles are checked at the short N)
SHORT_EDGES = [(c, n) for c in (40, 5) for n in (16, 32, 48)]
PLL_EDGES = [(c, n) for c in (40, 5) for n in (16, 32, 48, 16384)]
BPSK_EDGES = [(c, n) for c in (40, 5) for n in (16, 32, 48, 2048)]


def compare_pll_edges(device="cuda",
                      cases=SHORT_EDGES + [(5, 16384)]) -> list[dict]:
    """The sequential PLL kernel (``kernels/pll.py::pilot_pll_seq``) against
    its plain version at the edge shapes ``cases`` (:data:`SHORT_EDGES`),
    max abs error 0, on float32 theta and on int16 theta and dt, two
    blocks with carried state each.  Returns one verdict row per (form, C,
    N)."""
    from fm_radio_tpu_torch.kernels import pll as kp
    from fm_radio_tpu_torch.kernels.qformat import PH_SCALE, q_i16
    from fm_radio_tpu_torch.models.demod import INT8_CONFIG
    from fm_radio_tpu_torch.models.pilot_pll import pilot_pll_init_state

    cfg = INT8_CONFIG
    rows = []
    for c, n in cases:
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


# the plain chunked PLL's inputs and outputs by (C, G, W, L, block): the
# default and the bounds-checked build hold their kernels against it on the
# same inputs, so its serial loop runs once for both where they are equal
_PLL_CHUNKED_PLAIN: dict = {}


def _pll_chunked_plain_once(key: tuple, cfg, st, th):
    """``kernels/pll.py::pll_chunked_plain(cfg, st, th)``, taken from
    :data:`_PLL_CHUNKED_PLAIN` where ``key`` holds the same state and
    theta (``torch.equal``), else run and kept there."""
    from fm_radio_tpu_torch.kernels import pll as kp

    hit = _PLL_CHUNKED_PLAIN.get(key)
    if hit is not None and torch.equal(hit[1], th) and all(
            torch.equal(a, b) for a, b in zip(hit[0], st)):
        return hit[2]
    pout = kp.pll_chunked_plain(cfg, st, th)
    _PLL_CHUNKED_PLAIN[key] = (tuple(t.clone() for t in st), th.clone(),
                               pout)
    return pout


def compare_pll_chunked_edges(device="cuda",
                              channels=(5, 40)) -> list[dict]:
    """The chunked PLL kernel (``kernels/pll.py::pilot_pll_chunked``)
    against its plain version at edge shapes, max abs error 0: C = 5 and
    40 (lanes C * G not a multiple of its 8 lanes a block; flat arrays
    whose length is not a multiple of its 16-step batch), G =
    :data:`PLL_CHUNK_EDGE_GS`, each W of :data:`PLL_CHUNK_EDGE_WLS` with
    its chunk lengths L (windows that start off the batch grid, chunks
    whose kept range shares a batch with the next), two blocks with
    carried state on a pilot track the loop locks on; the plain version
    run once a case for both builds (:func:`_pll_chunked_plain_once`).
    Returns one verdict row per (C, G, W, L)."""
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
                        pout = _pll_chunked_plain_once((c, g, w, l, blk),
                                                       *a)
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


# extract's filter orders at its edges: the receiver's (128, 128,
# extract_blocked_kernel) and others within the halos (L+R / L-R taps,
# RDS taps; extract_blocked_any_kernel), those of the numpy model of its
# schedule (tests/test_torch_extract_any_order.py): not multiples of the
# decimation, the longest the halos admit, the shortest
EXTRACT_EDGE_ORDERS = ((128, 128), (64, 64), (96, 96), (124, 120),
                       (130, 131), (132, 136), (8, 16), (5, 9))
# orders around the halos' limits, where the route answers "refused"
EXTRACT_ROUTE_ORDERS = ((3, 8), (4, 7), (4, 8), (133, 64), (64, 137),
                        (4, 136), (132, 8), (128, 96), (64, 128))


def compare_extract_edges(device="cuda") -> dict:
    """Extract against its plain version at edge shapes, max abs error 0
    (the RDS power within POWER_RTOL: the plain version sums it in another
    order), two blocks with carried state from random tails, on random
    planes and dt: C = 40 at N = 1,024 (one tile, whose halo is all
    carried tail) and 2,048, on its three forms (float32; int16 planes and
    dt; int16 planes and float32 dt), at every order of
    EXTRACT_EDGE_ORDERS (the receiver's filters on extract_blocked_kernel,
    the others on extract_blocked_any_kernel), each call's kernel read on
    the counters; and the C entry's route (``fmt_extract_route``) against
    its host copy (``kernels/extract.py::extract_route``) over those orders
    and EXTRACT_ROUTE_ORDERS.  Returns {"rows": verdict rows,
    "route_mismatch": [...]}."""
    from fm_radio_tpu_torch.kernels import _build
    from fm_radio_tpu_torch.kernels import extract as ke
    from fm_radio_tpu_torch.models.demod import INT8_CONFIG, make_coeffs

    cfg = INT8_CONFIG
    co = make_coeffs(cfg, device)
    g = torch.Generator(device=device).manual_seed(13)

    def taps(nn):
        t = torch.rand((nn,), generator=g, device=device)
        return t / t.sum()

    c = 40
    rows = []
    for nn_a, nn_r in EXTRACT_EDGE_ORDERS:
        cx = co if (nn_a, nn_r) == (128, 128) else co._replace(
            taps_audio_lpr=taps(nn_a), taps_audio_lmr=taps(nn_a),
            taps_rds=taps(nn_r))
        want = "any" if (nn_a, nn_r) != (128, 128) else "receiver"
        if ke.extract_route(cx) != "blocked":
            raise RuntimeError(f"extract: filters of {nn_a} / {nn_r} taps "
                               f"take the {ke.extract_route(cx)} route")
        for n in (1024, 2048):
            for form in ("extract", "extract_i16", "extract_i16_f32dt"):
                st = _extract_state(cfg, cx, c, g, device)
                acc = {}
                for blk in range(2):
                    a = (cx, cfg, st, *_extract_inputs(form, c, n, g, device))
                    before = (ke.launches_blocked, ke.launches_any)
                    kout = ke.extract(*a)
                    pout = ke.extract_plain(*a)
                    took = ("any" if ke.launches_any > before[1] else
                            "receiver" if ke.launches_blocked > before[0]
                            else "none")
                    if took != want:
                        raise RuntimeError(f"extract {form} at {nn_a} / "
                                           f"{nn_r} taps, N = {n}: took "
                                           f"{took}, not {want}")
                    e = stage_errors("extract", kout, pout)
                    dump_mismatch(form, a, kout, pout, e)
                    _merge(acc, form, e)
                    st = kout[0]
                torch.cuda.synchronize(device)
                rows.append(dict(_verdict(form, acc[form]),
                                 orders=[nn_a, nn_r], kernel=want,
                                 channels=c, samples=n))
    fn = _build.function("extract", "fmt_extract_route", ke.ROUTE_ARGTYPES)
    bad = []
    for nn_a, nn_r in EXTRACT_EDGE_ORDERS + EXTRACT_ROUTE_ORDERS:
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
    """Registers (and stack and local memory bytes: spills; static shared
    memory bytes) of each kernel of a built library by ``cuobjdump
    -res-usage``, keyed by mangled name; {} where the toolkit has no
    cuobjdump."""
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
                         "local": int(kv.get("LOCAL", -1)),
                         "shared": int(kv.get("SHARED", -1))}
            name = None
    return res


def res_of(usage: dict, kernel: str) -> dict:
    """The entries of :func:`_res_usage`'s ``usage`` whose mangled name
    holds ``kernel`` (each instantiation)."""
    return {n: r for n, r in usage.items() if kernel in n}


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
                       cases=SHORT_EDGES + [(5, 2048)]) -> list[dict]:
    """BPSK (``kernels/bpsk.py::bpsk_sync``) against its plain version at
    the edge shapes ``cases`` (:data:`SHORT_EDGES`; at C = 5 the last warp
    is partial), max abs error 0 and no ``valid`` apart; with a gain and
    without; on random input and on zeros; two blocks with carried state
    each.  Returns one verdict row per (C, N, gain, input)."""
    from fm_radio_tpu_torch.kernels import bpsk as kb
    from fm_radio_tpu_torch.models.bpsk import bpsk_init_state
    from fm_radio_tpu_torch.models.demod import INT8_CONFIG

    cfg = INT8_CONFIG
    g = torch.Generator(device=device).manual_seed(17)
    rows = []
    for c, n in cases:
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


# the float K1's orders off its 64-tap kernel (k1_tile_any_kernel: every
# order check_state admits, nn % 4 == 0 from 4 to 132, but 64) and their
# edge shapes (C, B): C = 8 with a last tile of one output (B = 8,324: a
# first, a whole and a last tile of 1,024 outputs), C = 40 with a whole
# tile and one of 16 outputs (B = 4,160); each two blocks, so a block's
# first tile starts from the tail the one before carried
K1_ANY_ORDERS = tuple(nn for nn in range(4, 133, 4) if nn != 64)
K1_ANY_SHAPES = ((8, 8324), (40, 4160))


def compare_k1_any_orders(device="cuda", orders=K1_ANY_ORDERS,
                          shapes=K1_ANY_SHAPES, seed: int = 17) -> dict:
    """The float K1 at other orders than 64 (k1_tile_any_kernel) against
    its plain version, max abs error 0: every load form with float taps
    (float32 planes on and off the u8 grid, packed words, complex64, int8
    planes), float32 and int16 stores, at each order of ``orders`` and
    shape of ``shapes``, two blocks with carried state (a random carried
    tail and phase to start; full-range u8 input), the allocator's free
    memory filled with NaN before each order, every call counted as a
    launch of the any-order kernel.  Returns {"rows": one verdict row per
    (order, store) over the forms and shapes, "off_route": the calls that
    did not count}."""
    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.kernels import frontend as kf
    from fm_radio_tpu_torch.models.demod import make_coeffs

    stages = _stages()
    g = torch.Generator(device=device).manual_seed(seed)
    rows, off_route = [], []
    for nn in orders:
        cfg = DemodConfig(order_poly_ds_lpf_fm_out=nn)
        co = make_coeffs(cfg, device)
        poison_free_memory(device, 256 << 20)
        acc = {}
        for c, b in shapes:
            st0 = _ds4_state(cfg, co, c, g, device)
            u8 = torch.randint(0, 256, (2, c, 2 * b), generator=g,
                               device=device).float()
            xs = _k1_inputs(u8)
            for form, x in xs.items():
                for i16 in (False, True):
                    name = "frontend_i16" if i16 else "frontend"
                    s1 = st0
                    for blk in range(2):
                        xb = x[..., blk * b : (blk + 1) * b].contiguous()
                        before = kf.launches_any
                        kout, _ = compare_stage(
                            acc, name, (co, cfg, s1, xb, False, i16), stages)
                        if kf.launches_any != before + 1:
                            off_route.append((nn, form, i16, c, b))
                        s1 = kout[0]
        torch.cuda.synchronize(device)
        rows += [dict(_verdict(name, e), case=f"{name}:any:{nn}", order=nn,
                      forms=list(xs), shapes=[list(s) for s in shapes])
                 for name, e in acc.items()]
    return {"rows": rows, "off_route": off_route}


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


# the K3 probe's value at its edges (compare_value_edges): N = 64 (the
# smallest the entry admits: one partial warp), 448 (a whole warp and a
# partial one), 1,024, 5,120 and 32,768 (the probe's own), each with a
# partial last warp, at C = 5 and 40; against full where extract admits
# N (a multiple of its 1,024); the probe's orders, the only ones the
# entry admits (others: VALUE_REFUSED)
VALUE_EDGE_NS = (64, 448, 1024, 5120, 32768)
VALUE_EDGE_CS = (5, 40)
VALUE_REFUSED = ((96, 128), (64, 96), (32, 64), (132, 136))


def compare_value_edges(device="cuda", seed: int = 13) -> list[dict]:
    """The K3 probe's value (``k3_value_kernel``) against its plain
    version and, where extract admits N, against full (extract's kernel
    on the same taps), max abs error 0, at VALUE_EDGE_CS x VALUE_EDGE_NS,
    N(0, 1) planes, the allocator's free memory filled with NaN before
    each call, each call one counted launch; its geometry's C side
    against its host copy; and the other orders refused
    before any launch by the wrapper, and by the C entry itself.  One row
    a case (kernel, case, max_abs_err, ok)."""
    from fm_radio_tpu_torch.kernels import _build
    from fm_radio_tpu_torch.probes import _probe
    from fm_radio_tpu_torch.probes import k3_probe as k3

    rows = []
    co = k3.coeffs(device)
    g = torch.Generator(device=device).manual_seed(seed)
    host, card = k3.value_geom(), k3.value_geom_card()
    rows.append({"kernel": "k3_value", "case": "geometry",
                 "host": {k: host[k] for k in card}, "card": card,
                 "max_abs_err": None,
                 "ok": all(host[k] == v for k, v in card.items())})
    for c in VALUE_EDGE_CS:
        for n in VALUE_EDGE_NS:
            xs = tuple(torch.randn((c, n), generator=g, device=device)
                       for _ in range(3))
            poison_free_memory(device, 64 << 20)
            before = k3.launches_value
            kout = k3.value(xs, co)
            counted = k3.launches_value == before + 1
            refs = [(k3.extract_plain(xs, co), "plain")]
            if n % 1024 == 0:
                refs.append((k3.full(xs, co), "full"))
            for ref, vs in refs:
                e = _probe.max_err(kout, ref)
                rows.append({"kernel": "k3_value",
                             "case": f"C={c} N={n} vs {vs}",
                             "max_abs_err": e, "ok": e == 0.0 and counted})
    for orders in VALUE_REFUSED:
        xs = tuple(torch.zeros((5, 1024), device=device) for _ in range(3))
        other = k3.coeffs(device)
        other.taps_audio_lpr = other.taps_audio_lmr = torch.ones(
            orders[0], device=device) / orders[0]
        other.taps_rds = torch.ones(orders[1], device=device) / orders[1]
        before = k3.launches_value
        try:
            k3.value(xs, other)
            refused = False
        except ValueError:
            refused = k3.launches_value == before
        rows.append({"kernel": "k3_value", "case": f"orders {orders} "
                     "refused by the wrapper", "max_abs_err": None,
                     "ok": refused})
    # the C entry itself, given the probe's buffers and another order
    xs = tuple(torch.zeros((5, 1024), device=device) for _ in range(3))
    outs = [torch.empty((5, 256), device=device) for _ in range(3)] + [
        torch.empty((5, 128), device=device) for _ in range(2)]
    w = [torch.zeros(128, device=device) for _ in range(3)]
    fn = _build.function("k3_probe", "fmt_k3_value", k3.VALUE_ARGTYPES)
    for na, nr in ((96, 128), (64, 136)):
        err = fn(*(x.data_ptr() for x in xs), 5, 1024, w[0].data_ptr(),
                 w[1].data_ptr(), na, w[2].data_ptr(), nr,
                 *(o.data_ptr() for o in outs),
                 _build.stream_ptr(torch.device(device)))
        rows.append({"kernel": "k3_value",
                     "case": f"C entry nn_a={na} nn_r={nr} refused",
                     "max_abs_err": None, "ok": err != 0})
    torch.cuda.synchronize(device)
    return rows


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
# the K2 probe's engine kernels at their edges (compare_k2_edges), at C =
# 1 and 5: ds2 at B4 of one short tile (16, 48: 8 and 24 outputs), a tile
# and a partial one (2,064, 4,128) and whole tiles (8,192); hilb at every
# t_blk here, each at K2_ENGINE_B4's three B4: 16 and 48 (tiles shorter
# than the delay: the rotation is by d % lt), 512 and 1,024 (dividing the
# CTA's tile of 1,024 outputs), 768 (tiles that end in the next CTA's:
# re's rotated part from device memory), 2,048 (the CTA's tile) and 4,096
# (longer: from device memory)
K2_ENGINE_DS2_B4 = (16, 48, 2064, 4128, 8192)
K2_ENGINE_TBLK = (16, 48, 512, 768, 1024, 2048, 4096)


def k2_engine_b4(t_blk: int) -> list:
    """hilb's B4 at t_blk (compare_k2_edges): the fewest samples it takes
    (B4/2 >= 64), about 5,000 (a partial CTA tile where t_blk <= 1,024)
    and about 12,000 (several CTAs), each a multiple of t_blk."""
    return sorted({t_blk * -(-n // t_blk) for n in (128, 5000, 12000)})


def compare_k2_edges(device="cuda", seed: int = 3) -> list[dict]:
    """restruct:li[:stk] (k2_deemph_block_kernel, k2_peak_block_kernel, and
    the ds x2 and Hilbert launches between them) against its plain version
    at every compiled li, both forms, at K2_EDGE_SHAPES, the outputs filled
    with NaN first, max abs error 0 on each of re, im, theta and power; and
    the layout's C side against its host copy for every li and kind; the
    engine's ds2 (k2_ds2_kernel) and hilb (k12_mid_ds2_kernel, then
    k2_hilb_kernel) at their edges (K2_ENGINE_DS2_B4, K2_ENGINE_TBLK) and
    hilb's Hilbert launch alone at every t_blk, outputs NaN first, max abs
    error 0 on re, im and theta.  One row a case (kernel, case,
    max_abs_err, ok)."""
    from fm_radio_tpu_torch.probes import _probe
    from fm_radio_tpu_torch.probes import k2_probe as k2

    co = k2.coeffs(device)
    rows = []

    def engine_row(kernel, case, kout, pout):
        errs = [_probe.max_err(a, b) for a, b in zip(kout, pout)]
        rows.append({"kernel": kernel, "case": case,
                     "max_abs_err": max(errs), "errs_re_im_theta": errs,
                     "ok": all(e == 0.0 for e in errs)})

    def nan_out(c, n):
        return tuple(torch.full((c, n), math.nan, device=device)
                     for _ in range(3))

    for c in (1, 5):
        for b4 in K2_ENGINE_DS2_B4:
            x = k2.make_input(c, b4, device, seed=seed + b4)
            engine_row("k2_ds2", f"ds2:C={c}:B4={b4}",
                       k2.variant("ds2", x, 1024, co, out=nan_out(c, b4 // 2)),
                       k2.ds2_plain(x, co))
        for t_blk in K2_ENGINE_TBLK:
            for b4 in k2_engine_b4(t_blk):
                x = k2.make_input(c, b4, device, seed=seed + b4 + t_blk)
                engine_row("k2_hilb", f"hilb:C={c}:B4={b4}:t_blk={t_blk}",
                           k2.variant("hilb", x, t_blk, co,
                                      out=nan_out(c, b4 // 2)),
                           k2.hilb_plain(x, t_blk, co))
            fm = k2.make_input(c, k2_engine_b4(t_blk)[1] // 2, device,
                               seed=seed + t_blk)
            engine_row("k2_hilb", f"hilb_launch:C={c}:n8={fm.shape[1]}:"
                       f"t_blk={t_blk}",
                       k2.hilb_launch(fm, t_blk, co,
                                      out=nan_out(c, fm.shape[1])),
                       k2.hilb_launch_plain(fm, t_blk, co))
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


# the de-emphasis recurrence at its edges (compare_deemph_edges): C = 1,
# 40 (a partial last block of lanes) and 2,048 at 13, 14 and 15 batches of
# 16 steps (nb % 4 = 1, 2, 3; one short chunk), at 65 (two chunks of the
# routes' 32 batches and a short one), 195 and 229 (seven and eight
# chunks, the last short: the ring's 6 slots reused), the lenses' C =
# 2,048 x 16,384 and the K2 probe's 1,024 x 32,768
DEEMPH_EDGE_SHAPES = tuple((c, 16 * nb) for c in (1, 40, 2048)
                           for nb in (13, 14, 15, 65, 195, 229)) + (
                               (2048, 16384), (1024, 32768))


def compare_deemph_edges(device="cuda", seed: int = 9,
                         shapes=DEEMPH_EDGE_SHAPES) -> list[dict]:
    """``k12_deemph_kernel`` (``kernels/midend.py::deemph``) against
    ``iir_filter`` at each shape of ``shapes``, in place (the routes' form)
    and into an output filled with NaN, on memory poisoned first (every
    free byte 0xFF: NaN), max abs error 0 on the outputs and the carried
    state.  One row a case (name "deemph")."""
    from fm_radio_tpu_torch.kernels import midend as km
    from fm_radio_tpu_torch.ops.iir import iir_filter

    g = torch.Generator(device=device).manual_seed(seed)
    b, a = (0.2543, 0.2543), (1.0, -0.4914)  # a 1-pole low-pass
    rows = []

    def case(c, n, in_place):
        x = torch.randn((c, n), generator=g, device=device)
        st = {"x_hist": torch.randn((c, 1), generator=g, device=device),
              "y_hist": torch.randn((c, 1), generator=g, device=device)}
        ps, py = iir_filter(b, a, st, x)
        poison_free_memory(device)
        out = (x.clone() if in_place
               else torch.full((c, n), math.nan, device=device))
        ks, ky = km.deemph(b, a, st, out if in_place else x, out=out)
        e = max(float((ky - py).abs().max()),
                *(float((ks[k] - ps[k]).abs().max()) for k in ps))
        rows.append({"name": "deemph", "kernel": "k12_deemph_kernel",
                     "case": f"C={c}:n={n}:nb%4={n // 16 % 4}:"
                             f"{'in_place' if in_place else 'nan_out'}",
                     "max_abs_err": e, "ok": e == 0.0})

    for c, n in shapes:
        for in_place in (True, False):
            case(c, n, in_place)
    torch.cuda.synchronize(device)
    return rows


# fp_i8man_kernel at its edges (compare_man_edges): the lens's tiles (8 x
# 2,048 and 8 x 4,096) and others (one row a CTA; 16 rows; two runs a
# thread at 16 x 2,048), no at its least (32), the lens's 128 and its
# most (t_blk / 4 - 32), on C = 16 x B = 16,384
MAN_EDGE_SHAPE = (16, 16384)
MAN_EDGE_TILES = ((8, 2048, 128), (8, 4096, 128), (8, 4096, 32),
                  (8, 2048, 480), (1, 512, 32), (16, 1024, 64),
                  (16, 2048, 128))


def compare_man_edges(device="cuda", seed: int = 10) -> list[dict]:
    """fp_i8man (``probes/frontend_probe.py::i8manual``) against
    ``i8man_plain`` at MAN_EDGE_TILES, dots and full, on memory poisoned
    first (its outputs land on NaN), max abs error 0; a tile past the
    shared memory or the threads refused before any launch; and the C
    side's shared-memory formula against its host copy.  One row a case
    (kernel "fp_i8man")."""
    from fm_radio_tpu_torch.probes import frontend_probe as fp

    c, b = MAN_EDGE_SHAPE
    x8 = fp.make_inputs(c, b, device, seed=seed)["u8"]
    tb = fp.tables(device)
    rows = []
    for c_blk, t_blk, no in MAN_EDGE_TILES:
        for full in (False, True):
            pout = fp.i8man_plain(x8, full, t_blk, no, tb)
            poison_free_memory(device)
            kout = fp.i8manual(x8, full, c_blk, t_blk, no, tb)
            e = float((kout - pout).abs().max())
            rows.append({"kernel": "fp_i8man",
                         "case": f"{'full' if full else 'dots'}:tile="
                                 f"{c_blk}x{t_blk}:no={no}",
                         "max_abs_err": e, "ok": e == 0.0})
    try:
        fp.i8manual(x8, True, 16, 4096, 128, tb)
        refused = False
    except ValueError:
        refused = True
    rows.append({"kernel": "fp_i8man", "case": "tile=16x4096 refused",
                 "max_abs_err": None, "ok": refused})
    for c_blk in (1, 2, 4, 8, 16):
        for t_blk in (512, 1024, 2048, 4096, 8192):
            for full in (False, True):
                host = fp.i8man_smem(c_blk, t_blk, full)
                card = fp.i8man_smem(c_blk, t_blk, full, device)
                rows.append({"kernel": "fp_i8man_smem",
                             "case": f"tile={c_blk}x{t_blk}:full={full}",
                             "host": host, "card": card,
                             "max_abs_err": None, "ok": host == card})
    torch.cuda.synchronize(device)
    return rows


# the K1 probe's int8-direct forms on K12's tile at their edges: every
# noasm t_blk the entry admits from 512 up (its tiles inside one CTA's
# 4,096 samples), C = 5 and 40, B = 16,384 (whole segments) and 14,336
# (a last segment of 512 outputs, where t_blk divides it); no at its
# least, the lens's 128 and its most.  K12's windows also at the tiles
# that straddle a CTA's segment (I8D_STRADDLE: 8,192 on B = 16,384 and
# 3,584 on 14,336, the CTA's first output after theta(t0 - 1)) and at 48
# (12 outputs a tile: tiles that start inside a thread's run of 8)
I8D_EDGE_TBLKS = (512, 1024, 2048, 4096)
I8D_STRADDLE = ((8192, 16384), (3584, 14336), (48, 16384), (48, 14336))
I8D_EDGE_CS = (5, 40)
I8D_EDGE_BS = (16384, 14336)


def i8d_edge_nos(t_blk: int) -> tuple:
    """The noasm ``no`` values of an edge tile: 32, 128 and t_blk / 4 -
    32, those inside [32, t_blk / 4 - 32]."""
    tw = t_blk // 4
    return tuple(sorted({no for no in (32, 128, tw - 32) if 32 <= no
                         <= tw - 32}))


def frontend_kernels(step, device) -> dict:
    """The port's kernels (``fmt::`` names, without their template
    arguments) that one call of ``step`` launches, with their counts, as
    the profiler's trace records them (after one unprofiled call, in a
    window that :func:`open_window` opens)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        open_window(device)
        step()
        torch.cuda.synchronize(device)
    path = os.path.join(DUMP_DIR, "frontend_kernels_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    out = {}
    for ev in events:
        name = ev.get("name", "")
        if ev.get("cat") == "kernel" and "fmt::" in name:
            key = name.split("fmt::", 1)[1].split("<", 1)[0].split("(", 1)[0]
            out[key] = out.get(key, 0) + 1
    return out


def compare_i8d_edges(device="cuda", seed: int = 12) -> list[dict]:
    """fp_i8d (``probes/frontend_probe.py::i8direct``) against
    ``i8d_plain`` on every form (dots and full, K12's windows and noasm)
    at I8D_EDGE_TBLKS x I8D_EDGE_CS x I8D_EDGE_BS (noasm at every no of
    :func:`i8d_edge_nos`), and K12's windows at I8D_STRADDLE, on memory
    poisoned first (its outputs land on NaN), max abs error 0, one
    wrapper launch a call; full at a straddling tile is one launch of
    ``ds4_i8_blocked_kernel`` by the profiler (:func:`frontend_kernels`);
    and the refusals before any launch (a noasm tile past one CTA's
    segment, a no off the runs or outside its tile).  One row a case
    (kernel "fp_i8d")."""
    from fm_radio_tpu_torch.probes import frontend_probe as fp

    tb = fp.tables(device)
    rows = []
    for c in I8D_EDGE_CS:
        for b in I8D_EDGE_BS:
            x8 = fp.make_inputs(c, b, device, seed=seed + c)["u8"]
            tblks = [*I8D_EDGE_TBLKS,
                     *(t for t, bb in I8D_STRADDLE if bb == b)]
            for t_blk in tblks:
                if b % t_blk:
                    continue
                forms = [(False, min(128, t_blk // 4))]
                if t_blk in I8D_EDGE_TBLKS:
                    forms += [(True, no) for no in i8d_edge_nos(t_blk)]
                for noasm, no in forms:
                    for full in (False, True):
                        pout = fp.i8d_plain(x8, full, t_blk, no, noasm, tb)
                        poison_free_memory(device)
                        before = fp.launches_i8d
                        kout = fp.i8direct(x8, full, t_blk, no, noasm, tb)
                        e = float((kout - pout).abs().max())
                        ok = e == 0.0 and fp.launches_i8d == before + 1
                        rows.append({
                            "kernel": "fp_i8d",
                            "case": f"{'full' if full else 'dots'}"
                                    f"{':noasm' if noasm else ''}:C={c}:"
                                    f"B={b}:t_blk={t_blk}:no={no}",
                            "max_abs_err": e, "ok": ok})
    # the profiler now and then records no kernel of a window (the note
    # at _profile): an empty trace is taken again, up to three in all
    x8 = fp.make_inputs(40, 16384, device, seed=seed)["u8"]
    for attempt in range(1, 4):
        kernels = frontend_kernels(
            lambda: fp.i8direct(x8, True, 8192, 128, False, tb), device)
        if kernels:
            break
    rows.append({"kernel": "fp_i8d",
                 "case": "full:C=40:B=16384:t_blk=8192 one launch",
                 "launches": kernels, "attempts": attempt,
                 "max_abs_err": None,
                 "ok": kernels == {"ds4_i8_blocked_kernel": 1}})
    x8 = fp.make_inputs(5, 16384, device, seed=seed)["u8"]
    for t_blk, no in ((8192, 128), (2048, 44), (2048, 24), (1024, 232),
                      (256, 64)):
        before = fp.launches_i8d
        try:
            fp.i8direct(x8, True, t_blk, no, True, tb)
            refused = False
        except ValueError:
            refused = fp.launches_i8d == before
        rows.append({"kernel": "fp_i8d",
                     "case": f"noasm:t_blk={t_blk}:no={no} refused",
                     "max_abs_err": None, "ok": refused})
    torch.cuda.synchronize(device)
    return rows


# the stream path (models/app.py::demod_stream, one CUDA graph a call):
# (label, input kind, DemodConfig kwargs, blocks a call)
STREAM_CELLS = (("presplit", "i8", {"frontend_int8": True}, 8),
                ("f32w", "words", {"assume_integer_input": True}, 2),
                ("chain", "words", {"assume_integer_input": True,
                                    "chain_fusion": "auto"}, 2))


def _stream_equal(a, b) -> bool:
    """Two (state, outs) pairs bit for bit: every out equal and every
    state leaf's max difference 0."""
    return (all(torch.equal(a[1][k], b[1][k]) for k in a[1])
            and _leaf_max_diff(a[0], b[0]) == 0.0)


def _wall_ms(fn, reps: int, device) -> tuple:
    """Host ms of one call of ``fn`` from a synchronised card, best of
    ``reps``: (to the card's end, to the call's return: the host's own
    time to enqueue it)."""
    best, host = float("inf"), float("inf")
    for _ in range(reps):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        host = min(host, (time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize(device)
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best, host


def stream_cell(label: str, kind: str, kw: dict, blocks: int,
                channels: int = 2048, block: int = 131072, reps: int = 3,
                device="cuda") -> dict:
    """demod_stream on a cell's input on the card (one block of
    bench.py's signal, ``blocks`` times in time: [..., blocks * block]):
    the first call captures one graph (its ms, the pool's bytes, the
    wrappers' counted calls: the capture's, a warm-up block and the
    blocks); it and a second call, which replays the cached graph (no
    capture, no counted launch), each bit for bit the host loop that the
    graph captures (``models/app.py::_run_blocks``: demod_block over the
    same blocks, run eagerly) from the same state; a call after
    update_controls captures anew and equals the loop on the new
    coefficients.  Then the wall ms a block of each (best of ``reps``
    synchronised calls; and the host's own ms a block to enqueue it) and
    the device-busy ms a block of each (:func:`_profile` over one
    call)."""
    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.models import app as mapp
    from fm_radio_tpu_torch.models.demod import (
        BroadcastFMDemod, demod_init_state)

    mapp.clear_stream_graphs()
    cfg = DemodConfig(**kw)
    dm = BroadcastFMDemod(cfg, channels, device)
    x1 = split_input(kind, channels, block, 0, device)
    x = torch.cat([x1] * blocks, dim=-1)
    del x1
    st0 = demod_init_state(cfg, channels, device)
    res = {"cell": label, "config": kw, "channels": channels,
           "block": block, "blocks": blocks}
    reset_counts()
    g1 = mapp.demod_stream(cfg, x, block, st0, dm.coeffs)
    torch.cuda.synchronize(device)
    res["first"] = dict(mapp.last_stream)
    res["capture_launches"] = {k: v for k, v in read_counts().items() if v}
    l1 = mapp._run_blocks(cfg, dm.coeffs, st0, x, block, blocks)
    res["first_equal"] = _stream_equal(g1, l1)
    reset_counts()
    g2 = mapp.demod_stream(cfg, x, block, g1[0], dm.coeffs)
    torch.cuda.synchronize(device)
    res["second"] = dict(mapp.last_stream)
    res["replay_launches"] = sum(read_counts().values())
    l2 = mapp._run_blocks(cfg, dm.coeffs, l1[0], x, block, blocks)
    res["second_equal"] = _stream_equal(g2, l2)
    dm.update_controls(audio_stereo_mix_factor=0.5)
    g3 = mapp.demod_stream(dm.cfg, x, block, g2[0], dm.coeffs)
    res["controls"] = dict(mapp.last_stream)
    l3 = mapp._run_blocks(dm.cfg, dm.coeffs, l2[0], x, block, blocks)
    res["controls_equal"] = (_stream_equal(g3, l3)
                             and not torch.equal(g3[1]["audio"],
                                                 g2[1]["audio"]))
    del g1, g2, g3, l1, l2, l3
    cfg = dm.cfg
    for k, fn in (("graph", lambda: mapp.demod_stream(
            cfg, x, block, st0, dm.coeffs)),
                  ("loop", lambda: mapp._run_blocks(
                      cfg, dm.coeffs, st0, x, block, blocks))):
        wall, host = _wall_ms(fn, reps, device)
        res[f"{k}_ms_per_block"] = wall / blocks
        res[f"{k}_host_ms_per_block"] = host / blocks
    # a call launches each of the port's kernels once a block
    pg = _profile(f"{label}_stream", lambda: mapp.demod_stream(
        cfg, x, block, st0, dm.coeffs), 1, device, per_step=blocks)
    pl = _profile(f"{label}_loop", lambda: mapp._run_blocks(
        cfg, dm.coeffs, st0, x, block, blocks), 1, device, per_step=blocks)
    for k, p in (("graph", pg), ("loop", pl)):
        res[f"{k}_profile_attempts"] = p["attempts"]
        res[f"{k}_lost_records"] = p["lost_records"]
        res[f"{k}_busy_ms_per_block"] = p["device_busy_ms"] / blocks
        res[f"{k}_profile_wall_ms_per_block"] = p["wall_ms"] / blocks
        res[f"{k}_top_ms_per_block"] = {
            n: v / blocks for n, v in p["device_ms_per_block"].items()}
    res["ok"] = (res["first"]["captured"] and not res["second"]["captured"]
                 and res["controls"]["captured"] and res["first_equal"]
                 and res["second_equal"] and res["controls_equal"]
                 and res["replay_launches"] == 0)
    mapp.clear_stream_graphs()
    del x
    torch.cuda.empty_cache()
    return res


def checkpoint_card(channels: int = 40, block: int = 16384,
                    device="cuda") -> dict:
    """A checkpoint round trip on the card (utils/checkpoint.py): 3 blocks
    of bench.py's signal as int8 planes through K12, the state saved with
    ``block_index`` and loaded into a fresh demod's template, then 3 more
    blocks each way: the resumed outs and state bit for bit the
    uninterrupted run's, and every loaded leaf on the card in its
    template's dtype."""
    import io as _io

    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.models.app import _leaves
    from fm_radio_tpu_torch.models.demod import BroadcastFMDemod
    from fm_radio_tpu_torch.utils.checkpoint import load_state, save_state

    cfg = DemodConfig(frontend_int8=True)
    xs = [split_input("i8", channels, block, s, device) for s in range(6)]
    a = BroadcastFMDemod(cfg, channels, device)
    for x in xs[:3]:
        a.process(x)
    buf = _io.BytesIO()
    save_state(buf, a.state, extra={"block_index": 3})
    buf.seek(0)
    b = BroadcastFMDemod(cfg, channels, device)
    b.state, extras = load_state(buf, b.state)
    ok = int(extras["block_index"]) == 3
    ok = ok and _leaf_max_diff(a.state, b.state) == 0.0
    leaves = _leaves(b.state, [])
    ok = ok and all(t.device.type == "cuda" for t in leaves)
    same = True
    for x in xs[3:]:
        oa, ob = a.process(x), b.process(x)
        same = same and all(np.array_equal(oa[k], ob[k]) for k in oa)
    same = same and _leaf_max_diff(a.state, b.state) == 0.0
    return {"channels": channels, "block": block, "leaves": len(leaves),
            "bytes": buf.getbuffer().nbytes, "ok": ok and same}


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


def engine_floor(mode: str, c: int, b4: int, nn2: int = 64, nh: int = 65,
                 sms: int | None = None, hz: float | None = None) -> dict:
    """The K2 probe's ds2 or hilb FMUL+FADD issue floor at C x B4, ms
    (computed, not measured): an FMUL and an FADD a tap an output
    (-fmad=false), nn2 taps for the ds x2 launch and nh for hilb's
    Hilbert launch, over the C x B4/2 outputs, at 128 a clock an SM, at
    this card's SM count and highest SM clock (or those given)."""
    if sms is None:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
    if hz is None:
        hz = _sm_clock_hz()
    rate = 128.0 * sms * hz
    outs = float(c) * (b4 // 2)
    launches = {"ds2": 2 * nn2} if mode == "ds2" else {
        "ds2": 2 * nn2, "hilbert": 2 * nh}
    ms = {k: outs * v / rate * 1e3 for k, v in launches.items()}
    return {"fmul_fadd_floor_ms": sum(ms.values()),
            "launch_floors_ms": ms,
            "instructions_an_output": sum(launches.values()),
            "outputs": outs, "sms": sms, "sm_clock_hz": hz}


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


def deemph_floor(n: int) -> dict:
    """The de-emphasis recurrence's chain floor, ms (computed, not
    measured): n steps of its dependent chain y1 * a1 -> . - ., two
    float32 operations (-fmad=false; x1 b1 + x b0 is off the chain) at
    DEP_CLOCKS each, at this card's highest SM clock."""
    hz = _sm_clock_hz()
    return {"chain_floor_ms": n * 2 * DEP_CLOCKS / hz * 1e3, "steps": n,
            "sm_clock_hz": hz}


def i8_floor(c: int, b: int, taps: int = 132) -> dict:
    """The K1 probe's int8-tap window sums' issue floor, ms (computed,
    not measured): taps / 4 IDP4A on each of two tap planes and two IQ
    planes an output (C B / 4 of them), at 64 a clock an SM, at this
    card's SM count and highest SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    hz = _sm_clock_hz()
    per = 2 * 2 * taps // 4
    out = float(c) * b / 4
    return {"idp4a_floor_ms": out * per / (64 * sms * hz) * 1e3,
            "idp4a_an_output": per, "sms": sms, "sm_clock_hz": hz}


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
    rounded apart, -fmad=false; at the receiver's order and at any other),
    no IDP4A in an int8-tap kernel, and any spill (stack or local bytes) in
    a ds x4 kernel.  atan2_poly's IEEE
    division refines its MUFU.RCP with FFMAs (exact by construction), so
    the float K1 may hold as many FFMAs as the int8-tap kernel with the
    same store (the same atan2 and discriminator, no float sum), and no
    more."""
    if "error" in sass:
        return []
    bad = []
    for name, r in sass.items():
        float_k1 = any(k in name for k in FLOAT_K1)
        if float_k1:
            store = name.partition("Ds4Disc")[2][:3]
            div = [q["FFMA"] for n, q in sass.items()
                   if DS4_FLAT in n and q["lib"] == "frontend"
                   and n.partition("Ds4Disc")[2][:3] == store]
            if not div or r["FFMA"] > min(div):
                bad.append((name, "FFMA beyond the division's", r["FFMA"],
                            div))
        if not float_k1 and not r["IDP"]:
            bad.append((name, "no IDP4A"))
        if r.get("stack", 0) > 0 or r.get("local", 0) > 0:
            bad.append((name, "spills", r.get("stack"), r.get("local")))
    if not all(any(k in n for n in sass) for k in FLOAT_K1 + (DS4_PS,)):
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
                            "midend_split": blocks,
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


def _station_run(dev):
    """Phase 6's run on ``dev``: the selftest station (2 s of int8 planes)
    through App.  Returns the App, the seconds of its ``process`` and the
    input's samples."""
    from fm_radio_tpu_torch.apps.cli import power_ceil, selftest_planes
    from fm_radio_tpu_torch.models.app import App
    from fm_radio_tpu_torch.models.demod import INT8_CONFIG

    block = power_ceil(65536)
    x8 = selftest_planes(2.0, block)
    app = App(block_size=block, cfg=INT8_CONFIG, channels=1, device=dev)
    t0 = time.perf_counter()
    app.process(x8)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)
    return app, time.perf_counter() - t0, x8.shape[-1]


def station(device="cuda", legs=None) -> dict:
    """The selftest station through the port's App on the card and,
    with the plain versions, on the host CPU (the leg ``station`` of
    :func:`station_cpu_leg`, from ``legs`` where it was started)."""
    from fm_radio_tpu_torch.apps.cli import selftest_checks

    gpu, t_gpu, _ = _station_run(device)
    cpu = cpu_leg(legs, "station")
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
        "seconds": {str(device): t_gpu, "cpu": cpu.seconds},
    }


# phase 6b's station: its length, s, and block
STATION_SPLIT_SECONDS, STATION_SPLIT_BLOCK = 1.0, 65536


def _station_split_run(path: str, dev, pcm):
    """Phase 6b's run ``path`` on ``dev``: the selftest station
    (:data:`STATION_SPLIT_SECONDS`) through App on complex64
    (``process_u8``, ``DemodConfig()``) or through ``demod --ingest f32w``
    on ``pcm``, which this writes first.  Returns the App, the seconds of
    the run and the input's samples."""
    from fm_radio_tpu_torch.apps.cli import (
        build_parser, demod_app, selftest_u8)
    from fm_radio_tpu_torch.models.app import App

    block = STATION_SPLIT_BLOCK
    u8 = selftest_u8(STATION_SPLIT_SECONDS, block)
    if path != "app_complex64":
        u8.tofile(pcm)
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
    return app, time.perf_counter() - t0, u8.shape[0]


def station_split(device="cuda", legs=None) -> list[dict]:
    """The selftest station (:data:`STATION_SPLIT_SECONDS` of it) on the
    default configuration's split path, on the card and, with the plain
    versions, on the host CPU (the legs ``split:<path>``): through App on
    complex64 (``process_u8``, ``DemodConfig()``) and through ``demod
    --ingest f32w`` (packed words, integer input; ``demod_app``, then the
    command itself on the card).  Each row: RDS bytes identical, audio SNR
    of the card against the CPU, the selftest gates on the card's output,
    the launches of the card's run."""
    from fm_radio_tpu_torch.apps.cli import selftest_checks
    from fm_radio_tpu_torch.kernels import _build

    block = STATION_SPLIT_BLOCK
    smoke = _build.BUILD_ROOT / "smoke"
    smoke.mkdir(parents=True, exist_ok=True)
    pcm = smoke / "station.pcm"
    rows = []
    for path in ("app_complex64", "demod_f32w"):
        reset_counts()
        gpu, t_gpu, n = _station_split_run(path, device, pcm)
        counts = read_counts()
        cpu = cpu_leg(legs, f"split:{path}")
        settle = int(0.15 * gpu.demod.fs_audio)
        checks = selftest_checks(gpu)
        rows.append({
            "path": path, "seconds_audio": n / 1_024_000,
            "cfg": {k: getattr(gpu.cfg, k) for k in (
                "frontend_int8", "assume_integer_input", "k12_fusion")},
            "launches": counts,
            "rds_bytes": int(gpu.rds_bytes(0).size),
            "rds_identical": bool(np.array_equal(gpu.rds_bytes(0),
                                                 cpu.rds_bytes(0))),
            "snr_vs_cpu_db": _snr_db(gpu.audio[0, settle:],
                                     cpu.audio[0, settle:]),
            "rds_pi": checks["rds_pi"]["value"],
            "seconds": {str(device): t_gpu, "cpu": cpu.seconds}})
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


# phase 6c's runs: path -> (block, channels, DemodConfig keywords), and the
# station's length, s
STATION_LOOPS = {
    "app_pll_chunked": (262144, 1, {"frontend_int8": True,
                                    "pll_time_chunks": 4}),
    "app_chain_8ch": (65536, 8, {"assume_integer_input": True,
                                 "chain_fusion": "auto"}),
}
STATION_LOOPS_SECONDS = 1.0


def _station_loops_run(path: str, dev):
    """Phase 6c's run ``path`` (:data:`STATION_LOOPS`) on ``dev``: the
    selftest station (:data:`STATION_LOOPS_SECONDS`) through App, as int8
    planes on one channel or as packed words copied to each channel.
    Returns the App, the seconds of the run and the input's samples."""
    from fm_radio_tpu_torch.apps.cli import selftest_u8
    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.models.app import App
    from fm_radio_tpu_torch.utils.transfer import pack_iq_u8, split_iq_i8

    block, c, kw = STATION_LOOPS[path]
    u8 = selftest_u8(STATION_LOOPS_SECONDS, block)
    x = (split_iq_i8(u8)[:, None, :] if c == 1
         else np.repeat(pack_iq_u8(u8)[None, :], c, axis=0))
    t0 = time.perf_counter()
    app = App(block_size=block, cfg=DemodConfig(**kw), channels=c,
              device=dev)
    app.process(x)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)
    return app, time.perf_counter() - t0, u8.shape[0]


def station_loops(device="cuda", legs=None) -> list[dict]:
    """The selftest station (:data:`STATION_LOOPS_SECONDS` of it) through
    App with each of the two loop options, on the card and, with the plain
    versions, on the host CPU (the legs ``loops:<path>``):
    ``pll_time_chunks=4`` on int8 planes at block 262,144 (N / G = 8192 >
    W: the chunked PLL), and ``chain_fusion="auto"`` on packed words
    copied to 8 channels (the megakernel's gate needs C % 8 == 0) at block
    65,536.  Each row: RDS bytes identical on every channel, the lowest
    audio SNR of the card against the CPU, channel 0's PI on the card, the
    card run's launches."""
    from fm_radio_tpu_torch.apps.cli import selftest_checks

    rows = []
    for path, (block, c, kw) in STATION_LOOPS.items():
        reset_counts()
        gpu, t_gpu, n = _station_loops_run(path, device)
        counts = read_counts()
        cpu = cpu_leg(legs, f"loops:{path}")
        settle = int(0.15 * gpu.demod.fs_audio)
        rows.append({
            "path": path, "cfg": kw, "channels": c, "block": block,
            "seconds_audio": n / 1_024_000,
            "launches": counts,
            "rds_bytes": min(int(gpu.rds_bytes(i).size) for i in range(c)),
            "rds_identical": all(np.array_equal(gpu.rds_bytes(i),
                                                cpu.rds_bytes(i))
                                 for i in range(c)),
            "snr_vs_cpu_db": min(_snr_db(gpu.audio[i, settle:],
                                         cpu.audio[i, settle:])
                                 for i in range(c)),
            "rds_pi": selftest_checks(gpu)["rds_pi"]["value"],
            "seconds": {str(device): t_gpu, "cpu": cpu.seconds}})
    return rows


def _snr_db(a, b) -> float:
    """SNR (dB) of ``a`` against the reference ``b``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return 10 * math.log10(float(np.sum(b ** 2))
                           / (float(np.sum((a - b) ** 2)) + 1e-30))


# phase 7's captures: (stations, M, seconds), their block, and the
# seconds of each that the card and the host CPU compare
WIDEBAND_STATIONS = ((4, 8, 2.0), (3, 32, 1.5))
WIDEBAND_BLOCK, WIDEBAND_CPU_SECONDS = 65536, 0.5


def _wideband_cpu_n() -> int:
    """The samples of phase 7's captures that the host CPU runs."""
    return int(WIDEBAND_CPU_SECONDS * 1_024_000) // WIDEBAND_BLOCK \
        * WIDEBAND_BLOCK


def stations_app_run(k_st: int, m: int, n: int, block: int, device):
    """K stations of ``wideband_capture`` (n samples each, M channels)
    through ``StationsApp`` (``wideband_demod_block``: the channelizer,
    the int8 bridge, every channel demodulated) on ``device``; the
    selected stations' rows kept.  Returns (app, seconds, the wideband
    selftest's checks)."""
    from fm_radio_tpu_torch.apps.cli import wideband_capture, wideband_checks
    from fm_radio_tpu_torch.models.app import StationsApp
    from fm_radio_tpu_torch.utils.transfer import pack_iq_u8

    words = pack_iq_u8(wideband_capture(k_st, m, n))
    app = StationsApp(m, block, select=range(1, k_st + 1), device=device)
    t0 = time.perf_counter()
    app.process(words)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return app, time.perf_counter() - t0, wideband_checks(app)


def wideband_stations(device="cuda", legs=None) -> list[dict]:
    """Wideband stations through StationsApp (:func:`stations_app_run`,
    the loop around ``wideband_demod_block``, bench.py's wideband path): 4
    stations on an M=8 grid (2 s, the flat int8 bridge) and 3 on an M=32
    grid (1.5 s, the phase-split bridge) on the card; then the first
    :data:`WIDEBAND_CPU_SECONDS` of the same
    captures on the card and, with the plain versions, on the host CPU
    (the legs ``wideband:<M>``): RDS bytes identical and audio SNR of the
    card against the CPU for every station.  Each row's "pass" is the
    selftest gate (PI, name, >= 5 groups) and "gate" what this phase
    holds: at M=8 the selftest gate; at M=32 the PI and the group count,
    with the name reported.  (The int8 bridge carries a station at 1/M of
    its capture amplitude, as the JAX package's bridge does: ~1.2 LSB rms
    at M=32, where a station's name may miss a segment in seconds of
    signal; identically in the JAX package, whose RDS bytes the port
    reproduces.  The CPU leg is shortened to stay under about two
    minutes.)"""
    block = WIDEBAND_BLOCK
    results = []
    for k_st, m, seconds in WIDEBAND_STATIONS:
        n = int(seconds * 1_024_000) // block * block
        _, t_gpu, checks = stations_app_run(k_st, m, n, block, device)
        n_cmp = _wideband_cpu_n()
        gpu, _, _ = stations_app_run(k_st, m, n_cmp, block, device)
        cpu = cpu_leg(legs, f"wideband:{m}")
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
                        "seconds": {"card": t_gpu, "cpu": cpu.seconds},
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


# phase 7b's station: M, its channel, the block, the blocks on the card at
# each precision mode and the blocks that the card and the host CPU compare
SPLITS_M, SPLITS_CHANNEL, SPLITS_BLOCK = 32, 3, 32768
SPLITS_BLOCKS, SPLITS_CPU_BLOCKS = 24, 16


def _splits_run(words: np.ndarray, dev, splits: int, n_blocks: int) -> dict:
    """Phase 7b's run on ``dev``: the first ``n_blocks`` blocks of
    ``words`` (:func:`station_splits_words`) through
    ``wideband_demod_block`` at ``splits``.  Returns the station's audio,
    RDS bytes and PI, the launches and the seconds of the run."""
    from fm_radio_tpu_torch.kernels.channelizer import make_tables
    from fm_radio_tpu_torch.models.demod import INT8_CONFIG, make_coeffs
    from fm_radio_tpu_torch.models.wideband import (
        wideband_demod_block, wideband_init_state)
    from fm_radio_tpu_torch.parallel.channelizer import make_channelizer_taps
    from fm_radio_tpu_torch.rds.chain import make_rds_chain

    m, channel = SPLITS_M, SPLITS_CHANNEL
    t = m * SPLITS_BLOCK
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
        st, o = wideband_demod_block(cfg, co, tab, st, xb, m, splits=splits)
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


def station_splits(device="cuda", legs=None) -> dict:
    """The JAX package's hardware gate for the precision modes
    (tests/test_tpu_accuracy.py:200-278) on the port: the station of
    :func:`station_splits_words` through ``wideband_demod_block`` (int8
    bridge, phase-split at M = 32) at splits 3, 2 and 1 on the card, its
    PI decoded at each, the audio of splits 2 and 1 against splits 3 (SNR
    over the last three quarters); then the first
    :data:`SPLITS_CPU_BLOCKS` blocks at splits=1 on the card and with the
    plain versions on the host CPU (the leg ``splits1``): RDS bytes and
    audio SNR.  Each card run's launches are counted."""
    words = station_splits_words(SPLITS_M, SPLITS_CHANNEL, SPLITS_BLOCK,
                                 SPLITS_BLOCKS)
    runs = {sp: _splits_run(words, device, sp, SPLITS_BLOCKS)
            for sp in (3, 2, 1)}
    res = {"m": SPLITS_M, "channel": SPLITS_CHANNEL, "block": SPLITS_BLOCK,
           "blocks": SPLITS_BLOCKS,
           "seconds_audio": SPLITS_BLOCKS * SPLITS_BLOCK / 1_024_000,
           "splits": {}}
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
    gpu = _splits_run(words, device, 1, SPLITS_CPU_BLOCKS)
    cpu = cpu_leg(legs, "splits1")
    settle = int(0.15 * 32000)
    res["splits1_card_vs_cpu"] = {
        "blocks": SPLITS_CPU_BLOCKS,
        "seconds_audio": SPLITS_CPU_BLOCKS * SPLITS_BLOCK / 1_024_000,
        "rds_bytes": int(gpu["rds"].size),
        "rds_identical": bool(np.array_equal(gpu["rds"], cpu.rds_bytes(0))),
        "snr_db": _snr_db(gpu["audio"][settle:], cpu.audio[0][settle:]),
        "seconds": {"card": gpu["seconds"], "cpu": cpu.seconds}}
    return res


# phase 7c: the wideband commands' capture (stations on the carrier grid,
# M, seconds; M is the commands' default), scrape's station (seconds),
# tune's captures (rate, the station's offset) and their seconds, every
# command's block (the CLI's default), and the seconds of each input that
# the card and the host CPU compare
COMMANDS_WIDE = (6, 16, 1.5)
COMMANDS_SCRAPE_SECONDS = 2.0
COMMANDS_TUNE = ((2_048_000, 512_000), (8_192_000, 2_048_000))
COMMANDS_TUNE_SECONDS = 1.0
COMMANDS_BLOCK, COMMANDS_CPU_SECONDS = 65536, 0.5
# the scrape runs: (ingest, --stream)
SCRAPE_RUNS = {"scrape_i8": ("i8", False), "scrape_f32w": ("f32w", False),
               "scrape_i8_stream": ("i8", True),
               "scrape_f32w_stream": ("f32w", True)}
# the runs that the card and the host CPU compare (each the CPU leg
# "cmd:<run>"): stations, scan and scrape / tune on the first
# COMMANDS_CPU_SECONDS of their inputs, channelize on the whole capture
COMMAND_RUNS = ("stations", "scan", "channelize", *SCRAPE_RUNS,
                *(f"tune_{rate}" for rate, _ in COMMANDS_TUNE))
# the kernels each command must launch on the card (every other count of
# its run is logged): the wideband commands' complex64 split path, scrape's
# ingests, tune's complex64
_SPLIT_KERNELS = ("frontend", "midend", "pll", "extract", "bpsk")
COMMAND_KERNELS = {
    "stations": ("channelizer",) + _SPLIT_KERNELS,
    "stations_native": ("channelizer",) + _SPLIT_KERNELS,
    "scan": ("channelizer",) + _SPLIT_KERNELS,
    "channelize": ("channelizer",),
    "scrape_i8": ("k12", "pll", "extract", "bpsk"),
    "scrape_f32w": _SPLIT_KERNELS,
    "tune": _SPLIT_KERNELS,
}


def command_inputs(root, seconds: float | None = None,
                   names=("wide", "station", "tune")) -> dict:
    """Phase 7c's captures, written under ``root`` from their seeds:
    "wide" (:data:`COMMANDS_WIDE`'s stations on the carrier grid,
    ``apps/cli.py::wideband_capture``), "station" (the selftest station,
    :data:`COMMANDS_SCRAPE_SECONDS`) and "tune_<rate>" (the selftest
    station held rate / 1.024 MHz samples a sample at the capture's rate,
    moved to its offset and halved for headroom, as JAX
    tests/test_cli.py:217-250 makes its capture;
    :data:`COMMANDS_TUNE_SECONDS`); with ``seconds``, the first
    ``seconds`` of each.  Returns {name: path}."""
    from pathlib import Path

    from fm_radio_tpu_torch.apps.cli import (
        LEFT_HZ, RIGHT_HZ, SELFTEST_PI, SELFTEST_PS, selftest_u8,
        wideband_capture)
    from fm_radio_tpu_torch.io.pcm import c64_to_u8
    from fm_radio_tpu_torch.io.synth import (
        FMModulator, ModulatorConfig, station_group_schedule)

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    fs, block = 1_024_000, COMMANDS_BLOCK
    paths = {}

    def write(name: str, u8: np.ndarray, rate_mult: int) -> None:
        if seconds is not None:
            u8 = u8[: int(seconds * fs) * rate_mult]
        paths[name] = str(root / f"{name}.pcm")
        u8.tofile(paths[name])

    if "wide" in names:
        k_st, m, secs = COMMANDS_WIDE
        write("wide", wideband_capture(k_st, m, int(secs * fs) // block
                                       * block), m)
    if "station" in names:
        write("station", selftest_u8(COMMANDS_SCRAPE_SECONDS, block), 1)
    if "tune" in names:
        groups = station_group_schedule(SELFTEST_PI, ps=SELFTEST_PS,
                                        rt="FMTPU SELFTEST")
        iq = FMModulator(ModulatorConfig()).generate(
            int(COMMANDS_TUNE_SECONDS * fs), left_hz=LEFT_HZ,
            right_hz=RIGHT_HZ, rds_groups=groups)
        for rate, offset in COMMANDS_TUNE:
            mult = rate // fs
            t = np.arange(iq.size * mult) / rate
            wide = (np.repeat(iq, mult)
                    * np.exp(2j * np.pi * offset * t)).astype(np.complex64)
            write(f"tune_{rate}", c64_to_u8(wide / 2.0), mult)
    return paths


def command_argv(run: str, inputs: dict, out: str, seconds=None) -> list:
    """The CLI arguments of phase 7c's run ``run`` on ``inputs``
    (:func:`command_inputs`), writing under ``out`` (``seconds``: scan's
    window)."""
    m = str(COMMANDS_WIDE[1])
    b = ["-b", str(COMMANDS_BLOCK)]
    sel = ",".join(str(k) for k in range(1, COMMANDS_WIDE[0] + 1))
    if run in ("stations", "stations_native"):
        return (["stations", "-i", inputs["wide"], "-o", out, "-m", m, *b,
                 "--auto"]
                + (["--rds-native"] if run == "stations_native" else []))
    if run == "stations_select":
        return ["stations", "-i", inputs["wide"], "-o", out, "-m", m, *b,
                "--select", sel]
    if run == "scan":
        return (["scan", "-i", inputs["wide"], "-m", m, *b]
                + (["--seconds", str(seconds)] if seconds else []))
    if run == "channelize":
        return ["channelize", "-i", inputs["wide"], "-o", out, "-m", m]
    if run in SCRAPE_RUNS:
        ingest, stream = SCRAPE_RUNS[run]
        return (["scrape", "-i", inputs["station"], "-o", out, *b,
                 "--ingest", ingest] + (["--stream"] if stream else []))
    rate = int(run.split("_")[1])
    offset = dict(COMMANDS_TUNE)[rate]
    return ["tune", "-i", inputs[f"tune_{rate}"], "-r", str(rate), "-f",
            str(offset), *b, "-o", out]


def run_command(argv: list, device, out=None, profiled=False) -> dict:
    """One CLI command in this process on ``device``, its launches counted
    from 0 just before it and read just after: {"rc", "stdout",
    "seconds" (wall), "launches"}.  ``out``, the command's output
    directory, is emptied first (the scraper names its files by the
    second).  ``profiled``: the run inside ``torch.profiler`` (in a window
    that :func:`open_window` opens), with "device_busy_ms" (the device
    time of every CUDA event but the opening launches') and "idle_share"
    (1 - that / the wall) added."""
    import contextlib
    import io
    import shutil

    from torch.profiler import ProfilerActivity, profile

    from fm_radio_tpu_torch.apps.cli import main as cli_main

    if out is not None:
        shutil.rmtree(out, ignore_errors=True)
    out = io.StringIO()
    window = (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA])
              if profiled else contextlib.nullcontext())
    with window as prof:
        if profiled:
            open_window(device)
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli_main([str(a) for a in argv] + ["--device", str(device)])
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
    res = {"rc": rc, "stdout": out.getvalue(), "seconds": seconds,
           "launches": read_counts()}
    if profiled:
        busy = 0.0
        for e in prof.key_averages():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and PAD_KERNEL not in e.key):
                us = getattr(e, "self_device_time_total", None)
                busy += float(e.self_cuda_time_total if us is None
                              else us) / 1e3
        res.update(device_busy_ms=busy,
                   idle_share=1.0 - busy / (seconds * 1e3))
    return res


def scraper_files(d) -> dict:
    """A scraper directory's WAV and RDS bytes: {"wav", "bin"}."""
    names = os.listdir(d)
    (wav,) = [f for f in names if f.endswith(".wav")]
    (rds,) = [f for f in names if f.endswith(".bin")]
    with open(os.path.join(d, wav), "rb") as f:
        w = f.read()
    with open(os.path.join(d, rds), "rb") as f:
        b = f.read()
    return {"wav": w, "bin": b}


def wav_audio(blob: bytes) -> np.ndarray:
    """A 16-bit stereo WAV's frames [N, 2] (after its 44-byte header)."""
    return np.frombuffer(blob[44:], "<i2").reshape(-1, 2)


def rds_of(blob: bytes) -> dict:
    """RDS bytes decoded (``rds-decode``'s chain): the database summary and
    the group count."""
    from fm_radio_tpu_torch.rds.chain import RDSDecodingChain

    chain = RDSDecodingChain()
    chain.process(np.frombuffer(blob, np.uint8))
    return {**chain.db.summary(), "groups": len(chain.groups)}


def tone_hz(audio: np.ndarray, channel: int, fs: int = 32000) -> float:
    """The strongest frequency of one channel of 16-bit audio after 0.1 s."""
    x = audio[int(0.1 * fs):, channel].astype(np.float64)
    spec = np.abs(np.fft.rfft(x * np.hanning(x.size)))
    return float(np.fft.rfftfreq(x.size, 1 / fs)[np.argmax(spec)])


def command_cpu_leg(run: str) -> dict:
    """Phase 7c's run ``run`` (:data:`COMMAND_RUNS`) with the plain versions
    on the host CPU, on the first :data:`COMMANDS_CPU_SECONDS` of its input
    (channelize: the whole capture), made in its own directory: stations
    as its App's outputs (:class:`CpuRun`'s fields), the others as their
    output directory and standard output."""
    from fm_radio_tpu_torch.apps.cli import build_parser, stations_app
    from fm_radio_tpu_torch.kernels import _build

    root = _build.BUILD_ROOT / "smoke" / "commands" / f"cpu_{run}"
    names = ("wide",) if run in ("stations", "scan", "channelize") else (
        ("station",) if run in SCRAPE_RUNS else ("tune",))
    inputs = command_inputs(root, None if run == "channelize"
                            else COMMANDS_CPU_SECONDS, names)
    out = str(root / "out")
    if run == "stations":
        args = build_parser().parse_args(
            command_argv("stations_select", inputs, out))
        t0 = time.perf_counter()
        _, app = stations_app(args, torch.device("cpu"))
        return {"audio": app.audio,
                "rds": [app.rds_bytes(i) for i in range(app.channels)],
                "pi": app.rds_database(0).summary()["pi_code"],
                "seconds": time.perf_counter() - t0}
    r = run_command(command_argv(run, inputs, out, COMMANDS_CPU_SECONDS),
                    "cpu", out)
    return {"dir": out, "stdout": r["stdout"], "rc": r["rc"],
            "seconds": r["seconds"]}


def _launch_gate(name: str, run: str, launches: dict) -> list:
    """The kernels of :data:`COMMAND_KERNELS` that ``run`` did not
    launch."""
    key = ("tune" if run.startswith("tune") else
           run.replace("_stream", "") if run.startswith("scrape") else run)
    return [f"{name}:{k}" for k in COMMAND_KERNELS[key] if not launches[k]]


def commands_phase(device="cuda", legs=None) -> dict:
    """Phase 7c: the commands on the card at their own width, each with
    its launches counted, its wall seconds and its gates; the stations
    command's device idle share (its one run under the profiler); the
    same capture through ``StationsApp`` for the record; and each run
    against the host CPU's plain versions (:func:`command_cpu_leg`: RDS
    bytes identical, audio >= SNR_MIN_DB, scan's JSON, channelize's bytes
    within 1).  Returns the rows and the
    faults found (empty when every gate held)."""
    from fm_radio_tpu_torch.apps.cli import build_parser, stations_app
    from fm_radio_tpu_torch.kernels import _build

    root = _build.BUILD_ROOT / "smoke" / "commands"
    full = command_inputs(root / "full")
    short = command_inputs(root / "short", COMMANDS_CPU_SECONDS)
    k_st, m, secs = COMMANDS_WIDE
    pis = [f"{0x1234 + i:04X}" for i in range(k_st)]
    names = [f"ST {i + 1:02d}".ljust(8) for i in range(k_st)]
    runs, faults = {}, []

    def card(run: str, inputs: dict, tag: str = "full", seconds=None,
             profiled=False):
        out = str(root / tag / run)
        r = run_command(command_argv(run, inputs, out, seconds), device, out,
                        profiled)
        if r["rc"] != 0:
            faults.append(f"{run} ({tag}): exit {r['rc']}")
        runs[f"{run}:{tag}"] = {"seconds": r["seconds"],
                                "launches": r["launches"]}
        if tag == "full":
            faults.extend(_launch_gate("launch", run, r["launches"]))
        return r

    # the wideband commands on the whole capture; stations under the
    # profiler, its wall and the device's idle share from that one run
    st = card("stations", full, profiled=True)
    idle = {"wall_ms": st["seconds"] * 1e3,
            "device_busy_ms": st["device_busy_ms"],
            "idle_share": st["idle_share"]}
    summary = json.loads(st["stdout"]) if st["rc"] == 0 else []
    got = [(s["channel"], s["pi_code"], s["service_name"]) for s in summary]
    if got != list(zip(range(1, k_st + 1), pis, names)):
        faults.append(f"stations: {got}")
    nat = card("stations_native", full)
    nsum = json.loads(nat["stdout"]) if nat["rc"] == 0 else []
    if [{k: v for k, v in s.items() if k != "wav"} for s in nsum] != \
            [{k: v for k, v in s.items() if k != "wav"} for s in summary]:
        faults.append(f"stations --rds-native: {nsum} against {summary}")
    sc = card("scan", full)
    report = json.loads(sc["stdout"]) if sc["rc"] == 0 else {}
    want = ",".join(str(k) for k in range(1, k_st + 1))
    if report.get("select") != want or [a["pi"] for a in report.get(
            "active", [])] != pis:
        faults.append(f"scan: {report}")
    card("channelize", full)
    chan_files = sorted(os.listdir(root / "full" / "channelize"))
    if chan_files != [f"channel_{k:02d}.pcm" for k in range(m)]:
        faults.append(f"channelize wrote {chan_files}")
    # scrape on the station, both ingests, batch and --stream
    scraped = {}
    for run in SCRAPE_RUNS:
        r = card(run, full)
        if r["rc"] == 0:
            scraped[run] = scraper_files(root / "full" / run)
            db = rds_of(scraped[run]["bin"])
            runs[f"{run}:full"]["rds"] = db
            if db["pi_code"] != "1234" or db["service_name"] != "SELFTEST":
                faults.append(f"{run}: {db}")
    for ingest in ("i8", "f32w"):
        a, b = (scraped.get(f"scrape_{ingest}{s}") for s in ("", "_stream"))
        if not (a and b and a["bin"] == b["bin"]
                and a["wav"][44:] == b["wav"][44:]):
            faults.append(f"scrape --ingest {ingest}: --stream differs from "
                          f"batch")
    # tune at each rate
    for rate, _ in COMMANDS_TUNE:
        run = f"tune_{rate}"
        r = card(run, full)
        if r["rc"] != 0:
            continue
        info = json.loads(r["stdout"].strip().splitlines()[-2])
        files = scraper_files(root / "full" / run)
        tones = [tone_hz(wav_audio(files["wav"]), c) for c in (0, 1)]
        runs[f"{run}:full"].update(pi=info["pi_code"],
                                   name=info["service_name"], tones_hz=tones)
        # both tones, in either channel: the L-R phase estimate may settle
        # at its other sign and swap L and R, as the JAX command's does on
        # these captures
        if info["pi_code"] != "1234" or any(
                abs(a - b) > 20 for a, b in zip(sorted(tones),
                                                (1000.0, 3000.0))):
            faults.append(f"{run}: {info}, tones {tones}")
    # the same capture through StationsApp (wideband_demod_block), for
    # the record
    n = int(secs * 1_024_000) // COMMANDS_BLOCK * COMMANDS_BLOCK
    _, t_sa, sa_checks = stations_app_run(k_st, m, n, COMMANDS_BLOCK, device)
    record = {"seconds": t_sa, "checks": sa_checks}

    # against the host CPU on the first COMMANDS_CPU_SECONDS
    compare = {}
    args = build_parser().parse_args(command_argv(
        "stations_select", short, str(root / "short" / "stations")))
    _, gpu = stations_app(args, torch.device(device))
    cpu = cpu_leg(legs, "cmd:stations")
    settle = int(0.15 * 32000)
    compare["stations"] = {
        "rds_identical": all(np.array_equal(gpu.rds_bytes(i),
                                            cpu.rds_bytes(i))
                             for i in range(k_st)),
        "rds_bytes": min(int(gpu.rds_bytes(i).size) for i in range(k_st)),
        "snr_vs_cpu_db": min(_snr_db(gpu.audio[i, settle:],
                                     cpu.audio[i, settle:])
                             for i in range(k_st)),
        "seconds_cpu": cpu.seconds}
    for run in COMMAND_RUNS[1:]:
        c = command_result(legs, f"cmd:{run}")
        row = {"seconds_cpu": c["seconds"], "rc_cpu": c["rc"]}
        if run == "channelize":
            d_card = root / "full" / "channelize"
            diff = max(int(np.abs(
                np.fromfile(d_card / f, np.uint8).astype(np.int16)
                - np.fromfile(os.path.join(c["dir"], f), np.uint8)).max())
                for f in chan_files)
            row.update(max_byte_diff=diff, ok=diff <= 1)
        elif run == "scan":
            r = card("scan", short, "short", COMMANDS_CPU_SECONDS)
            a, b = json.loads(r["stdout"]), json.loads(c["stdout"])
            d = max([abs(a["noise_floor_db"] - b["noise_floor_db"])]
                    + [abs(x[k] - y[k]) for x, y in zip(a["active"],
                                                        b["active"])
                       for k in ("power_db", "above_floor_db")])

            def strip(j):
                return [{k: v for k, v in x.items()
                         if k not in ("power_db", "above_floor_db")}
                        for x in j["active"]] + [j["select"]]

            row.update(max_db_diff=d, ok=d <= 0.1 + 1e-9
                       and strip(a) == strip(b))
        else:
            r = card(run, short, "short")
            g = scraper_files(root / "short" / run)
            h = scraper_files(c["dir"])
            row.update(
                rds_bytes=len(g["bin"]),
                rds_identical=g["bin"] == h["bin"],
                snr_vs_cpu_db=_snr_db(wav_audio(g["wav"])[settle:],
                                      wav_audio(h["wav"])[settle:]))
            if run.startswith("tune"):
                row["json_equal"] = (r["stdout"].strip().splitlines()[-2]
                                     == c["stdout"].strip().splitlines()[-2])
            row["ok"] = (row["rds_identical"] and row["rds_bytes"] > 0
                         and row["snr_vs_cpu_db"] >= SNR_MIN_DB
                         and row.get("json_equal", True))
        compare[run] = row
    s = compare["stations"]
    s["ok"] = (s["rds_identical"] and s["rds_bytes"] > 0
               and s["snr_vs_cpu_db"] >= SNR_MIN_DB)
    faults += [f"{run} against the host CPU: {row}"
               for run, row in compare.items() if not row["ok"]]
    return {"runs": runs, "stations_idle": idle, "stations_app": record,
            "compare": compare, "faults": faults}


class CpuRun:
    """A station phase's run on the host CPU as :func:`station_cpu_leg`
    returns it: each channel's audio and RDS bytes (read as App's), the
    first channel's PI and the seconds of the run."""

    def __init__(self, audio, rds, pi, seconds):
        self.audio, self.rds, self.pi, self.seconds = audio, rds, pi, seconds

    def rds_bytes(self, channel: int = 0) -> np.ndarray:
        return self.rds[channel]


# the station phases' runs on the host CPU (phases 6-7c), by name, longest
# first within phases 6-7b, then phase 7c's: "station", "split:<path>",
# "loops:<path>", "i16", "wideband:<M>", "splits1", "cmd:<run>"
STATION_CPU_LEGS = ("station", "loops:app_pll_chunked",
                    "loops:app_chain_8ch", "split:app_complex64",
                    "split:demod_f32w", "wideband:32", "splits1", "i16",
                    "wideband:8", *(f"cmd:{run}" for run in COMMAND_RUNS))


def station_cpu_leg(name: str, threads: int | None = None) -> dict:
    """The run with the plain versions on the host CPU that a station
    phase holds its card's run against (:data:`STATION_CPU_LEGS`): the
    same function as the card's run, on ``"cpu"`` and on the same inputs,
    made here from their seeds; on ``threads`` torch threads where given.
    Returns :class:`CpuRun`'s fields as plain values, which a worker
    process can send back."""
    from fm_radio_tpu_torch.kernels import _build

    if threads:
        torch.set_num_threads(threads)
    kind, _, arg = name.partition(":")
    if kind == "cmd":
        return command_cpu_leg(arg)
    if kind == "station":
        app, secs, _ = _station_run("cpu")
    elif kind == "split":
        smoke = _build.BUILD_ROOT / "smoke"
        smoke.mkdir(parents=True, exist_ok=True)
        app, secs, _ = _station_split_run(arg, "cpu",
                                          smoke / "station_cpu.pcm")
    elif kind == "loops":
        app, secs, _ = _station_loops_run(arg, "cpu")
    elif kind == "i16":
        app, secs, _ = _station_i16_run("cpu", STATION_I16_CFG)
    elif kind == "wideband":
        k_st, m = next((k, m) for k, m, _ in WIDEBAND_STATIONS
                       if m == int(arg))
        app, secs, _ = stations_app_run(k_st, m, _wideband_cpu_n(),
                                        WIDEBAND_BLOCK, "cpu")
    elif kind == "splits1":
        words = station_splits_words(SPLITS_M, SPLITS_CHANNEL, SPLITS_BLOCK,
                                     SPLITS_BLOCKS)
        r = _splits_run(words, "cpu", 1, SPLITS_CPU_BLOCKS)
        return {"audio": r["audio"][None], "rds": [r["rds"]],
                "pi": r["pi"], "seconds": r["seconds"]}
    else:
        raise ValueError(f"no station CPU leg {name!r}")
    audio = app.audio
    return {"audio": audio,
            "rds": [app.rds_bytes(i) for i in range(audio.shape[0])],
            "pi": app.rds_database(0).summary()["pi_code"], "seconds": secs}


def station_cpu_pool():
    """Starts every leg of :data:`STATION_CPU_LEGS` in worker processes,
    spawned (the main process holds the card), one a core but two, each
    on its share of the cores' torch threads.  One after another in the
    main process the legs held most of the station phases' time; side by
    side the phases wait for the longest.  Returns the pool (its caller
    shuts it down) and {leg: Future}."""
    import concurrent.futures
    import multiprocessing

    cores = len(os.sched_getaffinity(0))
    workers = max(1, min(len(STATION_CPU_LEGS), cores - 2))
    pool = concurrent.futures.ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"))
    return pool, {n: pool.submit(station_cpu_leg, n,
                                 max(1, cores // workers))
                  for n in STATION_CPU_LEGS}


def command_result(legs, name: str) -> dict:
    """The station CPU leg ``name`` as its worker returned it: from its
    worker where ``legs`` (:func:`station_cpu_pool`'s futures) holds it,
    else run here."""
    return (legs[name].result() if legs and name in legs
            else station_cpu_leg(name))


def cpu_leg(legs, name: str) -> CpuRun:
    """The station CPU leg ``name`` as a :class:`CpuRun`."""
    return CpuRun(**command_result(legs, name))


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
    t_run = time.perf_counter()
    os.makedirs(DUMP_DIR, exist_ok=True)
    LOG_FILE = os.path.join(DUMP_DIR, "chip_smoke.log")
    open(LOG_FILE, "w").close()
    # the wall seconds of each phase, from the end of the one before (the
    # summary line before the kernels line lists them all)
    phase_s, mark = {}, [t_run]

    def phase(label: str) -> None:
        now = time.perf_counter()
        phase_s[label] = now - mark[0]
        mark[0] = now
        log(f"[phase] {label}: {phase_s[label]:.1f} s")

    # 1. device
    smi = nvidia_smi_line()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(dev)
    log(f"[device] {smi} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | {name}")

    # 2. build (one nvcc per source and build, all started together)
    phase("1 device")
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
    phase("2 build")
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
    phase("2b hbm sweep")
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
        elif n in ("fp_i8d", "fp_i8man"):
            # the int8 taps' IDP4A issue floor beside the bound
            k = dict(k, launches=eng["launches"][n],
                     **i8_floor(*PROBE_FULL["fp"]))
        elif n in ("k2_ds2", "k2_hilb"):
            # the FIRs' computed FMUL+FADD issue floor
            k = dict(k, launches=eng["launches"][n],
                     **engine_floor(PROBE_REP[n], *PROBE_FULL["k2"]))
        elif n == "k2_restruct":
            # the block kernels' computed issue floor at every li
            c, b4 = PROBE_FULL["k2"]
            k = dict(k, launches=eng["launches"][n], floors={
                li: restruct_floor(c, b4 // 2, li)["fmul_fadd_floor_ms"]
                for li in (64, 128, 256, 512)},
                **restruct_floor(c, b4 // 2, 128))
        log(f"[probe] kernel {n} {json.dumps(k)}")
    # every int8-window row of the K1 probe (13c's fp_i8d variants, 13d's
    # fp_i8man tiles) with the IDP4A issue floor at the default shape
    i8_rows = {r["variant"]: r["ms"] for r in eng["rows"]["fp"]
               if r["kernel"] in ("fp_i8d", "fp_i8man")}
    log(f"[probe] int8-window rows, ms at C x B = {PROBE_FULL['fp']}: "
        f"{json.dumps(i8_rows)}; IDP4A issue floor (computed, not "
        f"measured) {json.dumps(i8_floor(*PROBE_FULL['fp']))}")
    log(f"[probe] launches {json.dumps(eng['launches'])}; "
        f"{time.perf_counter() - t0:.1f} s")
    idle = [n for n, _, _ in ENGINE_KERNELS if not eng["launches"].get(n)]
    if idle:
        raise RuntimeError(f"engine probe kernels not launched by their "
                           f"sections: {idle}")

    # 2d. four probe kernels against the one PyTorch call of the same
    # function, in turns (probes/vs_library.py: 25 rounds of 10 calls, the
    # paired sign test)
    phase("2c engine probes")
    t0 = time.perf_counter()
    from fm_radio_tpu_torch.probes import vs_library

    turns = {r["case"]: r for r in vs_library.run(dev)}
    for r in turns.values():
        log(f"[vs_library] {json.dumps(r)}")
    for r in vs_library.conv1d_rows(dev):
        log(f"[vs_library] conv1d alone: {json.dumps(r)}")
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
    phase("2d vs_library")
    t0 = time.perf_counter()
    rows = compare_kernels(256, 131072, 2, dev)
    for r in rows:
        log(f"[compare] {json.dumps(r)}")
    log(f"[compare] {time.perf_counter() - t0:.1f} s")
    bad = [r["name"] for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: {bad}")

    phase("3 kernels vs plain")
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
    phase("3 wideband kernels")
    t0 = time.perf_counter()
    reps = k12_repeats(K12_REPEATS, 8, 16384, dev)
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
            creps = k12_repeats(K12_REPEATS_CHECKED, 8, 16384, dev)
            # a channel count that is not a multiple of 32 (ROADMAP queue 3)
            creps += k12_repeats(K12_REPEATS_CHECKED, 40, 16384, dev)
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
    phase("3a k12 repeats, matrix channelizers")
    t0 = time.perf_counter()
    wedge = compare_wgmma_edges(dev)
    for r in wedge:
        log(f"[compare] matrix kernel edge: {json.dumps(r)}")
    t1 = time.perf_counter()
    medge = compare_mid_edges(dev, orders=MID_EDGE_ORDERS + MID_ANY_ORDERS)
    try:
        with _build.checked_build():
            cm = compare_mid_edges(dev,
                                   orders=MID_EDGE_ORDERS + MID_ANY_ORDERS)
    except RuntimeError as e:
        raise RuntimeError(f"tiled mid end edges on the bounds-checked "
                           f"build: {e}")
    medge["rows"] += [dict(r, build="checked") for r in cm["rows"]]
    medge["route_mismatch"] += cm["route_mismatch"]
    medge["off_route"] += cm["off_route"]
    for r in medge["rows"]:
        log(f"[compare] tiled mid end edge: {json.dumps(r)}")
    # the any-order kernels alone at every order the halo admits
    many = compare_mid_any_orders(dev)
    with _build.checked_build():
        many += [dict(r, build="checked")
                 for r in compare_mid_any_orders(dev)]
    for r in many:
        log(f"[compare] any-order mid end kernels, every order: "
            f"{json.dumps(r)}")
    # the launches route on blocks shorter than a carried tail, the state
    # carried through them
    mshort = compare_mid_short_blocks(dev)
    with _build.checked_build():
        mshort += [dict(r, build="checked")
                   for r in compare_mid_short_blocks(dev, seed=20)]
    for r in mshort:
        log(f"[compare] mid end on short blocks: {json.dumps(r)}")
    log(f"[compare] tiled mid end edges, de-emphasis off and on, "
        f"{len(MID_EDGE_ORDERS + MID_ANY_ORDERS)} filter orders, both "
        f"builds: {time.perf_counter() - t1:.1f} s")
    sass = sass_counts()
    log(f"[build] channelizer_wgmma SASS: {json.dumps(sass)}; route "
        f"mismatches {medge['route_mismatch']}; calls off their route "
        f"{medge['off_route']}; {time.perf_counter() - t0:.1f} s")
    bad = [(r["name"], r.get("route"), r.get("form"), r.get("build"))
           for r in wedge + medge["rows"] + many + mshort if not r["ok"]]
    if bad or medge["route_mismatch"] or medge["off_route"]:
        raise RuntimeError(f"edge shapes disagree {bad} or the mid end's "
                           f"route differs on the card "
                           f"{medge['route_mismatch']} or calls left their "
                           f"route {medge['off_route']}")
    if "error" not in sass and not (
            sass["HGMMA"] and sass["IGMMA"] and not sass["IMMA"]
            and sass["UTMALDG"] + sass["UBLKCP"]):
        raise RuntimeError(f"channelizer_wgmma lacks its float or integer "
                           f"wgmma or bulk copies, or has mma.sync, in its "
                           f"SASS: {sass}")
    # the PLL, extract and BPSK at their edge shapes, on the default and
    # the bounds-checked build (every global index of the three kernels
    # checked), extract's other route, the PLL's and BPSK's SASS
    phase("3a matrix and mid end edges")
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
                      for r in compare_pll_edges(dev, SHORT_EDGES)]
            pedge += [dict(r, build="checked")
                      for r in compare_pll_chunked_edges(dev)]
            ce = compare_extract_edges(dev)
            bedge += [dict(r, build="checked")
                      for r in compare_bpsk_edges(dev, SHORT_EDGES)]
    except RuntimeError as e:
        raise RuntimeError(f"PLL / extract / BPSK edges on the "
                           f"bounds-checked build: {e}")
    eedge["rows"] += [dict(r, build="checked") for r in ce["rows"]]
    eedge["route_mismatch"] += ce["route_mismatch"]
    for r in pedge + eedge["rows"] + bedge:
        log(f"[compare] pll / extract / bpsk edge: {json.dumps(r)}")
    psass = pll_sass()
    bsass = bpsk_sass()
    # the registers, spills and shared memory of the split mid end's two
    # tiled kernels and of the K3 probe's value (no sample staged: its
    # shared memory must be 0)
    midres, k3res = _res_usage("midend"), _res_usage("k3_probe")
    from fm_radio_tpu_torch.probes import k3_probe as _k3
    k3_run = _k3.VALUE_RUN
    log(f"[build] resources: " + json.dumps(
        {"midend": midres, "k3_probe": res_of(k3res, "k3_value_kernel")}))
    if any(r["shared"] > 0 or r["local"] > 0 or r["stack"] > 0
           for r in res_of(k3res, "k3_value_kernel").values()):
        raise RuntimeError(f"k3_value_kernel holds shared or local memory: "
                           f"{res_of(k3res, 'k3_value_kernel')}")
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
    phase("3a pll, extract, bpsk edges")
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
    # the float K1 at every other order (k1_tile_any_kernel) on both builds
    t1 = time.perf_counter()
    k1any = compare_k1_any_orders(dev)
    try:
        with _build.checked_build():
            ck = compare_k1_any_orders(dev, seed=18)
    except RuntimeError as e:
        raise RuntimeError(f"K1 at other orders on the bounds-checked "
                           f"build: {e}")
    k1any["rows"] += [dict(r, build="checked") for r in ck["rows"]]
    k1any["off_route"] += ck["off_route"]
    bad = [(r["case"], r.get("build")) for r in k1any["rows"]
           if not r["ok"] or r["max_abs_err"] != 0.0]
    log(f"[compare] K1 at other orders: {len(k1any['rows'])} rows "
        f"({len(K1_ANY_ORDERS)} orders, every float-tap form and store, "
        f"shapes {K1_ANY_SHAPES}, both builds), off {bad}, calls off the "
        f"any-order kernel {k1any['off_route']}; "
        f"{time.perf_counter() - t1:.1f} s")
    if bad or k1any["off_route"]:
        raise RuntimeError(f"K1 at other orders disagrees {bad} or left "
                           f"its kernel {k1any['off_route']}")
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
    # the K3 probe's value at its edges on both builds
    vedge = compare_value_edges(dev)
    try:
        with _build.checked_build():
            vedge += [dict(r, build="checked")
                      for r in compare_value_edges(dev, seed=14)]
    except RuntimeError as e:
        raise RuntimeError(f"value edges on the bounds-checked build: {e}")
    bad = [r for r in vedge if not r["ok"]]
    log(f"[compare] k3 value edges: {len(vedge)} cases on both builds, "
        f"{len(bad)} off")
    for r in bad:
        log(f"[compare] k3 value edge off: {json.dumps(r)}")
    if bad:
        raise RuntimeError(f"k3 value edge cases disagree: "
                           f"{[(r['case'], r.get('build')) for r in bad]}")
    # the K2 probe's block recurrences and engine kernels at their edges
    # on both builds
    kedge = compare_k2_edges(dev)
    try:
        with _build.checked_build():
            kedge += [dict(r, build="checked")
                      for r in compare_k2_edges(dev, seed=4)]
    except RuntimeError as e:
        raise RuntimeError(f"K2 probe edges on the bounds-checked build: {e}")
    bad = [r for r in kedge if not r["ok"]]
    log(f"[compare] K2 probe edges: {len(kedge)} cases on both builds, "
        f"{len(bad)} off; {sorted({r['kernel'] for r in kedge})}")
    for r in bad:
        log(f"[compare] K2 probe edge off: {json.dumps(r)}")
    if bad:
        raise RuntimeError(f"K2 probe edge cases disagree: "
                           f"{[(r['case'], r.get('build')) for r in bad]}")
    # the de-emphasis recurrence and the K1 probe's manual pipeline at
    # their edges on both builds, on NaN-filled memory
    t1 = time.perf_counter()
    deedge = compare_deemph_edges(dev)
    manedge = compare_man_edges(dev)
    i8dedge = compare_i8d_edges(dev)
    try:
        with _build.checked_build():
            deedge += [dict(r, build="checked")
                       for r in compare_deemph_edges(dev, seed=10)]
            manedge += [dict(r, build="checked")
                        for r in compare_man_edges(dev, seed=11)]
            i8dedge += [dict(r, build="checked")
                        for r in compare_i8d_edges(dev, seed=13)]
    except RuntimeError as e:
        raise RuntimeError(f"de-emphasis / i8man / i8d edges on the "
                           f"bounds-checked build: {e}")
    for r in deedge + manedge:
        log(f"[compare] de-emphasis / i8man edge: {json.dumps(r)}")
    bad = [r for r in deedge + manedge + i8dedge if not r["ok"]]
    for r in bad:
        log(f"[compare] edge off: {json.dumps(r)}")
    log(f"[compare] de-emphasis / i8man / i8d edges: {len(deedge)} + "
        f"{len(manedge)} + {len(i8dedge)} cases on both builds, {len(bad)} "
        f"off; {time.perf_counter() - t1:.1f} s")
    if bad:
        raise RuntimeError(f"de-emphasis / i8man / i8d edge cases disagree: "
                           f"{[(r['case'], r.get('build')) for r in bad]}")
    # the exact channelizer at every M instantiation and its edge shapes,
    # on both builds; the megakernel at the chain cell's shape on the
    # checked build (its small shapes are in the repeats above)
    t1 = time.perf_counter()
    cedge = compare_chan_edges(dev)
    # the megakernel at other filter orders (chain_any_kernel): every set
    # of CHAIN_ANY_ORDERS at C = 8 and 40 (the checked build at C = 40)
    corders = compare_chain_orders(dev, 11)
    try:
        with _build.checked_build():
            cedge += [dict(r, build="checked")
                      for r in compare_chan_edges(dev, seed=1)]
            corders += [dict(r, build="checked") for r in
                        compare_chain_orders(dev, 31, channels=(40,))]
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
    phase("3a ds4, K1, probe, chan and chain edges")
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
    phase("3b split")
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
    phase("3b f32 bridge")
    t0 = time.perf_counter()
    crows = compare_chain(256, 131072, 2, dev, full=False)
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
    phase("3c chain, pll_chunked")
    t0 = time.perf_counter()
    irows, iroutes, i16_c5_launches = compare_i16(256, 131072, 2, 5, dev,
                                                   full=False)
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
    phase("3d i16")
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
    split = lacking(prof, SPLIT_MID + REDESIGNED_KERNELS + (DS4_FLAT,))
    if split or showing(prof, SPLIT_MID_GONE):
        raise RuntimeError(f"the pre-split cell's profile lacks the split "
                           f"mid end's or the redesigned kernels {split}, "
                           f"or shows {showing(prof, SPLIT_MID_GONE)}: "
                           f"{list(prof['device_ms_per_block'])}")

    # 4b. the split cells at full width
    phase("4 pre-split cell")
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
        # K1 in one launch: its kernel, and no second launch; the split
        # mid end without the de-emphasis
        gone = showing(prof, (K1_DISC,) + SPLIT_MID_GONE)
        if lacking(prof, (SPLIT_CELL_DS4[label],) + SPLIT_MID) or gone:
            raise RuntimeError(f"the {label} cell's profile lacks "
                               f"{SPLIT_CELL_DS4[label]} or the split mid "
                               f"end or shows {gone}: "
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
    phase("4b split cells")
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
    phase("4c chain, chunked cells")
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
    # K2 in int16 on the split route: its four kernels, none of the
    # launches route's, the de-emphasis or the fused kernel it replaced
    gone = showing(prof, SPLIT_MID_GONE)
    if lacking(prof, SPLIT_MID) or gone:
        raise RuntimeError(f"the i16 cell's profile lacks "
                           f"{lacking(prof, SPLIT_MID)} or shows {gone}: "
                           f"{list(prof['device_ms_per_block'])}")

    # 4e. the de-emphasis lenses: the mid end's split route with the
    # de-emphasis at the split cells' shape, its three kernels alone, each
    # lens profiled
    phase("4d i16 cell")
    t0 = time.perf_counter()
    lenses, lens_prof = {}, {}
    for label, kind, kw in DEEMPH_LENSES:
        torch.cuda.reset_peak_memory_stats(dev)
        lenses[label] = deemph_lens(label, kind, kw, 2048, 131072, 8, dev)
        log(f"[deemph] {json.dumps(lenses[label])}")
        prof = profile_split(label, kind, kw, device=dev)
        log(f"[profile] {json.dumps(prof)}")
        lens_prof[label] = prof
        gone = showing(prof, DEEMPH_GONE[label])
        if lacking(prof, DEEMPH_KERNELS) or gone:
            raise RuntimeError(f"the {label} lens's profile lacks "
                               f"{lacking(prof, DEEMPH_KERNELS)} or shows "
                               f"{gone}: {list(prof['device_ms_per_block'])}")
    for label, r in lenses.items():
        dev_ms = {k: device_ms(lens_prof[label], k) for k in DEEMPH_KERNELS}
        floors = {n: floors_ms(f) for n, f in r["floors"].items()}
        bounds = {n: b["bound_ms"] for n, b in r["bound"].items()}
        alone = {n: r["kernel_ms"][n] for n in r["floors"]}
        log(f"[deemph] {label}: {r['ms_per_block']:.3f} ms/block; device ms "
            f"a block {json.dumps(dev_ms)}; alone (events) "
            f"{json.dumps(alone)} beside the plain versions' "
            f"{json.dumps({n: r['plain_ms'][n] for n in r['floors']})}; "
            f"issue and chain floors (computed, not measured) "
            f"{json.dumps(floors)}; bounds {json.dumps(bounds)}; "
            f"k12_deemph_kernel's (grid, block) "
            f"{json.dumps(r['deemph_grid'])}")
    log(f"[deemph] {time.perf_counter() - t0:.1f} s")
    bad = [(label, r["name"]) for label, c in lenses.items()
           for r in c["compare"] if not r["ok"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions at "
                           f"the de-emphasis lenses: {bad}")
    # 4f. extract's other-order lens: every extract launch on
    # extract_blocked_any_kernel, timed alone, its profile
    phase("4e de-emphasis lenses")
    t0 = time.perf_counter()
    olens, olens_prof = {}, {}
    for label, kind, kw in ORDER_LENSES:
        torch.cuda.reset_peak_memory_stats(dev)
        olens[label] = order_lens(label, kind, kw, 2048, 131072, 8, dev)
        log(f"[orders] {json.dumps(olens[label])}")
        prof = profile_split(label, kind, kw, device=dev)
        log(f"[profile] {json.dumps(prof)}")
        olens_prof[label] = prof
        gone = showing(prof, EXT_GONE)
        if lacking(prof, (EXT_ANY,)) or gone:
            raise RuntimeError(f"the {label} lens's profile lacks {EXT_ANY} "
                               f"or shows {gone}: "
                               f"{list(prof['device_ms_per_block'])}")
        r = olens[label]
        log(f"[orders] {label}: {r['ms_per_block']:.3f} ms/block; "
            f"{EXT_ANY} {device_ms(prof, EXT_ANY):.4f} device ms a block; "
            f"extract alone (events) {r['kernel_ms']['extract']:.4f} beside "
            f"the plain version's {r['plain_ms']['extract']:.4f}; bound "
            f"{r['bound']['extract']['bound_ms']:.4f}; FMUL+FADD issue "
            f"floor (computed, not measured) "
            f"{r['floor']['fmul_fadd_floor_ms']:.4f}")
    log(f"[orders] {time.perf_counter() - t0:.1f} s")
    bad = [(label, r["name"]) for label, c in olens.items()
           for r in c["compare"] if not r["ok"]]
    if bad:
        raise RuntimeError(f"extract disagrees with its plain version at "
                           f"the other-order lens: {bad}")
    # 4g. the mid end's other-order lens: every mid end launch on the split
    # route's any-order kernels, K12 and the two kernels timed alone, its
    # profile
    phase("4f extract orders")
    t0 = time.perf_counter()
    mlens, mlens_prof = {}, {}
    for label, kind, kw in MID_ORDER_LENSES:
        torch.cuda.reset_peak_memory_stats(dev)
        mlens[label] = mid_order_lens(label, kind, kw, 2048, 131072, 8, dev)
        log(f"[mid_orders] {json.dumps(mlens[label])}")
        prof = profile_split(label, kind, kw, device=dev)
        log(f"[profile] {json.dumps(prof)}")
        mlens_prof[label] = prof
        gone = showing(prof, MID_ANY_GONE)
        if lacking(prof, MID_ANY) or gone:
            raise RuntimeError(f"the {label} lens's profile lacks "
                               f"{lacking(prof, MID_ANY)} or shows {gone}: "
                               f"{list(prof['device_ms_per_block'])}")
        r = mlens[label]
        log(f"[mid_orders] {label}: {r['ms_per_block']:.3f} ms/block; "
            f"device ms a block "
            f"{json.dumps({k: device_ms(prof, k) for k in MID_ANY})}; alone "
            f"(events) {json.dumps(r['kernel_ms'])} beside the plain "
            f"versions' {json.dumps(r['plain_ms'])}; bounds "
            f"{json.dumps({n: b['bound_ms'] for n, b in r['bound'].items()})}"
            f"; FMUL+FADD issue floors (computed, not measured) "
            f"{json.dumps({n: floors_ms(f) for n, f in r['floors'].items()})}")
    log(f"[mid_orders] {time.perf_counter() - t0:.1f} s")
    bad = [(label, r["name"]) for label, c in mlens.items()
           for r in c["compare"] if not r["ok"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions at "
                           f"the mid end's other-order lens: {bad}")

    # 4h. the float K1's other-order lens: every K1 launch on
    # k1_tile_any_kernel, K1 and K2 timed alone, its profile
    phase("4g mid end orders")
    t0 = time.perf_counter()
    klens, klens_prof = {}, {}
    for label, kind, kw in K1_ORDER_LENSES:
        torch.cuda.reset_peak_memory_stats(dev)
        klens[label] = k1_order_lens(label, kind, kw, 2048, 131072, 8, dev)
        log(f"[k1_orders] {json.dumps(klens[label])}")
        prof = profile_split(label, kind, kw, device=dev)
        log(f"[profile] {json.dumps(prof)}")
        klens_prof[label] = prof
        gone = showing(prof, K1_ANY_GONE)
        want = (K1_ANY,) + MID_ANY
        if lacking(prof, want) or gone:
            raise RuntimeError(f"the {label} lens's profile lacks "
                               f"{lacking(prof, want)} or shows {gone}: "
                               f"{list(prof['device_ms_per_block'])}")
        r = klens[label]
        log(f"[k1_orders] {label}: {r['ms_per_block']:.3f} ms/block; "
            f"{K1_ANY} {device_ms(prof, K1_ANY):.4f} device ms a block; K1 "
            f"alone (events) {r['kernel_ms']['frontend']:.4f} beside the "
            f"plain version's {r['plain_ms']['frontend']:.4f}; bound "
            f"{r['bound']['frontend']['bound_ms']:.4f}; FMUL+FADD issue "
            f"floor (computed, not measured) "
            f"{r['floor']['fmul_fadd_floor_ms']:.4f}; "
            f"{r['library']['library']} {r['library']['library_ms']:.4f}; "
            f"forms {json.dumps(r['forms'])}")
    log(f"[k1_orders] {time.perf_counter() - t0:.1f} s")
    bad = [(label, r["name"]) for label, c in klens.items()
           for r in c["compare"] if not r["ok"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions at "
                           f"the float K1's other-order lens: {bad}")
    # 4i. the megakernel's other-order lens: every launch on
    # chain_any_kernel, the megakernel timed alone, its profile
    phase("4h K1 orders")
    t0 = time.perf_counter()
    chlens, chlens_prof = {}, {}
    for label, kind, kw in CHAIN_ORDER_LENSES:
        torch.cuda.reset_peak_memory_stats(dev)
        chlens[label] = chain_order_lens(label, kind, kw, 2048, 131072, 8,
                                         dev)
        log(f"[chain_orders] {json.dumps(chlens[label])}")
        prof = profile_split(label, kind, kw, device=dev)
        log(f"[profile] {json.dumps(prof)}")
        chlens_prof[label] = prof
        gone = showing(prof, CHAIN_ANY_GONE)
        if lacking(prof, (CHAIN_ANY,)) or gone:
            raise RuntimeError(f"the {label} lens's profile lacks "
                               f"{CHAIN_ANY} or shows {gone}: "
                               f"{list(prof['device_ms_per_block'])}")
        r = chlens[label]
        log(f"[chain_orders] {label}: {r['ms_per_block']:.3f} ms/block; "
            f"{CHAIN_ANY} {device_ms(prof, CHAIN_ANY):.4f} device ms a "
            f"block; alone (events) {r['kernel_ms']['chain']:.4f} beside "
            f"the plain version's {r['plain_ms']['chain']:.4f}; bound "
            f"{r['bound']['chain']['bound_ms']:.4f}; FIR stages' FMUL+FADD "
            f"issue floor (computed, not measured) "
            f"{json.dumps(r['floor'])}")
    log(f"[chain_orders] {time.perf_counter() - t0:.1f} s")
    bad = [(label, r["name"]) for label, c in chlens.items()
           for r in c["compare"] if not r["ok"]]
    if bad:
        raise RuntimeError(f"the megakernel disagrees with its plain version "
                           f"at its other-order lens: {bad}")
    # the float K1's and the megakernel's kernels: registers, spills,
    # shared memory (cuobjdump)
    k1res, chres = _res_usage("frontend"), _res_usage("chain")
    log(f"[build] resources: " + json.dumps(
        {"frontend": {**res_of(k1res, K1_TILE), **res_of(k1res, K1_ANY)},
         "chain": chres}))

    # 4j. the stream path: demod_stream as one CUDA graph a call against a
    # host loop of demod_block, at full width (the counts are the
    # capture's wrapper calls: a replay counts nothing); then a
    # checkpoint round trip; both builds (the checked one at a small width)
    phase("4i chain orders")
    t0 = time.perf_counter()
    streams = []
    for label, kind, kw, nb in STREAM_CELLS:
        torch.cuda.reset_peak_memory_stats(dev)
        r = stream_cell(label, kind, kw, nb, device=dev)
        log(f"[stream] {json.dumps(r)}")
        log(f"[stream] {label}, {nb} blocks a call: graph "
            f"{r['graph_ms_per_block']:.4f} ms a block (busy "
            f"{r['graph_busy_ms_per_block']:.4f}), host loop "
            f"{r['loop_ms_per_block']:.4f} (busy "
            f"{r['loop_busy_ms_per_block']:.4f}); capture "
            f"{r['first']['capture_ms']:.1f} ms, pool "
            f"{r['first']['pool_bytes'] / 2 ** 20:.1f} MiB; counted in "
            f"the capture {r['capture_launches']}, in a replay "
            f"{r['replay_launches']}")
        streams.append(r)
    with _build.checked_build():
        streams += [dict(stream_cell(label, kind, kw, 2, channels=64,
                                     block=16384, reps=1, device=dev),
                         build="checked")
                    for label, kind, kw, _ in STREAM_CELLS]
    ckpts = [checkpoint_card(device=dev)]
    with _build.checked_build():
        ckpts.append(dict(checkpoint_card(device=dev), build="checked"))
    log(f"[stream] checkpoint round trips: {json.dumps(ckpts)}")
    log(f"[stream] {time.perf_counter() - t0:.1f} s")
    bad = [(r["cell"], r.get("build")) for r in streams if not r["ok"]]
    if bad or not all(c["ok"] for c in ckpts):
        raise RuntimeError(f"the stream path or a checkpoint is off: {bad}, "
                           f"{ckpts}")

    # 5. the wideband main path at its cell, then the M=16 and f32 bridges
    phase("4j stream")
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
                else (MAT_KERNEL,) if sp == 2 else ()) + (DS4_PS,) \
            + SPLIT_MID
        if lacking(prof, want) or showing(prof, SPLIT_MID_GONE):
            raise RuntimeError(f"the wideband profile at splits={sp} lacks "
                               f"{lacking(prof, want)} or shows "
                               f"{showing(prof, SPLIT_MID_GONE)}: "
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

    # 6-7c: the station phases; their runs on the host CPU go on side
    # by side in worker processes (station_cpu_pool) while the card's
    # runs go on here
    pool, legs = station_cpu_pool()
    try:
        # 6. station on the card and on the host CPU
        phase("5 wideband")
        t0 = time.perf_counter()
        stn = station(dev, legs)
        log(f"[station] {json.dumps(stn)}")
        log(f"[station] {time.perf_counter() - t0:.1f} s")
        if not (stn["checks_pass"] and stn["rds_identical"]
                and stn["snr_vs_cpu_db"] >= SNR_MIN_DB
                and stn["rds_bytes"] > 0):
            raise RuntimeError("station phase failed its gates")

        # 6b. the station on the default configuration's split path
        phase("6 station")
        t0 = time.perf_counter()
        sst = station_split(dev, legs)
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
        phase("6b split station")
        t0 = time.perf_counter()
        lst = station_loops(dev, legs)
        log(f"[station] loops: {json.dumps(lst)}")
        log(f"[station] loops: {time.perf_counter() - t0:.1f} s")
        for r in lst:
            want = ("pll_chunked" if r["path"] == "app_pll_chunked"
                    else "chain")
            if not (r["rds_identical"] and r["rds_bytes"] > 0
                    and r["snr_vs_cpu_db"] >= SNR_MIN_DB
                    and r["rds_pi"] == "1234" and r["launches"][want] > 0):
                raise RuntimeError(
                    f"station {r['path']} failed its gates: {r}")

        # 6d. the station in the int16 format
        phase("6c loops")
        t0 = time.perf_counter()
        si = station_i16(dev, legs)
        log(f"[station] i16: {json.dumps(si)}")
        log(f"[station] i16: {time.perf_counter() - t0:.1f} s")
        cv, fv = si["card_vs_cpu"], si["i16_vs_float_route"]
        if not (cv["rds_identical"] and cv["rds_bytes"] > 0
                and cv["snr_db"] >= STATION_I16_CPU_DB and fv["rds_identical"]
                and fv["snr_db"] >= STATION_I16_FLOAT_DB
                and set(si["rds_pi"].values()) == {"1234"}
                and all(si["launches"]["card_i16"][k] > 0
                        for k in I16_STATION)):
            raise RuntimeError(f"int16 station failed its gates: {si}")

        # 7. wideband stations on the card and on the host CPU
        phase("6d i16 station")
        t0 = time.perf_counter()
        wst = wideband_stations(dev, legs)
        log(f"[stations] {json.dumps(wst)}")
        log(f"[stations] {time.perf_counter() - t0:.1f} s")
        for grid in wst:
            for r in grid["per_station"]:
                if not (r["gate"] and r["rds_identical"] and r["rds_bytes"] > 0
                        and r["snr_vs_cpu_db"] >= SNR_MIN_DB):
                    raise RuntimeError(f"wideband stations (M={grid['m']}) "
                                       f"failed their gates: {r}")

        # 7b. a station through the three precision modes
        phase("7 wideband stations")
        t0 = time.perf_counter()
        sps = station_splits(dev, legs)
        log(f"[stations] splits: {json.dumps(sps)}")
        log(f"[stations] splits: {time.perf_counter() - t0:.1f} s")
        vs = sps["splits1_card_vs_cpu"]
        for sp, r in sps["splits"].items():
            chan = CHANNELIZER_BY_SPLITS[sp]
            if r["pi"] != "5005" or not r["launches"].get(chan) or (
                    sp != 3
                    and r["snr_vs_splits3_db"] < STATION_SPLITS_SNR_DB):
                raise RuntimeError(f"station at splits={sp} failed its gates: "
                                   f"{r}")
        if not (vs["rds_identical"] and vs["rds_bytes"] > 0
                and vs["snr_db"] >= SNR_MIN_DB):
            raise RuntimeError(f"station at splits=1, card vs CPU: {vs}")

        # 7c. the commands on the card (stations, its native RDS chain,
        # scan, channelize, scrape, tune) and against the host CPU
        phase("7b station splits")
        cmds = commands_phase(dev, legs)
        for run, r in cmds["runs"].items():
            log(f"[commands] {run}: {json.dumps(r)}")
        log(f"[commands] stations' device idle share: "
            f"{json.dumps(cmds['stations_idle'])}")
        log(f"[commands] the stations capture through StationsApp, for the "
            f"record: {json.dumps(cmds['stations_app'])}")
        for run, r in cmds["compare"].items():
            log(f"[commands] {run} against the host CPU: {json.dumps(r)}")
        log("[commands] wall s on the card: " + json.dumps(
            {run: round(r["seconds"], 2) for run, r in cmds["runs"].items()
             if run.endswith(":full")}))
        if cmds["faults"]:
            raise RuntimeError(f"commands failed their gates: "
                               f"{cmds['faults']}")
        phase("7c commands")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)

    # the kernels line: each kernel's numbers from its cell (pre-split:
    # k12, pll, extract, bpsk; the loud wideband cell: channelizer, k12_ps;
    # f32w: frontend, midend; k12off: frontend_i8), its errors at C=256 (or
    # W=4) and at full width, and its launches on every path
    err_small, err_full = {}, {}
    rep_rows = [k for r in reps for k in r["kernels"]]
    for r in (rows + wrows + srows + frows + crows + mrows + rep_rows + irows
              + wedge + medge["rows"] + pedge + eedge["rows"] + bedge
              + dedge + cedge + corders + [chk] + k1any["rows"] + mshort
              + [r for r in deedge if r["max_abs_err"] is not None]):
        err_small[r["name"]] = max(err_small.get(r["name"], 0.0),
                                   r["max_abs_err"])
    for r in (mp["compare"] + wb_bench["compare"] + wb["compare"]
              + wb16["compare"]
              + [r for c in cells.values() for r in c["compare"]]
              + ch["compare"] + pc["compare"] + wb_i8_bench["compare"]
              + wb_i8["compare"] + wb_bf16["compare"] + i16c["compare"]
              + [r for c in lenses.values() for r in c["compare"]]
              + [r for c in olens.values() for r in c["compare"]]
              + [r for c in mlens.values() for r in c["compare"]
                 if r["name"] == "k12"]):
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
             **{label: c["launches"] for label, c in lenses.items()},
             **{label: c["launches"] for label, c in olens.items()},
             **{label: c["launches"] for label, c in mlens.items()},
             **{label: c["launches"] for label, c in klens.items()},
             **{label: c["launches"] for label, c in chlens.items()},
             "i16_route_c5": {k: i16_c5_launches.get(k, 0)
                              for k in i16c["launches"]},
             **{f"cmd_{run.split(':')[0]}": r["launches"]
                for run, r in cmds["runs"].items() if run.endswith(":full")},
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
            # the mid end's split route: its launches on the kernel's path
            # (each also counted by the kernel)
            k["launches_split_route"] = home[n]["launches"]["midend_split"]
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
        if n == "extract":
            # the FMUL+FADD issue floor at the cell's 128 / 128 taps
            k.update(floors_ms(ext_floor(128, 128, 2048, 131072 // 8)))
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
    # the mid end's de-emphasis lenses: the wrapper alone on the lens's
    # last-block arguments, and its route's launches there
    for k in kernels:
        for label, c in lenses.items():
            if k["name"] == DEEMPH_MID[label]:
                n = k["name"]
                k["deemph_lens"] = {
                    "lens": label, "ms": c["kernel_ms"][n],
                    "plain_ms": c["plain_ms"][n],
                    "bound_ms": c["bound"][n]["bound_ms"],
                    "launches_split_route": c["launches"]["midend_split"],
                    "ms_per_block": c["ms_per_block"]}
    # the split route's three kernels, each timed alone on the f32w_de
    # lens's last-block arguments (K2's float32 form; the pre-split lens's,
    # K12's form on theta1, beside them); their launches: the route's on
    # the lens's counted blocks (each route launch there runs each kernel
    # once), and on every path the route's (the de-emphasis only on the
    # lenses, whose every launch has it on)
    for n, kern, src, rep in DEEMPH_NEW_KERNELS:
        cell = lenses["f32w_de"]
        b = cell["bound"][n]
        pre = lenses["presplit_de"]
        k = {"name": n, "route": "cuda", "source": src, "replaces": rep,
             "kernel": kern, "launches": cell["launches"]["midend_split"],
             "launches_by_path": {p: c.get("midend_split", 0)
                                  for p, c in paths.items()
                                  if n != "deemph" or p in lenses},
             "max_abs_err": max(err_small.get(n, 0.0), err_full[n]),
             "max_abs_err_full_width": err_full[n],
             "max_abs_err_small": err_small.get(n),
             "ms": cell["kernel_ms"][n], "plain_ms": cell["plain_ms"][n],
             "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
             "library_ms": None, "hbm_bytes_s": b["hbm_bytes_s"],
             "work": {key: b[key] for key in ("bytes", "f32_ops")},
             "device_ms": {label: device_ms(lens_prof[label], kern)
                           for label in lens_prof},
             **floors_ms(cell["floors"][n]),
             "k12_theta1_form": {
                 "ms": pre["kernel_ms"][n], "plain_ms": pre["plain_ms"][n],
                 "bound_ms": pre["bound"][n]["bound_ms"],
                 **floors_ms(pre["floors"][n])},
             "resources": res_of(midres, kern),
             "edge_shapes": (deedge if n == "deemph" else
                             [r for r in medge["rows"] if r["name"] == n
                              and r["orders"] == list(MID_EDGE_ORDERS[0])]),
             **in_turns_keys(n)}
        kernels.append(k)
    # extract at other orders (extract_blocked_any_kernel), alone on the
    # other-order lens's last-block arguments; its launches: the lens's
    for label, c in olens.items():
        b = c["bound"]["extract"]
        any_edges = [r for r in eedge["rows"] if r["kernel"] == "any"]
        kernels.append({
            "name": "extract_any", "route": "cuda",
            "source": "fm_radio_tpu_torch/csrc/extract.cu",
            "replaces": "fm_radio_tpu/kernels/extract_pallas.py:122",
            "kernel": EXT_ANY, "lens": label,
            "launches": c["launches"]["extract_any"],
            "launches_by_path": {p: v.get("extract_any", 0)
                                 for p, v in paths.items()},
            "max_abs_err": max([r["max_abs_err"] for r in c["compare"]]
                               + [r["max_abs_err"] for r in any_edges]),
            "ms": c["kernel_ms"]["extract"],
            "plain_ms": c["plain_ms"]["extract"],
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "library_ms": None, "hbm_bytes_s": b["hbm_bytes_s"],
            "work": {key: b[key] for key in ("bytes", "f32_ops")},
            "device_ms": device_ms(olens_prof[label], EXT_ANY),
            **floors_ms(c["floor"]),
            "edge_shapes": any_edges})
    # the split route's any-order kernels, each alone on the mid end's
    # other-order lens's last-block arguments (K12's form: ds x2 on
    # theta1); their launches: the lens's; their edges: every edge case at
    # an order that takes them (K12, K2 and the kernels alone)
    for label, c in mlens.items():
        for n, stage, kern, axis in (
                ("mid_ds2_any", "mid_ds2", MID_ANY[0], 0),
                ("mid_hilb_any", "mid_hilb", MID_ANY[1], 1)):
            b = c["bound"][stage]
            tiled = MID_EDGE_ORDERS[0][axis]
            edges = [r for r in medge["rows"] if r["orders"][axis] != tiled]
            kernels.append({
                "name": n, "route": "cuda",
                "source": "fm_radio_tpu_torch/csrc/k12_stages.cuh",
                "replaces": "fm_radio_tpu/kernels/k12_pallas.py:59, "
                            "fm_radio_tpu/kernels/midend_pallas.py:225",
                "kernel": kern, "lens": label,
                "orders": [c["config"]["order_poly_ds_lpf_fm_out"],
                           c["config"]["order_fir_hilbert"]],
                "launches": c["launches"][n],
                "launches_by_path": {p: v.get(n, 0)
                                     for p, v in paths.items()},
                "max_abs_err": max(
                    [r["max_abs_err"] for r in c["compare"]
                     if r["name"] in (stage, "k12")]
                    + [r["max_abs_err"] for r in edges]
                    + [r["max_abs_err"] for r in many
                       if r["name"] == stage]),
                "ms": c["kernel_ms"][stage], "plain_ms": c["plain_ms"][stage],
                "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "library_ms": c["library"][stage]["library_ms"],
                "library": c["library"][stage]["library"],
                "hbm_bytes_s": b["hbm_bytes_s"],
                "work": {key: b[key] for key in ("bytes", "f32_ops")},
                "device_ms": device_ms(mlens_prof[label], kern),
                **floors_ms(c["floors"][stage]),
                "resources": res_of(midres, kern),
                "edge_shapes": edges,
                "every_order": [r for r in many if r["name"] == stage]})
    # the float K1 at other orders (k1_tile_any_kernel) alone on its
    # lens's last-block arguments (words, float32 store; the int16 store
    # and complex64 beside it); its launches: the lens's; its edges: every
    # other order on both builds
    for label, c in klens.items():
        b = c["bound"]["frontend"]
        kernels.append({
            "name": "frontend_any", "route": "cuda",
            "source": "fm_radio_tpu_torch/csrc/frontend.cu",
            "replaces": "fm_radio_tpu/kernels/frontend_pallas.py:223",
            "kernel": K1_ANY, "lens": label,
            "order": c["config"]["order_poly_ds_lpf_fm_out"],
            "launches": c["launches"]["frontend_any"],
            "launches_by_path": {p: v.get("frontend_any", 0)
                                 for p, v in paths.items()},
            "max_abs_err": max([r["max_abs_err"] for r in c["compare"]]
                               + [r["max_abs_err"] for r in k1any["rows"]]),
            "ms": c["kernel_ms"]["frontend"],
            "plain_ms": c["plain_ms"]["frontend"],
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "library_ms": c["library"]["library_ms"],
            "library": c["library"]["library"],
            "hbm_bytes_s": b["hbm_bytes_s"],
            "work": {key: b[key] for key in ("bytes", "f32_ops")},
            "device_ms": device_ms(klens_prof[label], K1_ANY),
            **floors_ms(c["floor"]), "forms": c["forms"],
            "resources": res_of(k1res, K1_ANY),
            "edge_shapes": {"rows": len(k1any["rows"]),
                            "orders": list(K1_ANY_ORDERS),
                            "shapes": [list(s) for s in K1_ANY_SHAPES],
                            "max_abs_err": max(r["max_abs_err"]
                                               for r in k1any["rows"])}})
    # the megakernel at other orders (chain_any_kernel) alone on its lens's
    # last-block arguments; its launches: the lens's; its edges: every
    # order set of CHAIN_ANY_ORDERS on both builds
    for label, c in chlens.items():
        b = c["bound"]["chain"]
        kernels.append({
            "name": "chain_any", "route": "cuda",
            "source": "fm_radio_tpu_torch/csrc/chain.cu",
            "replaces": "fm_radio_tpu/kernels/chain_pallas.py:74",
            "kernel": CHAIN_ANY, "lens": label,
            "orders": [c["config"][k] for k in CHAIN_ORDER_KEYS],
            "launches": c["launches"]["chain_any"],
            "launches_by_path": {p: v.get("chain_any", 0)
                                 for p, v in paths.items()},
            "max_abs_err": max([r["max_abs_err"] for r in c["compare"]]
                               + [r["max_abs_err"] for r in corders]),
            "ms": c["kernel_ms"]["chain"], "plain_ms": c["plain_ms"]["chain"],
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "library_ms": None, "hbm_bytes_s": b["hbm_bytes_s"],
            "work": {key: b[key] for key in ("bytes", "f32_ops")},
            "serial_steps": b["serial_steps"],
            "device_ms": device_ms(chlens_prof[label], CHAIN_ANY),
            **floors_ms(c["floor"]), "floor_stages_ms": c["floor"]["stages_ms"],
            "resources": res_of(chres, CHAIN_ANY),
            "edge_shapes": corders})
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
            # hilb's in-turns case is its Hilbert launch alone (beside
            # launch_alone), not the variant: no one call does both FIRs
            **({"hilbert_launch_in_turns": in_turns_keys(n)}
               if n == "k2_hilb" else in_turns_keys(n)),
            **({"launch_alone": pk["launch_alone"]}
               if "launch_alone" in pk else {}),
            **(floors_ms(engine_floor(pk["variant"], *PROBE_FULL["k2"]))
               if n in ("k2_ds2", "k2_hilb") else {}),
            # extract at the K3 probe's 64 / 128 taps
            **(floors_ms(ext_floor(64, 128, *PROBE_FULL["k3"]))
               if n == "k3_full" else {}),
            "work": {key: pk[key] for key in ("bytes", "f32_ops", "i8_ops",
                                              "design_f32_ops") if key in pk},
            **({"serial_steps": pk["serial_steps"]}
               if pk["serial_steps"] is not None else {}),
            **({"idp4a_floor_ms": i8_floor(*PROBE_FULL["fp"])[
                "idp4a_floor_ms"],
                "edge_shapes": manedge if n == "fp_i8man" else i8dedge}
               if n in ("fp_i8man", "fp_i8d") else {}),
            # value without a staged tile: its run, its edges, what
            # cuobjdump says of its registers and shared memory
            **({"run": k3_run, "edge_shapes": vedge,
                "resources": res_of(k3res, "k3_value_kernel")}
               if n == "k3_value" else {})})
    if DUMPS:
        raise RuntimeError(f"mismatches saved (passed their tolerances): "
                           f"{DUMPS}")
    phase("kernels line")
    log("[phases] wall s by phase: " + json.dumps(
        {k: round(v, 1) for k, v in phase_s.items()}))
    log(f"[wall] chip_smoke.py: {time.perf_counter() - t_run:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
