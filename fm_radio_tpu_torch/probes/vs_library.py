"""Three probe kernels against the one PyTorch call of the same function,
timed in turns on one card.

    python -m fm_radio_tpu_torch.probes.vs_library [--rounds 25] [--reps 10]

The cases, each at the shape ``chip_smoke.py`` times it at:

- ``hbm_dma_copy`` (``probes/hbm_sweep.py::dma_copy``, 32 KiB chunks
  through two buffers) against ``Tensor.copy_``, on the sweep's 256 MiB
  float32 [R, 1024] array;
- ``fp_sum`` stream (``probes/frontend_probe.py::tile_sum``, packed words,
  128 x 2048 tiles) against ``x.view(C, n_tt, 2048).sum(-1)``, at C =
  1,024 x B = 262,144;
- ``k3_stream31`` (``probes/k3_probe.py::tile_sum("stream31")``) against
  ``x3.view(3C, n_tt, 1024).sum(-1)``, at C = 1,024 x B8 = 32,768.

Both sides write into outputs made once beforehand (the probes' tile sums
also write their ``last`` [C, 128], 0.05% of the bytes), so a call is one
launch on each side.  Each round times ``reps`` chained calls of one side
and then of the other (``ab_time._ms``: CUDA events, after one call), the
kernel first in even rounds and the library call first in odd ones.  One
JSON row a case: each side's median, minimum and maximum ms a call over
the rounds, the median of the per-round differences (kernel - library),
the rounds in which the kernel was slower, and ``loses``: the kernel's
median above the library's by more than either side's spread (maximum -
minimum).  The first line names the card and its power limit.  Exits 1
without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from fm_radio_tpu_torch.probes import frontend_probe as fp
from fm_radio_tpu_torch.probes import hbm_sweep as hs
from fm_radio_tpu_torch.probes import k3_probe as k3
from fm_radio_tpu_torch.probes.ab_time import _ms


def in_turns(kernel, library, rounds: int, reps: int) -> dict:
    """Both sides timed alternately (module docstring)."""
    ks, ls = [], []
    for i in range(rounds):
        if i % 2 == 0:
            ks.append(_ms(kernel, reps))
            ls.append(_ms(library, reps))
        else:
            ls.append(_ms(library, reps))
            ks.append(_ms(kernel, reps))
    diffs = [k - lib for k, lib in zip(ks, ls)]

    def side(v):
        return {"median_ms": statistics.median(v), "min_ms": min(v),
                "max_ms": max(v), "spread_ms": max(v) - min(v)}

    k, lib = side(ks), side(ls)
    gap = k["median_ms"] - lib["median_ms"]
    return {"kernel": k, "library": lib,
            "median_diff_ms": statistics.median(diffs),
            "rounds_kernel_slower": sum(d > 0 for d in diffs),
            "rounds": rounds, "calls_a_round": reps,
            "loses": gap > max(k["spread_ms"], lib["spread_ms"])}


def cases(device) -> list:
    """(name, kernel call, library call, what) of each case."""
    rows = 256 * (1 << 20) // (4 * hs.LANES)
    rows -= rows % 2048
    g = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((rows, hs.LANES), generator=g, device=device)
    y = torch.empty_like(x)
    c, b = 1024, 262144
    xw = fp.make_inputs(c, b, device)["f32w"]
    xs = k3.make_inputs(1024, 32768, device)
    x3 = k3.stack31(xs, k3.C_BLK)
    # each side's outputs, (last, sums) for the kernels
    fp_out = (torch.empty((c, 128), device=device),
              torch.empty((c, b // 2048), device=device))
    fp_lib = torch.empty_like(fp_out[1])
    k3_out = (torch.empty((1024, 128), device=device),
              torch.empty((3 * 1024, 32768 // 1024), device=device))
    k3_lib = torch.empty_like(k3_out[1])
    return [
        ("hbm_dma_copy", lambda: hs.dma_copy(x, 32 * 1024, 2, out=y),
         lambda: y.copy_(x), f"dma2:32KiB vs Tensor.copy_, {x.numel() * 4} "
                             "bytes"),
        ("fp_sum", lambda: fp.tile_sum(xw, "f32w", False, 128, 2048,
                                       out=fp_out),
         lambda: torch.sum(xw.view(c, -1, 2048), -1, out=fp_lib),
         "stream:no=128:f32 vs x.view(C, n_tt, 2048).sum(-1), words "
         "1024 x 262144"),
        ("k3_stream31", lambda: k3.tile_sum("stream31", (x3,), 1024,
                                            out=k3_out),
         lambda: torch.sum(x3.view(3 * 1024, -1, 1024), -1, out=k3_lib),
         "stream31:t=1024 vs x3.view(3C, n_tt, 1024).sum(-1), 1024 x 32768"),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=25)
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("vs_library: no CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"probe": "vs_library", "card": smi}), flush=True)
    for name, kern, lib, what in cases(dev):
        print(json.dumps({"case": name, "what": what,
                          **in_turns(kern, lib, a.rounds, a.reps)}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
