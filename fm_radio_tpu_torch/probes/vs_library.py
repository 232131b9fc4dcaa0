"""Six probe kernels and the mid end's two tiled FIR kernels against the
one PyTorch call of the same function, timed in turns on one card.

    python -m fm_radio_tpu_torch.probes.vs_library [--rounds 25] [--reps 10]

The cases, each at the shape ``chip_smoke.py`` times it at:

- ``hbm_dma_copy`` (``probes/hbm_sweep.py::dma_copy``, 32 KiB chunks
  through two buffers) against ``Tensor.copy_``, on the sweep's 256 MiB
  float32 [R, 1024] array;
- ``fp_sum`` stream (``probes/frontend_probe.py::tile_sum``, packed words,
  128 x 2048 tiles) against ``x.view(C, n_tt, 2048).sum(-1)``, at C =
  1,024 x B = 262,144;
- ``k3_stream31`` (``probes/k3_probe.py::tile_sum("stream31")``) against
  ``x3.view(3C, n_tt, 1024).sum(-1)``, at C = 1,024 x B8 = 32,768;
- ``hbm_read`` (``probes/hbm_sweep.py::read_sum``, 512-row blocks: every
  column c into lane c % 128) against ``x.view(-1, 8, 128).sum((0, 1))``,
  the same function in one call, on the sweep's array;
- ``mid_ds2`` (``kernels/midend.py::mid_ds2``: the de-emphasis route's ds
  x2 kernel on float32 fm_demod, K2's form) against
  ``F.conv1d([tail | fmd].view(C, 1, .), w2_rev.view(1, 1, 64),
  stride=2)``, and ``mid_hilb`` (``mid_hilb``: its Hilbert kernel, re and
  im) against ``F.conv1d([htail | fm_out].view(C, 1, .), wh_rev.view(1,
  1, 65))`` (im only: re is the delayed input), at the de-emphasis
  lenses' shape (C = 2,048, B = 131,072: fm_demod [2048, 32768], fm_out
  [2048, 16384]), N(0, 0.3^2) samples and carried tails, the
  concatenated inputs made once beforehand; cuDNN in float32 (the port
  turns TF32 off, ``fm_radio_tpu_torch/__init__.py``);
- ``k2_ds2`` (``probes/k2_probe.py::variant("ds2")``: ``k2_ds2_kernel``,
  the ds x2 FIR into re, im and theta) against ``F.conv1d([zeros |
  x].view(C, 1, .), w2_rev.view(1, 1, 64), stride=2)``, on the K2 probe's
  fm_demod (C = 1,024 x B4 = 65,536), and ``k2_hilb``
  (``k2_probe.hilb_launch``: ``k2_hilb_kernel`` alone, the Hilbert FIR into
  im and theta and the rotated re, t_blk 1,024) against ``F.conv1d([zeros
  | fm_out].view(C, 1, .), wh_rev.view(1, 1, 65))`` (im only), on a given
  fm_out of 1,024 x 32,768 (the probe's own N(0, 1), seed 1); the probe's
  filters, its zero state.

Both sides write into outputs made once beforehand (the probes' tile sums
also write their ``last`` [C, 128], 0.05% of the bytes; ``F.conv1d`` has
no ``out=``: its output comes from the caching allocator, which does no
device work), so a call is one launch on each side (the read two: its
blocks' sums, then their sum).  :func:`conv1d_rows` times the one
``F.conv1d`` call of three probe FIRs at their own shapes, for the kernels
table (no kernel beside it): the K2 probe's ds2 (C = 1,024 x B4 =
65,536, 64 taps, stride 2) and hilb's Hilbert (1,024 x 32,768, 65 taps)
and the K1 probe's dots (both planes of C = 1,024 x B = 262,144 as 2C
rows, 132 taps, stride 4).
Each round times ``reps`` chained calls of one side and then of the other
(``ab_time._ms``: CUDA events, after one call), the kernel first in even
rounds and the library call first in odd ones.  One JSON row a case: each
side's median, minimum and maximum ms a call over the rounds, the median
of the per-round differences (kernel - library), the rounds in which the
kernel was slower and faster, and the verdict of a one-sided sign test on
the paired rounds at 1% (:func:`verdict`): ``loses`` where the kernel was
slower in at least :func:`sign_need` of the rounds that were not ties
(19 of 25) and the median difference is above 0, ``wins`` the same the
other way.  The first line names the card and its power limit.  Exits 1
without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess

import torch

import torch.nn.functional as fnn

from fm_radio_tpu_torch.kernels import midend as km
from fm_radio_tpu_torch.probes import frontend_probe as fp
from fm_radio_tpu_torch.probes import hbm_sweep as hs
from fm_radio_tpu_torch.probes import k2_probe as k2
from fm_radio_tpu_torch.probes import k3_probe as k3
from fm_radio_tpu_torch.probes.ab_time import _ms


SIGN_LEVEL = 0.01  # the sign test's one-sided level


def sign_need(n: int, level: float = SIGN_LEVEL) -> int:
    """The fewest of n paired rounds that one side must win for a
    one-sided sign test at ``level``: the least s with P(X >= s) <= level
    for X ~ Binomial(n, 1/2) (19 for n = 25); n + 1 where no s will do."""
    tail = 0.0
    for s in range(n, -1, -1):
        tail += math.comb(n, s) / 2.0 ** n
        if tail > level:
            return s + 1
    return 0


def verdict(diffs: list) -> dict:
    """The paired rule on per-round differences (kernel - library, ms):
    ties (0) drop out, as a sign test drops them; the kernel ``loses``
    where it was slower in at least sign_need(rounds not tied) rounds and
    the median difference is above 0, and ``wins`` where it was faster in
    as many and the median is below 0."""
    slower = sum(d > 0 for d in diffs)
    faster = sum(d < 0 for d in diffs)
    need = sign_need(slower + faster)
    med = statistics.median(diffs)
    return {"median_diff_ms": med, "rounds_kernel_slower": slower,
            "rounds_kernel_faster": faster, "rounds_needed": need,
            "loses": slower >= need and med > 0,
            "wins": faster >= need and med < 0}


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

    def side(v):
        return {"median_ms": statistics.median(v), "min_ms": min(v),
                "max_ms": max(v), "spread_ms": max(v) - min(v)}

    return {"kernel": side(ks), "library": side(ls),
            **verdict([k - lib for k, lib in zip(ks, ls)]),
            "rounds": rounds, "calls_a_round": reps}


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
    bm = 512
    rd_out = (torch.empty((rows // bm, 128), device=device),
              torch.empty((1, 128), device=device))
    rd_lib = torch.empty((128,), device=device)
    # the de-emphasis lenses' mid end: fm_demod [C, B/4], fm_out [C, B/8]
    cm, n4 = 2048, 32768
    w2 = torch.randn((64,), generator=g, device=device) / 64
    wh = torch.randn((65,), generator=g, device=device) / 65
    fmd = 0.3 * torch.randn((cm, n4), generator=g, device=device)
    t2 = 0.3 * torch.randn((cm, 62), generator=g, device=device)
    fm = 0.3 * torch.randn((cm, n4 // 2), generator=g, device=device)
    ht = 0.3 * torch.randn((cm, 64), generator=g, device=device)
    ds2_out = (torch.empty((cm, n4 // 2), device=device),
               torch.empty((cm, 62), device=device))
    hilb_out = tuple(torch.empty((cm, n4 // 2), device=device)
                     for _ in range(2))
    ds2_in = torch.cat([t2, fmd], dim=1).view(cm, 1, -1)
    hilb_in = torch.cat([ht, fm], dim=1).view(cm, 1, -1)
    # the K2 probe's engine: fm_demod [1024, 65536], fm_out [1024, 32768]
    ck, b4 = 1024, 65536
    co = k2.coeffs(device)
    k2w2, k2wh = (t.flip(0).contiguous() for t in (co.taps_fm_out,
                                                     co.taps_hilbert))
    k2x = k2.make_input(ck, b4, device)
    k2fm = k2.make_input(ck, b4 // 2, device, seed=1)
    k2_ds2_out = tuple(torch.empty((ck, b4 // 2), device=device)
                       for _ in range(3))
    k2_hilb_out = tuple(torch.empty_like(k2fm) for _ in range(3))
    k2_ds2_in = torch.cat([torch.zeros((ck, 62), device=device), k2x],
                          dim=1).view(ck, 1, -1)
    k2_hilb_in = torch.cat([torch.zeros((ck, 64), device=device), k2fm],
                           dim=1).view(ck, 1, -1)
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
        ("hbm_read", lambda: hs.read_sum(x, bm, out=rd_out),
         lambda: torch.sum(x.view(-1, 8, 128), (0, 1), out=rd_lib),
         f"read:{bm}x1024 vs x.view(-1, 8, 128).sum((0, 1)), "
         f"{x.numel() * 4} bytes"),
        ("mid_ds2", lambda: km.mid_ds2(w2, t2, fmd, out=ds2_out),
         lambda: fnn.conv1d(ds2_in, w2.view(1, 1, -1), stride=2),
         f"k12_mid_ds2_kernel on float32 fm_demod {cm} x {n4} vs "
         "F.conv1d([tail | fmd], w2_rev, stride=2)"),
        ("mid_hilb", lambda: km.mid_hilb(wh, ht, fm, out=hilb_out),
         lambda: fnn.conv1d(hilb_in, wh.view(1, 1, -1)),
         f"k12_mid_hilb_kernel (re, im) on fm_out {cm} x {n4 // 2} vs "
         "F.conv1d([htail | fm_out], wh_rev) (im)"),
        ("k2_ds2", lambda: k2.variant("ds2", k2x, 1024, co, out=k2_ds2_out),
         lambda: fnn.conv1d(k2_ds2_in, k2w2.view(1, 1, -1), stride=2),
         f"k2_ds2_kernel (re, im, theta) on fm_demod {ck} x {b4} vs "
         "F.conv1d([zeros | x], w2_rev, stride=2)"),
        ("k2_hilb", lambda: k2.hilb_launch(k2fm, 1024, co, out=k2_hilb_out),
         lambda: fnn.conv1d(k2_hilb_in, k2wh.view(1, 1, -1)),
         f"k2_hilb_kernel (re, im, theta; t_blk 1024) on fm_out {ck} x "
         f"{b4 // 2} vs F.conv1d([zeros | fm_out], wh_rev) (im)"),
    ]


def conv1d_rows(device, reps: int = 20) -> list:
    """The one ``F.conv1d`` call of two probe FIRs at their own shapes
    (module docstring), ms a call (``ab_time._ms``), one row each."""
    g = torch.Generator(device=device).manual_seed(2)
    rows = []
    for case, c, n, taps, stride in (("k2_ds2", 1024, 65536, 64, 2),
                                     ("k2_hilb", 1024, 32768, 65, 1),
                                     ("fp_fir dots", 2 * 1024, 262144, 132,
                                      4)):
        x = torch.randn((c, 1, n + taps - stride), generator=g,
                        device=device)
        w = torch.randn((1, 1, taps), generator=g, device=device)
        rows.append({"case": case, "what": f"F.conv1d [{c}, 1, "
                     f"{n + taps - stride}] x {taps} taps, stride {stride}",
                     "library_ms": _ms(lambda: fnn.conv1d(x, w,
                                                          stride=stride),
                                       reps)})
        del x
    return rows


def run(device, rounds: int = 25, reps: int = 10, emit=None) -> list:
    """Every case in turns (module docstring): one row each, also passed
    to ``emit``."""
    rows = []
    for name, kern, lib, what in cases(device):
        r = {"case": name, "what": what, **in_turns(kern, lib, rounds, reps)}
        rows.append(r)
        if emit is not None:
            emit(r)
    return rows


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
    run(dev, a.rounds, a.reps, lambda r: print(json.dumps(r), flush=True))
    for r in conv1d_rows(dev):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
