"""What the engine probes share: the ordered per-tile sums of the stream
variants (the plain side of ``csrc/probe_sum.cuh``), the timer, the
command line and the rows they print.

Each probe (``frontend_probe``, ``k2_probe``, ``k3_probe``,
``chain_probe``) runs on the card unless ``--device cpu`` is given, which
runs the plain versions at a tiny shape; with no card and no ``--device
cpu`` it raises.  Every variant is timed over chained calls with CUDA
events, best of 3, and printed as one JSON row: variant, ms, gbps_in
(input bytes over the time) and max_abs_err against its plain version.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

WARP = 32
SMEM_BYTES = 232448  # shared memory one CTA may use on this card


def lane_sums(vals: torch.Tensor, vec: int) -> torch.Tensor:
    """[..., t] -> [..., 32]: lane l's ordered partial sum of a tile of t
    per-element values, as the kernels add them: its 16-byte vectors
    k*32 + l one after the other (``vec`` values each), element by
    element, in float32."""
    t = vals.shape[-1]
    v = vals.reshape(*vals.shape[:-1], t // (WARP * vec), WARP, vec)
    acc = torch.zeros(v.shape[:-3] + (WARP,), dtype=torch.float32,
                      device=vals.device)
    for k in range(v.shape[-3]):
        for e in range(vec):
            acc = acc + v[..., k, :, e]
    return acc


def butterfly(acc: torch.Tensor) -> torch.Tensor:
    """[..., 32] -> [...]: the warp's lanes added by butterfly (xor 16, 8,
    4, 2, 1), as ``warp_allsum``: every lane ends with lane 0's sum."""
    idx = torch.arange(WARP, device=acc.device)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[..., idx ^ off]
    return acc[..., 0]


def last_tile(sums: torch.Tensor) -> torch.Tensor:
    """The TPU kernels' [R, 128] output of the stream variants: the last
    time tile's row sums, broadcast over 128 lanes (each grid step wrote the
    same output block; the last one stays)."""
    return sums[:, -1:].expand(sums.shape[0], 128).contiguous()


# tile_sum_kernel's walk (csrc/probe_sum.cuh; this is its host copy):
# the tile lengths its lane loop is compiled for, the 16-byte loads a lane
# keeps in flight at most, and a CTA's warps
SUM_T_BLKS = (1024, 2048, 4096)
SUM_LOADS = 8
SUM_WARPS = 8


def sum_item(i: int, rows: int, n_tt: int, raster: int) -> tuple[int, int]:
    """(row, time tile) of item i (``sum_item``): raster 0 each row's
    tiles in order, row after row; raster 1 every row's tile ti, then
    tile ti + 1."""
    if raster == 0:
        return i // n_tt, i % n_tt
    return i % rows, i // rows


def sum_grid(rows: int, n_tt: int) -> int:
    """The launch's warps (``launch_tile_sum_k``): a CTA of SUM_WARPS for
    every SUM_WARPS items."""
    return -(-rows * n_tt // SUM_WARPS) * SUM_WARPS


def sum_walk(rows: int, n_tt: int, raster: int, warps: int) -> list:
    """Each of ``warps`` warps' items in the order it sums them, each as
    (row, tile): warp p takes items p, p + warps, ... (one each on the
    launch's grid, :func:`sum_grid`)."""
    items = rows * n_tt
    return [[sum_item(i, rows, n_tt, raster) for i in range(p, items, warps)]
            for p in range(warps)]


def sum_batch(k: int, planes: int) -> int:
    """A row's vectors a batch at a compiled length of k vectors a lane
    (``sum_batch``): the largest power of two dividing k with a batch of
    every plane within SUM_LOADS loads, at least 1."""
    b = 1
    while b * 2 <= k and k % (b * 2) == 0 and b * 2 * planes <= SUM_LOADS:
        b *= 2
    return b


def lane_order(t_blk: int, vec: int, planes: int) -> list[list[int]]:
    """The batches in which a lane fetches its vectors k of a row's tile
    (vector k * 32 + lane): at a compiled length sum_batch's batches, at
    any other one vector at a time.  Each batch's loads go out before its
    first add; the adds follow k in order."""
    k = t_blk // (WARP * vec)
    b = sum_batch(k, planes) if t_blk in SUM_T_BLKS else 1
    return [list(range(k0, k0 + b)) for k0 in range(0, k, b)]


def parse(argv, doc: str, positional: list[tuple[str, int]],
          sections: str, iters: int) -> argparse.Namespace:
    """The probes' command line: the TPU tool's positional shape
    arguments with their defaults, ``--sections``, ``--iters`` and
    ``--device``."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    for name, default in positional:
        ap.add_argument(name, type=int, nargs="?", default=None,
                        help=f"default {default} (a tiny shape with "
                             "--device cpu)")
    ap.add_argument("--sections", default=sections,
                    help=f"comma-separated (default {sections})")
    ap.add_argument("--iters", type=int, default=iters,
                    help="chained calls per timing (best of 3)")
    ap.add_argument("--device", default=None,
                    help="cpu: the plain versions at a tiny shape")
    return ap.parse_args(argv)


def device_of(name: str | None) -> torch.device:
    """The card, unless ``name`` is "cpu"; raises where there is no card."""
    if name == "cpu":
        return torch.device("cpu")
    if name not in (None, "cuda") and not str(name).startswith("cuda"):
        raise ValueError(f"unknown device {name!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run on the card, or pass "
                           "--device cpu for the plain versions")
    return torch.device(name or "cuda")


def time_ms(fn, iters: int, device: torch.device, repeats: int = 3):
    """(ms, out): ms per call of ``fn()`` over ``iters`` chained calls
    (CUDA events), best of ``repeats``, after one call whose result is
    ``out`` (the one the probes compare, so a comparison adds no launch);
    ms None on the CPU (no device time is measured there)."""
    out = fn()
    if device.type != "cuda":
        return None, out
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        best = min(best, start.elapsed_time(end) / iters)
    return best, out


def max_err(a, b) -> float:
    """Max abs difference over a tensor or a tuple of tensors (NaN where
    either side has one)."""
    if isinstance(a, (tuple, list)):
        errs = [max_err(x, y) for x, y in zip(a, b)]
        # Python's max drops a NaN that comes after a number
        return math.nan if any(map(math.isnan, errs)) else max(errs)
    return float((a.float() - b.float()).abs().max())


def row(variant: str, kernel: str, ms, in_bytes: int, err,
        **extra) -> dict:
    """One printed row: the variant, the kernel that ran it (its launch
    counter's name in the probe's ``counts()``), ms per call (None: not
    measured, the CPU), the input bytes over the time in GB/s, the max abs
    error against the plain version (None: not compared)."""
    r = {"variant": variant, "kernel": kernel, "ms": ms,
         "gbps_in": None if ms is None else in_bytes / ms / 1e6,
         "max_abs_err": err}
    r.update(extra)
    return r


def emit(r: dict) -> None:
    print(json.dumps(r), flush=True)


def header(name: str, device: torch.device, **shape) -> dict:
    """The first printed line: the probe, the device and the shape."""
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu (plain versions; no device time)")
    h = {"probe": name, "device": kind, **shape}
    print(json.dumps(h), flush=True)
    return h
