"""Device-memory streaming sweep: the copy and read rates the card reaches.

Counterpart of ``tools/hbm_sweep.py`` (the TPU's bandwidth diagnostic).
Each hand-written kernel (``csrc/hbm_sweep.cu``) beside its plain PyTorch
version and a launch counter:

  grid_copy(x, bm, bn)      ``pallas_copy``: one CTA per [bm, bn] block,
                            16-byte loads and stores
  dma_copy(x, chunk, nbuf)  ``dma_copy``: chunks staged through shared
                            memory by the bulk asynchronous copy, one or
                            two buffers an issuer, several issuers a CTA
                            (``dma_plan``)
  read_sum(x, bm)           ``pallas_read``: a read-only sum into [1, 128],
                            every column c into lane c % 128, in a fixed
                            order

and beside them one PyTorch call each, as the TPU tool times XLA's
``x * c``: ``torch.mul(x, c)`` and ``Tensor.copy_`` for the copies,
``torch.sum(x)`` for the read, ``Tensor.zero_`` for a write alone.
:func:`sweep` times each over chained calls on one float32 [R, 1024] array
with CUDA events, counting 2x the bytes for a copy and 1x for a read or a
write (the staged copy's halves, :func:`dma_half`), and checks each copy
equal to its input and each read equal to its plain version.  Its best copy rate and its best read rate
are the card's own byte rates: ``chip_smoke.py`` divides a read-only
kernel's bytes by the read rate and every other kernel's by the copy
rate.

    python -m fm_radio_tpu_torch.probes.hbm_sweep [--mib 256] [--iters 50]
"""

from __future__ import annotations

import argparse
import ctypes
import json

import torch

from fm_radio_tpu_torch.kernels import _build
from fm_radio_tpu_torch.probes import _probe

LANES = 1024
SMEM_BYTES = _probe.SMEM_BYTES  # shared memory one CTA may use
# the staged copy's issuers a CTA at most, and the shared memory their
# buffers may take beside their barriers (csrc/hbm_sweep.cu)
DMA_ISSUERS = 32
DMA_SMEM = SMEM_BYTES - 2 * 8 * DMA_ISSUERS
# the staged copy's halves, timed apart: its loads alone, its stores alone
DMA_HALVES = {"load": 1, "store": 2}

# kernel launches since the counter was last set to 0
launches_copy = 0
launches_dma = 0
launches_read = 0

# the TPU tool's swept shapes (tools/hbm_sweep.py:263-278); the DMA chunks
# are what shared memory holds, in KiB
COPY_BLOCKS = ((256, 1024), (512, 1024), (1024, 1024), (512, 512),
               (1024, 512), (2048, 256), (8, 1024))
DMA_CHUNKS_KIB = (16, 32, 64, 128)
READ_ROWS = (512, 2048)

_P, _I, _I64 = _build.P, _build.I, _build.I64


def grid_copy_plain(x: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    """A copy of x (the block shape changes only how the kernel walks it)."""
    return x.clone()


def dma_copy_plain(x: torch.Tensor, chunk: int, nbuf: int) -> torch.Tensor:
    """A copy of x."""
    return x.clone()


def read_sum_plain(x: torch.Tensor, bm: int) -> torch.Tensor:
    """[1, 128]: every column c of x [R, 1024] summed into lane c % 128, in
    the kernel's order: the rows of each block of bm rows one after the
    other, the eight columns of a lane in column order, then the blocks in
    row order."""
    rows = x.shape[0]
    v = x.reshape(rows // bm, bm, LANES // 128, 128)
    acc = torch.zeros_like(v[:, 0])
    for r in range(bm):
        acc = acc + v[:, r]
    lane = torch.zeros_like(acc[:, 0])
    for k in range(acc.shape[1]):
        lane = lane + acc[:, k]
    y = torch.zeros_like(lane[0])
    for b in range(lane.shape[0]):
        y = y + lane[b]
    return y[None]


def _check(name: str, x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous() \
            or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be contiguous 16-byte aligned "
                         f"float32 [R, N], got {x.dtype} {tuple(x.shape)}")


def grid_copy(x: torch.Tensor, bm: int, bn: int,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """x [R, N] float32 copied by the grid-copy kernel into ``out`` (new if
    None).  CPU tensors run :func:`grid_copy_plain`."""
    _check("grid_copy", x)
    if _build.on_cpu("grid_copy", x.device):
        return grid_copy_plain(x, bm, bn)
    global launches_copy
    y = torch.empty_like(x) if out is None else out
    _build.require("grid_copy", x.device, torch.float32, y=y)
    fn = _build.function("hbm_sweep", "fmt_hbm_grid_copy",
                         [_P, _P, _I, _I, _I, _I, _P])
    _build.check("hbm_sweep", fn(x.data_ptr(), y.data_ptr(), x.shape[0],
                                 x.shape[1], bm, bn,
                                 _build.stream_ptr(x.device)))
    launches_copy += 1
    return y


def dma_plan(nbytes: int, chunk: int, nbuf: int, sms: int) -> tuple:
    """(CTAs, issuers a CTA) of the staged copy (``csrc/hbm_sweep.cu::
    dma_plan``, whose host copy this is): as many issuers a CTA as shared
    memory holds ``nbuf`` buffers of ``chunk`` bytes for (32 at most), one
    CTA an SM, no more CTAs than the chunks need."""
    per_cta = min(DMA_ISSUERS, DMA_SMEM // (nbuf * chunk))
    n_chunks = nbytes // chunk
    want = -(-n_chunks // per_cta) if per_cta > 0 else 0
    return min(want, sms), per_cta


def dma_plan_card(nbytes: int, chunk: int, nbuf: int, sms: int) -> tuple:
    """The C side's ``dma_plan`` (``fmt_hbm_dma_plan``), for the host copy
    to be held against."""
    fn = _build.function("hbm_sweep", "fmt_hbm_dma_plan",
                         [_I64, _I, _I, _I, _P])
    out = (ctypes.c_int * 2)()
    _build.check("hbm_sweep", fn(nbytes, chunk, nbuf, sms,
                                 ctypes.addressof(out)))
    return out[0], out[1]


def dma_walk(n_chunks: int, issuers: int) -> list:
    """The chunks each of ``issuers`` issuers copies, in its order: issuer
    q takes q, q + issuers, q + 2 issuers, ..."""
    return [list(range(q, n_chunks, issuers)) for q in range(issuers)]


def dma_copy(x: torch.Tensor, chunk: int, nbuf: int,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """x copied in chunks of ``chunk`` bytes staged through shared memory
    with ``nbuf`` buffers an issuer into ``out`` (new if None), on
    :func:`dma_plan`'s grid.  CPU tensors run :func:`dma_copy_plain`."""
    return _dma("dma_copy", x, chunk, nbuf, 0, out)


def dma_half(x: torch.Tensor, chunk: int, nbuf: int, half: str,
             out: torch.Tensor) -> torch.Tensor:
    """One half of :func:`dma_copy`, the same kernel on the same plan:
    ``half`` "load" brings every chunk of x into shared memory and stores
    nothing (``out`` untouched), "store" stores each issuer's buffers to
    every chunk of ``out`` and loads nothing (``out`` then holds whatever
    shared memory held).  A rate, with no plain version; CPU tensors are
    refused."""
    return _dma("dma_half", x, chunk, nbuf, DMA_HALVES[half], out)


def _dma(name: str, x: torch.Tensor, chunk: int, nbuf: int, half: int,
         out: torch.Tensor | None) -> torch.Tensor:
    _check(name, x)
    nbytes = x.numel() * 4
    if nbytes % chunk or chunk % 16 or nbuf not in (1, 2) \
            or nbuf * chunk > DMA_SMEM:
        raise ValueError(f"{name}: chunk {chunk} x {nbuf} does not fit "
                         f"{nbytes} bytes and shared memory")
    if _build.on_cpu(name, x.device):
        if half:
            raise ValueError(f"{name}: a rate of the card, no plain version")
        return dma_copy_plain(x, chunk, nbuf)
    global launches_dma
    y = torch.empty_like(x) if out is None else out
    _build.require(name, x.device, torch.float32, y=y)
    fn = _build.function("hbm_sweep", "fmt_hbm_dma_copy",
                         [_P, _P, _I64, _I, _I, _I, _P])
    _build.check("hbm_sweep", fn(x.data_ptr(), y.data_ptr(), nbytes, chunk,
                                 nbuf, half, _build.stream_ptr(x.device)))
    launches_dma += 1
    return y


def read_sum(x: torch.Tensor, bm: int, out: tuple | None = None
             ) -> torch.Tensor:
    """x [R, 1024] float32 -> [1, 128] (:func:`read_sum_plain`'s sum) by
    the read kernel, into ``out`` (its scratch [R / bm, 128] and the
    result) where given.  CPU tensors run the plain version."""
    _check("read_sum", x)
    if x.shape[1] != LANES or x.shape[0] % bm:
        raise ValueError(f"read_sum: x must be [R, {LANES}] with {bm} | R")
    if _build.on_cpu("read_sum", x.device):
        return read_sum_plain(x, bm)
    global launches_read
    part, y = out or (torch.empty((x.shape[0] // bm, 128), device=x.device),
                      torch.empty((1, 128), device=x.device))
    fn = _build.function("hbm_sweep", "fmt_hbm_read",
                         [_P, _I, _I, _P, _P, _P])
    _build.check("hbm_sweep", fn(x.data_ptr(), x.shape[0], bm,
                                 part.data_ptr(), y.data_ptr(),
                                 _build.stream_ptr(x.device)))
    launches_read += 1
    return y


def reset_counts() -> None:
    global launches_copy, launches_dma, launches_read
    launches_copy = launches_dma = launches_read = 0


def _time(fn, iters: int) -> float:
    """ms per call over ``iters`` chained calls (CUDA events), after one."""
    fn(0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sweep(mib: int = 256, iters: int = 50, device="cuda", seed: int = 0,
          copy_blocks=COPY_BLOCKS, dma_chunks_kib=DMA_CHUNKS_KIB,
          read_rows=READ_ROWS) -> dict:
    """Every variant on one float32 [R, 1024] array of about ``mib`` MiB
    (R a multiple of 2048), ``iters`` chained calls each: a copy goes from
    one buffer into the other and back (call i + 1 reads what call i
    wrote), the read sums the same array; beside each staged copy its
    loads alone and its stores alone (:func:`dma_half`: rates of one
    direction, as ``torch.sum`` reads and ``Tensor.zero_`` writes).  Each
    copy's result is checked equal to its input and the read equal to
    :func:`read_sum_plain`.  Returns {"rows": one per variant (name,
    route, kind: copy, read or write, ms per call, GB/s, ok), "best_copy"
    and "best_read": the fastest copy's and read's rows (:func:`best`),
    "array": shape and bytes}."""
    dev = torch.device(device)
    rows = mib * (1 << 20) // (4 * LANES)
    rows -= rows % 2048
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((rows, LANES), generator=g, device=dev)
    bufs = (x.clone(), torch.empty_like(x))
    nbytes = x.numel() * 4
    out = []

    def copy_row(name, route, step):
        def fn(i):
            step(bufs[i % 2], bufs[1 - i % 2])

        ms = _time(fn, iters)
        bufs[1].zero_()
        step(bufs[0], bufs[1])
        ok = bool(torch.equal(bufs[1], x))
        bufs[0].copy_(x)
        out.append({"variant": name, "route": route, "kind": "copy",
                    "ms": ms, "gbps": 2 * nbytes / ms / 1e6, "ok": ok})

    def rate_row(name, route, kind, step):
        ms = _time(lambda i: step(), iters)
        out.append({"variant": name, "route": route, "kind": kind, "ms": ms,
                    "gbps": nbytes / ms / 1e6, "ok": True})  # a rate only

    for bm, bn in copy_blocks:
        copy_row(f"copy:{bm}x{bn}", "cuda",
                 lambda a, b, bm=bm, bn=bn: grid_copy(a, bm, bn, out=b))
    for kib in dma_chunks_kib:
        for nbuf in (1, 2):
            if nbuf * kib * 1024 > DMA_SMEM:
                continue
            c = kib * 1024
            copy_row(f"dma{nbuf}:{kib}KiB", "cuda",
                     lambda a, b, c=c, n=nbuf: dma_copy(a, c, n, out=b))
            # the copy's halves apart: its loads alone, its stores alone
            for half, kind in (("load", "read"), ("store", "write")):
                rate_row(f"dma{nbuf}:{kib}KiB:{half}", "cuda", kind,
                         lambda c=c, n=nbuf, h=half: dma_half(
                             bufs[0], c, n, h, bufs[1]))
    scale = 1.0000001  # a multiply, as the TPU tool's XLA stream
    copy_row("torch.mul", "library",
             lambda a, b: torch.mul(a, scale, out=b))
    out[-1]["ok"] = True  # a scaled copy: checked as a rate only
    copy_row("Tensor.copy_", "library", lambda a, b: b.copy_(a))
    for bm in read_rows:
        ms = _time(lambda i, bm=bm: read_sum(x, bm), iters)
        ok = bool(torch.equal(read_sum(x, bm), read_sum_plain(x, bm)))
        out.append({"variant": f"read:{bm}x{LANES}", "route": "cuda",
                    "kind": "read", "ms": ms, "gbps": nbytes / ms / 1e6,
                    "ok": ok})
    total = torch.empty((), device=dev)
    rate_row("torch.sum", "library", "read",
             lambda: torch.sum(x.view(-1), 0, out=total))
    rate_row("Tensor.zero_", "library", "write", lambda: bufs[1].zero_())
    return dict(best(out), rows=out,
                array={"shape": [rows, LANES], "bytes": nbytes,
                       "iters": iters})


def best(rows: list) -> dict:
    """{"best_copy", "best_read"}: the fastest row of each kind, copy and
    read, of a sweep's rows, by GB/s."""
    def top(kind):
        return max((r for r in rows if r["kind"] == kind),
                   key=lambda r: r["gbps"])

    return {"best_copy": top("copy"), "best_read": top("read")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mib", type=int, default=256)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hbm_sweep: no CUDA device")
        return 1
    res = sweep(args.mib, args.iters)
    for r in res["rows"]:
        print(json.dumps(r))
    print(json.dumps({"best_copy": res["best_copy"],
                      "best_read": res["best_read"],
                      "device": torch.cuda.get_device_name(0)}))
    return 0 if all(r["ok"] for r in res["rows"]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
