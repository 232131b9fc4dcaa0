"""Device-memory streaming sweep: the copy and read rates the card reaches.

Counterpart of ``tools/hbm_sweep.py`` (the TPU's bandwidth diagnostic).
Each hand-written kernel (``csrc/hbm_sweep.cu``) beside its plain PyTorch
version and a launch counter:

  grid_copy(x, bm, bn)      ``pallas_copy``: one CTA per [bm, bn] block,
                            16-byte loads and stores
  dma_copy(x, chunk, nbuf)  ``dma_copy``: chunks staged through shared
                            memory by the bulk asynchronous copy, one or
                            two buffers
  read_sum(x, bm)           ``pallas_read``: a read-only sum into [1, 128],
                            every column c into lane c % 128, in a fixed
                            order

and beside them one PyTorch call each, as the TPU tool times XLA's
``x * c``: ``torch.mul(x, c)`` and ``Tensor.copy_``.  :func:`sweep` times
each over chained calls on one float32 [R, 1024] array with CUDA events,
counting 2x the bytes for a copy and 1x for the read, and checks each copy
equal to its input and each read equal to its plain version.  Its best copy
rate is the card's own byte rate, which ``chip_smoke.py`` divides every
kernel's bytes by.

    python -m fm_radio_tpu_torch.probes.hbm_sweep [--mib 256] [--iters 50]
"""

from __future__ import annotations

import argparse
import json

import torch

from fm_radio_tpu_torch.kernels import _build

LANES = 1024
SMEM_BYTES = 232448  # shared memory one CTA may use on this card

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


def dma_ctas(device, chunk: int, nbuf: int) -> int:
    """CTAs for the staged copy: as many as shared memory lets each SM
    hold."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * max(1, SMEM_BYTES // (nbuf * chunk + 1024))


def dma_copy(x: torch.Tensor, chunk: int, nbuf: int,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """x copied in chunks of ``chunk`` bytes staged through shared memory
    with ``nbuf`` buffers into ``out`` (new if None).  CPU tensors run
    :func:`dma_copy_plain`."""
    _check("dma_copy", x)
    nbytes = x.numel() * 4
    if nbytes % chunk or chunk % 16 or nbuf not in (1, 2) \
            or nbuf * chunk > SMEM_BYTES:
        raise ValueError(f"dma_copy: chunk {chunk} x {nbuf} does not fit "
                         f"{nbytes} bytes and shared memory")
    if _build.on_cpu("dma_copy", x.device):
        return dma_copy_plain(x, chunk, nbuf)
    global launches_dma
    y = torch.empty_like(x) if out is None else out
    _build.require("dma_copy", x.device, torch.float32, y=y)
    fn = _build.function("hbm_sweep", "fmt_hbm_dma_copy",
                         [_P, _P, _I64, _I, _I, _I, _P])
    ctas = min(dma_ctas(x.device, chunk, nbuf), nbytes // chunk)
    _build.check("hbm_sweep", fn(x.data_ptr(), y.data_ptr(), nbytes, chunk,
                                 nbuf, ctas, _build.stream_ptr(x.device)))
    launches_dma += 1
    return y


def read_sum(x: torch.Tensor, bm: int) -> torch.Tensor:
    """x [R, 1024] float32 -> [1, 128] (:func:`read_sum_plain`'s sum) by
    the read kernel.  CPU tensors run the plain version."""
    _check("read_sum", x)
    if x.shape[1] != LANES or x.shape[0] % bm:
        raise ValueError(f"read_sum: x must be [R, {LANES}] with {bm} | R")
    if _build.on_cpu("read_sum", x.device):
        return read_sum_plain(x, bm)
    global launches_read
    part = torch.empty((x.shape[0] // bm, 128), device=x.device)
    y = torch.empty((1, 128), device=x.device)
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
    wrote), the read sums the same array.  Each copy's result is checked
    equal to its input and the read equal to :func:`read_sum_plain`.
    Returns {"rows": one per variant (name, route, ms per call, GB/s,
    ok), "best_copy": the fastest copy's row, "array": shape and bytes}."""
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
        out.append({"variant": name, "route": route, "ms": ms,
                    "gbps": 2 * nbytes / ms / 1e6, "ok": ok})

    for bm, bn in copy_blocks:
        copy_row(f"copy:{bm}x{bn}", "cuda",
                 lambda a, b, bm=bm, bn=bn: grid_copy(a, bm, bn, out=b))
    for kib in dma_chunks_kib:
        for nbuf in (1, 2):
            if nbuf * kib * 1024 > SMEM_BYTES:
                continue
            copy_row(f"dma{nbuf}:{kib}KiB", "cuda",
                     lambda a, b, c=kib * 1024, n=nbuf: dma_copy(a, c, n,
                                                                 out=b))
    scale = 1.0000001  # a multiply, as the TPU tool's XLA stream
    copy_row("torch.mul", "library",
             lambda a, b: torch.mul(a, scale, out=b))
    out[-1]["ok"] = True  # a scaled copy: checked as a rate only
    copy_row("Tensor.copy_", "library", lambda a, b: b.copy_(a))
    for bm in read_rows:
        ms = _time(lambda i, bm=bm: read_sum(x, bm), iters)
        ok = bool(torch.equal(read_sum(x, bm), read_sum_plain(x, bm)))
        out.append({"variant": f"read:{bm}x{LANES}", "route": "cuda",
                    "ms": ms, "gbps": nbytes / ms / 1e6, "ok": ok})
    copies = [r for r in out if not r["variant"].startswith("read")]
    return {"rows": out, "best_copy": max(copies, key=lambda r: r["gbps"]),
            "array": {"shape": [rows, LANES], "bytes": nbytes,
                      "iters": iters}}


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
                      "device": torch.cuda.get_device_name(0)}))
    return 0 if all(r["ok"] for r in res["rows"]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
