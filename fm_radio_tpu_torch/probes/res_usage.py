"""Registers, spills, shared memory and CTAs an SM of a checkout's kernels.

    python3 fm_radio_tpu_torch/probes/res_usage.py [--root DIR]
        [--libs midend,k3_probe] [--match k12_mid_ds2_kernel,...]

Builds the checkout at DIR (this one by default) with its own
``kernels/_build.py`` (``probes/sass_diff.py``'s ``build``), extracts each
library's cubin (``cuobjdump -xelf``), and for every kernel whose name
holds one of the ``--match`` strings asks the CUDA driver API (through
``ctypes``): its registers a thread, static shared memory,
local memory a thread (spills and local arrays; ``cuobjdump -res-usage``'s
STACK beside it) and, at the threads a CTA its launches use
(:data:`THREADS`) and the dynamic shared memory they ask for
(:data:`DYNAMIC_SHARED`), the CTAs an SM can hold
(``cuOccupancyMaxActiveBlocksPerMultiprocessor``).  One JSON row a
kernel, with the card's name and power limit.  Exits 1 without a CUDA
device, 2 without ``cuobjdump``.

    python3 fm_radio_tpu_torch/probes/res_usage.py --libs frontend,chain
        --match k1_tile_kernel,k1_tile_any_kernel,chain_kernel,chain_any_kernel

reads the float K1's and the megakernel's kernels at the receiver's
orders and at any other.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import subprocess
import sys
import tempfile

# threads a CTA each kernel is launched with (csrc/k12_stages.cuh:
# kMidThreads, kDs2Threads, the any-order forms as their tiled kernels,
# kDs4Tile / kDs4Run; csrc/k3_probe.cu: kValueThreads), by name
THREADS = {"k12_mid_fused_kernel": 256, "k12_mid_ds2_kernel": 128,
           "k12_mid_hilb_kernel": 256, "k12_mid_ds2_any_kernel": 128,
           "k12_mid_hilb_any_kernel": 256, "k3_value_kernel": 128,
           "k1_tile_kernel": 256, "k1_tile_any_kernel": 256,
           "chain_kernel": 128, "chain_any_kernel": 128,
           "ds4_i8_blocked_kernel": 128}
# dynamic shared memory bytes a CTA (the float K1's at 64 taps and, its
# any-order kernel, at the lenses' 96: csrc/frontend.cu::k1_smem; the
# megakernel's: csrc/chain.cu::kChSmemFloats; the int8 ds x4 tile at the
# K1 probe's 132 taps, csrc/k12_stages.cuh::ds4_i8_smem(33): 9,224 at
# K12's 64), by name; 0 for the others
DYNAMIC_SHARED = {"k1_tile_kernel": 39200, "k1_tile_any_kernel": 39584,
                  "chain_kernel": 54784, "chain_any_kernel": 55120,
                  "ds4_i8_blocked_kernel": 9616}


def stacks(cuobjdump: str, so: str) -> dict:
    """``cuobjdump -res-usage``'s STACK bytes by mangled kernel name."""
    out = subprocess.run([cuobjdump, "-res-usage", so], capture_output=True,
                         text=True, timeout=120).stdout
    res, name = {}, None
    for ln in out.splitlines():
        if "Function" in ln:
            name = ln.split("Function", 1)[1].strip().rstrip(":").strip()
        elif name and "REG:" in ln:
            kv = dict(w.split(":", 1) for w in ln.split() if ":" in w)
            res[name] = int(kv.get("STACK", -1))
            name = None
    return res


def demangle(names: list, nvcc: str) -> dict:
    """Mangled name -> readable, by ``cu++filt`` beside nvcc (the name
    itself where there is none)."""
    exe = os.path.join(os.path.dirname(nvcc), "cu++filt")
    if not os.path.isfile(exe) or not names:
        return {n: n for n in names}
    out = subprocess.run([exe, *names], capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else {
        n: n for n in names}


class Driver:
    """The few CUDA driver calls this needs, on device 0's primary
    context."""

    def __init__(self):
        self.cu = ctypes.CDLL("libcuda.so.1")
        self._ok(self.cu.cuInit(0))
        dev, ctx = ctypes.c_int(), ctypes.c_void_p()
        self._ok(self.cu.cuDeviceGet(ctypes.byref(dev), 0))
        self._ok(self.cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev))
        self._ok(self.cu.cuCtxSetCurrent(ctx))

    @staticmethod
    def _ok(err: int) -> None:
        if err != 0:
            raise RuntimeError(f"CUDA driver error {err}")

    def load(self, cubin: str):
        mod = ctypes.c_void_p()
        self._ok(self.cu.cuModuleLoad(ctypes.byref(mod), cubin.encode()))
        return mod

    def function(self, mod, name: str):
        fn = ctypes.c_void_p()
        err = self.cu.cuModuleGetFunction(ctypes.byref(fn), mod,
                                          name.encode())
        return fn if err == 0 else None

    def attr(self, fn, which: int) -> int:
        v = ctypes.c_int()
        self._ok(self.cu.cuFuncGetAttribute(ctypes.byref(v), which, fn))
        return v.value

    def ctas(self, fn, threads: int, dynamic: int = 0) -> int:
        if dynamic:  # as the launch wrappers allow it (cudaFuncSetAttribute)
            self._ok(self.cu.cuFuncSetAttribute(fn, _MAX_DYNAMIC,
                                                ctypes.c_int(dynamic)))
        n = ctypes.c_int()
        self._ok(self.cu.cuOccupancyMaxActiveBlocksPerMultiprocessor(
            ctypes.byref(n), fn, threads, ctypes.c_size_t(dynamic)))
        return n.value


# CUfunction_attribute values (cuda.h)
_SHARED, _LOCAL, _REGS, _MAX_DYNAMIC = 1, 3, 4, 8


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--libs", default="midend,k3_probe")
    ap.add_argument("--match", default=",".join(THREADS))
    a = ap.parse_args(argv)
    root = os.path.abspath(a.root)
    sys.path.insert(0, os.path.dirname(os.path.dirname(here)))
    from fm_radio_tpu_torch.probes.sass_diff import build

    try:
        drv = Driver()
    except (OSError, RuntimeError) as e:
        print(f"res_usage: no CUDA device ({e})", file=sys.stderr)
        return 1
    bdir, nvcc = build(root)
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.isfile(cuobjdump):
        print(f"res_usage: no cuobjdump beside {nvcc}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    keys = [k for k in a.match.split(",") if k]
    for lib in a.libs.split(","):
        so = os.path.join(bdir, f"lib{lib}.so")
        stack = stacks(cuobjdump, so)
        names = [n for n in stack if any(k in n for k in keys)]
        readable = demangle(names, nvcc)
        with tempfile.TemporaryDirectory() as tmp:
            subprocess.run([cuobjdump, "-xelf", "all", so], cwd=tmp,
                           capture_output=True, check=True, timeout=120)
            mods = [drv.load(c) for c in sorted(glob.glob(
                os.path.join(tmp, "*.cubin")))]
            for name in names:
                fn = next((f for f in (drv.function(m, name) for m in mods)
                           if f is not None), None)
                kern = next(k for k in keys if k in name)
                threads = THREADS.get(kern)
                row = {"root": root, "lib": lib, "kernel": readable[name],
                       "stack_bytes": stack[name], "card": smi}
                if fn is not None:
                    row.update(regs=drv.attr(fn, _REGS),
                               shared_bytes=drv.attr(fn, _SHARED),
                               local_bytes=drv.attr(fn, _LOCAL))
                    if threads:
                        dyn = DYNAMIC_SHARED.get(kern, 0)
                        row.update(threads=threads, dynamic_shared_bytes=dyn,
                                   ctas_an_sm=drv.ctas(fn, threads, dyn))
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
