"""The float K1's tile kernels at other register caps, on the card.

    python -m fm_radio_tpu_torch.probes.k1_caps [-c C] [-b B] [--rounds N]

``csrc/frontend.cu`` builds ``k1_tile_kernel`` with a minimum of CTAs an
SM in its ``__launch_bounds__`` (``kK1Ctas``), which caps ptxas's
registers a thread, and ``k1_tile_any_kernel`` without one.  This probe
builds the source as it is ("built"), with the 64-tap kernel's minimum
taken out ("uncapped") and with a minimum of 4 CTAs put on the any-order
kernel ("any_capped"), by text, as ``probes/chain_phases.py`` edits
``chain.cu``; prints each build's registers and spilled bytes a kernel
(``cuobjdump -res-usage``), then times ``kernels/frontend.py::frontend``
(float taps) from each build in turns, on bench.py's signal as packed
words, complex64 and u8 - 127 float32 planes at 64 taps
(``k1_tile_kernel``) and 96 (``k1_tile_any_kernel``): CUDA events, the
mean of 20 calls after one, the builds' order reversed every other
round.  Prints the card's name and power limit, then one JSON line a
build.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.kernels import _build
from fm_radio_tpu_torch.kernels import frontend as kf
from fm_radio_tpu_torch.models.demod import demod_init_state, make_coeffs
from fm_radio_tpu_torch.probes.chain_phases import (build_variants, library,
                                                    time_ms)

_ANY = "__launch_bounds__(kK1Threads)\nk1_tile_any_kernel("
VARIANTS = {"built": (),
            "uncapped": (("__launch_bounds__(kK1Threads, kK1Ctas<Load>)",
                          "__launch_bounds__(kK1Threads)"),),
            "any_capped": ((_ANY, _ANY.replace("kK1Threads)",
                                               "kK1Threads, 4)")),)}
FORMS = ("words", "complex", "planes_int")
ORDERS = (64, 96)


def registers(lib) -> dict:
    """{kernel: [registers, stack bytes]} of the library's K1 tile kernels
    (``cuobjdump -res-usage``, mangled names)."""
    exe = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    out = subprocess.run([exe, "-res-usage", str(lib)], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    res, name = {}, None
    for ln in out.splitlines():
        if "Function" in ln:
            name = ln.split("Function", 1)[1].strip().rstrip(":").strip()
        elif name and "REG:" in ln:
            if "k1_tile" in name:
                kv = dict(w.split(":", 1) for w in ln.split() if ":" in w)
                res[name] = [int(kv["REG"]), int(kv["STACK"])]
            name = None
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-c", "--channels", type=int, default=2048)
    ap.add_argument("-b", "--block", type=int, default=131072)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_caps: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke  # bench.py's signal in every ingest form

    libs = build_variants("frontend", VARIANTS)
    dev = torch.device("cuda", 0)
    cases = {}
    for nn in ORDERS:
        cfg = DemodConfig(assume_integer_input=True,
                          order_poly_ds_lpf_fm_out=nn)
        co = make_coeffs(cfg, dev)
        st = demod_init_state(cfg, args.channels, dev)
        for form in FORMS:
            x = chip_smoke.split_input(form, args.channels, args.block, 0,
                                       dev)
            cases[f"{form}:{nn}"] = (co, cfg, st, x, False)
    ms = {name: {case: [] for case in cases} for name in libs}
    for rnd in range(args.rounds):
        order = list(libs.items())
        for name, path in order if rnd % 2 == 0 else order[::-1]:
            with library(path, "frontend"):
                for case, a in cases.items():
                    ms[name][case].append(
                        time_ms(lambda a=a: kf.frontend(*a), reps=20))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    for name, path in libs.items():
        print(json.dumps({"build": name, "channels": args.channels,
                          "block": args.block, "ms": ms[name],
                          "registers_stack": registers(path)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
