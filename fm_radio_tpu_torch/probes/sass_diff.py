"""Whether two checkouts' CUDA libraries hold the same machine code.

    python3 fm_radio_tpu_torch/probes/sass_diff.py --a DIR --b DIR
        [--libs k12,pll,...]

Builds each checkout's kernels with its own ``kernels/_build.py`` (in a
subprocess run from that checkout), dumps every library's SASS with
``cuobjdump -sass`` and compares the two function by function,
instruction by instruction (each instruction's text; its address and
encoding dropped).  One JSON row a library: its functions and
instructions in each checkout, whether all are the same, and the
functions that differ or that only one side has.  The default libraries
are the receiver's (every library but the probes').  Exits 1 where a
library differs, 2 without ``cuobjdump``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# the receiver's libraries: every csrc/*.cu but the probes'
PRODUCTION = ("k12", "pll", "extract", "bpsk", "channelizer",
              "channelizer_wgmma", "frontend", "midend", "chain")

_BUILD = ("import sys; sys.path.insert(0, '.'); "
          "from fm_radio_tpu_torch.kernels import _build; _build.build(); "
          "print(_build.build_dir()); print(_build.nvcc())")


def build(root: str) -> tuple[str, str]:
    """(the build directory, nvcc's path) of the checkout at ``root``,
    its kernels built."""
    out = subprocess.run([sys.executable, "-c", _BUILD], cwd=root,
                         capture_output=True, text=True, check=True,
                         timeout=1200).stdout.split()
    return out[-2], out[-1]


def functions(sass: str) -> dict:
    """{function name: [instruction text, ...]} of cuobjdump -sass text."""
    funcs, cur = {}, None
    for ln in sass.splitlines():
        s = ln.strip()
        if s.startswith("Function :"):
            cur = funcs.setdefault(s.split(":", 1)[1].strip(), [])
        elif cur is not None and s.startswith("/*") and "*/" in s:
            text = s.split("*/", 1)[1].split(";", 1)[0].strip()
            if text:
                cur.append(text)
    return funcs


def compare(lib: str, dir_a: str, dir_b: str, cuobjdump: str) -> dict:
    sides = []
    for d in (dir_a, dir_b):
        sass = subprocess.run([cuobjdump, "-sass",
                               os.path.join(d, f"lib{lib}.so")],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        sides.append(functions(sass))
    a, b = sides
    differ = sorted(f for f in set(a) & set(b) if a[f] != b[f])
    only = sorted(set(a) ^ set(b))
    return {"lib": lib, "functions": [len(a), len(b)],
            "instructions": [sum(map(len, a.values())),
                             sum(map(len, b.values()))],
            "same": not differ and not only, "differ": differ,
            "only_one_side": only}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True)
    ap.add_argument("--b", required=True)
    ap.add_argument("--libs", default=",".join(PRODUCTION))
    args = ap.parse_args(argv)
    (dir_a, nvcc), (dir_b, _) = build(args.a), build(args.b)
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.isfile(cuobjdump):
        print(f"sass_diff: no cuobjdump beside {nvcc}", file=sys.stderr)
        return 2
    rows = [compare(lib, dir_a, dir_b, cuobjdump)
            for lib in args.libs.split(",")]
    for r in rows:
        print(json.dumps(r), flush=True)
    return 0 if all(r["same"] for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
