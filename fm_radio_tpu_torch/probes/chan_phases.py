"""Where the exact channelizer's time goes, on the card.

    python -m fm_radio_tpu_torch.probes.chan_phases [-w W] [-m M] [-t T]

The exact channelizer (``csrc/channelizer.cu``) is one launch (and the
small carried-state one).  As ``probes/chain_phases.py`` does for the
megakernel, this probe times it whole and with phases taken out: each
variant is ``channelizer.cu`` with some statements replaced (the staging's
global loads by zeros, the phase filter's or the DFT's loop started past
its end), built by nvcc with the kernels' flags into
``fm_radio_tpu_torch/_build/probes/`` and launched through
``kernels/channelizer.py`` on W captures of T random packed words (the
wideband cell's shape by default: W = 64, T = 4,194,304, M = 32, K = 16),
in the i8ps and f32 forms.  A variant's outputs are wrong by design; only
its time means anything: the full kernel's time less a variant's is what
the dropped phase costs at the occupancy the kernel has.  Each variant is
timed with CUDA events (mean of 5 calls after one), in turn with the
others, twice.  Prints the card's name and power limit, then one JSON line
of ms per variant, form and round.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from fm_radio_tpu_torch.kernels import channelizer as kch
from fm_radio_tpu_torch.parallel.channelizer import make_channelizer_taps
from fm_radio_tpu_torch.probes.chain_phases import (
    build_variants,
    library,
    time_ms,
)

# variant -> the (statement, replacement) edits of channelizer.cu, each
# statement found once (``chain_phases.variant_source``)
VARIANTS = {
    "full": (),
    "no_stage_loads": (
        ("a[u] = FMT_AT(x0, t, n_x);", "a[u] = 0.0f;"),
        ("b[u] = kPacked ? 0.0f : FMT_AT(x1, t, n_x);", "b[u] = 0.0f;")),
    "no_filter": (("for (int rb = 0; rb < k_taps; rb += kZRun) {",
                   "for (int rb = k_taps; rb < k_taps; rb += kZRun) {"),),
    "no_dft": (("for (int p = 0; p < M; ++p) {",
                "for (int p = M; p < M; ++p) {"),),
}
VARIANTS["rest"] = (VARIANTS["no_stage_loads"] + VARIANTS["no_filter"]
                    + VARIANTS["no_dft"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-w", "--captures", type=int, default=64)
    ap.add_argument("-m", "--channels", type=int, default=32)
    ap.add_argument("-t", "--samples", type=int, default=131072 * 32)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chan_phases: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    libs = build_variants("channelizer", VARIANTS)
    m, k, w, t = args.channels, 16, args.captures, args.samples
    tab = kch.make_tables(make_channelizer_taps(m, k), m, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    words = (torch.randint(0, 256, (w, t), generator=g, device=dev) * 256.0
             + torch.randint(0, 256, (w, t), generator=g, device=dev))
    st = (torch.zeros((w, (k - 1) * m), device=dev),) * 2
    outs = ("i8ps", "f32") if m == 32 else ("i8", "f32")
    ms = {name: {o: [] for o in outs} for name in libs}
    for _ in range(2):
        for name, path in libs.items():
            with library(path, "channelizer"):
                for o in outs:
                    ms[name][o].append(time_ms(
                        lambda: kch.channelize(tab, st, words, m, o)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps({"captures": w, "samples": t, "m": m, "k": k,
                      "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
