"""Where the full-chain megakernel's time goes, on the card.

    python -m fm_radio_tpu_torch.probes.chain_phases [-c C] [-b B]
        [--orders FM_OUT,HILBERT,AUDIO,RDS]

The megakernel (``csrc/chain.cu``) is one launch, so a profiler shows one
number.  This probe times it whole and with phases taken out: each
variant is ``chain.cu`` with some phases emptied (a serial stage's
``if (tid < kChCh)`` made false, a parallel stage's loop started past its
end and its register-blocked branch made false), built by nvcc with the
kernels' flags into ``fm_radio_tpu_torch/_build/probes/`` and launched
through
``kernels/chain.py`` on the chain cell's input (bench.py's FM-like phase
walk as packed u8 words, ``DemodConfig(assume_integer_input=True,
chain_fusion="auto")``; ``--orders`` sets its filter orders,
``order_poly_ds_lpf_fm_out`` (the ds x4 and ds x2), ``order_fir_hilbert``,
``order_poly_ds_lpf_audio`` and ``order_poly_ds_lpf_rds``: at other orders
than the receiver's the probe times ``chain_any_kernel``).  A variant's outputs are wrong by design; only
its time means anything: the full kernel's time less a variant's is what
the dropped phases cost at the occupancy the kernel has, their barriers
included.  Each variant is timed with CUDA events (mean of 5 calls after
one), in turn with the others, twice.  Prints the card's name and power
limit, then one JSON line of ms per variant and round.  Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys

import torch

from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.kernels import _build
from fm_radio_tpu_torch.kernels import chain as tchain
from fm_radio_tpu_torch.models.demod import demod_init_state, make_coeffs

_LOOP, _NO_LOOP = "for (int e = tid;", "for (int e = tid + (1 << 30);"
_SERIAL, _OFF = "if (tid < kChCh) {", "if (false) {"
# the register-blocked stages (fir_block at the receiver's orders in
# chain_kernel, fir_block_any at any other in chain_any_kernel: one call
# for both), skipped
_DS4 = "ch_ds4<kAny>("
_EXT = "ch_ext_firs<kAny>("

# variant -> the (phase label, statement, replacement) edits of chain.cu;
# phases are labelled as in the kernel's tile loop.  Each edit reaches
# both kernels, so a variant times the receiver's orders and any other.
VARIANTS = {
    "full": (),
    "no_serial": tuple((n, _SERIAL, _OFF) for n in (5, 7, 9)),
    "no_ds4": (("2a", _DS4, f"if (false) {_DS4}"), ("2b", _LOOP, _NO_LOOP)),
    "no_extract_firs": ((11, _EXT, f"if (false) {_EXT}"),),
}
VARIANTS["rest"] = (VARIANTS["no_serial"] + VARIANTS["no_ds4"]
                    + VARIANTS["no_extract_firs"])
# the DemodConfig fields --orders sets, in its order
ORDER_KEYS = ("order_poly_ds_lpf_fm_out", "order_fir_hilbert",
              "order_poly_ds_lpf_audio", "order_poly_ds_lpf_rds")


def variant_source(src: str, edits) -> str:
    """``src`` with each edit applied: a (phase, statement, replacement)
    edit inside its phase (from the phase's "// N. " comment to its
    closing barrier, as chain.cu labels them), a (statement, replacement)
    edit where the statement occurs, which must be once in ``src``."""
    for edit in edits:
        *phase, old, new = edit
        if phase:
            i = src.index(f"    // {phase[0]}. ")
            j = src.index("__syncthreads();", i)
            where = f"phase {phase[0]}"
        else:
            i, j, where = 0, len(src), "the source"
        n = src[i:j].count(old)
        if n == 0 or (n > 1 and not phase):
            raise ValueError(f"{where} has {n} of {old!r}")
        src = src[:i] + src[i:j].replace(old, new, 1) + src[j:]
    return src


def build_variants(source: str = "chain", variants=None) -> dict:
    """Build every variant of ``csrc/<source>.cu`` (:func:`variant_source`
    with each of ``variants``, VARIANTS by default; one nvcc each, all at
    once) into ``_build/probes/``; {name: library path}."""
    out = _build.BUILD_ROOT / "probes"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / f"{source}.cu").read_text()
    jobs = {}
    for name, edits in (VARIANTS if variants is None else variants).items():
        cu = out / f"{source}_{name}.cu"
        cu.write_text(variant_source(src, edits))
        lib = out / f"lib{source}_{name}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(lib), str(cu)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
    return {name: lib for name, (lib, _) in jobs.items()}


@contextlib.contextmanager
def library(path, name: str = "chain"):
    """Launch the kernels of ``kernels/<name>.py`` from the library at
    ``path``."""
    lib = ctypes.CDLL(str(path))
    lib.fmt_error_string.argtypes = [ctypes.c_int]
    lib.fmt_error_string.restype = ctypes.c_char_p
    key = (name, False)
    saved = _build._libs.get(key)
    _build._libs[key] = lib
    try:
        yield
    finally:
        if saved is None:
            _build._libs.pop(key, None)
        else:
            _build._libs[key] = saved


def bench_words(channels: int, block: int, device) -> torch.Tensor:
    """bench.py's FM-like signal (constant envelope, N(0, 0.5) phase steps)
    on the u8 grid, as packed words [C, B], made on the device (seed 0)."""
    g = torch.Generator(device=device).manual_seed(0)
    phase = torch.cumsum(torch.randn((channels, block), generator=g,
                                     device=device) * 0.5, dim=-1)
    re = torch.round(100.0 * torch.cos(phase) + 127.0)
    im = torch.round(100.0 * torch.sin(phase) + 127.0)
    return re * 256.0 + im


def time_ms(fn, reps: int = 5) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-c", "--channels", type=int, default=2048)
    ap.add_argument("-b", "--block", type=int, default=131072)
    ap.add_argument("--orders", default="64,65,128,128",
                    help="order_poly_ds_lpf_fm_out, order_fir_hilbert, "
                         "order_poly_ds_lpf_audio, order_poly_ds_lpf_rds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chain_phases: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    libs = build_variants()
    cfg = DemodConfig(assume_integer_input=True, chain_fusion="auto",
                      **dict(zip(ORDER_KEYS,
                                 map(int, args.orders.split(",")))))
    co = make_coeffs(cfg, dev)
    st = demod_init_state(cfg, args.channels, dev)
    x = bench_words(args.channels, args.block, dev)
    ms = {name: [] for name in libs}
    for _ in range(2):
        for name, path in libs.items():
            with library(path):
                ms[name].append(time_ms(lambda: tchain.chain(co, cfg, st, x)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps({"channels": args.channels, "block": args.block,
                      "orders": args.orders, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
