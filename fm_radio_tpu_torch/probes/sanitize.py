"""Every CUDA kernel of the port once, at a small shape, for a memory
checker.

    python -m fm_radio_tpu_torch.probes.sanitize [--build-only] [--paths ...]
    compute-sanitizer --tool memcheck|racecheck|initcheck|synccheck \\
        --error-exitcode 9 python -m fm_radio_tpu_torch.probes.sanitize

Runs the kernels through the entry points a user calls (``demod_block``,
``wideband_demod_block``), two blocks with carried state each, without
their plain versions: a checker slows every launch, and the plain
versions' serial loops launch tens of thousands of small PyTorch ops.
Paths (``--paths``, all by default):

- ``k12``: int8 planes, C = 8, B = 16,384 (K12 flat, the PLL, extract,
  BPSK), with de-emphasis off and on;
- ``wideband``: W = 2 loud captures at M = 32 (channelizer -> phase-split
  K12) with ``splits`` 3, 2 and 1, and at M = 16 (flat int8 bridge);
- ``split``: K1 on complex64 and on packed words, K2; the int8-direct K1
  (``k12_fusion="off"``);
- ``chain``: the megakernel on packed words (C = 8);
- ``pll_chunked``: the chunked PLL (``pll_time_chunks=4``, B = 262,144);
- ``i16``: the int16 inter-stage format (``interstage_i16``) on int8
  planes at C = 8 (every kernel in int16) and C = 5 (the PLL in float32,
  extract on int16 planes with float32 dt), and on packed words;
- ``hbm``: the device-memory probes on a 16 MiB array.

``--build-only`` builds the libraries and exits (so that nvcc does not run
under the checker).  Prints one line per path and "sanitize: done"; a
fault the checker finds is its own report, and ``--error-exitcode`` makes
it the exit code.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys

import torch

PATHS = ("k12", "wideband", "split", "chain", "pll_chunked", "i16", "hbm")


def _planes(c: int, b: int, seed: int, device) -> torch.Tensor:
    """[2, C, B] int8 planes of an FM-like random phase walk (u8 - 128)."""
    g = torch.Generator(device=device).manual_seed(seed)
    ph = torch.cumsum(torch.randn((c, b), generator=g, device=device) * 0.5,
                      dim=-1)
    u8 = torch.stack([torch.round(100.0 * torch.cos(ph) + 127.0),
                      torch.round(100.0 * torch.sin(ph) + 127.0)])
    return (u8 - 128.0).to(torch.int8)


def _words(c: int, b: int, seed: int, device) -> torch.Tensor:
    """[C, B] packed u8 words of the same signal."""
    u8 = _planes(c, b, seed, device).to(torch.float32) + 128.0
    return u8[0] * 256.0 + u8[1]


def _wide_words(n_w: int, m: int, b: int, seed: int, device) -> torch.Tensor:
    """[W, M*B] packed words of M FM-like channels at 2.8*M each, loud
    enough to cross the int8 bridge (chip_smoke.py's loud captures)."""
    g = torch.Generator(device=device).manual_seed(seed)
    k = torch.arange(m, device=device, dtype=torch.float64)
    fm = torch.exp(2j * math.pi * torch.outer(k, k) / m).to(torch.complex64)
    out = torch.empty((n_w, m * b), device=device)
    for w in range(n_w):
        ph = torch.cumsum(torch.randn((m, b), generator=g, device=device)
                          * 0.5, dim=-1)
        wide = (torch.polar(torch.full_like(ph, 2.8 * m), ph).t()
                @ fm).reshape(-1)
        re = torch.round(wide.real.clamp(-127.0, 127.0) + 127.0)
        im = torch.round(wide.imag.clamp(-127.0, 127.0) + 127.0)
        out[w] = re * 256.0 + im
    return out


def _blocks(cfg, x, c: int, blocks: int, device) -> None:
    from fm_radio_tpu_torch.models.demod import (
        demod_block, demod_init_state, make_coeffs)

    co = make_coeffs(cfg, device)
    st = demod_init_state(cfg, c, device)
    b = x.shape[-1] // blocks
    for i in range(blocks):
        st, _ = demod_block(cfg, co, st,
                            x[..., i * b : (i + 1) * b].contiguous())


def run(path: str, device, c: int = 8, b: int = 16384,
        blocks: int = 2) -> None:
    from fm_radio_tpu_torch.config import DemodConfig
    from fm_radio_tpu_torch.models.demod import INT8_CONFIG, make_coeffs
    from fm_radio_tpu_torch.models.wideband import (
        wideband_demod_block, wideband_init_state)

    if path == "k12":
        x = _planes(c, b * blocks, 1, device)
        for de in (False, True):
            cfg = dataclasses.replace(INT8_CONFIG, use_deemphasis_filter=de,
                                      deemphasis_cutoff_us=50)
            _blocks(cfg, x, c, blocks, device)
    elif path == "wideband":
        co = make_coeffs(INT8_CONFIG, device)
        for m, splits in ((32, 3), (16, 3), (32, 2), (32, 1), (16, 1)):
            x = _wide_words(2, m, b * blocks, m, device)
            st = wideband_init_state(INT8_CONFIG, m, 2, device=device)
            for i in range(blocks):
                xb = x[:, i * m * b : (i + 1) * m * b].contiguous()
                st, _ = wideband_demod_block(INT8_CONFIG, co, None, st, xb, m,
                                             splits=splits)
    elif path == "split":
        x = _planes(c, b * blocks, 2, device)
        xc = torch.complex(x[0].float() + 1.0, x[1].float() + 1.0)
        _blocks(DemodConfig(), xc, c, blocks, device)
        _blocks(DemodConfig(assume_integer_input=True),
                _words(c, b * blocks, 3, device), c, blocks, device)
        _blocks(DemodConfig(frontend_int8=True, k12_fusion="off"), x, c,
                blocks, device)
    elif path == "chain":
        _blocks(DemodConfig(assume_integer_input=True, chain_fusion="auto"),
                _words(c, b * blocks, 4, device), c, blocks, device)
    elif path == "pll_chunked":
        bb = 262144
        _blocks(DemodConfig(frontend_int8=True, pll_time_chunks=4),
                _planes(c, bb * blocks, 5, device), c, blocks, device)
    elif path == "i16":
        i16 = DemodConfig(frontend_int8=True, interstage_i16=True)
        for cc in (c, 5):
            _blocks(i16, _planes(cc, b * blocks, 6, device), cc, blocks,
                    device)
        _blocks(DemodConfig(assume_integer_input=True, interstage_i16=True),
                _words(c, b * blocks, 7, device), c, blocks, device)
    elif path == "hbm":
        from fm_radio_tpu_torch.probes import hbm_sweep

        hbm_sweep.sweep(mib=16, iters=1, copy_blocks=((8, 1024),),
                        dma_chunks_kib=(32,), read_rows=(512,),
                        device=device)
    else:
        raise KeyError(path)
    torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--paths", nargs="*", default=list(PATHS),
                    choices=PATHS)
    ap.add_argument("--build-only", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sanitize: no CUDA device", file=sys.stderr)
        return 1
    from fm_radio_tpu_torch.kernels import _build

    _build.build()
    if args.build_only:
        print(f"sanitize: built {_build.build_dir().name}")
        return 0
    dev = torch.device("cuda", 0)
    for p in args.paths:
        run(p, dev)
        print(f"sanitize: {p} ok", flush=True)
    print("sanitize: done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
