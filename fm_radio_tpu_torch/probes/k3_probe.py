"""Engine decomposition of the extract kernel (K3) on the card, and the
design without its shared-memory tile.

Counterpart of ``tools/k3_probe.py``: ``extract_kernel`` (2.95 ms in the
cells, PERF.md; 4- and 8-way shared-memory bank conflicts the suspect)
split by variants on the same three planes re, im, dt [C, B8]:

  stream1   read re: the per-tile sums of one plane
  stream    read re, im and dt (the read alone; also
            ``tools/chain_probe.py::_stream3_pallas``, at t_blk = 1024)
  stream31  read one row-stacked [3C, B8] plane (c_blk-interleaved row
            groups: one taller read per tile instead of three)
  phasor    + the harmonic phasors and the four mixes, summed per tile
  full      the production extract kernel (``csrc/extract.cu``) on the
            probe's taps (create_fir_lpf(64, 0.1) for L+R and L-R,
            (128, 0.05) for RDS), harmonics 2 and 3, offset 0
  value     extract without the staged tile (``csrc/k3_probe.cu``): each
            thread register-blocks 16 audio outputs and mixes its own
            window samples as it slides (ROADMAP performance item 1)

Semantics pinned down (the tests hold them against the TPU tool): the
stream-style variants return the TPU's [C, 128] output, which holds only
the LAST time tile's sums (``stream31`` only the first c_blk rows of each
row group), and the per-tile sums beside it.  The TPU probe never writes
its carried tails, so ``full`` and ``value`` are extract on zero tails:
the same function, and on the card the same bits.  On the card ``value``
has no tile; ``--iters``, ``--sections`` (stream, phasor, full, value) and
``--device cpu`` as the other probes.

    python -m fm_radio_tpu_torch.probes.k3_probe [C=1024] [B8=32768]
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.kernels import _build
from fm_radio_tpu_torch.kernels import extract as _extract
from fm_radio_tpu_torch.ops.design import create_fir_lpf
from fm_radio_tpu_torch.probes import _probe

C_BLK = 128
MODES = {"stream1": 0, "stream": 1, "phasor": 2, "stream31": 3}
VALUE_RUN = 16  # audio outputs per thread (csrc/k3_probe.cu kValueRun)

# kernel launches since the counters were last set to 0 (full is the
# production extract kernel: ``kernels/extract.py`` counts its launches)
launches_sum = 0       # stream1, stream, phasor (fmt_k3_sum)
launches_stream31 = 0  # stream31 (fmt_k3_sum on the stacked plane)
launches_value = 0     # value (fmt_k3_value)

_P, _I = _build.P, _build.I


def reset_counts() -> None:
    global launches_sum, launches_stream31, launches_value
    launches_sum = launches_stream31 = launches_value = 0


def counts() -> dict:
    return {"k3_sum": launches_sum, "k3_stream31": launches_stream31,
            "k3_value": launches_value}


def coeffs(device="cpu") -> SimpleNamespace:
    """The probe's taps as ``kernels/extract.py`` takes them."""
    def t(n, k):
        return torch.as_tensor(np.asarray(create_fir_lpf(n, k), np.float32),
                               device=device)

    return SimpleNamespace(taps_audio_lpr=t(64, 0.1),
                           taps_audio_lmr=t(64, 0.1),
                           taps_rds=t(128, 0.05))


def zero_state(c: int, co: SimpleNamespace, device="cpu") -> dict:
    """Extract's carried state at zero: the tails the TPU probe never
    writes, and offset 0."""
    def z(n):
        return torch.zeros((c, n), dtype=torch.complex64, device=device)

    return {"ds_audio_lpr": z(co.taps_audio_lpr.shape[0] - 4),
            "ds_audio_lmr": z(co.taps_audio_lmr.shape[0] - 4),
            "ds_rds": z(co.taps_rds.shape[0] - 8),
            "lmr_phase_err": torch.zeros((c,), device=device)}


def stack31(xs, c_blk: int = C_BLK) -> torch.Tensor:
    """The TPU tool's row-stacked [3C, B8] plane: row groups of c_blk rows
    of re, im, dt in turn (tools/k3_probe.py:239-241)."""
    c, b8 = xs[0].shape
    return torch.cat([x.reshape(c // c_blk, c_blk, b8) for x in xs],
                     dim=1).reshape(3 * c, b8)


# ---- plain versions ---------------------------------------------------------

def _tiles(x: torch.Tensor, t_blk: int) -> torch.Tensor:
    return x.reshape(x.shape[0], -1, t_blk)


def sum_plain(mode: str, xs, t_blk: int, c_blk: int = C_BLK):
    """(last [C, 128], sums [rows, n_tt]) of a stream-style variant in the
    kernel's order; xs = (re, im, dt), or (x3,) for stream31."""
    if mode == "stream31":
        (x3,) = xs
        sums = _probe.butterfly(_probe.lane_sums(_tiles(x3, t_blk), 4))
        rows = sums.shape[0]
        keep = sums.reshape(rows // (3 * c_blk), 3 * c_blk, -1)[:, :c_blk]
        return _probe.last_tile(keep.reshape(rows // 3, -1)), sums
    xr, xi, dt = xs
    if mode == "stream1":
        acc = _probe.lane_sums(_tiles(xr, t_blk), 4)
    elif mode == "stream":
        a = [_probe.lane_sums(_tiles(p, t_blk), 4) for p in (xr, xi, dt)]
        acc = (a[0] + a[1]) + a[2]
    else:
        off = torch.zeros((xr.shape[0],), device=xr.device)
        (mr, mi), (rr, ri) = _extract.mix(xr, xi, dt, off)
        acc = _probe.lane_sums(_tiles(((mr + mi) + rr) + ri, t_blk), 4)
    sums = _probe.butterfly(acc)
    return _probe.last_tile(sums), sums


def extract_plain(xs, co=None):
    """full and value: extract on zero tails, (lpr, lmr_re, lmr_im, rds_re,
    rds_im)."""
    xr, xi, dt = xs
    co = co or coeffs(xr.device)
    _, lpr, lmr, rds, _ = _extract.extract_plain(
        co, DemodConfig(), zero_state(xr.shape[0], co, xr.device), (xr, xi),
        dt)
    return (lpr, *lmr, *rds)


# ---- the kernels --------------------------------------------------------------

def _check(name: str, *xs) -> None:
    for x in xs:
        if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
            raise ValueError(f"{name}: planes must be contiguous float32 "
                             f"[C, N], got {x.dtype} {tuple(x.shape)}")


def tile_sum(mode: str, xs, t_blk: int, c_blk: int = C_BLK):
    """A stream-style variant: (last [C, 128], sums).  CPU tensors run
    :func:`sum_plain`."""
    _check(mode, *xs)
    if _build.on_cpu(mode, xs[0].device):
        return sum_plain(mode, xs, t_blk, c_blk)
    global launches_sum, launches_stream31
    rows, n = xs[0].shape
    c = rows // 3 if mode == "stream31" else rows
    sums = torch.empty((rows, n // t_blk), device=xs[0].device)
    last = torch.empty((c, 128), device=xs[0].device)
    ptrs = [x.data_ptr() for x in xs] + [None] * (3 - len(xs))
    fn = _build.function("k3_probe", "fmt_k3_sum",
                         [_P, _P, _P] + [_I] * 5 + [_P, _P, _P])
    _build.check("k3_probe", fn(*ptrs, MODES[mode], c, n, c_blk, t_blk,
                                sums.data_ptr(), last.data_ptr(),
                                _build.stream_ptr(xs[0].device)))
    if mode == "stream31":
        launches_stream31 += 1
    else:
        launches_sum += 1
    return last, sums


def value(xs, co=None):
    """extract without the staged tile: (lpr, lmr_re, lmr_im, rds_re,
    rds_im).  CPU tensors run :func:`extract_plain`."""
    _check("value", *xs)
    xr, xi, dt = xs
    co = co or coeffs(xr.device)
    if _build.on_cpu("value", xr.device):
        return extract_plain(xs, co)
    global launches_value
    c, n = xr.shape
    f = dict(device=xr.device, dtype=torch.float32)
    outs = [torch.empty((c, n // 4), **f) for _ in range(3)] + [
        torch.empty((c, n // 8), **f) for _ in range(2)]
    w = [getattr(co, k).flip(0).contiguous()
         for k in ("taps_audio_lpr", "taps_audio_lmr", "taps_rds")]
    fn = _build.function("k3_probe", "fmt_k3_value",
                         [_P, _P, _P, _I, _I, _P, _P, _I, _P, _I]
                         + [_P] * 5 + [_P])
    _build.check("k3_probe", fn(
        xr.data_ptr(), xi.data_ptr(), dt.data_ptr(), c, n, w[0].data_ptr(),
        w[1].data_ptr(), w[0].shape[0], w[2].data_ptr(), w[2].shape[0],
        *(o.data_ptr() for o in outs), _build.stream_ptr(xr.device)))
    launches_value += 1
    return tuple(outs)


def full(xs, co=None):
    """The production extract kernel on the probe's taps and zero tails:
    (lpr, lmr_re, lmr_im, rds_re, rds_im).  CPU tensors run the plain
    version.  Its launches count in ``kernels/extract.py``'s own counter."""
    _check("full", *xs)
    xr, xi, dt = xs
    co = co or coeffs(xr.device)
    _, lpr, lmr, rds, _ = _extract.extract(
        co, DemodConfig(), zero_state(xr.shape[0], co, xr.device), (xr, xi),
        dt)
    return (lpr, *lmr, *rds)


# ---- the sections ---------------------------------------------------------------

def make_inputs(c: int, b8: int, device, seed: int = 0):
    """The TPU tool's three N(0, 1) planes (numpy seed)."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((c, b8))
                                  .astype(np.float32)).to(device)
                 for _ in range(3))


CASES = (("stream1", 1024), ("stream1", 2048), ("stream31", 1024),
         ("stream31", 2048), ("stream", 1024), ("stream", 2048),
         ("stream", 4096), ("phasor", 1024), ("full", 1024), ("value", 0))


def variant_fn(mode: str, xs, t_blk: int, x3=None, co=None,
               c_blk: int = C_BLK):
    """(kernel call, plain call, input bytes, kernel name) of one
    variant (``k3_full``: the production extract kernel)."""
    if mode == "stream31":
        return (lambda: tile_sum(mode, (x3,), t_blk, c_blk),
                lambda: sum_plain(mode, (x3,), t_blk, c_blk), x3.numel() * 4,
                "k3_stream31")
    if mode in MODES:
        planes = xs[:1] if mode == "stream1" else xs
        return (lambda: tile_sum(mode, xs, t_blk, c_blk),
                lambda: sum_plain(mode, xs, t_blk, c_blk),
                sum(p.numel() for p in planes) * 4, "k3_sum")
    kern = full if mode == "full" else value
    return (lambda: kern(xs, co), lambda: extract_plain(xs, co),
            3 * xs[0].numel() * 4, f"k3_{mode}")


def run(c: int, b8: int, iters: int, device, check: bool = True,
        sections=None, emit=_probe.emit) -> list[dict]:
    """Every case of the TPU tool at [C, B8]; each kernel against its plain
    version where ``check``."""
    xs = make_inputs(c, b8, device)
    c_blk = min(c, C_BLK)
    x3 = stack31(xs, c_blk)
    co = coeffs(device)
    rows = []
    for mode, t_blk in CASES:
        kind = "stream" if mode.startswith("stream") else mode
        if sections and kind not in sections:
            continue
        if t_blk and b8 % t_blk:
            continue
        kern, plain, nbytes, kernel = variant_fn(mode, xs, t_blk, x3, co,
                                                 c_blk)
        ms, out = _probe.time_ms(kern, iters, device)
        err = _probe.max_err(out, plain()) if check else None
        tag = (f"{mode}:t={t_blk}" if t_blk else
               f"{mode}:run={VALUE_RUN} (no tile)")
        r = _probe.row(tag, kernel, ms, nbytes, err)
        rows.append(r)
        emit(r)
    return rows


def main(argv=None) -> int:
    args = _probe.parse(argv, __doc__, [("channels", 1024), ("b8", 32768)],
                        "stream,phasor,full,value", 96)
    dev = _probe.device_of(args.device)
    cpu = dev.type == "cpu"
    c = args.channels or (8 if cpu else 1024)
    b8 = args.b8 or (4096 if cpu else 32768)
    _probe.header("k3_probe", dev, channels=c, b8=b8,
                  in_gb=3 * c * b8 * 4 / 1e9, iters=args.iters)
    rows = run(c, b8, args.iters, dev,
               sections=set(args.sections.split(",")))
    return 0 if all(r["max_abs_err"] in (None, 0.0) for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
