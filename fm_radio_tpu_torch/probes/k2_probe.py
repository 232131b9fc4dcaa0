"""Engine decomposition of the K2 mid end on the card, and the peak IIR as a
block-parallel recurrence.

Counterpart of ``tools/k2_probe.py``: K2 (ds x2 + de-emphasis + Hilbert +
pilot peak IIR + theta; its times on the card in PERF.md section 6, rows 7
and 13e) split by variants on fm_demod [C, B4] (``csrc/k2_probe.cu``):

  stream             re, im, theta copied from the halves of each tile
  ds2                + the ds x2 FIR (create_fir_lpf(64, 0.25)) into all
                     three outputs
  hilb               + the "Hilbert" (create_fir_lpf(65, 0.3)): im
                     filtered, theta = im, re each tile's ds x2 output
                     rotated by the delay 32 (the TPU probe reads re after
                     carrying the tile's tail: its first 32 samples are the
                     tile's own last 32)
  full               the production K2 device code (ds x2, the serial
                     de-emphasis at 2*3200/128000 and peak IIR b = [0.001,
                     0, -0.001], a = [1, -1.9989, 0.9998], theta, power)
  restruct:li[:stk]  the de-emphasis and the peak IIR as block-Toeplitz
                     recurrences: every block's in-block sums in parallel,
                     l/li serial carry steps instead of l (ROADMAP
                     performance item 2); h, hm, pm from
                     :func:`iir_tile_mats`, the port's float32 copy of
                     ``midend_pallas.py::_iir_tile_mats``; li one of 64,
                     128, 256, 512 (the kernels' instantiations; the
                     shared-memory layout :func:`block_layout`, the walk
                     :func:`unit_rows`); stk: re and im chains on the same
                     threads

The TPU probe never writes its carried buffers and state, so every variant
but ``stream`` is K2 on zero state (the kernels' and the plain versions'
reading; the tests hold it against the TPU tool with its scratch at zero).
``full`` and ``restruct`` return (re, im, theta, power).

    python -m fm_radio_tpu_torch.probes.k2_probe [C=1024] [B4=65536]
        [--iters 96] [--device cpu]
"""

from __future__ import annotations

import ctypes
import math
from types import SimpleNamespace

import numpy as np
import torch

from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.kernels import _build
from fm_radio_tpu_torch.kernels.midend import midend_plain
from fm_radio_tpu_torch.models.demod import demod_init_state
from fm_radio_tpu_torch.ops.cmath import atan2_poly, f32
from fm_radio_tpu_torch.ops.design import (
    create_fir_lpf,
    create_iir_single_pole_lpf,
)
from fm_radio_tpu_torch.ops.fir import decimate_core, hilbert_fir_p
from fm_radio_tpu_torch.probes import _probe

HALO = 128             # the kernels' zero tails: [C, 128]
LI = (64, 128, 256, 512)
MODES = ("stream", "ds2", "hilb", "full", *(f"restruct:{li}{s}" for li in LI
                                           for s in ("", ":stk")))
PEAK_B = (0.001, 0.0, -0.001)
# restruct's kernels (csrc/k2_probe.cu): outputs a range, rows a unit (one
# a lane), row padding, chains a chunk at most; the kinds of block_layout
BLOCK_R, BLOCK_ROWS, BLOCK_PAD, BLOCK_CHAINS = 8, 32, 4, 64
SMEM_BYTES = _probe.SMEM_BYTES
BLOCK_KINDS = ("deemph", "peak", "peak:stk")
PEAK_A = (1.0, -1.9989, 0.9998)

# kernel launches since the counters were last set to 0
launches_engine = 0    # stream, ds2, hilb (fmt_k2_engine)
launches_full = 0      # full (fmt_k2_full)
launches_restruct = 0  # restruct (fmt_k2_restruct)

_P, _I = _build.P, _build.I


def reset_counts() -> None:
    global launches_engine, launches_full, launches_restruct
    launches_engine = launches_full = launches_restruct = 0


def counts() -> dict:
    return {"k2_engine": launches_engine, "k2_full": launches_full,
            "k2_restruct": launches_restruct}


# ---- the host tables --------------------------------------------------------

def coeffs(device="cpu") -> SimpleNamespace:
    """The probe's filters as ``kernels/midend.py`` takes them."""
    def t(taps):
        return torch.as_tensor(np.asarray(taps, np.float32), device=device)

    def host(v):
        return tuple(f32(x) for x in np.asarray(v, np.float32))

    de_b, de_a = create_iir_single_pole_lpf(2.0 * 3200.0 / 128000.0)
    return SimpleNamespace(taps_fm_out=t(create_fir_lpf(64, 0.25)),
                           taps_hilbert=t(create_fir_lpf(65, 0.3)),
                           deemph_b=host(de_b), deemph_a=host(de_a),
                           peak_b=host(PEAK_B), peak_a=host(PEAK_A))


def _companion(a: torch.Tensor) -> torch.Tensor:
    """Companion matrix of the denominator a (a[0] == 1), as
    ``fm_radio_tpu/ops/iir.py::_companion``."""
    r = a.shape[0] - 1
    top = -a[1:][None, :]
    if r == 1:
        return top.reshape(1, 1)
    eye = torch.eye(r - 1, r, dtype=a.dtype)
    return torch.cat([top, eye], dim=0)


def _matmul_fma(p: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """p [r, r] times each s [n, r, r] in float32 as XLA on the CPU
    evaluates the small products of ``_power_stack``: the first product
    rounded, each further one added to it in one rounding (a fused
    multiply-add; the products of two float32 values are exact in
    float64)."""
    out = torch.empty_like(s)
    for i in range(p.shape[0]):
        for k in range(s.shape[2]):
            acc = p[i, 0] * s[:, 0, k]
            for j in range(1, p.shape[1]):
                acc = (p[i, j].double() * s[:, j, k].double()
                       + acc.double()).float()
            out[:, i, k] = acc
    return out


def _power_stack(amat: torch.Tensor, n: int) -> torch.Tensor:
    """[n + 1, r, r] powers A^0 .. A^n by doubling, in float32, as
    ``fm_radio_tpu/ops/iir.py::_power_stack`` evaluates them on the CPU
    (:func:`_matmul_fma`)."""
    r = amat.shape[0]
    stack = torch.eye(r, dtype=amat.dtype)[None]
    p = amat
    while stack.shape[0] < n + 1:
        stack = torch.cat([stack, _matmul_fma(p, stack)], dim=0)
        p = _matmul_fma(p, p[None])[0]
    return stack[: n + 1]


def iir_tile_mats(b, a, l: int):
    """(T [l, l], hm [ob, l], pm [r, l]) float32 for an exact in-block IIR,
    in the order of ``midend_pallas.py::_iir_tile_mats``: y = x @ T (T[i, j]
    = h[j - i], h = b * g the impulse response), plus hm times the carried
    inputs (newest first) and pm times the carried outputs."""
    b = torch.as_tensor(np.asarray(b, np.float32))
    a = torch.as_tensor(np.asarray(a, np.float32))
    ob = b.shape[0] - 1
    stack = _power_stack(_companion(a), l)
    g = stack[:l, 0, 0]
    h = torch.zeros((l,), dtype=torch.float32)
    for j in range(ob + 1):
        h[j:] = h[j:] + b[j] * g[: l - j]
    ii = torch.arange(l)
    d = ii[None, :] - ii[:, None]
    t_mat = torch.where(d >= 0, h[d.clamp(0, l - 1)], torch.zeros(()))
    hm = torch.zeros((max(ob, 1), l), dtype=torch.float32)
    for q in range(ob):
        for j in range(q + 1, ob + 1):
            k0 = j - q - 1
            hm[q] = hm[q] + b[j] * torch.where(
                ii - k0 >= 0, g[(ii - k0).clamp(0, l - 1)], torch.zeros(()))
    pm = stack[1 : l + 1, 0, :].T.contiguous()
    return t_mat, hm, pm


def block_mats(li: int, device="cpu", co=None) -> dict:
    """h, hm, pm of the de-emphasis and the peak IIR at block width li."""
    co = co or coeffs()
    out = {}
    for key, (b, a) in (("de", (co.deemph_b, co.deemph_a)),
                        ("pk", (co.peak_b, co.peak_a))):
        t_mat, hm, pm = iir_tile_mats(b, a, li)
        out[key] = tuple(v.contiguous().to(device) for v in (t_mat[0], hm, pm))
    return out


def block_layout(li: int, kind: str, device=None) -> dict:
    """restruct:li's kernel layout for ``kind`` (BLOCK_KINDS): blocks a
    chunk (each plane), units a chunk (stk: re, then im), threads a CTA
    (li / 16 warps, a pair of ranges each) and bytes of shared memory (two
    units of BLOCK_ROWS rows of li + BLOCK_PAD floats, h, hm and pm, the
    chains' last sums, last inputs and carries).  The host copy of
    ``csrc/k2_probe.cu::k2_block_layout``; on a CUDA ``device`` the C side's
    (``fmt_k2_block_layout``).  Raises ValueError for an li the kernels are
    not compiled for."""
    if li not in LI or kind not in BLOCK_KINDS:
        raise ValueError(f"k2_probe: no restruct kernel for li={li} "
                         f"{kind!r} (li one of {LI})")
    k = BLOCK_KINDS.index(kind)
    if device is not None and torch.device(device).type == "cuda":
        out = (ctypes.c_int * 4)()
        fn = _build.function("k2_probe", "fmt_k2_block_layout",
                             [_I, _I, _P])
        _build.check("k2_probe", fn(li, k, out))
        return dict(zip(("nb", "units", "threads", "smem"), out))
    ord_ = 1 if k == 0 else 2
    return {"nb": BLOCK_ROWS // 2 if k == 1 else BLOCK_ROWS,
            "units": 2 if k == 2 else 1,
            "threads": 32 * (li // BLOCK_R // 2),
            "smem": 4 * (2 * BLOCK_ROWS * (li + BLOCK_PAD)
                         + (1 + 2 * ord_) * li + BLOCK_CHAINS * 8)}


def unit_rows(li: int, kind: str, nblk: int, u: int) -> list:
    """Unit u's rows (one a lane) in the kernels' walk of a channel of nblk
    blocks: (plane, block) each, or None past the last block (not loaded,
    not stored).  deemph: 32 blocks; peak: 16 blocks, lanes 0-15 re
    (plane 0), 16-31 im; peak:stk: 32 blocks of re (u even), then of im."""
    g = block_layout(li, kind)
    k, q = divmod(u, g["units"])
    rows = []
    for r in range(BLOCK_ROWS):
        p = q if kind == "peak:stk" else r // g["nb"]
        b = k * g["nb"] + r % g["nb"]
        rows.append((p, b) if b < nblk else None)
    return rows


def block_units(li: int, kind: str, nblk: int) -> int:
    """Units the kernels walk for a channel of nblk blocks (the last
    chunk ragged where nb does not divide nblk)."""
    g = block_layout(li, kind)
    return -(-nblk // g["nb"]) * g["units"]


# ---- plain versions ---------------------------------------------------------

def _zeros(c: int, n: int, device) -> torch.Tensor:
    return torch.zeros((c, n), dtype=torch.float32, device=device)


def stream_plain(x: torch.Tensor, t_blk: int):
    """(re, im, theta): the first and second half of each tile of x."""
    c, n = x.shape
    v = x.reshape(c, n // t_blk, t_blk)
    re = v[..., : t_blk // 2].reshape(c, -1)
    return re, v[..., t_blk // 2 :].reshape(c, -1), re


def ds2_plain(x: torch.Tensor, co=None):
    co = co or coeffs(x.device)
    nn = co.taps_fm_out.shape[0]
    _, y = decimate_core(co.taps_fm_out, _zeros(x.shape[0], nn - 2, x.device),
                         x, 2)
    return y, y, y


def hilb_plain(x: torch.Tensor, t_blk: int, co=None):
    """(re, im, im): im the Hilbert FIR of the ds x2 output; re each tile of
    t_blk/2 ds x2 outputs rotated by the delay (the TPU probe reads re
    after carrying the tile's tail into the buffer's head)."""
    co = co or coeffs(x.device)
    fm_out = ds2_plain(x, co)[0]
    nh = co.taps_hilbert.shape[0]
    _, (_, im) = hilbert_fir_p(co.taps_hilbert,
                               _zeros(x.shape[0], nh - 1, x.device), fm_out)
    c, n = fm_out.shape
    re = torch.roll(fm_out.reshape(c, -1, t_blk // 2), (nh - 1) // 2, -1)
    return re.reshape(c, n), im, im


def full_plain(x: torch.Tensor, co=None):
    """(re, im, theta) of the production K2's plain version on zero state
    (power: the kernel's is checked against :func:`power_of`)."""
    co = co or coeffs(x.device)
    st = demod_init_state(DemodConfig(), x.shape[0], x.device)
    _, (re, im), theta = midend_plain(
        co, SimpleNamespace(use_deemphasis_filter=True), st, x)
    return re, im, theta


def block_iir_plain(x: torch.Tensor, h, hm, pm) -> torch.Tensor:
    """The block-Toeplitz recurrence on x [C, n] from zero state, in the
    kernels' order: each output sums h[j - i] x[i] from i = 0 up, then
    adds x1 hm[0] (, x2 hm[1]), y1 pm[0] (, y2 pm[1]).  The in-block sums
    of all blocks at once; only the carries step block by block."""
    c, n = x.shape
    li = h.shape[0]
    r = pm.shape[0]
    xs = x.reshape(c, n // li, li)
    acc = torch.zeros_like(xs)
    for i in range(li):
        acc[..., i:] = acc[..., i:] + h[: li - i] * xs[..., i : i + 1]
    xc = [torch.zeros((c, 1), device=x.device) for _ in range(r)]
    yc = [torch.zeros((c, 1), device=x.device) for _ in range(r)]
    out = torch.empty_like(xs)
    for s in range(n // li):
        y = acc[:, s]
        for q in range(hm.shape[0]):
            y = y + xc[q] * hm[q]
        for q in range(r):
            y = y + yc[q] * pm[q]
        xc = [xs[:, s, li - 1 - q : li - q] for q in range(r)]
        yc = [y[:, li - 1 - q : li - q] for q in range(r)]
        out[:, s] = y
    return out.reshape(c, n)


def power_of(pr: torch.Tensor, pi: torch.Tensor, li: int) -> torch.Tensor:
    """The restructured kernel's power [C]: each thread's outputs
    (pr^2 + pi^2 in float32) summed in double over the blocks, then the
    threads in order."""
    c, n = pr.shape
    p = (pr * pr + pi * pi).double().reshape(c, n // li, li)
    acc = torch.zeros((c, li), dtype=torch.float64, device=pr.device)
    for s in range(n // li):
        acc = acc + p[:, s]
    tot = torch.zeros((c,), dtype=torch.float64, device=pr.device)
    for j in range(li):
        tot = tot + acc[:, j]
    return tot.float()


def restruct_plain(x: torch.Tensor, li: int, co=None, mats=None):
    """(re, im, theta, power) of restruct:li on zero state."""
    co = co or coeffs(x.device)
    mats = mats or block_mats(li, x.device)
    fm_out = block_iir_plain(ds2_plain(x, co)[0], *mats["de"])
    nh = co.taps_hilbert.shape[0]
    _, (re, im) = hilbert_fir_p(co.taps_hilbert,
                                _zeros(x.shape[0], nh - 1, x.device), fm_out)
    pr = block_iir_plain(re, *mats["pk"])
    pi = block_iir_plain(im, *mats["pk"])
    theta = atan2_poly(pi, pr) * f32(1.0 / (2.0 * math.pi))
    return re, im, theta, power_of(pr, pi, li)


def variant_plain(mode: str, x: torch.Tensor, t_blk: int = 1024, co=None):
    if mode == "stream":
        return stream_plain(x, t_blk)
    if mode == "ds2":
        return ds2_plain(x, co)
    if mode == "hilb":
        return hilb_plain(x, t_blk, co)
    if mode == "full":
        return full_plain(x, co)
    return restruct_plain(x, int(mode.split(":")[1]), co)


# ---- the kernels --------------------------------------------------------------

def _taps(co):
    return (co.taps_fm_out.flip(0).contiguous(),
            co.taps_hilbert.flip(0).contiguous())


def restruct_li(mode: str, n4: int) -> int:
    """restruct:li[:stk]'s li; raises ValueError (before any launch, on
    every device) for an li the kernels are not compiled for or one that
    does not divide B4/2."""
    li = int(mode.split(":")[1])
    if li not in LI or n4 % 2 or (n4 // 2) % li:
        raise ValueError(f"k2_probe: {mode} needs li one of {LI} dividing "
                         f"B4/2, got B4={n4}")
    return li


def variant(mode: str, x: torch.Tensor, t_blk: int = 1024, co=None,
            mats=None, out=None):
    """One variant on fm_demod x [C, B4] float32: (re, im, theta) [C, B4/2],
    with the power [C] for full and restruct.  CPU tensors run
    :func:`variant_plain`.  ``out``: restruct's (re, im, theta, power) to
    write into (the card only; made here otherwise)."""
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"k2_probe: x must be contiguous float32 [C, B4], "
                         f"got {x.dtype} {tuple(x.shape)}")
    li = restruct_li(mode, x.shape[1]) if mode.startswith("restruct") else 0
    co = co or coeffs(x.device)
    if _build.on_cpu("k2_probe", x.device):
        if out is not None:
            raise ValueError("k2_probe: out= is for the card's kernels")
        return variant_plain(mode, x, t_blk, co)
    global launches_engine, launches_full, launches_restruct
    c, n4 = x.shape
    dev = x.device
    w2, wh = _taps(co)
    zeros = _zeros(c, HALO, dev)
    if out is not None:
        if not mode.startswith("restruct"):
            raise ValueError(f"k2_probe: out= is restruct's, not {mode}'s")
        _build.require("k2_probe", dev, torch.float32, re=out[0], im=out[1],
                       theta=out[2], power=out[3])
        if (any(o.shape != (c, n4 // 2) for o in out[:3])
                or out[3].shape != (c,)):
            raise ValueError("k2_probe: out must be (re, im, theta) "
                             "[C, B4/2] and power [C]")
    outs = (list(out[:3]) if out is not None else
            [torch.empty((c, n4 // 2), device=dev) for _ in range(3)])
    fm_out = torch.empty((c, n4 // 2), device=dev)
    ptrs = [o.data_ptr() for o in outs]
    stream = _build.stream_ptr(dev)
    if mode in ("stream", "ds2", "hilb"):
        fn = _build.function("k2_probe", "fmt_k2_engine",
                             [_P, _I, _I, _I, _I, _P, _I, _P, _I] + [_P] * 6)
        _build.check("k2_probe", fn(
            x.data_ptr(), ("stream", "ds2", "hilb").index(mode), c, n4, t_blk,
            w2.data_ptr(), w2.shape[0], wh.data_ptr(), wh.shape[0],
            zeros.data_ptr(), fm_out.data_ptr(), *ptrs, stream))
        launches_engine += 1
        return tuple(outs)
    power = torch.empty((c,), device=dev)
    if mode == "full":
        de = (ctypes.c_float * 3)(co.deemph_b[0], co.deemph_b[1],
                                  co.deemph_a[1])
        pk = (ctypes.c_float * 5)(*co.peak_b, *co.peak_a[1:])
        de_out = torch.empty((c, 2), device=dev)
        pk_out = torch.empty((c, 8), device=dev)
        fn = _build.function("k2_probe", "fmt_k2_full",
                             [_P, _I, _I, _P, _I, _P, _I] + [_P] * 11)
        _build.check("k2_probe", fn(
            x.data_ptr(), c, n4, w2.data_ptr(), w2.shape[0], wh.data_ptr(),
            wh.shape[0], zeros.data_ptr(), de, pk, de_out.data_ptr(),
            pk_out.data_ptr(), fm_out.data_ptr(), *ptrs, power.data_ptr(),
            stream))
        launches_full += 1
        return (*outs, power)
    mats = mats or block_mats(li, dev, co)
    if out is not None:
        power = out[3]
    fn = _build.function("k2_probe", "fmt_k2_restruct",
                         [_P, _I, _I, _I, _I, _P, _I, _P, _I] + [_P] * 13)
    _build.check("k2_probe", fn(
        x.data_ptr(), c, n4, li, int(mode.endswith(":stk")), w2.data_ptr(),
        w2.shape[0], wh.data_ptr(), wh.shape[0], zeros.data_ptr(),
        *(m.data_ptr() for m in mats["de"]),
        *(m.data_ptr() for m in mats["pk"]), fm_out.data_ptr(), *ptrs,
        power.data_ptr(), stream))
    launches_restruct += 1
    return (*outs, power)


# ---- the sections ---------------------------------------------------------------

def theta_vs_serial(theta: torch.Tensor, serial: torch.Tensor) -> dict:
    """How far a restructured theta lies from the serial recurrence's
    (``full``) on the same input, in cycles wrapped to +-0.5: the median,
    and the share of outputs more than 0.01 apart.  The blocked tables are
    float32 powers of the companion matrix, which the probe's peak biquad
    (two poles 0.03 rad apart at radius 0.9999) makes ill-conditioned."""
    d = (theta - serial).abs()
    d = torch.minimum(d, 1.0 - d)
    return {"theta_vs_serial_median": float(d.median()),
            "theta_vs_serial_share_over_0.01": float((d > 0.01).float()
                                                     .mean())}


def make_input(c: int, b4: int, device, seed: int = 0) -> torch.Tensor:
    """The TPU tool's N(0, 1) fm_demod (numpy seed)."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((c, b4)).astype(np.float32)
                            ).to(device)


def run(c: int, b4: int, iters: int, device, check: bool = True,
        modes=MODES, emit=_probe.emit) -> list[dict]:
    """Every mode of the TPU tool at [C, B4] (t_blk 1024); each kernel
    against its plain version where ``check`` (full: re, im, theta)."""
    x = make_input(c, b4, device)
    co = coeffs(device)
    rows = []
    serial = (variant("full", x, 1024, co)[2]
              if any(m.startswith("restruct") for m in modes) else None)
    for mode in modes:
        mats = (block_mats(int(mode.split(":")[1]), device, co)
                if mode.startswith("restruct") else None)
        kern = lambda mode=mode, mats=mats: variant(mode, x, 1024, co, mats)
        ms, out = _probe.time_ms(kern, iters, device)
        err = None
        if check:
            err = _probe.max_err(out[:3] if mode == "full" else out,
                                 variant_plain(mode, x, 1024, co))
        extra = {"serial_steps": (b4 // 2 // int(mode.split(":")[1])
                                  if mode.startswith("restruct") else
                                  b4 // 2 if mode == "full" else 0)}
        if mode.startswith("restruct"):
            extra.update(theta_vs_serial(out[2], serial))
        kernel = ("k2_full" if mode == "full" else "k2_restruct"
                  if mode.startswith("restruct") else "k2_engine")
        r = _probe.row(mode, kernel, ms, x.numel() * 4, err, **extra)
        rows.append(r)
        emit(r)
    return rows


def main(argv=None) -> int:
    args = _probe.parse(argv, __doc__, [("channels", 1024), ("b4", 65536)],
                        ",".join(MODES), 96)
    dev = _probe.device_of(args.device)
    cpu = dev.type == "cpu"
    c = args.channels or (8 if cpu else 1024)
    b4 = args.b4 or (4096 if cpu else 65536)
    _probe.header("k2_probe", dev, channels=c, b4=b4,
                  in_gb=c * b4 * 4 / 1e9, iters=args.iters)
    modes = [m for m in MODES if m in args.sections.split(",")]
    rows = run(c, b4, args.iters, dev, modes=modes)
    return 0 if all(r["max_abs_err"] in (None, 0.0) for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
