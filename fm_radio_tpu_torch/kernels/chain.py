"""The full-chain megakernel: K1 + K2 + pilot PLL + extract in one kernel —
CUDA kernel and plain version.

Counterpart of ``fm_radio_tpu/kernels/chain_pallas.py::demod_chain_pallas``
(``chain_fusion != "split"``):

    baseband [C, B]: packed u8 words [C, B] float32 or (re, im) float32
    planes [2, C, B] -> ds x4 (float taps) + discriminator -> ds x2
    -> de-emphasis -> Hilbert -> peak IIR + pilot power -> pilot PLL
    -> L+R / L-R / RDS extraction
    -> lpr [C, B/32], (lmr_re, lmr_im) [C, B/32], (rds_re, rds_im) [C, B/64]

It reads and writes every state key that K1, K2, the PLL and extract own;
``lmr_phase_err`` is read at block start and updated by the caller, as
after extract.  K1 always takes the float taps (chain_pallas.py:294-297
takes the float band), and no RDS power is summed: the megakernel's route
runs the unfused RDS AGC (demod.py:576-609).  The kernel is
``csrc/chain.cu``; it evaluates the split kernels' device code tile by
tile (the register-blocked ds x4 and extract FIRs,
``extract_stages.cuh::fir_block`` at the receiver's filter orders in
``chain_kernel``, ``fir_block_any`` at any other in ``chain_any_kernel``,
in the same tap order), so its outputs and state equal the split path's
with float taps.
"""

from __future__ import annotations

import torch

from fm_radio_tpu_torch.kernels import _build
from fm_radio_tpu_torch.kernels.extract import TAILS, ext_args, extract_plain
from fm_radio_tpu_torch.kernels.frontend import (
    _scale,
    check_state,
    frontend_plain,
    input_form,
    input_planes,
)
from fm_radio_tpu_torch.kernels.midend import (
    mid_args,
    mid_c_args,
    mid_iir_state,
    midend_plain,
)
from fm_radio_tpu_torch.kernels.pll import pll_plain
from fm_radio_tpu_torch.models.pilot_pll import (
    PilotPLLState,
    pll_consts_from_cfg,
)
from fm_radio_tpu_torch.ops.agc import _agc_gain
from fm_radio_tpu_torch.ops.cmath import div_scalar

# kernel launches since the counter was last set to 0; and those at other
# filter orders than the receiver's (RECEIVER_ORDERS: chain_any_kernel),
# each counted in ``launches`` too
launches = 0
launches_any = 0

FORMS = {"planes": 0, "words": 1}
# the channel multiple the wrapper takes (the JAX gate's, pick_tiles_chain;
# csrc/chain.cu runs half of it, kChCh = 4, a CUDA block)
CHANNELS = 8
TILE = 512    # baseband samples per time tile (kChT)
# the ds x4, L+R / L-R and RDS orders chain_kernel is built for
# (csrc/chain.cu: kChDs4Taps, kExtTaps); every other set takes
# chain_any_kernel
RECEIVER_ORDERS = (64, 128, 128)

_P, _I, _F = _build.P, _build.I, _build.F
_ARGTYPES = ([_P, _I, _I, _I] + [_P, _P, _I, _P, _F]
             + [_P, _I, _P, _I, _F, _F, _F, _P, _P, _P, _I, _P] + [_F] * 5
             + [_P, _P] + [_P, _P] + [_F] * 7 + [_P] * 9 + [_I, _P, _I]
             + [_P] * 15 + [_P])


def pick_tiles_chain(c: int, b: int, packed: bool = True):
    """The JAX megakernel's tiles (c_blk, t_blk), or None where its shape
    contract fails (chain_pallas.py:237-250): b a multiple of 8 tiles of
    1024, and channel tiles of c (up to 256 for words, 128 for planes) that
    divide c and are a multiple of 8.  ``demod_block`` takes the
    megakernel exactly where this holds, as the JAX package does."""
    t_blk = 1024
    if b % (t_blk * 8) != 0:
        return None
    cap = 256 if packed else 128
    c_blk = c if c <= cap else cap
    if c % c_blk != 0 or c_blk % 8 != 0:
        return None
    return c_blk, t_blk


def chain_plain(coeffs, cfg, state: dict, x: torch.Tensor):
    """The chain in plain PyTorch: K1 with float taps, K2, the sequential
    PLL and extract, each on the whole block in its kernel's op order
    (the megakernel evaluates the same operations in the same order, tile
    by tile), the RDS power dropped.  Returns (state', lpr, (lmr_re,
    lmr_im), (rds_re, rds_im))."""
    st, fmd = frontend_plain(coeffs, cfg, state, x, False)
    st, iq_p, theta = midend_plain(coeffs, cfg, st, fmd)
    st["pll"], dt = pll_plain(cfg, st["pll"], theta)
    st, lpr, lmr, rds, _ = extract_plain(coeffs, cfg, st, iq_p, dt)
    return st, lpr, lmr, rds


def check_tiles(x: torch.Tensor) -> None:
    """The kernel's shape limits (whole groups of CHANNELS channels, the
    JAX gate's, and whole tiles of TILE samples, csrc/chain.cu's); raises
    ValueError."""
    c, b = x.shape[-2], x.shape[-1]
    if c % CHANNELS or b % TILE:
        raise ValueError(f"chain: C = {c} must be a multiple of {CHANNELS} "
                         f"and B = {b} of {TILE}")


def _launch(coeffs, cfg, state: dict, x: torch.Tensor):
    dev = x.device
    check_tiles(x)
    c, b = x.shape[-2], x.shape[-1]
    nn1 = check_state("chain", coeffs, state, c)
    tail = state["ds_fm_in"]
    k1 = {"x": x, "tail1": torch.stack([tail.real, tail.imag]).contiguous(),
          "w1": coeffs.taps_fm_in.flip(0).contiguous(),
          "prev": state["disc_prev_theta"].contiguous(),
          "pll": torch.stack(list(state["pll"]))}
    if k1["pll"].shape != (5, c):
        raise ValueError(f"chain: PLL state rows {tuple(k1['pll'].shape)} "
                         f"!= (5, {c})")
    _build.require("chain", dev, torch.float32, **k1)
    m = mid_args("chain", coeffs, cfg, state, c, dev)
    e = ext_args("chain", coeffs, cfg, state, c, dev)
    f = dict(device=dev, dtype=torch.float32)
    lpr, lmr_re, lmr_im = (torch.empty((c, b // 32), **f) for _ in range(3))
    rds_re, rds_im = (torch.empty((c, b // 64), **f) for _ in range(2))
    prev_out, power = torch.empty((c,), **f), torch.empty((c,), **f)
    tail2_out, htail_out = (torch.empty_like(m[k]) for k in ("tail2", "htail"))
    pll_out = torch.empty_like(k1["pll"])
    o_ext = [torch.empty_like(e[k]) for k in TAILS]
    fn = _build.function("chain", "fmt_chain", _ARGTYPES)
    err = fn(x.data_ptr(), FORMS[input_form(x)], c, b,
             k1["tail1"].data_ptr(), k1["w1"].data_ptr(), nn1,
             k1["prev"].data_ptr(), _scale(cfg), *mid_c_args(coeffs, cfg, m),
             k1["pll"].data_ptr(), pll_out.data_ptr(),
             *pll_consts_from_cfg(cfg).values(), e["off"].data_ptr(),
             *(e[k].data_ptr() for k in TAILS), e["wa"].data_ptr(),
             e["wm"].data_ptr(), e["wa"].shape[0], e["wr"].data_ptr(),
             e["wr"].shape[0],
             *(t.data_ptr() for t in (lpr, lmr_re, lmr_im, rds_re, rds_im,
                                      prev_out, tail2_out, htail_out, power)),
             *(t.data_ptr() for t in o_ext), _build.stream_ptr(dev))
    _build.check("chain", err)
    new = dict(state)
    t_re, t_im = input_planes(x[..., b - (nn1 - 4) :])
    new["ds_fm_in"] = torch.complex(t_re, t_im)
    new["disc_prev_theta"] = prev_out
    new["ds_fm_out"] = tail2_out
    new["hilbert"] = htail_out
    new["deemph"], new["peak_pilot"] = mid_iir_state(state, cfg, m)
    new["agc_pilot"] = _agc_gain(state["agc_pilot"],
                                 div_scalar(power, b // 8), 1.0, 0.2)
    new["pll"] = PilotPLLState(*pll_out.unbind(0))
    new["ds_audio_lpr"] = torch.complex(o_ext[0], o_ext[1])
    new["ds_audio_lmr"] = torch.complex(o_ext[2], o_ext[3])
    new["ds_rds"] = torch.complex(o_ext[4], o_ext[5])
    return new, lpr, (lmr_re, lmr_im), (rds_re, rds_im)


def chain(coeffs, cfg, state: dict, x: torch.Tensor):
    """x: packed words [C, B] or float32 planes [2, C, B] -> as
    :func:`chain_plain`.  CPU tensors run the plain version; CUDA tensors
    launch the kernel (C % 8 == 0, B % 512 == 0: :func:`check_tiles`,
    checked first on any other device)."""
    if input_form(x) not in FORMS:
        raise ValueError(f"chain takes packed words [C, B] or float32 planes "
                         f"[2, C, B], got {x.dtype} {tuple(x.shape)}")
    if x.device.type != "cpu":  # the kernel's limits, before any launch
        check_tiles(x)
    if _build.on_cpu("chain", x.device):
        return chain_plain(coeffs, cfg, state, x)
    global launches, launches_any
    out = _launch(coeffs, cfg, state, x)
    launches += 1
    launches_any += int(chain_orders(coeffs) != RECEIVER_ORDERS)
    return out


def chain_orders(coeffs) -> tuple[int, int, int]:
    """The ds x4, L+R / L-R and RDS filter orders of ``coeffs``, which
    pick the kernel (:data:`RECEIVER_ORDERS` or any other)."""
    return (coeffs.taps_fm_in.shape[0], coeffs.taps_audio_lpr.shape[0],
            coeffs.taps_rds.shape[0])
