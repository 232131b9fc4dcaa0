"""A numpy model of the mid end's split route with de-emphasis on, bit
for bit against the port's plain versions (``kernels/midend.py::
midend_plain``, ``mid_ds2_plain``, ``mid_hilb_plain``).

The model walks ``csrc/k12_stages.cuh``'s split route as the card runs it
with the de-emphasis between its two kernels: ``k12_mid_ds2_kernel`` one
CTA per (channel, tile of ``MID_TILE`` outputs), fm_demod staged over the
tile's window from the block (int16 dequantised as ``dq_i16`` at
FM_SCALE, or K12's discriminator on staged theta1) and from the carried
ds x2 tail, each run of 8 outputs summed tap
by tap from the oldest sample, the new ds x2 tail written by each
channel's last tile; ``k12_deemph_kernel`` in place over fm_out;
``k12_mid_hilb_kernel`` one CTA per (channel, tile), the tile's window of
fm_out staged with the carried Hilbert tail before the block, im summed
tap by tap, re the delayed sample, stored as float32 and, with the int16
outputs, as ``q_i16`` at IQ_SCALE.  The peak IIR and theta pass after
them are modelled in tests/test_torch_midend_i16_split.py, which walks
the same route with de-emphasis off.

C = 3 at B = 512 (one partial tile) and 8,320 (a whole tile and a
partial one), two blocks with carried state, K2 in its four formats and
K12's form on theta1.  The kernels themselves are held against the plain
versions on the card (chip_smoke.py::compare_mid_edges,
tests/test_torch_gpu.py).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.kernels import midend as tmid
from fm_radio_tpu_torch.kernels.qformat import FM_SCALE, IQ_SCALE
from fm_radio_tpu_torch.models import demod as tdemod
from fm_radio_tpu_torch.ops.cmath import f32
from fm_radio_tpu_torch.ops.discriminator import discriminate_theta

F = np.float32
CFG = DemodConfig(frontend_int8=True, use_deemphasis_filter=True,
                  deemphasis_cutoff_us=50)
CO = tdemod.make_coeffs(CFG)
NN2, NH = tmid.TILED_TAPS
H2, HH, D = NN2 - 2, NH - 1, (NH - 1) // 2
RUN = tmid.MID_TILE // tmid.DS2_THREADS  # ds x2 outputs a thread
SCALE = 0.37


def q16(x: np.ndarray, scale: float) -> np.ndarray:
    """``common.cuh::q_i16``: round half to even, saturate to +-32767."""
    return np.clip(np.rint(x * F(scale)), -32767, 32767).astype(np.int16)


def dq16(v: np.ndarray, scale: float) -> np.ndarray:
    """``common.cuh::dq_i16``: through int32, times 1 / scale."""
    return v.astype(np.int32).astype(F) * F(1.0 / scale)


def disc(theta: np.ndarray, prev: np.ndarray, scale: float) -> np.ndarray:
    """``k12_stages.cuh::disc_value`` in float32."""
    d = theta - prev
    d = np.where(d >= F(math.pi), d - F(2.0 * math.pi), d)
    d = np.where(d <= -F(math.pi), d + F(2.0 * math.pi), d)
    return (d * F(scale)).astype(F)


def ds2_model(src: np.ndarray, w2_rev, tail2, prev_theta=None):
    """``k12_mid_ds2_kernel`` tile by tile: (fm_out [C, n8], the new ds x2
    tail [C, H2]); src float32 or int16 fm_demod, or theta1 given
    ``prev_theta`` (the discriminator on the staged window)."""
    c, n4 = src.shape
    n8 = n4 // 2
    fm_out = np.full((c, n8), np.nan, F)
    tails = np.full((c, H2), np.nan, F)
    for i0 in range(0, n8, tmid.MID_TILE):
        nt = min(tmid.MID_TILE, n8 - i0)
        j = 2 * i0 - H2 + np.arange(2 * nt + H2)  # the staged window
        s_u = np.zeros((c, j.size), F)
        inb, old = j >= 0, (j < 0) & (j >= -H2)
        if prev_theta is not None:
            th = src[:, j[inb]]
            prev = np.concatenate([
                prev_theta[:, None] if j[inb][0] == 0
                else src[:, j[inb][0] - 1 : j[inb][0]], th[:, :-1]], axis=1)
            s_u[:, inb] = disc(th, prev, SCALE)
        else:
            s_u[:, inb] = (dq16(src[:, j[inb]], FM_SCALE)
                           if src.dtype == np.int16 else src[:, j[inb]])
        s_u[:, old] = tail2[:, H2 + j[old]]
        if i0 + nt == n8:
            tails[:] = s_u[:, j >= n4 - H2]
        assert nt % RUN == 0  # whole runs: two 16-byte stores each
        a = np.arange(nt)
        acc = np.zeros((c, nt), F)
        for k in range(NN2):
            acc = acc + w2_rev[k] * s_u[:, 2 * a + k]
        assert np.isnan(fm_out[:, i0 : i0 + nt]).all()  # written once
        fm_out[:, i0 : i0 + nt] = acc
    return fm_out, tails


def deemph_model(fm_out: np.ndarray, st: np.ndarray, b, a) -> np.ndarray:
    """``k12_deemph_kernel`` in place: y = (x1 b1 + x b0) - y1 a1 from
    st [C, 2] (x1, y1); returns the state after the block."""
    b0, b1, a1 = F(b[0]), F(b[1]), F(a[1])
    x1, y1 = st[:, 0].copy(), st[:, 1].copy()
    for t in range(fm_out.shape[1]):
        x = fm_out[:, t].copy()
        y1 = (x1 * b1 + x * b0) - y1 * a1
        x1 = x
        fm_out[:, t] = y1
    return np.stack([x1, y1], axis=1)


def hilb_model(fm_out: np.ndarray, wh_rev, htail, out_i16: bool):
    """``k12_mid_hilb_kernel`` tile by tile: (re, im) [C, n8] float32 and,
    with ``out_i16``, also as q_i16 at IQ_SCALE."""
    c, n8 = fm_out.shape
    re = np.full((c, n8), np.nan, F)
    im = np.full((c, n8), np.nan, F)
    for i0 in range(0, n8, tmid.MID_TILE):
        nt = min(tmid.MID_TILE, n8 - i0)
        i = i0 - HH + np.arange(nt + HH)  # the staged window
        s_f = np.empty((c, i.size), F)
        s_f[:, i >= 0] = fm_out[:, i[i >= 0]]
        s_f[:, i < 0] = htail[:, HH + i[i < 0]]
        r = np.arange(nt)
        acc = np.zeros((c, nt), F)
        for k in range(NH):
            acc = acc + wh_rev[k] * s_f[:, r + k]
        im[:, i0 : i0 + nt] = acc
        re[:, i0 : i0 + nt] = s_f[:, r + HH - D]
    if out_i16:
        return re, im, q16(re, IQ_SCALE), q16(im, IQ_SCALE)
    return re, im


def route_model(state: dict, src: np.ndarray, out_i16: bool,
                prev_theta=None):
    """The split route with de-emphasis up to Hilbert: ((re, im[, re16,
    im16]), the new ds x2 tail, the new Hilbert tail, the de-emphasis
    state [C, 2])."""
    a = tmid.mid_args("model", CO, CFG, state, src.shape[0],
                      torch.device("cpu"))
    w2, t2, wh, ht, de = (a[k].numpy() for k in (
        "w2_rev", "tail2", "wh_rev", "htail", "de_in"))
    fm_out, tail = ds2_model(src, w2, t2, prev_theta)
    de_new = deemph_model(fm_out, de, CO.deemph_b, CO.deemph_a)
    return hilb_model(fm_out, wh, ht, out_i16), tail, fm_out[:, -HH:], de_new


def _state(c: int, rng) -> dict:
    """A carried state with every tail and IIR history non-zero."""
    st = tdemod.demod_init_state(CFG, c)
    st["ds_fm_out"] = torch.from_numpy(
        (0.3 * rng.standard_normal((c, H2))).astype(F))
    st["hilbert"] = torch.from_numpy(
        (0.3 * rng.standard_normal((c, HH))).astype(F))
    st["deemph"] = {"x_hist": torch.from_numpy(
        rng.standard_normal((c, 1)).astype(F)),
        "y_hist": torch.from_numpy(rng.standard_normal((c, 1)).astype(F))}
    return st


def _check_state(new: dict, tail, htail, de) -> None:
    np.testing.assert_array_equal(tail, new["ds_fm_out"].numpy())
    np.testing.assert_array_equal(htail, new["hilbert"].numpy())
    np.testing.assert_array_equal(de[:, :1], new["deemph"]["x_hist"].numpy())
    np.testing.assert_array_equal(de[:, 1:], new["deemph"]["y_hist"].numpy())


@pytest.mark.parametrize("b", [512, 8320], ids=["partial_tile",
                                                 "whole_and_partial"])
@pytest.mark.parametrize("in_i16,out_i16", [(False, False), (True, False),
                                            (False, True), (True, True)],
                         ids=["f32", "in_i16", "out_i16", "i16_both"])
def test_deemph_model_matches_plain(b, in_i16, out_i16):
    """Every format of K2 takes the split route with the de-emphasis; its
    tiles, halos and carried tails bit for bit against midend_plain over
    two blocks."""
    cfg = dataclasses.replace(CFG, interstage_i16=in_i16 or out_i16)
    assert tmid.midend_route(CO, b // 4) == "split"
    c = 3
    rng = np.random.default_rng(b + 2 * in_i16 + out_i16)
    st = _state(c, rng)
    for _ in range(2):
        x = (0.3 * rng.standard_normal((c, b // 4))).astype(F)
        fmd = q16(x, FM_SCALE) if in_i16 else x
        outs, tail, htail, de = route_model(st, fmd, out_i16)
        new, (pr, pi), _ = tmid.midend_plain(CO, CFG, st,
                                             torch.from_numpy(fmd), out_i16)
        got = outs[2:] if out_i16 else outs
        for m, p in zip(got, (pr, pi)):
            assert m.dtype == p.numpy().dtype
            np.testing.assert_array_equal(m, p.numpy())
        _check_state(new, tail, htail, de)
        st = new


@pytest.mark.parametrize("b", [512, 8320], ids=["partial_tile",
                                                 "whole_and_partial"])
def test_deemph_model_on_theta1_matches_plain(b):
    """K12's form: the ds x2 kernel runs the discriminator on the staged
    theta1 (the previous phase of the block's first sample carried); the
    route bit for bit against the discriminator then midend_plain, and
    mid_ds2_plain's theta form against the model, over two blocks."""
    c = 3
    rng = np.random.default_rng(b)
    st = _state(c, rng)
    prev = rng.uniform(-np.pi, np.pi, c).astype(F)
    for _ in range(2):
        th = rng.uniform(-np.pi, np.pi, (c, b // 4)).astype(F)
        outs, tail, htail, de = route_model(st, th, False, prev)
        _, fmd = discriminate_theta(torch.from_numpy(prev),
                                    torch.from_numpy(th), f32(SCALE))
        new, (pr, pi), _ = tmid.midend_plain(CO, CFG, st, fmd)
        for m, p in zip(outs, (pr, pi)):
            np.testing.assert_array_equal(m, p.numpy())
        _check_state(new, tail, htail, de)
        a = tmid.mid_args("model", CO, CFG, st, c, torch.device("cpu"))
        fm_out, t2 = tmid.mid_ds2_plain(a["w2_rev"], a["tail2"],
                                        torch.from_numpy(th),
                                        torch.from_numpy(prev), f32(SCALE))
        np.testing.assert_array_equal(t2.numpy(), tail)
        mf, _ = ds2_model(th, a["w2_rev"].numpy(), a["tail2"].numpy(), prev)
        np.testing.assert_array_equal(fm_out.numpy(), mf)
        st, prev = new, th[:, -1].copy()


@pytest.mark.parametrize("form", ["f32", "i16", "theta1"])
def test_mid_ds2_wrapper_runs_its_plain_version_on_cpu(form):
    """mid_ds2 on CPU tensors is its plain version, ds x2 as midend_plain
    runs it: fm_out [C, n4/2] and the new tail [C, 62]."""
    rng = np.random.default_rng(4)
    c, n4 = 2, 2080
    st = _state(c, rng)
    a = tmid.mid_args("t", CO, CFG, st, c, torch.device("cpu"))
    x = (0.3 * rng.standard_normal((c, n4))).astype(F)
    src = torch.from_numpy(q16(x, FM_SCALE) if form == "i16" else x)
    prev = torch.zeros(c) if form == "theta1" else None
    fm_out, tail = tmid.mid_ds2(a["w2_rev"], a["tail2"], src, prev,
                                f32(SCALE))
    want = tmid.mid_ds2_plain(a["w2_rev"], a["tail2"], src, prev, f32(SCALE))
    assert fm_out.shape == (c, n4 // 2) and tail.shape == (c, H2)
    assert torch.equal(fm_out, want[0]) and torch.equal(tail, want[1])
    mf, mt = ds2_model(src.numpy(), a["w2_rev"].numpy(), a["tail2"].numpy(),
                       None if prev is None else prev.numpy())
    np.testing.assert_array_equal(fm_out.numpy(), mf)
    np.testing.assert_array_equal(tail.numpy(), mt)


@pytest.mark.parametrize("out_i16", [False, True], ids=["f32", "out_i16"])
def test_mid_hilb_wrapper_runs_its_plain_version_on_cpu(out_i16):
    """mid_hilb on CPU tensors is its plain version: Hilbert as
    midend_plain runs it, the int16 outputs quantised from it."""
    rng = np.random.default_rng(5)
    c, n8 = 2, 1040
    st = _state(c, rng)
    a = tmid.mid_args("t", CO, CFG, st, c, torch.device("cpu"))
    fm_out = torch.from_numpy((0.3 * rng.standard_normal((c, n8))).astype(F))
    got = tmid.mid_hilb(a["wh_rev"], a["htail"], fm_out, out_i16)
    want = hilb_model(fm_out.numpy(), a["wh_rev"].numpy(),
                      a["htail"].numpy(), out_i16)
    assert len(got) == (4 if out_i16 else 2)
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(w).dtype
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("case", ["ds2_order", "hilb_order", "ds2_n4",
                                  "hilb_n8", "ds2_theta_int16", "ds2_tail",
                                  "hilb_tail"])
def test_tiled_kernels_refuse_before_any_launch(device, case):
    """The two kernels take only their filter orders, whole runs (n4 % 16,
    n8 % 8), their dtypes and carried tails of the orders: anything else
    raises ValueError on every device before any launch."""
    c = 2
    f = dict(device=device)
    w2, wh = torch.zeros(NN2, **f), torch.zeros(NH, **f)
    t2, ht = torch.zeros(c, H2, **f), torch.zeros(c, HH, **f)
    fmd, fm_out = torch.zeros(c, 2080, **f), torch.zeros(c, 1040, **f)
    calls = {
        "ds2_order": lambda: tmid.mid_ds2(torch.zeros(48, **f), t2, fmd),
        "hilb_order": lambda: tmid.mid_hilb(torch.zeros(33, **f), ht,
                                            fm_out),
        "ds2_n4": lambda: tmid.mid_ds2(w2, t2, torch.zeros(c, 2088, **f)),
        "hilb_n8": lambda: tmid.mid_hilb(wh, ht, torch.zeros(c, 1044, **f)),
        "ds2_theta_int16": lambda: tmid.mid_ds2(
            w2, t2, fmd.to(torch.int16), torch.zeros(c, **f), 1.0),
        "ds2_tail": lambda: tmid.mid_ds2(w2, torch.zeros(c, 64, **f), fmd),
        "hilb_tail": lambda: tmid.mid_hilb(wh, torch.zeros(c, 62, **f),
                                           fm_out),
    }
    with pytest.raises(ValueError):
        calls[case]()


def test_out_is_the_cards():
    """``out=`` names the card kernels' outputs; on CPU tensors it
    raises."""
    c = 2
    with pytest.raises(ValueError):
        tmid.mid_ds2(torch.zeros(NN2), torch.zeros(c, H2),
                     torch.zeros(c, 2080),
                     out=(torch.zeros(c, 1040), torch.zeros(c, H2)))
    with pytest.raises(ValueError):
        tmid.mid_hilb(torch.zeros(NH), torch.zeros(c, HH),
                      torch.zeros(c, 1040),
                      out=(torch.zeros(c, 1040), torch.zeros(c, 1040)))
