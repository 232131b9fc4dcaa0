"""The redesigned extract and sequential PLL kernels, on the host.

The kernels run only on the card (``chip_smoke.py`` and
``tests/test_torch_gpu.py`` hold them against their plain versions, max
abs error 0).  Here: the route ``fmt_extract`` takes (``kernels/
extract.py::extract_route`` is its host copy), the step counts the PLL
wrapper refuses, the sum order both kernels must reproduce
(``ops/fir.py``'s against a numpy float32 loop), and a numpy model of
the blocked FIR's
schedule (``csrc/extract_stages.cuh::fir_block``: its windows, slots and
skewed addresses) against that sum.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.kernels import extract as text
from fm_radio_tpu_torch.kernels import pll as tpll
from fm_radio_tpu_torch.kernels.qformat import PH_SCALE, q_i16
from fm_radio_tpu_torch.models import demod as tdemod
from fm_radio_tpu_torch.models.pilot_pll import pilot_pll_init_state
from fm_radio_tpu_torch.ops.fir import polyphase_decimate_p

CFG = DemodConfig(frontend_int8=True)
CO = tdemod.make_coeffs(CFG)


def _co_orders(nn_a, nn_r):
    """CO with L+R / L-R filters of nn_a taps and an RDS filter of nn_r."""
    return CO._replace(taps_audio_lpr=torch.ones(nn_a) / nn_a,
                       taps_audio_lmr=torch.ones(nn_a) / nn_a,
                       taps_rds=torch.ones(nn_r) / nn_r)


@pytest.mark.parametrize("cfg", [
    CFG, DemodConfig(),
    DemodConfig(assume_integer_input=True, chain_fusion="auto"),
    dataclasses.replace(CFG, use_deemphasis_filter=True,
                        deemphasis_cutoff_us=50),
    DemodConfig(interstage_i16=True)],
    ids=["int8", "default", "chain", "deemphasis", "i16"])
def test_receiver_filters_take_the_blocked_route(cfg):
    """Every configuration's own filters have the order the blocked kernel
    is built for, so the main path takes it."""
    co = tdemod.make_coeffs(cfg)
    assert (co.taps_audio_lpr.shape[0], co.taps_audio_lmr.shape[0],
            co.taps_rds.shape[0]) == (text.BLOCKED_TAPS,) * 3
    assert text.extract_route(co) == "blocked"


# (L+R / L-R taps, RDS taps): orders the 128-sample halos still take
# (nn_a - 4 <= 128, nn_r - 8 <= 128) other than the blocked kernel's
OTHER_ORDERS = [(64, 128), (128, 96), (64, 64), (124, 128), (128, 120),
                (132, 136), (8, 16)]


@pytest.mark.parametrize("orders", OTHER_ORDERS,
                         ids=[f"{a}_{r}" for a, r in OTHER_ORDERS])
def test_other_orders_take_the_tiled_route(orders):
    co = _co_orders(*orders)
    assert text.extract_route(co) == "tiled"


@pytest.mark.parametrize("n", [8, 24, 100, 16383])
def test_pll_seq_refuses_partial_batches(n):
    """A step count that is not a multiple of the 16 steps the kernel
    loads and stores at once raises before any launch, on either
    device."""
    th = torch.zeros((40, n))
    with pytest.raises(ValueError, match="multiple of 16"):
        tpll.pilot_pll_seq(CFG, pilot_pll_init_state(40), th)


@pytest.mark.parametrize("c", [40, 5])
def test_pll_seq_on_cpu_is_the_plain_loop(c):
    """pilot_pll_seq on CPU tensors is pll_plain on either form, whatever
    the channel tile (the kernel takes int16 at C = 5 too)."""
    rng = np.random.default_rng(c)
    th = torch.from_numpy(rng.uniform(-0.5, 0.5, (c, 48)).astype(np.float32))
    for x in (th, q_i16(th, PH_SCALE)):
        st = pilot_pll_init_state(c)
        s1, d1 = tpll.pilot_pll_seq(CFG, st, x)
        s2, d2 = tpll.pll_plain(CFG, st, x)
        assert d1.dtype == x.dtype and torch.equal(d1, d2)
        assert all(torch.equal(u, v) for u, v in zip(s1, s2))


def _sum_ascending(w_rev, v, m, n):
    """y[i] = sum_k w_rev[k] * v[m i + k] for i < n, from 0.0 in ascending
    k, every product and sum rounded to float32 (numpy fuses nothing)."""
    acc = np.zeros(v.shape[:-1] + (n,), np.float32)
    for k, w in enumerate(np.asarray(w_rev, np.float32)):
        acc = acc + w * v[..., k : k + m * n : m]
    return acc


@pytest.mark.parametrize("m", [4, 8])
def test_fir_sum_order_is_fir_dots(m):
    """ops/fir.py::polyphase_decimate_p, the plain version both kernels
    equal bit for bit, sums each output as fir_dot does: from 0.0, tap by
    tap in ascending order of the reversed taps, over [tail | x]."""
    rng = np.random.default_rng(m)
    taps = rng.normal(0, 0.1, 128).astype(np.float32)
    c, t, halo = 3, 256, 128 - m
    tail = (rng.normal(0, 1, (c, halo))
            + 1j * rng.normal(0, 1, (c, halo))).astype(np.complex64)
    xr, xi = (rng.normal(0, 1, (c, t)).astype(np.float32) for _ in range(2))
    st, (yr, yi) = polyphase_decimate_p(
        torch.from_numpy(taps), torch.from_numpy(tail),
        (torch.from_numpy(xr), torch.from_numpy(xi)), m)
    w_rev = taps[::-1]
    for y, h, x in ((yr, tail.real, xr), (yi, tail.imag, xi)):
        want = _sum_ascending(w_rev, np.concatenate([h, x], -1), m, t // m)
        assert np.array_equal(y.numpy(), want)
    assert np.array_equal(st.numpy()[:, -1], (xr + 1j * xi)[:, -1])


def _mid_skew(x):
    return x + (x >> 5)


def _fir_block_model(plane, lane, w, m, r_outs, nn, b0, seen):
    """csrc/extract_stages.cuh::fir_block for one lane, step for step: the
    window slots, the loads at a constant offset from the lane's pointer
    for each block of R steps, the taps four at a time; every address it
    loads (skewed) added to ``seen``."""
    nq = nn // m
    xl = 33 * lane

    def load(at):
        seen.add(at)
        return plane[at]

    v = [[load(xl + _mid_skew(b0 + m * r + p)) for r in range(r_outs)]
         for p in range(m)]
    acc = [np.float32(0.0)] * r_outs

    def steps(qb, last):
        xq, wq = xl + 33 * (qb // r_outs), m * qb
        for qq in range(r_outs):
            wk = w[wq + m * qq : wq + m * qq + m]
            for p in range(m):
                for r in range(r_outs):
                    acc[r] = np.float32(acc[r] + np.float32(
                        wk[p] * v[p][(r + qq) % r_outs]))
                if not last or qq + 1 < r_outs:
                    v[p][qq] = load(xq + _mid_skew(b0 + m * (r_outs + qq) + p))

    for qb in range(0, nq - r_outs, r_outs):
        steps(qb, False)
    steps(nq - r_outs, True)
    return acc


@pytest.mark.parametrize("m,r_outs,b0", [(4, 8, 4), (8, 4, 8)],
                         ids=["ds4_audio", "ds8_rds"])
def test_fir_block_schedule_is_fir_dots_sum(m, r_outs, b0):
    """The blocked FIR's schedule over a skewed plane of the extract
    kernel's tile (1024 samples + 128 halo) gives every lane's outputs
    bit for bit as the ascending sum does, reads only the tile's samples,
    and its 32 lanes load from 32 distinct banks at every step."""
    rng = np.random.default_rng(m)
    n_w, nn = 1152, 128
    x = rng.normal(0, 1, n_w).astype(np.float32)
    plane = np.full(_mid_skew(n_w) + 1, np.nan, np.float32)
    plane[_mid_skew(np.arange(n_w))] = x
    w = rng.normal(0, 0.1, nn).astype(np.float32)
    want = _sum_ascending(w, x[b0:], m, 32 * r_outs)
    per_lane = []
    for lane in range(32):
        seen = set()
        got = _fir_block_model(plane, lane, w, m, r_outs, nn, b0, seen)
        assert np.array_equal(np.array(got, np.float32),
                              want[lane * r_outs : (lane + 1) * r_outs])
        assert max(seen) <= _mid_skew(n_w - 1)
        per_lane.append(sorted(seen))
    # load j of every lane: the same offset from 33 lane, so 32 banks
    for j in range(len(per_lane[0])):
        assert len({per_lane[lane][j] % 32 for lane in range(32)}) == 32
