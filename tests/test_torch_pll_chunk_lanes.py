"""A numpy model of the chunked PLL kernel's lane schedule, bit for bit
against the port's plain version (``kernels/pll.py::pll_chunked_plain``).

The model walks ``csrc/pll.cu::pll_chunked_kernel`` as the card runs it:
lanes chunk-major (lane = g C + c), lane (g, c) running the steps [a0, a1)
of the flat theta [C N] (a0 = c N + max(g L - W, 0), a1 = c N + g L + L)
and keeping those from k0 = c N + g L; its batches of ``BATCH`` steps on
the flat array's grid, from the one that holds a0 to the one that holds
a1 - 1, the steps before a0 and past a1 masked; three batches loaded
ahead, the look-ahead past the last batch loading the last again (never
run), a batch that reaches past the array's end read element by element
with its missing steps as 0; the kept outputs stored whole batches at a
time where the batch is the lane's alone, else element by element; the
NCO phase of chunk 0 the carried one wrapped, of chunks g >= 1 seeded
from theta at a0; the last chunk's state carried out.

Over G = 2, 4, 8, W = 0, 7, 64, L a multiple of the batch (80) and not
(75) and C = 1, 5, two blocks with carried state: dt and the state equal
the plain version's bit for bit, every output is stored exactly once, and
every load lies inside the array.  The kernel itself is held against the
plain version on the card (chip_smoke.py::compare_pll_chunked_edges,
tests/test_torch_gpu.py).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.kernels import pll as tpll
from fm_radio_tpu_torch.models.pilot_pll import (
    PilotPLLState,
    pll_consts_from_cfg,
)

F = np.float32
LOOK_AHEAD = 3  # batches in flight beyond the present one


def wrap(t):
    return t - np.rint(t)


def step(k: dict, s: list, th):
    """``pll_step.cuh::pll_step`` in float32 on every lane at once: the
    new state (lpf_x1, lpf_y1, integ, nco_t, prev_pe) and t."""
    x1, y1, integ, t, pe = s
    lpf_pe = k["lpf_b0"] * (pe + x1) - k["lpf_a1"] * y1
    integ = np.clip(integ + k["ki_ts"] * pe, F(-1), F(1))
    control = np.clip(lpf_pe * k["kp"] + integ, F(-1), F(1))
    t = wrap(t + k["ts"] * (k["f_center"] + control * k["f_gain"]))
    return [pe, lpf_pe, integ, t, F(2.0 * math.pi) * wrap(th + t)], t


def lanes_model(cfg, state: PilotPLLState, theta: np.ndarray):
    """The kernel's schedule: (state' rows [5, C], dt [C, N], the count of
    stores of each output, the loads' batch starts)."""
    c, n = theta.shape
    g, w = int(cfg.pll_time_chunks), int(cfg.pll_chunk_warmup)
    l, total, bt = n // g, c * n, tpll.BATCH
    flat = theta.reshape(-1)
    k = {key: F(v) for key, v in pll_consts_from_cfg(cfg).items()}
    lane = np.arange(c * g)
    gg, cc = lane // c, lane % c
    a0 = cc * n + np.maximum(gg * l - w, 0)
    k0 = cc * n + gg * l
    a1 = k0 + l
    q0 = a0 // bt
    nb = -(-a1 // bt) - q0
    s = [np.asarray(r)[cc].astype(F) for r in state]
    seed = np.where(gg == 0, s[3], -flat[a0] - F(tpll.seed_offset(cfg)))
    s[3] = wrap(seed.astype(F))
    dt = np.full(total, np.nan, F)
    stores = np.zeros(total, np.int64)
    loads = []
    for j in range(int(nb.max()) + LOOK_AHEAD):
        at = (q0 + np.minimum(j, nb - 1)) * bt
        loads.append(at)
        e = at[:, None] + np.arange(bt)
        batch = np.where(e < total, flat[np.minimum(e, total - 1)], F(0))
        live = j < nb
        run = live[:, None] & (e >= a0[:, None]) & (e < a1[:, None])
        # a whole batch stored at once (16-byte stores) where it lies in
        # the lane's kept range, else its kept steps one by one
        whole = live & (at >= k0) & (at + bt <= a1)
        keep = np.where(whole[:, None], True, run & (e >= k0[:, None]))
        for u in range(bt):
            new, t = step(k, s, batch[:, u])
            s = [np.where(run[:, u], a, b) for a, b in zip(new, s)]
            dt[e[keep[:, u], u]] = t[keep[:, u]]
            np.add.at(stores, e[keep[:, u], u], 1)
    last = gg == g - 1
    return (np.stack([r[last] for r in s]), dt.reshape(c, n),
            stores.reshape(c, n), np.stack(loads))


def _theta(c: int, n: int, rng) -> np.ndarray:
    """A 19 kHz pilot at the PLL's rate (cycles, wrapped) with a per-channel
    offset and noise: a track the loop locks on."""
    i = np.arange(n)
    x = (i * (19000.0 / 16000.0) + rng.random((c, 1))
         + 0.01 * rng.standard_normal((c, n)))
    return (x - np.rint(x)).astype(F)


CASES = [(c, g, w, l) for c in (1, 5) for g in (2, 4, 8)
         for w in (0, 7, 64) for l in (80, 75)]


@pytest.mark.parametrize("c,g,w,l", CASES,
                         ids=[f"c{c}-g{g}-w{w}-l{l}" for c, g, w, l in CASES])
def test_lane_schedule_matches_plain(c, g, w, l):
    cfg = dataclasses.replace(DemodConfig(frontend_int8=True),
                              pll_time_chunks=g, pll_chunk_warmup=w)
    n = g * l
    assert tpll.chunk_gate(cfg, n)
    rng = np.random.default_rng(1000 * c + 100 * g + 10 * w + l)
    # a carried state off zero: chunk 0 starts from it, its NCO wrapped
    state = PilotPLLState(*(torch.from_numpy(
        (0.3 * rng.standard_normal(c)).astype(F)) for _ in range(5)))
    th = _theta(c, 2 * n, rng)
    for blk in range(2):
        x = np.ascontiguousarray(th[:, blk * n : (blk + 1) * n])
        st_m, dt_m, stores, loads = lanes_model(cfg, state, x)
        new, dt_p = tpll.pll_chunked_plain(cfg, state, torch.from_numpy(x))
        assert (stores == 1).all(), np.argwhere(stores != 1)[:5]
        assert ((loads >= 0) & (loads < c * n) & (loads % tpll.BATCH == 0)
                ).all()
        np.testing.assert_array_equal(dt_m, dt_p.numpy())
        np.testing.assert_array_equal(st_m, torch.stack(list(new)).numpy())
        state = new
