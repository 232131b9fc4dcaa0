"""The mid end at every filter order the halo admits, on the host.

The split route now takes every ds x2 order 2 <= nn2 <= 130 and Hilbert
order 1 <= nh <= 129 (``csrc/k12_stages.cuh``: ``k12_mid_ds2_kernel`` and
``k12_mid_hilb_kernel`` at the receiver's 64 / 65 taps,
``k12_mid_ds2_any_kernel`` and ``k12_mid_hilb_any_kernel`` at any other).
The kernels run only on the card (``chip_smoke.compare_mid_edges``, max
abs error 0).  Here:

- a numpy model of the any-order schedule (the window staged at
  ``any_word``, ``mid_fir_any``'s whole blocks of R steps, its last 1 .. R
  steps and the extra step of the nn % M phases) gives every thread's run
  bit for bit as ``mid_ds2_plain`` and ``mid_hilb_plain`` do, adds the
  taps in ascending order, reads only staged words, loads a warp's words
  from 32 distinct banks, and stages the new ds x2 tail;
- the route over every order, and the refusal past the halo on every
  device before any launch;
- ``demod_block`` at orders 96 / 97 (the presplit_mo96 lens's) on K12 and
  on the split float path, and at 63 / 33 on the split float path,
  against JAX ``demod_block(loop_impl="pallas")`` for 3 blocks:
  ``rds_valid`` exact, audio within 1e-4 (tests/test_torch_demod.py's
  tolerance), the carried tails within K2's 2e-5, and the RDS predictions
  within 1e-4 or, where the JAX package's own XLA path takes the orders
  (its polyphase FIRs want nn2 % 4 == 0), no further from Pallas than
  that path is (at 96 / 97 the two JAX paths differ by up to ~7.5e-4
  there, the port by ~2e-4).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_radio_tpu.config import DemodConfig as JDemodConfig
from fm_radio_tpu.io.pcm import c64_to_u8
from fm_radio_tpu.io.synth import FMModulator, ModulatorConfig
from fm_radio_tpu.models import demod as jdemod
from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.kernels import k12 as tk12
from fm_radio_tpu_torch.kernels import midend as tmid
from fm_radio_tpu_torch.models import demod as tdemod
from fm_radio_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
from fm_radio_tpu_torch.utils.transfer import split_iq_i8

# csrc/k12_stages.cuh: the tile, the ds x2 kernel's runs (8 outputs a
# thread of 128) and the Hilbert kernel's (4 a thread of 256), the halo
MID_TILE, DS2_OUTS, HILB_OUTS, HALO = 1024, 8, 4, 128
DS2_ORDERS = list(range(2, HALO + 3))
HILB_ORDERS = list(range(1, HALO + 2, 2)) + [2, 64, 128]


def _word(j, p):
    """``any_word<P>``: sample j of a staged window at word j + j // P."""
    return j + j // p


def _staged(window, p, n_words):
    """A window as the any-order kernels stage it: sample b at _word(b,
    p), NaN at every word they do not write."""
    s = np.full(n_words, np.nan, np.float32)
    s[_word(np.arange(len(window)), p)] = window
    return s


def _fir_any_model(s, xl, w, m, r_outs, nn, seen, taps):
    """``mid_fir_any<M, R>`` for the threads whose first samples lie at
    words ``xl`` (an array: one thread each), step for step: the initial
    window, the whole blocks (every slot refilled), the last s = nq - q1
    steps (no load after the last), then the extra step of the phases
    p < nn % m, its samples loaded and used once.  Every load appends its
    words to ``seen``, every tap index added to ``taps``."""
    p_run = m * r_outs
    nq, px = divmod(nn, m)
    q1 = (nq - 1) // r_outs * r_outs

    def load(at):
        seen.append(at)
        return s[at]

    v = [[load(xl + _word(m * r + p, p_run)) for r in range(r_outs)]
         for p in range(m)]
    acc = [np.zeros(len(xl), np.float32) for _ in range(r_outs)]

    def add(r, k, x):
        acc[r] = (acc[r] + w[k] * x).astype(np.float32)

    def steps(xq, kq, n_steps, last):
        for qq in range(n_steps):
            for p in range(m):
                taps.append(kq + m * qq + p)
                for r in range(r_outs):
                    add(r, kq + m * qq + p, v[p][(r + qq) % r_outs])
                if not last or qq + 1 < n_steps:
                    v[p][qq] = load(xq + _word(m * (r_outs + qq) + p, p_run))

    for qb in range(0, q1, r_outs):
        steps(xl + (p_run + 1) * (qb // r_outs), m * qb, r_outs, False)
    xq, kq, n_last = xl + (p_run + 1) * (q1 // r_outs), m * q1, nq - q1
    assert 1 <= n_last <= r_outs
    steps(xq, kq, n_last, True)
    for p in range(px):
        taps.append(kq + m * n_last + p)
        for r in range(r_outs):
            add(r, kq + m * n_last + p,
                load(xq + _word(m * (n_last + r) + p, p_run)))
    return np.stack(acc, axis=1).reshape(-1)


def _check_loads(seen, written, threads):
    """Every load reads a staged word; each warp's words of one load lie
    in 32 distinct banks."""
    for at in seen:
        assert set(at.tolist()) <= written
        for w0 in range(0, threads, 32):
            lanes = at[w0 : w0 + 32]
            assert len(set((lanes % 32).tolist())) == len(lanes)


def _ds2_model(w2_rev, tail2, fmd):
    """The ds x2 any-order kernel on one row: fm_out and the new tail as
    its tiles store them, each tile modelled from its staged window."""
    nn2, n4 = len(w2_rev), len(fmd)
    h2, n8, p_run = nn2 - 2, n4 // 2, 2 * DS2_OUTS
    src = np.concatenate([tail2, fmd])  # fmd index j at h2 + j
    n_words = _word(2 * MID_TILE + HALO, p_run) + 1
    fm_out = np.full(n8, np.nan, np.float32)
    for i0 in range(0, n8, MID_TILE):
        nt = min(MID_TILE, n8 - i0)
        window = src[2 * i0 : 2 * i0 + 2 * nt + h2]
        s = _staged(window, p_run, n_words)
        written = set(_word(np.arange(len(window)), p_run).tolist())
        threads = nt // DS2_OUTS
        seen, taps = [], []
        fm_out[i0 : i0 + nt] = _fir_any_model(
            s, (p_run + 1) * np.arange(threads), w2_rev, 2, DS2_OUTS, nn2,
            seen, taps)
        assert taps == list(range(nn2))
        _check_loads(seen, written, threads)
        if i0 + nt == n8:  # the last tile writes the new tail
            new_tail = window[len(window) - h2 :]
    return fm_out, new_tail


def _hilb_model(wh_rev, htail, fm_out):
    """The Hilbert any-order kernel on one row: (re, im) as its tiles
    store them."""
    nh, n8 = len(wh_rev), len(fm_out)
    hh, p_run = nh - 1, HILB_OUTS
    src = np.concatenate([htail, fm_out])  # fm_out index i at hh + i
    n_words = _word(MID_TILE + HALO, p_run) + 1
    re = np.full(n8, np.nan, np.float32)
    im = np.full(n8, np.nan, np.float32)
    for i0 in range(0, n8, MID_TILE):
        nt = min(MID_TILE, n8 - i0)
        window = src[i0 : i0 + nt + hh]
        s = _staged(window, p_run, n_words)
        written = set(_word(np.arange(len(window)), p_run).tolist())
        threads = nt // HILB_OUTS
        seen, taps = [], []
        im[i0 : i0 + nt] = _fir_any_model(
            s, (p_run + 1) * np.arange(threads), wh_rev, 1, HILB_OUTS, nh,
            seen, taps)
        assert taps == list(range(nh))
        a = np.arange(nt) + hh // 2  # re: the window from (nh - 1) / 2
        seen.append(_word(a, p_run))
        re[i0 : i0 + nt] = s[_word(a, p_run)]
        _check_loads(seen[:-1], written, threads)
        assert set(seen[-1].tolist()) <= written
    return re, im


def _rows(rng, shape, scale=0.3):
    return rng.normal(0, scale, shape).astype(np.float32)


@pytest.mark.parametrize("nn2", DS2_ORDERS)
def test_ds2_schedule_is_the_plain_sum(nn2):
    """The any-order ds x2 schedule equals mid_ds2_plain bit for bit at
    the shortest block that holds the tail (one partial tile) and at a
    whole tile and a partial one, two rows, with the new tail."""
    rng = np.random.default_rng(nn2)
    h2 = nn2 - 2
    w2 = _rows(rng, nn2, 0.1)
    for n4 in sorted({max(16, -(-h2 // 16) * 16), 2 * (MID_TILE + 16)}):
        tail2, fmd = _rows(rng, (2, h2)), _rows(rng, (2, n4))
        want, want_tail = tmid.mid_ds2_plain(
            torch.from_numpy(w2), torch.from_numpy(tail2),
            torch.from_numpy(fmd))
        for c in range(2):
            got, tail = _ds2_model(w2, tail2[c], fmd[c])
            np.testing.assert_array_equal(got, want[c].numpy())
            np.testing.assert_array_equal(tail, want_tail[c].numpy())


@pytest.mark.parametrize("nh", HILB_ORDERS)
def test_hilbert_schedule_is_the_plain_sum(nh):
    """The any-order Hilbert schedule equals mid_hilb_plain bit for bit
    (im the FIR, re the window from (nh - 1) / 2) at the shortest block
    that holds the tail and at a whole tile and a partial one."""
    rng = np.random.default_rng(1000 + nh)
    hh = nh - 1
    wh = _rows(rng, nh, 0.1)
    for n8 in sorted({max(8, -(-hh // 8) * 8), MID_TILE + 16}):
        htail, x = _rows(rng, (2, hh)), _rows(rng, (2, n8))
        want_re, want_im = tmid.mid_hilb_plain(
            torch.from_numpy(wh), torch.from_numpy(htail),
            torch.from_numpy(x))
        for c in range(2):
            re, im = _hilb_model(wh, htail[c], x[c])
            np.testing.assert_array_equal(im, want_im[c].numpy())
            np.testing.assert_array_equal(re, want_re[c].numpy())


def _co(nn2, nh):
    return SimpleNamespace(taps_fm_out=torch.empty(nn2),
                           taps_hilbert=torch.empty(nh))


def test_route_takes_every_order_the_halo_admits():
    """midend_route: "split" at 2 <= nn2 <= 130 and 1 <= nh <= 129 on a
    block that holds both tails, "launches" on a shorter one, "refused"
    past the halo (csrc/k12_stages.cuh::midend_route, which chip_smoke
    holds the host copy against on the card)."""
    for nn2 in range(0, 140):
        for nh in (0, 1, 2, 3, 33, 64, 65, 97, 128, 129, 130, 131, 200):
            fits = 2 <= nn2 <= 130 and 1 <= nh <= 129
            for n4 in (32, 128, 256, 4096):
                holds = n4 >= nn2 - 2 and n4 // 2 >= nh - 1
                want = ("refused" if not fits else
                        "split" if holds else "launches")
                assert tmid.midend_route(_co(nn2, nh), n4) == want, (
                    nn2, nh, n4)


@pytest.mark.parametrize("orders", [(131, 65), (64, 130), (200, 201),
                                    (1, 65), (64, 0)])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_mid_end_refuses_orders_past_the_halo(orders, device):
    """Filters past the halo raise before any launch, on every device:
    K2, K12 and K12 on phase planes, and the two tiled kernels alone."""
    nn2, nh = orders
    c, b = 2, 8192
    co = tdemod.make_coeffs(DemodConfig(frontend_int8=True))._replace(
        taps_fm_out=torch.ones(nn2) / max(nn2, 1),
        taps_hilbert=torch.ones(nh) / max(nh, 1))
    cfg = DemodConfig(frontend_int8=True)
    st = tdemod.demod_init_state(cfg, c)
    with pytest.raises(ValueError, match="halo"):
        tmid.midend(co, cfg, st, torch.zeros((c, b // 4), device=device))
    with pytest.raises(ValueError, match="halo"):
        tk12.k12(co, cfg, st, torch.zeros((2, c, b), dtype=torch.int8,
                                          device=device))
    with pytest.raises(ValueError, match="halo"):
        tk12.k12_ps(co, cfg, st, torch.zeros((2, 4, c, b // 4),
                                             dtype=torch.int8,
                                             device=device))
    z = torch.zeros((c, b // 4), device=device)
    if not 2 <= nn2 <= 130:
        with pytest.raises(ValueError, match="taps"):
            tmid.mid_ds2(co.taps_fm_out.to(device),
                         torch.zeros((c, max(nn2 - 2, 0)), device=device), z)
    if not 1 <= nh <= 129:
        with pytest.raises(ValueError, match="taps"):
            tmid.mid_hilb(co.taps_hilbert.to(device),
                          torch.zeros((c, max(nh - 1, 0)), device=device), z)


GROUPS = [
    (0x1234, (0 << 12) | (1 << 10) | 0b00000, 0xE101, 0x4142),  # 0A
    (0x1234, (2 << 12) | 0b00000, 0x4845, 0x4C4C),              # 2A
]


def _stations(c: int, n: int, seed: int) -> np.ndarray:
    """complex64 [C, n]: a stereo+RDS station a channel, its own tones,
    plus noise."""
    rng = np.random.default_rng(seed)
    mod = FMModulator(ModulatorConfig())
    rows = []
    for ch in range(c):
        iq = mod.generate(n, left_hz=700.0 + 300 * ch, right_hz=2500.0,
                          rds_groups=GROUPS)
        rows.append(iq + 2.0 * (rng.standard_normal(n)
                                + 1j * rng.standard_normal(n)))
    return np.stack(rows).astype(np.complex64)


# (path, ds x2 order, Hilbert order): the presplit_mo96 lens's orders on
# K12 and on the split float path (K1 then K2), and an odd ds x2 order,
# which K12's int8 ds x4 does not take, on the split float path
DEMOD_CASES = [("k12_int8", 96, 97), ("split_complex64", 96, 97),
               ("split_complex64", 63, 33)]


@pytest.mark.parametrize("case", DEMOD_CASES,
                         ids=[f"{p}_{a}_{b}" for p, a, b in DEMOD_CASES])
def test_demod_block_at_other_mid_orders_matches_jax_pallas(case):
    path, nn2, nh = case
    kw = {"order_poly_ds_lpf_fm_out": nn2, "order_fir_hilbert": nh}
    if path == "k12_int8":
        kw["frontend_int8"] = True
    cfg, jcfg = DemodConfig(**kw), JDemodConfig(loop_impl="pallas", **kw)
    # the JAX package's XLA path, where its polyphase FIRs take the orders
    xcfg = JDemodConfig(**kw) if nn2 % 4 == 0 else None
    co_t, co_j = tdemod.make_coeffs(cfg), jdemod.make_coeffs(jcfg)
    c, b, blocks = 4, 8192, 3
    assert (co_t.taps_fm_out.shape[0], co_t.taps_hilbert.shape[0]) == (nn2,
                                                                       nh)
    assert tmid.midend_route(co_t, b // 4) == "split"
    assert dict(tmid.midend_plan(co_t, cfg, c, b // 4)).keys() >= {
        "k12_mid_ds2_any_kernel", "k12_mid_hilb_any_kernel"}
    iq = _stations(c, b * blocks, seed=nn2 + nh)
    x = split_iq_i8(c64_to_u8(iq)) if path == "k12_int8" else iq
    st_j = jdemod.demod_init_state(jcfg, c)
    if xcfg is not None:
        co_x, st_x = jdemod.make_coeffs(xcfg), jdemod.demod_init_state(xcfg, c)
    st_t = state_from_numpy(jax.tree.map(np.asarray, st_j))
    n_valid = 0
    for blk in range(blocks):
        xb = x[..., blk * b : (blk + 1) * b]
        calls = {}
        st_j, oj = jdemod.demod_block(jcfg, co_j, st_j, jnp.asarray(xb))
        st_t, ot = tdemod.demod_block(cfg, co_t, st_t, torch.from_numpy(xb),
                                      record=calls)
        assert ("k12" if path == "k12_int8" else "midend") in calls
        valid = np.asarray(oj["rds_valid"])
        np.testing.assert_array_equal(ot["rds_valid"].numpy(), valid)
        n_valid += int(valid.sum())
        np.testing.assert_allclose(ot["audio"].numpy(),
                                   np.asarray(oj["audio"]), atol=1e-4,
                                   rtol=0)
        pred = np.asarray(oj["rds_pred"])
        bound = 1e-4
        if xcfg is not None:
            st_x, ox = jdemod.demod_block(xcfg, co_x, st_x, jnp.asarray(xb))
            both = valid & np.asarray(ox["rds_valid"])
            bound = max(bound, np.abs(np.asarray(ox["rds_pred"])[both]
                                      - pred[both]).max(initial=0.0))
        port = np.abs(ot["rds_pred"].numpy()[valid] - pred[valid])
        assert port.max(initial=0.0) <= bound, (blk, port.max(), bound)
        sj, stn = jax.tree.map(np.asarray, st_j), state_to_numpy(st_t)
        for key in ("ds_fm_out", "hilbert"):
            assert stn[key].shape == sj[key].shape, key
            np.testing.assert_allclose(stn[key], sj[key], atol=2e-5,
                                       rtol=0, err_msg=key)
    assert n_valid > 0
