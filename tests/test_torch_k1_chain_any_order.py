"""The float K1 and the megakernel at filter orders other than the
receiver's, on the host.

At every ds x4 order but 64 the float K1 runs ``k1_tile_any_kernel`` and,
at any orders but (64, 128, 128), the megakernel runs ``chain_any_kernel``
(``csrc/frontend.cu``, ``csrc/chain.cu``): their FIRs on
``extract_stages.cuh::fir_block_any``.  The kernels run only on the card
(``chip_smoke.compare_k1_any_orders``, ``compare_chain_small``; max abs
error 0).  Here:

- a numpy model of K1's any-order schedule at every order nn % 4 == 0
  from 4 to 132, a tile of 1,024 outputs a CTA staged at plane index e =
  sample - (4 t0 - nn) and each lane's window from its pointer 1056 wq +
  33 L with B0 = 4: every output bit for bit ``ds4_theta_plain``'s sum
  (and its atan2 theta1), the taps added in ascending order, only staged
  words read, 32 distinct banks a warp at every load;
- the megakernel's layout at its orders: the input window of the first
  tile (from the carried tail) and of a later one (float4 fetches from t0
  - h1), staged at index 4 + j, ds x4 two channel planes a warp; and the
  six extraction planes shifted by ``ch_shift`` through the halo fill, the
  tiles' writes and the slide, the five FIRs two lanes a channel plane,
  the carried tails read back: outputs bit for bit the plain FIR sums of
  the concatenated stream, every word inside its plane, banks distinct;
- ``probes/k1_caps.py``'s edits of the K1 tile kernels' register caps;
- a decimator of as many taps as its factor (no halo) carries an empty
  tail, as JAX ``polyphase_decimate_p`` does;
- ``chain`` (plain) against ``demod_chain_pallas`` (interpret) at orders
  96 / 97 / 96 / 96 (the lens chain_o96) and 48 / 33 / 64 / 72, C = 8,
  B = 16,384, two blocks, at tests/test_torch_chain.py's tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_radio_tpu.kernels.chain_pallas import demod_chain_pallas
from fm_radio_tpu.models import demod as jdemod
from fm_radio_tpu.ops import fir as jfir
from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.kernels import _build
from fm_radio_tpu_torch.kernels import chain as tchain
from fm_radio_tpu_torch.kernels import frontend as tfront
from fm_radio_tpu_torch.models import demod as tdemod
from fm_radio_tpu_torch.ops.cmath import atan2_poly
from fm_radio_tpu_torch.ops.fir import correlate, polyphase_decimate_p
from fm_radio_tpu_torch.probes import chain_phases, k1_caps
from fm_radio_tpu_torch.utils.convert import state_from_numpy
from test_torch_chain import (OUT_ATOL, STATE_ATOL, _check_state, _inputs,
                              _stations, cfgs)

F = np.float32
K1_TILE, K1_ORDERS = 1024, list(range(4, 133, 4))
# csrc/chain.cu's tile and layout
T, H, CH = 512, 128, 4
IN_S, PL_S = 688, 226
PL_B = CH * PL_S
PL = H + T // 8
SLOT = {0: 0, 1: 5, 2: 1, 3: 2, 4: 3, 5: 4}  # ch_slot


def _skew(x):
    return x + (x >> 5)


def _fir_block_any(plane, xl, w, m, r_outs, b0, nn, loads, taps):
    """``fir_block_any`` for a vector of lanes (their pointers ``xl``), step
    for step: the first window, the whole blocks of R steps (every slot
    refilled), the last 1 .. R steps (no load after the last), the extra
    step of the phases p < nn % m.  Appends each load's address vector to
    ``loads`` and the tap index of each sum of output 0 to ``taps``.
    Returns the outputs [R, lanes]."""
    nq, px = nn // m, nn % m
    q1 = (nq - 1) // r_outs * r_outs

    def load(at):
        loads.append(at)
        return plane[at]

    v = [[load(xl + _skew(b0 + m * r + p)) for r in range(r_outs)]
         for p in range(m)]
    acc = [np.zeros(len(xl), F) for _ in range(r_outs)]

    def add(r, k, x):
        acc[r] = acc[r] + F(w[k]) * x
        if r == 0:
            taps.append(k)

    def steps(xq, kq, s, last):
        for qq in range(s):
            for p in range(m):
                for r in range(r_outs):
                    add(r, kq + m * qq + p, v[p][(r + qq) % r_outs])
                if not last or qq + 1 < s:
                    v[p][qq] = load(xq + _skew(b0 + m * (r_outs + qq) + p))

    for qb in range(0, q1, r_outs):
        steps(xl + 33 * (qb // r_outs), m * qb, r_outs, False)
    xq, kq, s = xl + 33 * (q1 // r_outs), m * q1, nq - q1
    assert 1 <= s <= r_outs
    steps(xq, kq, s, True)
    for p in range(px):
        for r in range(r_outs):
            add(r, kq + m * s + p, load(xq + _skew(b0 + m * (s + r) + p)))
    return np.stack(acc)


def _check_loads(loads, plane, warps):
    """Every load reads a staged word, and each warp's active lanes
    (``warps``: lists of lane indices into the address vectors) read
    distinct banks."""
    for at in loads:
        assert np.isfinite(plane[at]).all()
        for lanes in warps:
            assert len(set((at[lanes] % 32).tolist())) == len(lanes)


def test_k1_orders_reach_every_last_block():
    """The K1 orders end fir_block_any in each of its 1 .. 8 last steps."""
    assert {(nn // 4 - 1) % 8 + 1 for nn in K1_ORDERS} == set(range(1, 9))


@pytest.mark.parametrize("nn", K1_ORDERS)
def test_k1_any_order_schedule_is_the_plain_sum(nn):
    rng = np.random.default_rng(nn)
    b = 2 * 4 * K1_TILE
    w = rng.normal(0, 0.05, nn).astype(F)
    tail = rng.integers(-127, 129, (2, 1, nn - 4)).astype(F)
    x = rng.integers(-127, 129, (2, 1, b)).astype(F)
    co = tdemod.make_coeffs(DemodConfig())._replace(
        taps_fm_in=torch.from_numpy(w))
    st = {"ds_fm_in": torch.complex(torch.from_numpy(tail[0]),
                                    torch.from_numpy(tail[1]))}
    theta1, xf = tfront.ds4_theta_plain(co, st, torch.from_numpy(x), False)
    fm = correlate(co.taps_fm_in.flip(0).tolist(), xf, 4, b // 4)
    w_rev, xf = w[::-1].copy(), xf.numpy()[:, 0]
    n_plane = (_skew(nn + 4 * K1_TILE - 1) + 1 + 3) // 4 * 4
    wq, lane = np.divmod(np.arange(4 * 32), 32)
    for t0 in (0, K1_TILE):
        # plane index e holds sample 4 t0 - nn + e: xf index 4 t0 + e - 4
        e = np.arange(nn + 4 * K1_TILE)
        src = 4 * t0 + e - 4
        ok = (src >= 0) & (src < xf.shape[-1])
        sums = []
        for p in range(2):
            plane = np.full(n_plane, np.nan, F)
            plane[_skew(e)] = np.where(ok, xf[p, np.clip(src, 0, None)
                                             .clip(None, xf.shape[-1] - 1)],
                                       0.0)
            loads, taps = [], []
            acc = _fir_block_any(plane, 1056 * wq + 33 * lane, w_rev, 4, 8,
                                 4, nn, loads, taps)
            assert taps == list(range(nn))
            _check_loads(loads, plane,
                         [np.arange(32) + 32 * q for q in range(4)])
            # output u = 256 wq + 8 L + r of the tile
            sums.append(acc.T.reshape(-1))
            assert np.array_equal(sums[p],
                                  fm[p, 0, t0 : t0 + K1_TILE].numpy())
        th = atan2_poly(torch.from_numpy(sums[1]), torch.from_numpy(sums[0]))
        assert torch.equal(th, theta1[0, t0 : t0 + K1_TILE])


@pytest.mark.parametrize("nn1", K1_ORDERS)
def test_chain_any_order_ds4_window(nn1):
    """Phase 1 and 2a of chain_any_kernel: the first tile's window from the
    carried tail (the scalar path) and a later tile's (float4 fetches from
    t0 - h1), sample t0 - h1 + j at index 4 + j of its plane, every plane
    inside its kChInS words; ds x4 by fir_block_any<4, 8, 4> two channel
    planes a warp, 16 lanes each: every output K1's plain sum."""
    rng = np.random.default_rng(1000 + nn1)
    h1 = nn1 - 4
    w = rng.normal(0, 0.05, nn1).astype(F)
    # [2 CH, h1 + 2 T]: the carried tail, then two tiles (re 0-3, im 4-7)
    stream = rng.integers(-127, 129, (2 * CH, h1 + 2 * T)).astype(F)
    want = correlate(w[::-1].tolist(), torch.from_numpy(stream), 4,
                     2 * T // 4).numpy()
    cp, l = np.divmod(np.arange(128), 16)
    for t0 in (0, T):
        smem = np.full(2 * CH * IN_S, np.nan, F)
        if t0 >= h1:  # float4 fetches of samples t0 - h1 ..
            n_g = (h1 + T) // 4
            e = np.arange(CH * n_g)
            ch, g = np.divmod(e, n_g)
            j = (4 * g[:, None] + np.arange(4)).reshape(-1)
            ch = np.repeat(ch, 4)
        else:  # the scalar loop from the carried tail
            ch, j = np.divmod(np.arange(CH * (h1 + T)), h1 + T)
        for plane_ch in (ch, ch + CH):
            at = plane_ch * IN_S + _skew(4 + j)
            assert _skew(4 + j).max() < IN_S and len(set(at)) == len(at)
            smem[at] = stream[plane_ch, t0 + j]
        loads, taps = [], []
        acc = _fir_block_any(smem, cp * IN_S + 33 * l, w[::-1], 4, 8, 4,
                             nn1, loads, taps)
        assert taps == list(range(nn1))
        _check_loads(loads, smem, [np.arange(32) + 32 * q for q in range(4)])
        for r in range(8):
            jj = t0 // 4 + 8 * l + r
            assert np.array_equal(acc[r], want[cp, jj])


def _rows(nn):
    return min((nn + 31) // 32, H // 32)


def _shift(nn):
    return nn - 32 * _rows(nn)


# (L+R / L-R order, RDS order): the lens's, the receiver's, short and the
# longest, odd ones (extra phase steps), shifts of every sign
EXT_ORDERS = [(96, 96), (64, 72), (128, 128), (97, 131), (61, 93), (4, 8),
              (132, 136), (33, 9), (125, 127), (30, 40)]


@pytest.mark.parametrize("orders", EXT_ORDERS,
                         ids=[f"{a}_{r}" for a, r in EXT_ORDERS])
def test_chain_any_order_extraction_planes(orders):
    """Phases 11 and 12 of chain_any_kernel over three tiles: the six planes
    filled from the carried tails (window samples only), each tile's 64
    samples written at kChH + i, the five FIRs (fir_block_any<4, 8, 4> on
    lpr and L-R, <8, 4, 8> on RDS, two lanes a channel plane, each plane
    shifted by ch_shift and read from 33 (kChH / 32 - ch_rows + lane)),
    the slide of each plane's window; every output the plain FIR of the
    concatenated stream bit for bit, the carried tails its last samples."""
    nn_a, nn_r = orders
    rng = np.random.default_rng(nn_a * 1000 + nn_r)
    n_tiles = 3
    wa, wm = (rng.normal(0, 0.05, nn_a).astype(F) for _ in range(2))
    wr = rng.normal(0, 0.05, nn_r).astype(F)
    ext = {p: (nn_a - 4 if p < 4 else nn_r - 8) for p in range(6)}
    shift = {p: _shift(nn_a if p < 4 else nn_r) for p in range(6)}
    # per plane and channel: the carried tail, then the tiles' samples
    stream = {(p, c): rng.normal(0, 1, ext[p] + n_tiles * (T // 8)).astype(F)
              for p in range(6) for c in range(CH)}
    smem = np.full(6 * PL_B, np.nan, F)
    owner = {}

    def at(p, c, i):
        k = _skew(i + shift[p])
        assert 0 <= i + shift[p] and k < PL_S
        a = SLOT[p] * PL_B + c * PL_S + k
        assert owner.setdefault(a, (p, c)) == (p, c)
        return a

    for (p, c), s in stream.items():  # the halo: samples -h .. -1
        for k in range(H - ext[p], H):
            smem[at(p, c, k)] = s[k - (H - ext[p])]
    outs = {}
    for tile in range(n_tiles):
        for (p, c), s in stream.items():  # the tile's samples (phase 10)
            for i in range(T // 8):
                smem[at(p, c, H + i)] = s[ext[p] + tile * (T // 8) + i]
        for warp, planes in ((0, (0, 2, 3)), (1, (4, 5))):
            lanes = [(p, c, li) for p in planes for c in range(CH)
                     for li in range(2)]
            m, r_outs, nn = (4, 8, nn_a) if warp == 0 else (8, 4, nn_r)
            for w in ((wa, wm) if warp == 0 else (wr,)):
                sel = [k for k, (p, _, _) in enumerate(lanes)
                       if warp == 1 or (p == 0) == (w is wa)]
                xl = np.array([SLOT[p] * PL_B + c * PL_S
                               + 33 * (H // 32 - _rows(nn) + li)
                               for p, c, li in lanes])
                loads, taps = [], []
                acc = _fir_block_any(smem, xl, w[::-1], m, r_outs, m, nn,
                                     loads, taps)
                assert taps == list(range(nn))
                for a in loads:  # every lane reads window words
                    assert np.isfinite(smem[a[sel]]).all()
                    assert len(set((a % 32).tolist())) == len(lanes)
                for k in sel:
                    p, c, li = lanes[k]
                    for r in range(r_outs):
                        outs[(p, c, tile * (T // 8 // m)
                              + r_outs * li + r)] = acc[r, k]
        # phase 12: the last kChH samples slide to the halo (the window's)
        for (p, c) in stream:
            tmp = [smem[at(p, c, T // 8 + k)] for k in range(H)]
            for k in range(H - ext[p], H):
                smem[at(p, c, k)] = tmp[k]
    for (p, c), s in stream.items():
        if p == 1:
            continue
        m, nn, w = ((4, nn_a, wa if p == 0 else wm) if p < 4
                    else (8, nn_r, wr))
        n_out = n_tiles * (T // 8) // m
        want = correlate(w[::-1].tolist(), torch.from_numpy(s), m,
                         n_out).numpy()
        got = np.array([outs[(p, c, j)] for j in range(n_out)], F)
        assert np.array_equal(got, want), (p, c)
    for (p, c), s in stream.items():  # the carried tails
        tail = [smem[at(p, c, k)] for k in range(H - ext[p], H)]
        assert np.array_equal(np.array(tail, F), s[len(s) - ext[p]:])


@pytest.mark.parametrize("name", sorted(k1_caps.VARIANTS))
def test_k1_caps_edits_apply(name):
    """probes/k1_caps.py's builds of csrc/frontend.cu: the 64-tap kernel
    capped as built, uncapped, and the any-order kernel capped at 4 CTAs
    an SM (an edit that found nothing would time the built source under
    another name)."""
    src = (_build.CSRC / "frontend.cu").read_text()
    out = chain_phases.variant_source(src, k1_caps.VARIANTS[name])
    assert (out == src) == (name == "built")
    caps = {"built": ("kK1Threads, kK1Ctas<Load>)", "kK1Threads)\nk1_tile_any"),
            "uncapped": ("kK1Threads)\nk1_tile_kernel", "kK1Threads)\nk1_tile_any"),
            "any_capped": ("kK1Threads, kK1Ctas<Load>)",
                           "kK1Threads, 4)\nk1_tile_any")}[name]
    assert all(c in out for c in caps)


@pytest.mark.parametrize("imag_out", [False, True])
def test_decimator_without_a_halo_carries_an_empty_tail(imag_out):
    """A decimator of as many taps as its factor (extract's L+R and L-R at
    4 taps, RDS at 8: the shortest the halos admit) carries no tail, as
    JAX ``polyphase_decimate_p`` does (a tail of the whole block before)."""
    rng = np.random.default_rng(3)
    taps = rng.normal(0, 0.3, 4).astype(F)
    xr, xi = (rng.normal(0, 1, (2, 64)).astype(F) for _ in range(2))
    st = np.zeros((2, 0), np.complex64)
    got = polyphase_decimate_p(torch.from_numpy(taps), torch.from_numpy(st),
                               (torch.from_numpy(xr), torch.from_numpy(xi)),
                               4, imag_out)
    want = jfir.polyphase_decimate_p(jnp.asarray(taps), jnp.asarray(st),
                                     (jnp.asarray(xr), jnp.asarray(xi)), 4,
                                     imag_out)
    assert got[0].shape == (2, 0) and np.asarray(want[0]).shape == (2, 0)
    for a, b in zip(jax.tree.leaves(got[1]), jax.tree.leaves(want[1])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


# (order_poly_ds_lpf_fm_out, order_fir_hilbert, order_poly_ds_lpf_audio,
# order_poly_ds_lpf_rds): the lens chain_o96's, and one of each filter
# off the receiver's
PALLAS_ORDERS = [((96, 97, 96, 96), "words"), ((48, 33, 64, 72), "planes")]


@pytest.mark.parametrize("orders,form", PALLAS_ORDERS,
                         ids=["o96_words", "o48_planes"])
def test_chain_plain_matches_pallas_at_other_orders(orders, form):
    c, b = 8, 16384
    keys = ("order_poly_ds_lpf_fm_out", "order_fir_hilbert",
            "order_poly_ds_lpf_audio", "order_poly_ds_lpf_rds")
    tcfg, jcfg = cfgs(**dict(zip(keys, orders)))
    co_j, co_t = jdemod.make_coeffs(jcfg), tdemod.make_coeffs(tcfg)
    assert tchain.chain_orders(co_t) == (orders[0], orders[2], orders[3])
    cf, u8 = _stations(c, 2 * b, seed=4)
    x = np.ascontiguousarray(_inputs(form, cf, u8), np.float32)
    st_j = jdemod.demod_init_state(jcfg, c)
    st_t = state_from_numpy(jax.tree.map(np.asarray, st_j))
    for blk in range(2):
        xb = np.ascontiguousarray(x[..., blk * b : (blk + 1) * b])
        xj = (jnp.asarray(xb) if form == "words"
              else (jnp.asarray(xb[0]), jnp.asarray(xb[1])))
        st_j, lpr_j, lmr_j, rds_j = demod_chain_pallas(
            co_j, jcfg, st_j, xj, interpret=True, int_input=form == "words")
        st_t, lpr_t, lmr_t, rds_t = tchain.chain(co_t, tcfg, st_t,
                                                 torch.from_numpy(xb))
        for a, bb in [(lpr_t, lpr_j), *zip(lmr_t, lmr_j), *zip(rds_t, rds_j)]:
            np.testing.assert_allclose(a.numpy(), np.asarray(bb),
                                       atol=OUT_ATOL, rtol=0)
        _check_state(st_t, st_j, [k for k in STATE_ATOL
                                  if k not in ("lmr_phase_err", "bpsk")]
                     + ["agc_pilot"])
