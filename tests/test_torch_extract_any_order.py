"""Extract at every filter order the halos admit, on the host.

The blocked route now takes every L+R / L-R order nn_a and RDS order nn_r
with nn_a - 4 <= 128 and nn_r - 8 <= 128 (``csrc/extract.cu``:
``extract_blocked_kernel`` at the receiver's 128 taps,
``extract_blocked_any_kernel`` at any other).  The kernels run only on the
card (``chip_smoke.compare_extract_edges``, max abs error 0).  Here:

- a numpy model of the any-order schedule (``csrc/extract_stages.cuh``:
  the planes stored shifted by nn % 32 and skewed, ``fir_block_any``'s
  whole blocks, its last 1 .. R steps and the extra step of the nn % M
  phases) gives every lane's outputs bit for bit as ``extract_item``'s
  ascending sum does, adds the taps in ascending order, reads only
  staged samples, loads from 32 distinct banks at every step, and reads
  the carried tails from the tile's last samples;
- the route over every order, and the refusal past the halos;
- the plain ``extract`` at (64, 64), (96, 96) and (130, 131) against
  ``extract_pallas`` in interpret mode (its gate, halo <= 128, admits
  all three) on the three forms, two blocks with carried tails, at the
  tolerances of tests/test_torch_kernels.py (1e-5, the RDS power rtol
  2e-4);
- ``demod_block`` at orders 96 / 96 against JAX ``demod_block(
  loop_impl="pallas")`` for 3 blocks (``rds_valid`` exact, audio 1e-4,
  tests/test_torch_demod.py's tolerances).
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_radio_tpu.config import DemodConfig as JDemodConfig
from fm_radio_tpu.io.pcm import c64_to_u8
from fm_radio_tpu.io.synth import FMModulator, ModulatorConfig
from fm_radio_tpu.kernels import extract_pallas
from fm_radio_tpu.kernels import qformat as jq
from fm_radio_tpu.models import demod as jdemod
from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.kernels import extract as text
from fm_radio_tpu_torch.models import demod as tdemod
from fm_radio_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
from fm_radio_tpu_torch.utils.transfer import split_iq_i8

EXT_TILE, EXT_HALO = 1024, 128           # csrc/extract_stages.cuh
EXT_W = EXT_HALO + EXT_TILE

# the model's orders (L+R / L-R taps, RDS taps): multiples of the
# decimation and not, the halos' longest, short ones
MODEL_ORDERS = [(64, 64), (96, 96), (124, 120), (130, 131), (132, 136),
                (8, 16), (5, 9)]


def _mid_skew(x):
    return x + (x >> 5)


def _sum_ascending(w, v, m, n):
    """y[i] = sum_k w[k] * v[m i + k] for i < n from 0.0, k ascending,
    every product and sum rounded to float32 (extract_item's fir_dot)."""
    acc = np.zeros(n, np.float32)
    for k, wk in enumerate(np.asarray(w, np.float32)):
        acc = acc + wk * v[k : k + m * n : m]
    return acc


def _fir_block_any_model(plane, xl, w, m, r_outs, b0, nn, seen, taps_of):
    """``fir_block_any`` for one lane, step for step: the initial window,
    the whole blocks (every slot refilled), the last s = nq - q1 steps
    (kLast: no load after the last one), then the extra step of the
    phases p < nn % m, its samples loaded and used once.  Every address
    it loads is appended to ``seen``, every tap index each output adds to
    ``taps_of[r]``."""
    nq, px = nn // m, nn % m
    q1 = (nq - 1) // r_outs * r_outs

    def load(at):
        seen.append(at)
        return plane[at]

    v = [[load(xl + _mid_skew(b0 + m * r + p)) for r in range(r_outs)]
         for p in range(m)]
    acc = [np.float32(0.0)] * r_outs

    def add(r, k, x):
        acc[r] = np.float32(acc[r] + np.float32(w[k] * x))
        taps_of[r].append(k)

    def steps(xq, kq, s, last):
        for qq in range(s):
            for p in range(m):
                for r in range(r_outs):
                    add(r, kq + m * qq + p, v[p][(r + qq) % r_outs])
                if not last or qq + 1 < s:
                    v[p][qq] = load(xq + _mid_skew(b0 + m * (r_outs + qq)
                                                   + p))

    for qb in range(0, q1, r_outs):
        steps(xl + 33 * (qb // r_outs), m * qb, r_outs, False)
    xq, kq, s = xl + 33 * (q1 // r_outs), m * q1, nq - q1
    assert 1 <= s <= r_outs
    steps(xq, kq, s, True)
    for p in range(px):
        for r in range(r_outs):
            add(r, kq + m * s + p, load(xq + _mid_skew(b0 + m * (s + r) + p)))
    return acc


def _shifted_plane(t, s):
    """A tile's plane as ext_put_any stores it: sample e at mid_skew(e +
    s), NaN at every word it does not write."""
    plane = np.full(_mid_skew(EXT_W + 31) + 1, np.nan, np.float32)
    plane[_mid_skew(np.arange(EXT_W) + s)] = t
    return plane


@pytest.mark.parametrize("orders", MODEL_ORDERS,
                         ids=[f"{a}_{r}" for a, r in MODEL_ORDERS])
def test_any_order_schedule_is_extract_items_sum(orders):
    nn_a, nn_r = orders
    rng = np.random.default_rng(nn_a * 1000 + nn_r)
    for m, r_outs, nn, n_out in ((4, 8, nn_a, EXT_TILE // 4),
                                 (8, 4, nn_r, EXT_TILE // 8)):
        t = rng.normal(0, 1, EXT_W).astype(np.float32)
        w = rng.normal(0, 0.1, nn).astype(np.float32)
        s = nn % 32
        plane = _shifted_plane(t, s)
        written = set(_mid_skew(np.arange(EXT_W) + s).tolist())
        # extract_item: output j sums the tile from EXT_HALO - (nn - m) + m j
        want = _sum_ascending(w, t[EXT_HALO - (nn - m):], m, n_out)
        per_lane = []
        for lane in range(32):
            seen, taps_of = [], [[] for _ in range(r_outs)]
            got = _fir_block_any_model(plane, 33 * (4 - nn // 32 + lane), w,
                                       m, r_outs, m, nn, seen, taps_of)
            assert np.array_equal(
                np.array(got, np.float32),
                want[lane * r_outs : (lane + 1) * r_outs]), (m, lane)
            assert all(k == list(range(nn)) for k in taps_of), (m, lane)
            assert set(seen) <= written, (m, lane)
            per_lane.append(seen)
        # load j of every lane a constant offset from 33 lane: 32 banks
        for j in range(len(per_lane[0])):
            assert len({per_lane[lane][j] % 32 for lane in range(32)}) == 32
        # the carried tail: the tile's last nn - m samples
        h = nn - m
        tail = plane[_mid_skew(EXT_W - h + np.arange(h) + s)]
        assert np.array_equal(tail, t[EXT_W - h:])


def _co_orders(nn_a, nn_r):
    co = tdemod.make_coeffs(DemodConfig(frontend_int8=True))
    return co._replace(taps_audio_lpr=torch.ones(nn_a) / nn_a,
                       taps_audio_lmr=torch.ones(nn_a) / nn_a,
                       taps_rds=torch.ones(nn_r) / nn_r)


def test_route_takes_every_order_the_halos_admit():
    """extract_route: "blocked" exactly where 4 <= nn_a <= 132 and 8 <=
    nn_r <= 136 (csrc/extract.cu::extract_route, which chip_smoke holds
    the host copy against on the card), "refused" elsewhere."""
    for nn_a in range(1, 140):
        for nn_r in (1, 7, 8, 9, 64, 128, 131, 136, 137, 200):
            fits = 4 <= nn_a <= 132 and 8 <= nn_r <= 136
            co = SimpleNamespace(taps_audio_lpr=torch.empty(nn_a),
                                 taps_rds=torch.empty(nn_r))
            assert text.extract_route(co) == ("blocked" if fits
                                              else "refused"), (nn_a, nn_r)


@pytest.mark.parametrize("orders", [(133, 128), (128, 137), (3, 64)])
def test_extract_refuses_orders_past_the_halos(orders):
    """Filters past the halos raise before any launch, on every device."""
    c, n = 2, 1024
    co = _co_orders(*orders)
    st = tdemod.demod_init_state(DemodConfig(frontend_int8=True), c)
    x = torch.zeros((c, n))
    with pytest.raises(ValueError, match="halos"):
        text.extract(co, DemodConfig(), st, (x, x), x)


def _cfgs(nn_a, nn_r):
    kw = {"frontend_int8": True, "order_poly_ds_lpf_audio": nn_a,
          "order_poly_ds_lpf_rds": nn_r}
    return DemodConfig(**kw), JDemodConfig(**kw)


JAX_ORDERS = [(64, 64), (96, 96), (130, 131)]


@pytest.mark.parametrize("combo", ["f32_f32", "i16_i16", "i16_f32"])
@pytest.mark.parametrize("orders", JAX_ORDERS,
                         ids=[f"{a}_{r}" for a, r in JAX_ORDERS])
def test_extract_at_other_orders_matches_pallas(orders, combo):
    """The plain extract at other orders against ``extract_pallas``
    (interpret mode; its gate admits every halo <= 128, so no order here
    falls back to the JAX package's XLA extract), two blocks with carried
    tails: float32, int16 planes and dt, int16 planes with float32 dt."""
    tcfg, jcfg = _cfgs(*orders)
    co_j, co_t = jdemod.make_coeffs(jcfg), tdemod.make_coeffs(tcfg)
    assert (co_t.taps_audio_lpr.shape[0], co_t.taps_rds.shape[0]) == orders
    assert text.extract_route(co_t) == "blocked"
    c, n = 3, 2048
    rng = np.random.default_rng(sum(orders))
    planes = [rng.standard_normal((c, 2 * n)).astype(np.float32) * 0.4
              for _ in range(2)]
    dt = rng.random((c, 2 * n)).astype(np.float32) - 0.5
    if combo != "f32_f32":
        planes = [np.asarray(jq.q_i16(jnp.asarray(p), jq.IQ_SCALE))
                  for p in planes]
    if combo == "i16_i16":
        dt = np.asarray(jq.q_i16(jnp.asarray(dt), jq.PH_SCALE))
    off = rng.standard_normal((c,)).astype(np.float32) * 0.1
    st_j = jdemod.demod_init_state(jcfg, c)
    st_t = state_from_numpy(jax.tree.map(np.asarray, st_j))
    st_j = dict(st_j, lmr_phase_err=jnp.asarray(off))
    st_t = dict(st_t, lmr_phase_err=torch.from_numpy(off))
    for blk in range(2):
        sl = slice(blk * n, (blk + 1) * n)
        pj = tuple(jnp.asarray(np.ascontiguousarray(p[:, sl]))
                   for p in planes)
        st_j, lpr_j, lmr_j, rds_j, pow_j = extract_pallas.extract_pallas(
            co_j, jcfg, st_j, pj, jnp.asarray(dt[:, sl]), interpret=True)
        pt = tuple(torch.from_numpy(np.ascontiguousarray(p[:, sl]))
                   for p in planes)
        dtt = torch.from_numpy(np.ascontiguousarray(dt[:, sl]))
        st_t, lpr_t, lmr_t, rds_t, pow_t = text.extract(co_t, tcfg, st_t, pt,
                                                        dtt)
        np.testing.assert_allclose(lpr_t.numpy(), np.asarray(lpr_j),
                                   atol=1e-5)
        for k in range(2):
            np.testing.assert_allclose(lmr_t[k].numpy(), np.asarray(lmr_j[k]),
                                       atol=1e-5)
            np.testing.assert_allclose(rds_t[k].numpy(), np.asarray(rds_j[k]),
                                       atol=1e-5)
        np.testing.assert_allclose(pow_t.numpy(), np.asarray(pow_j),
                                   rtol=2e-4)
        sj, stn = jax.tree.map(np.asarray, st_j), state_to_numpy(st_t)
        # the raw (dequantised) L+R tail, exact
        np.testing.assert_array_equal(stn["ds_audio_lpr"], sj["ds_audio_lpr"])
        for key in ("ds_audio_lmr", "ds_rds"):
            np.testing.assert_allclose(stn[key], sj[key], atol=1e-5,
                                       err_msg=key)


def _planes(c, n, seed):
    """[2, C, n] int8: a stereo+RDS station per channel with added noise,
    quantized to u8 (tests/test_torch_demod.py's input)."""
    rng = np.random.default_rng(seed)
    mod = FMModulator(ModulatorConfig())
    groups = [(0x1234, (0 << 12) | (1 << 10), 0xE101, 0x4142),
              (0x1234, 2 << 12, 0x4845, 0x4C4C)]
    u8 = []
    for ch in range(c):
        iq = mod.generate(n, left_hz=700.0 + 300 * ch, right_hz=2500.0,
                          rds_groups=groups)
        iq = iq + 2.0 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        u8.append(c64_to_u8(iq.astype(np.complex64)))
    return split_iq_i8(np.stack(u8))


def test_demod_block_at_orders_96_matches_jax_pallas():
    """demod_block with order_poly_ds_lpf_audio = order_poly_ds_lpf_rds =
    96 (the presplit_o96 lens's configuration) against JAX demod_block(
    loop_impl="pallas") for 3 blocks: rds_valid exact, audio 1e-4."""
    tcfg, jcfg = _cfgs(96, 96)
    jcfg = dataclasses.replace(jcfg, loop_impl="pallas")
    c, b, blocks = 4, 8192, 3
    x = _planes(c, b * blocks, seed=7)
    co_j, co_t = jdemod.make_coeffs(jcfg), tdemod.make_coeffs(tcfg)
    assert text.extract_route(co_t) == "blocked"
    st_j = jdemod.demod_init_state(jcfg, c)
    st_t = state_from_numpy(jax.tree.map(np.asarray, st_j))
    n_valid = 0
    for blk in range(blocks):
        xb = x[:, :, blk * b : (blk + 1) * b]
        st_j, oj = jdemod.demod_block(jcfg, co_j, st_j, jnp.asarray(xb))
        st_t, ot = tdemod.demod_block(tcfg, co_t, st_t, torch.from_numpy(xb))
        valid = np.asarray(oj["rds_valid"])
        np.testing.assert_array_equal(ot["rds_valid"].numpy(), valid)
        n_valid += int(valid.sum())
        np.testing.assert_allclose(ot["audio"].numpy(),
                                   np.asarray(oj["audio"]), atol=1e-4, rtol=0)
    assert n_valid > 0
