"""The de-emphasis recurrence's kernel, on the host.

``csrc/k12_stages.cuh::k12_deemph_kernel`` runs only on the card.  Here a
numpy model of its schedule is held bit for bit against the plain version
it must equal (``ops/iir.py::iir_filter``, the port's serial recurrence):
one lane a channel; its row brought into a ring of ``slots`` chunks of
``chunk`` steps (the last chunk of a row short where the row is not a
whole number of chunks), ``slots - 1`` chunks loaded ahead; chunk k +
slots - 1 loaded into the slot chunk k - 1 left, before chunk k runs; a
chunk run 16 steps at a time and stored 16 at a time.  The model runs on
the row's memory in place (the routes' form: a load of a chunk already
partly stored would read outputs) and out of place, with the memory past
each row NaN (a load past it would carry NaN into the outputs), at step
counts of one short chunk, of several and past the ring's slots, for the
kernel's ring (``kDeemphChunk``, ``kDeemphSlots``) and for smaller rings
that every row here walks round more than once.  Composed into the plain mid end in the
de-emphasis's place, the model keeps K2 within ``midend_pallas``'s
tolerances of test_torch_split.py (the Pallas IIRs run as bf16x4 Toeplitz
products in interpret mode).  Also the launch plan: the de-emphasis on
``DEEMPH_LANES`` channels a block on both routes that run it, a grid that
covers every channel, and the wrapper's refusals before any launch.

The model rounds every product and sum to float32 in numpy in
``deemph_step``'s order ((x1 b1 + x b0) - y1 a1; ``-fmad=false``), so
equality with ``iir_filter`` is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_radio_tpu.config import DemodConfig as JDemodConfig
from fm_radio_tpu.io.synth import FMModulator, ModulatorConfig
from fm_radio_tpu.kernels.midend_pallas import midend_pallas
from fm_radio_tpu.models import demod as jdemod
from fm_radio_tpu.ops.discriminator import fm_discriminate_p
from fm_radio_tpu.ops.fir import polyphase_decimate_p
from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.kernels import midend as tmid
from fm_radio_tpu_torch.models import demod as tdemod
from fm_radio_tpu_torch.ops.iir import iir_filter
from fm_radio_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

F = np.float32
BATCH = 16
CFG = DemodConfig(frontend_int8=True, use_deemphasis_filter=True,
                  deemphasis_cutoff_us=50)
CO = tdemod.make_coeffs(CFG)
# the kernel's ring (csrc/k12_stages.cuh: kDeemphChunk steps a chunk,
# kDeemphSlots chunks a lane)
CHUNK, SLOTS = 512, 6
# batches a row: one and two; 13, 14, 15 (nb % 4 = 1, 2, 3: one short
# chunk of the kernel's 32 batches); 65 (three chunks, the last short); 195
# and 229 (seven and eight, past the kernel's six slots)
NBS = (1, 2, 13, 14, 15, 65, 195, 229)
# (chunk, slots): the kernel's, and smaller rings whose slots the longer
# rows above reuse (a chunk of one batch; two slots, the least the
# schedule allows)
SHAPES = ((CHUNK, SLOTS), (16, 2), (32, 3), (64, 4))


def deemph_model(x: np.ndarray, st: np.ndarray, b, a, chunk: int,
                 slots: int, in_place: bool, tail: int = 3 * BATCH):
    """``k12_deemph_kernel`` with a ring of ``slots`` chunks of ``chunk``
    steps a lane on x [C, n] from st [C, 2] (x1, y1), every lane in step (the lanes of a block differ only in
    their row): (y [C, n], the state after).  The rows lie in memory with
    ``tail`` NaN past each; in place the outputs overwrite x there."""
    c, n = x.shape
    nc = -(-n // chunk)
    b0, b1, a1 = F(b[0]), F(b[1]), F(a[1])
    src = np.full((c, n + tail), np.nan, F)
    src[:, :n] = x
    dst = src if in_place else np.full((c, n + tail), np.nan, F)
    x1, y1 = st[:, 0].copy(), st[:, 1].copy()
    ring, holds = [None] * slots, [None] * slots
    issued, stored = [], set()

    def issue(k):
        lo, hi = k * chunk, min(n, (k + 1) * chunk)
        assert k not in issued and not stored & set(range(lo, hi))
        issued.append(k)
        ring[k % slots] = src[:, lo:hi].copy()
        holds[k % slots] = k

    for k in range(min(slots - 1, nc)):
        issue(k)
    for k in range(nc):
        if k + slots - 1 < nc:
            assert k == 0 or holds[(k - 1) % slots] == k - 1  # run already
            issue(k + slots - 1)
        assert holds[k % slots] == k
        chunk_x = ring[k % slots]
        for i0 in range(0, chunk_x.shape[1], BATCH):
            out = np.empty((c, BATCH), F)
            for s in range(BATCH):
                v = chunk_x[:, i0 + s]
                y = ((x1 * b1).astype(F) + (v * b0).astype(F)).astype(F)
                y = (y - (y1 * a1).astype(F)).astype(F)
                x1, y1 = v, y
                out[:, s] = y
            at = k * chunk + i0
            dst[:, at:at + BATCH] = out
            stored.update(range(at, at + BATCH))
    assert issued == list(range(nc)) and stored == set(range(n))
    assert np.isnan(dst[:, n:]).all()  # nothing stored past the row
    return dst[:, :n].copy(), np.stack([x1, y1], axis=1)


def _case(c: int, nb: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((c, BATCH * nb)).astype(F)
    st = rng.standard_normal((c, 2)).astype(F)
    return x, st


def _plain(x, st):
    s = {"x_hist": torch.from_numpy(st[:, :1].copy()),
         "y_hist": torch.from_numpy(st[:, 1:].copy())}
    new, y = iir_filter(CO.deemph_b, CO.deemph_a, s, torch.from_numpy(x))
    return y.numpy(), torch.cat([new["x_hist"], new["y_hist"]], 1).numpy()


@pytest.mark.parametrize("in_place", [True, False],
                         ids=["in_place", "out_of_place"])
@pytest.mark.parametrize("chunk,slots", SHAPES,
                         ids=[f"{k}x{s}" for k, s in SHAPES])
@pytest.mark.parametrize("nb", NBS)
def test_deemph_schedule_equals_iir_filter(nb, chunk, slots, in_place):
    """The chunks in flight, the ring's slots in turn and the short last
    chunk, in place over the row and into a separate output, equal
    ``iir_filter`` bit for bit, outputs and state; no load reaches past
    the row or reads a step already stored."""
    x, st = _case(5, nb, seed=nb * 10 + slots)
    want_y, want_st = _plain(x, st)
    y, new = deemph_model(x, st, CO.deemph_b, CO.deemph_a, chunk, slots,
                          in_place)
    np.testing.assert_array_equal(y, want_y)
    np.testing.assert_array_equal(new, want_st)


def test_deemph_wrapper_on_cpu_and_refusals():
    """On CPU tensors the wrapper is ``iir_filter``; a step count that is
    not a whole number of batches, or ``out=``, is refused before any
    launch.  The kernel's ring fits the shared memory a block may use."""
    x, st = _case(3, 4, seed=1)
    s = {"x_hist": torch.from_numpy(st[:, :1].copy()),
         "y_hist": torch.from_numpy(st[:, 1:].copy())}
    new, y = tmid.deemph(CO.deemph_b, CO.deemph_a, s, torch.from_numpy(x))
    want_y, want_st = _plain(x, st)
    np.testing.assert_array_equal(y.numpy(), want_y)
    np.testing.assert_array_equal(
        torch.cat([new["x_hist"], new["y_hist"]], 1).numpy(), want_st)
    xt = torch.from_numpy(x)
    for kw, xx in (({}, xt[:, :40]), ({"out": xt}, xt)):
        with pytest.raises(ValueError):
            tmid.deemph(CO.deemph_b, CO.deemph_a, s, xx, **kw)
    # whole batches a chunk, a ring of two slots or more, within the
    # shared memory a block may use (rings and mbarriers)
    lanes = tmid.DEEMPH_LANES
    assert CHUNK % BATCH == 0 and SLOTS >= 2
    assert 4 * lanes * (SLOTS * CHUNK + 4) + 8 * lanes * SLOTS <= 232448


@pytest.mark.parametrize("c", [1, 5, 8, 9, 40, 2048])
@pytest.mark.parametrize("route", ["split", "launches"])
def test_plan_deemph_on_its_lanes(route, c):
    """Both routes plan the de-emphasis where it is on on DEEMPH_LANES
    channels a block: the grid covers every channel, its last block
    partial where C is not a multiple.  The launches route serves only a
    block shorter than a carried tail (B/8 = 48 < the Hilbert tail's
    64)."""
    n4 = 32768 if route == "split" else 96
    assert tmid.midend_route(CO, n4) == route
    plan = dict(tmid.midend_plan(CO, CFG, c, n4))
    (grid,) = plan["k12_deemph_kernel"]
    assert grid * tmid.DEEMPH_LANES >= c > (grid - 1) * tmid.DEEMPH_LANES


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_model_in_the_mid_end_matches_pallas(monkeypatch):
    """The plain mid end with the model in the de-emphasis's place (the
    kernel's ring, in place) against ``midend_pallas``
    with de-emphasis on (interpret), two blocks of a station and noise
    channels, at test_torch_split.py's tolerances: re/im 2e-5, theta 1e-4
    cycles on the station's channel and 1e-3 on noise, the IIR and Hilbert
    state 2e-5, the ds x2 tail exact, agc_pilot rtol 2e-4."""
    calls = []

    def model(b, a, state, x):
        st = torch.cat([state["x_hist"], state["y_hist"]], 1).numpy()
        y, new = deemph_model(x.numpy(), st, b, a, CHUNK, SLOTS, True)
        calls.append(x.shape)
        return ({"x_hist": torch.from_numpy(new[:, :1].copy()),
                 "y_hist": torch.from_numpy(new[:, 1:].copy())},
                torch.from_numpy(y))

    monkeypatch.setattr(tmid, "iir_filter", model)
    kw = dict(use_deemphasis_filter=True, deemphasis_cutoff_us=50)
    tcfg, jcfg = DemodConfig(**kw), JDemodConfig(**kw)
    co_j, co_t = jdemod.make_coeffs(jcfg), tdemod.make_coeffs(tcfg)
    c, b = 3, 8192
    rng = np.random.default_rng(5)
    cf = (rng.standard_normal((c, 2 * b))
          + 1j * rng.standard_normal((c, 2 * b))) * 40
    cf[0] = FMModulator(ModulatorConfig()).generate(2 * b, left_hz=1000.0,
                                                    right_hz=3000.0)
    cf = cf.astype(np.complex64)
    st_j = jdemod.demod_init_state(jcfg, c)
    st_t = state_from_numpy(_np(st_j))
    tail_x, prev_x = st_j["ds_fm_in"], st_j["disc_prev_theta"]
    for blk in range(2):
        xb = cf[:, blk * b:(blk + 1) * b]
        tail_x, fm_in = polyphase_decimate_p(
            co_j.taps_fm_in, tail_x,
            (jnp.asarray(xb.real), jnp.asarray(xb.imag)), 4)
        prev_x, fmd = fm_discriminate_p(prev_x, fm_in,
                                        jcfg.analog.f_wbfm_deviation,
                                        float(jcfg.rates.fs_fm_in))
        st_j, (re_j, im_j), th_j = midend_pallas(co_j, jcfg, st_j, fmd,
                                                 interpret=True)
        st_t, (re_t, im_t), th_t = tmid.midend(
            co_t, tcfg, st_t, torch.from_numpy(np.array(fmd)))
        np.testing.assert_allclose(re_t.numpy(), np.asarray(re_j), atol=2e-5)
        np.testing.assert_allclose(im_t.numpy(), np.asarray(im_j), atol=2e-5)
        d = th_t.numpy().astype(np.float64) - np.asarray(th_j)
        d = np.abs(d - np.round(d))
        assert d[0].max() <= 1e-4 and d.max() <= 1e-3, d.max(axis=1)
        sj, stn = _np(st_j), state_to_numpy(st_t)
        np.testing.assert_array_equal(stn["ds_fm_out"], sj["ds_fm_out"])
        np.testing.assert_allclose(stn["hilbert"], sj["hilbert"], atol=2e-5)
        for key in ("peak_pilot", "deemph"):
            for h in ("x_hist", "y_hist"):
                np.testing.assert_allclose(stn[key][h], sj[key][h],
                                           atol=2e-5, err_msg=f"{key} {h}")
        np.testing.assert_allclose(stn["agc_pilot"], sj["agc_pilot"],
                                   rtol=2e-4)
    assert calls == [(c, b // 8)] * 2  # the model ran in both blocks
