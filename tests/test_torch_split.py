"""The split path's kernels, run here as their plain PyTorch versions (CPU
tensors), against the JAX package.

K1 (``kernels/frontend.py``) on each of its six forms against
``ds4_disc_pallas`` in interpret mode (the TPU kernel's bf16 splits,
honest in interpret mode) and against XLA's ``polyphase_decimate_p`` +
``fm_discriminate_p`` (demod.py:417-423, exact float32); K2
(``kernels/midend.py``) against ``midend_pallas`` with de-emphasis off and
on; and the split int8 path against K12, bit for bit.  Each test streams
two blocks from one start state, each package carrying its own state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_radio_tpu.config import DemodConfig as JDemodConfig
from fm_radio_tpu.io.synth import FMModulator, ModulatorConfig
from fm_radio_tpu.kernels.frontend_pallas import ds4_disc_pallas
from fm_radio_tpu.kernels.midend_pallas import midend_pallas
from fm_radio_tpu.models import demod as jdemod
from fm_radio_tpu.ops.discriminator import fm_discriminate_p
from fm_radio_tpu.ops.fir import polyphase_decimate_p
from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.kernels import frontend as tfront
from fm_radio_tpu_torch.kernels import midend as tmid
from fm_radio_tpu_torch.models import demod as tdemod
from fm_radio_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
from fm_radio_tpu_torch.utils.transfer import pack_iq_u8, split_iq_i8

C, B = 3, 8192


def cfgs(**kw):
    """The port's and the JAX package's DemodConfig from the same keyword
    arguments."""
    return DemodConfig(**kw), JDemodConfig(**kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _baseband(c, n, seed):
    """(complex64 [C, n] not on the u8 grid, u8 [C, n, 2] of it quantized):
    channel 0 a stereo FM station, the others complex Gaussian noise of rms
    ~57 (so the int8 forms see the full byte range)."""
    rng = np.random.default_rng(seed)
    cf = (rng.standard_normal((c, n)) + 1j * rng.standard_normal((c, n))) * 40
    cf[0] = FMModulator(ModulatorConfig()).generate(n, left_hz=1000.0,
                                                    right_hz=3000.0)
    cf = cf.astype(np.complex64)
    u8 = np.clip(np.round(np.stack([cf.real, cf.imag], -1) + 127.0), 0, 255)
    return cf, u8.astype(np.uint8)


# form -> (K1 input from (cf, u8), int8 taps); the TPU kernel takes int8
# taps exactly where int8_dots holds (integer input and frontend_int8)
def _planes_float(cf, u8):
    return np.stack([cf.real, cf.imag]).astype(np.float32)


def _planes_int(cf, u8):
    return np.moveaxis(u8.astype(np.float32) - 127.0, -1, 0).copy()


FORMS = {
    "planes_float": (_planes_float, False),
    "planes_int8": (_planes_int, True),
    "words_float": (lambda cf, u8: pack_iq_u8(u8), False),
    "words_int8": (lambda cf, u8: pack_iq_u8(u8), True),
    "i8_float": (lambda cf, u8: split_iq_i8(u8), False),
    "i8_direct": (lambda cf, u8: split_iq_i8(u8), True),
}


def _jax_input(x):
    """What ``ds4_disc_pallas`` takes: a plane tuple, words or int8."""
    if x.dtype == np.float32 and x.ndim == 3:
        return jnp.asarray(x[0]), jnp.asarray(x[1])
    return jnp.asarray(x)


def _run_k1(ct, cfg, st, x, int8_taps):
    xt = torch.from_numpy(np.ascontiguousarray(x))
    if x.dtype == np.int8 and int8_taps:
        return tfront.frontend_i8(ct, cfg, st, xt)
    return tfront.frontend(ct, cfg, st, xt, int8_taps)


@pytest.mark.parametrize("form", list(FORMS))
def test_frontend_plain_matches_pallas(form):
    """Tolerances (fm_demod, radians x scale): float taps 1e-4 — the
    Pallas kernel's bf16x2 / bf16x3 band dots are ~2^-17 .. 2^-21 relative
    (measured 5.2e-5 on |fm_demod| ~0.85); int8 taps 1e-6 — the same
    integer dots, float32 combine and atan2 (measured 1.8e-7).  The carried
    tail is exact."""
    make, int8_taps = FORMS[form]
    tcfg, jcfg = cfgs()
    co_j, co_t = jdemod.make_coeffs(jcfg), tdemod.make_coeffs(tcfg)
    cf, u8 = _baseband(C, 2 * B, seed=7)
    x = make(cf, u8)
    st_j = jdemod.demod_init_state(jcfg, C)
    st_t = state_from_numpy(_np(st_j))
    tail_j = (st_j["ds_fm_in"].real, st_j["ds_fm_in"].imag)
    prev_j = st_j["disc_prev_theta"]
    atol = 1e-6 if int8_taps else 1e-4
    for blk in range(2):
        xb = np.ascontiguousarray(x[..., blk * B : (blk + 1) * B])
        tail_j, prev_j, y_j = ds4_disc_pallas(
            co_j.taps_fm_in, tail_j, prev_j, _jax_input(xb),
            jcfg.analog.f_wbfm_deviation, float(jcfg.rates.fs_fm_in),
            interpret=True, int_input=form != "planes_float",
            int8_dots=int8_taps)
        st_t, y_t = _run_k1(co_t, tcfg, st_t, xb, int8_taps)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=atol,
                                   rtol=0, err_msg=f"{form} block {blk}")
        tail = st_t["ds_fm_in"].numpy()
        np.testing.assert_array_equal(tail.real, np.asarray(tail_j[0]))
        np.testing.assert_array_equal(tail.imag, np.asarray(tail_j[1]))
        np.testing.assert_allclose(st_t["disc_prev_theta"].numpy(),
                                   np.asarray(prev_j), atol=atol * 0.1,
                                   rtol=0, err_msg="disc_prev_theta")


@pytest.mark.parametrize("form", list(FORMS))
def test_frontend_plain_matches_xla(form):
    """Against XLA's exact float32 ops on the same centred planes.  Float
    taps: 2e-6 on every channel (measured 8.3e-7: one fixed summation
    order against XLA's, and the polynomial atan2 against arctan2).  Int8
    taps carry the TPU kernel's two-plane tap quantization (~-89 dB,
    quantize_band_int8): 1e-3 on the station's channel (measured 3.4e-4
    in the first block, from the zero start state; 1.5e-5 after), whose
    constant envelope keeps the angle well conditioned — the noise
    channels pass near 0, where any tap error turns the angle freely."""
    make, int8_taps = FORMS[form]
    tcfg, jcfg = cfgs()
    co_j, co_t = jdemod.make_coeffs(jcfg), tdemod.make_coeffs(tcfg)
    cf, u8 = _baseband(C, 2 * B, seed=11)
    x = make(cf, u8)
    st_j = jdemod.demod_init_state(jcfg, C)
    st_t = state_from_numpy(_np(st_j))
    tail_x, prev_x = st_j["ds_fm_in"], st_j["disc_prev_theta"]
    rows = slice(0, 1) if int8_taps else slice(None)
    atol = 1e-3 if int8_taps else 2e-6
    for blk in range(2):
        xb = np.ascontiguousarray(x[..., blk * B : (blk + 1) * B])
        xr, xi = (p.numpy() for p in
                  tfront.input_planes(torch.from_numpy(xb)))
        tail_x, fm_in = polyphase_decimate_p(
            co_j.taps_fm_in, tail_x, (jnp.asarray(xr), jnp.asarray(xi)), 4)
        prev_x, y_x = fm_discriminate_p(prev_x, fm_in,
                                        jcfg.analog.f_wbfm_deviation,
                                        float(jcfg.rates.fs_fm_in))
        st_t, y_t = _run_k1(co_t, tcfg, st_t, xb, int8_taps)
        np.testing.assert_allclose(y_t.numpy()[rows], np.asarray(y_x)[rows],
                                   atol=atol, rtol=0,
                                   err_msg=f"{form} block {blk}")
        np.testing.assert_array_equal(st_t["ds_fm_in"].numpy(),
                                      np.asarray(tail_x))


@pytest.mark.parametrize("use_deemph", [False, True])
def test_midend_plain_matches_pallas(use_deemph):
    """K2 on the same fm_demod (XLA's front end on a station and noise)
    against ``midend_pallas`` (interpret).  K12's tolerances: re/im 2e-5,
    theta 1e-4 cycles on the station's channel (measured 5.2e-6 and
    3.7e-5: the Pallas IIRs run as bf16x4 Toeplitz products), the IIR and
    Hilbert state 2e-5, the ds x2 tail exact, agc_pilot rtol 2e-4 (its
    power is summed in another order).  On the noise channels theta is
    held to 1e-3 (measured 2.8e-4): there the 19 kHz peak filter's output
    is narrowband noise whose amplitude passes near 0, where the same
    float32-level error turns the angle further."""
    tcfg, jcfg = cfgs(use_deemphasis_filter=use_deemph,
                      deemphasis_cutoff_us=50)
    co_j, co_t = jdemod.make_coeffs(jcfg), tdemod.make_coeffs(tcfg)
    cf, _ = _baseband(C, 2 * B, seed=5)
    st_j = jdemod.demod_init_state(jcfg, C)
    st_t = state_from_numpy(_np(st_j))
    tail_x, prev_x = st_j["ds_fm_in"], st_j["disc_prev_theta"]
    for blk in range(2):
        xb = cf[:, blk * B : (blk + 1) * B]
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


@pytest.mark.parametrize("use_deemph", [False, True])
def test_split_int8_path_equals_k12(use_deemph):
    """``demod_block`` with ``k12_fusion="off"`` (the int8-direct K1, then
    K2) against the fused K12 on the same int8 planes, two blocks: the
    entries each config dispatches to, and every output and state leaf bit
    for bit.  On the CPU ``k12_plain`` is ``frontend_i8_plain`` followed by
    ``midend_plain``, so the arithmetic agrees by construction and this
    checks the dispatch and ``demod_block``'s state plumbing on each path;
    the kernels' equality is held on the card
    (``test_split_kernels_match_plain_on_card``, ``chip_smoke.py``), and
    the plain K12 against Pallas in ``test_k12_plain_matches_pallas``."""
    cfg = DemodConfig(frontend_int8=True, use_deemphasis_filter=use_deemph,
                      deemphasis_cutoff_us=50)
    off = DemodConfig(frontend_int8=True, k12_fusion="off",
                      use_deemphasis_filter=use_deemph,
                      deemphasis_cutoff_us=50)
    co = tdemod.make_coeffs(cfg)
    _, u8 = _baseband(C, 2 * B, seed=3)
    x = torch.from_numpy(split_iq_i8(u8))
    st_f = st_s = tdemod.demod_init_state(cfg, C)
    for blk in range(2):
        xb = x[..., blk * B : (blk + 1) * B]
        calls_f, calls_s = {}, {}
        st_f, o_f = tdemod.demod_block(cfg, co, st_f, xb, record=calls_f)
        st_s, o_s = tdemod.demod_block(off, co, st_s, xb, record=calls_s)
        assert list(calls_f) == ["k12", "pll", "extract", "bpsk"]
        assert list(calls_s) == ["frontend_i8", "midend", "pll", "extract",
                                 "bpsk"]
        for k in o_f:
            assert torch.equal(o_f[k], o_s[k]), k
        for (p, u), (q, v) in zip(
                jax.tree_util.tree_leaves_with_path(state_to_numpy(st_f)),
                jax.tree_util.tree_leaves_with_path(state_to_numpy(st_s))):
            assert p == q
            np.testing.assert_array_equal(u, v, err_msg=str(p))


@pytest.mark.parametrize("case", [
    # (form, DemodConfig kwargs) -> the K1 entry and taps demod_block takes
    ("complex", {}, "frontend", False),
    ("planes", {"frontend_int8": True}, "frontend", False),
    ("planes", {"frontend_int8": True, "assume_integer_input": True},
     "frontend", True),
    ("words", {}, "frontend", False),
    ("words", {"frontend_int8": True}, "frontend", True),
    ("i8", {}, "frontend", False),
    ("i8", {"frontend_int8": True, "k12_fusion": "off"}, "frontend_i8",
     True),
    ("i8", {"frontend_int8": True, "frontend_band_no": 256}, "k12", True),
], ids=lambda v: v if isinstance(v, str) else None)
def test_demod_block_takes_the_jax_gate(case):
    """The front end each form and configuration reaches, as demod.py:
    339-413 chooses it (int8_dots = frontend_int8 and (direct or
    assume_integer_input); the fused K12 only for int8 planes with
    frontend_int8 and k12_fusion != "off"; frontend_band_no is a TPU tiling
    knob and changes nothing)."""
    form, kw, entry, int8_taps = case
    cfg = DemodConfig(**kw)
    c, b = 2, 8192
    x = {"complex": torch.zeros((c, b), dtype=torch.complex64),
         "planes": torch.zeros((2, c, b)),
         "words": torch.full((c, b), 127.0 * 256 + 127.0),
         "i8": torch.zeros((2, c, b), dtype=torch.int8)}[form]
    calls = {}
    tdemod.demod_block(cfg, tdemod.make_coeffs(cfg),
                       tdemod.demod_init_state(cfg, c), x, record=calls)
    assert entry in calls
    if entry == "frontend":
        assert calls["frontend"][4] is int8_taps
        # complex64 reaches K1 as it is (the kernel reads it in place)
        assert tfront.input_form(calls["frontend"][3]) == form
