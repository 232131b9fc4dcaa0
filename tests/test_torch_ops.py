"""The port's ops (plain PyTorch) against the JAX package's ops on the
same numpy inputs, including split parity: two half blocks through the
carried state equal one whole block."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_radio_tpu.config import DemodConfig as JDemodConfig
from fm_radio_tpu.kernels.pll_pallas import _atan2 as j_atan2
from fm_radio_tpu.models import demod as jdemod
from fm_radio_tpu.ops import agc as jagc
from fm_radio_tpu.ops import cmath as jcm
from fm_radio_tpu.ops import fir as jfir
from fm_radio_tpu.ops import iir as jiir
from fm_radio_tpu.ops.discriminator import fm_discriminate_p as j_disc
from fm_radio_tpu.ops.mixer import apply_harmonic_pll_p as j_mix
from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.models import demod as tdemod
from fm_radio_tpu_torch.ops import agc as tagc
from fm_radio_tpu_torch.ops import cmath as tcm
from fm_radio_tpu_torch.ops import fir as tfir
from fm_radio_tpu_torch.ops import iir as tiir
from fm_radio_tpu_torch.ops.discriminator import fm_discriminate_p as t_disc
from fm_radio_tpu_torch.ops.mixer import apply_harmonic_pll_p as t_mix

CFG = DemodConfig(frontend_int8=True)
JCFG = JDemodConfig(frontend_int8=True)
RNG = np.random.default_rng(21)
CO_J = jdemod.make_coeffs(JCFG)
CO_T = tdemod.make_coeffs(CFG)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(a, b, atol, what=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0, err_msg=what)


def test_cmath_matches_jax():
    x = RNG.uniform(-0.5, 0.5, 4096).astype(np.float32)
    x[:4] = [-0.5, 0.5, 0.0, 0.25]
    _close(tcm.chebyshev_sine(_t(x)), jcm.chebyshev_sine(jnp.asarray(x)),
           atol=1e-7, what="chebyshev_sine")
    t = RNG.uniform(-3, 3, 4096).astype(np.float32)
    t[:4] = [0.5, -0.5, 1.5, 2.5]  # half-way cases round to even
    np.testing.assert_array_equal(tcm.wrap_cycles(_t(t)).numpy(),
                                  np.asarray(jcm.wrap_cycles(jnp.asarray(t))))
    p = RNG.uniform(-2.9 * np.pi, 2.9 * np.pi, 4096).astype(np.float32)
    np.testing.assert_array_equal(tcm.wrap_phase(_t(p)).numpy(),
                                  np.asarray(jcm.wrap_phase(jnp.asarray(p))))
    y, x2 = RNG.standard_normal((2, 4096)).astype(np.float32)
    y[:4], x2[:4] = [0, 0, 1, -1], [-1, 0, 0, 0]
    _close(tcm.atan2_poly(_t(y), _t(x2)), j_atan2(jnp.asarray(y),
                                                   jnp.asarray(x2)),
           atol=5e-7, what="atan2_poly")
    assert abs(float(tcm.atan2_poly(_t(y), _t(x2))[0]) - np.pi) < 1e-6


@pytest.mark.parametrize("name,m", [("taps_audio_lpr", 4), ("taps_rds", 8),
                                    ("taps_fm_out", 2)])
def test_polyphase_decimate_matches_jax_and_splits(name, m):
    c, n = 3, 1024
    taps_j, taps_t = getattr(CO_J, name), getattr(CO_T, name)
    xr, xi = RNG.standard_normal((2, c, 2 * n)).astype(np.float32)
    st0 = np.zeros((c, taps_t.shape[0] - m), np.complex64)
    sj, yj = jfir.polyphase_decimate_p(taps_j, jnp.asarray(st0),
                                       (jnp.asarray(xr), jnp.asarray(xi)), m)
    st, yt = tfir.polyphase_decimate_p(taps_t, _t(st0), (_t(xr), _t(xi)), m)
    for a, b in zip(yt, yj):
        _close(a, b, atol=2e-5, what="y")
    _close(st, sj, atol=0, what="tail")
    # two halves through the carried tail == one block, bit for bit
    sh, ya = tfir.polyphase_decimate_p(taps_t, _t(st0),
                                       (_t(xr[:, :n]), _t(xi[:, :n])), m)
    sh, yb = tfir.polyphase_decimate_p(taps_t, sh,
                                       (_t(xr[:, n:]), _t(xi[:, n:])), m)
    for k in range(2):
        assert torch.equal(torch.cat([ya[k], yb[k]], -1), yt[k])
    assert torch.equal(sh, st)
    # imag_out=False keeps only the real output and still carries im
    s1, y1 = tfir.polyphase_decimate_p(taps_t, _t(st0), (_t(xr), _t(xi)), m,
                                       imag_out=False)
    assert torch.equal(y1, yt[0]) and torch.equal(s1, st)


def test_hilbert_matches_jax():
    c, n = 2, 1024
    x = RNG.standard_normal((c, 2 * n)).astype(np.float32)
    st0 = np.zeros((c, 64), np.float32)
    sj, (rj, ij) = jfir.hilbert_fir_p(CO_J.taps_hilbert, jnp.asarray(st0),
                                      jnp.asarray(x))
    st, (rt, it) = tfir.hilbert_fir_p(CO_T.taps_hilbert, _t(st0), _t(x))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    _close(it, ij, atol=2e-5, what="im")
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("which", ["peak", "deemph"])
def test_iir_matches_jax_and_splits(which):
    if which == "peak":
        b, a = CO_J.peak_b, CO_J.peak_a
        bt, at = CO_T.peak_b, CO_T.peak_a
    else:
        kw = {"frontend_int8": True, "use_deemphasis_filter": True,
              "deemphasis_cutoff_us": 50}
        cj = jdemod.make_coeffs(JDemodConfig(**kw))
        ct = tdemod.make_coeffs(DemodConfig(**kw))
        b, a, bt, at = cj.deemph_b, cj.deemph_a, ct.deemph_b, ct.deemph_a
    c, n = 3, 512
    r = len(at) - 1
    x = RNG.standard_normal((c, 2 * n)).astype(np.float32)
    st0 = {"x_hist": RNG.standard_normal((c, r)).astype(np.float32),
           "y_hist": RNG.standard_normal((c, r)).astype(np.float32)}
    sj, yj = jiir.iir_filter(b, a, {k: jnp.asarray(v) for k, v in st0.items()},
                             jnp.asarray(x), method="scan")
    stt = {k: _t(v) for k, v in st0.items()}
    s_t, y_t = tiir.iir_filter(bt, at, stt, _t(x))
    _close(y_t, yj, atol=1e-4, what="y")
    for k in sj:
        _close(s_t[k], sj[k], atol=1e-4, what=k)
    # split parity, exact
    s_a, y_a = tiir.iir_filter(bt, at, stt, _t(x[:, :n]))
    s_b, y_b = tiir.iir_filter(bt, at, s_a, _t(x[:, n:]))
    assert torch.equal(torch.cat([y_a, y_b], -1), y_t)
    for k in s_t:
        assert torch.equal(s_b[k], s_t[k])
    # planes: re rows then im rows of one stacked state
    st2 = {k: torch.cat([v, v]) for k, v in stt.items()}
    s_p, (pr, pi) = tiir.iir_filter_planes(bt, at, st2, (_t(x), _t(x)))
    assert torch.equal(pr, y_t) and torch.equal(pi, y_t)
    assert s_p["y_hist"].shape == (2 * c, r)


def test_agc_matches_jax():
    c, n = 4, 2048
    xr, xi = (RNG.standard_normal((2, c, n)) * 0.3).astype(np.float32)
    xr[3] = xi[3] = 0.0  # silence holds the gain
    g0 = np.array([0.1, 0.5, 2.0, 0.1], np.float32)
    gj = jagc.agc_update_gain(jnp.asarray(g0), (jnp.asarray(xr),
                                                jnp.asarray(xi)), 1.0)
    gt = tagc.agc_update_gain(_t(g0), (_t(xr), _t(xi)), 1.0)
    _close(gt, gj, atol=1e-6, what="agc_update_gain")
    assert float(gt[3]) == np.float32(0.1)
    gj2, (yrj, yij) = jagc.agc_process_p(jnp.asarray(g0), (jnp.asarray(xr),
                                                           jnp.asarray(xi)), 0.5)
    gt2, (yrt, yit) = tagc.agc_process_p(_t(g0), (_t(xr), _t(xi)), 0.5)
    _close(gt2, gj2, atol=1e-6, what="agc_process_p gain")
    _close(yrt, yrj, atol=1e-6, what="re")
    _close(yit, yij, atol=1e-6, what="im")
    np.testing.assert_array_equal(tagc.agc_init_state(3).numpy(),
                                  np.asarray(jagc.agc_init_state(3)))


def test_discriminator_matches_jax_and_splits():
    c, n = 2, 1024
    ph = np.cumsum(RNG.standard_normal((c, 2 * n)) * 0.4, -1)
    xr, xi = np.cos(ph).astype(np.float32), np.sin(ph).astype(np.float32)
    p0 = np.array([0.3, -2.0], np.float32)
    fd, fs = CFG.analog.f_wbfm_deviation, float(CFG.rates.fs_fm_in)
    pj, yj = j_disc(jnp.asarray(p0), (jnp.asarray(xr), jnp.asarray(xi)), fd, fs)
    pt, yt = t_disc(_t(p0), (_t(xr), _t(xi)), fd, fs)
    _close(yt, yj, atol=1e-5, what="y")
    _close(pt, pj, atol=1e-6, what="prev")
    pa, ya = t_disc(_t(p0), (_t(xr[:, :n]), _t(xi[:, :n])), fd, fs)
    pb, yb = t_disc(pa, (_t(xr[:, n:]), _t(xi[:, n:])), fd, fs)
    assert torch.equal(torch.cat([ya, yb], -1), yt) and torch.equal(pb, pt)


@pytest.mark.parametrize("harmonic,offset", [(2.0, "per_channel"),
                                             (3.0, 0.0)])
def test_mixer_matches_jax(harmonic, offset):
    c, n = 3, 2048
    dt = (RNG.random((c, n)) - 0.5).astype(np.float32)
    xr, xi = RNG.standard_normal((2, c, n)).astype(np.float32)
    off = (RNG.standard_normal(c).astype(np.float32) * 0.1
           if offset == "per_channel" else offset)
    yj = j_mix(jnp.asarray(dt), (jnp.asarray(xr), jnp.asarray(xi)), harmonic,
               jnp.asarray(off))
    yt = t_mix(_t(dt), (_t(xr), _t(xi)), harmonic,
               _t(off) if offset == "per_channel" else off)
    for a, b in zip(yt, yj):
        _close(a, b, atol=2e-6, what="mix")
