"""The int16 inter-stage format (``DemodConfig.interstage_i16``), run here as
the plain PyTorch versions (CPU tensors), against the JAX package.

``kernels/qformat.py`` against the JAX package's on edge values; each stage
fed the same inputs on both sides (K1 with ``out_i16`` against
``ds4_disc_pallas``, K2 on int16 fm_demod with ``out_i16`` off and on
against ``midend_pallas``, the PLL on int16 theta against
``pilot_pll_pallas_theta`` at a channel-major C = 8 and at C = 5, extract
on its three type combinations against ``extract_pallas``; the Pallas
kernels in interpret mode); within the port, every int16 output equal to
``q_i16`` of the float32 output; ``demod_block`` against JAX
``demod_block(loop_impl="pallas", interstage_i16=True)`` on a stereo+RDS
station at C = 8 and C = 5; and the route each shape takes, against the
JAX gates.

An int16 output is held to ceil(float tolerance * scale) + 1 LSB of the
JAX kernel's, the float tolerance being the one the float32 stage's test
states (tests/test_torch_split.py, tests/test_torch_kernels.py): a value
within the float tolerance may round to a neighbouring integer.  Each
comparison prints the share of samples that differ.  The kernels equal
these plain versions bit for bit on the card (chip_smoke.py,
tests/test_torch_gpu.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_radio_tpu.config import DemodConfig as JDemodConfig
from fm_radio_tpu.io.synth import FMModulator, ModulatorConfig
from fm_radio_tpu.kernels import (
    bpsk_pallas,
    chain_pallas,
    extract_pallas,
    frontend_pallas,
    k12_pallas,
    midend_pallas,
    pll_pallas,
)
from fm_radio_tpu.kernels import qformat as jq
from fm_radio_tpu.models import demod as jdemod
from fm_radio_tpu.ops.discriminator import fm_discriminate_p
from fm_radio_tpu.ops.fir import polyphase_decimate_p
from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.io.pcm import c64_to_u8
from fm_radio_tpu_torch.kernels import extract as textract
from fm_radio_tpu_torch.kernels import frontend as tfront
from fm_radio_tpu_torch.kernels import midend as tmid
from fm_radio_tpu_torch.kernels import pll as tpll
from fm_radio_tpu_torch.kernels import qformat as tq
from fm_radio_tpu_torch.models import demod as tdemod
from fm_radio_tpu_torch.rds.chain import make_rds_chain
from fm_radio_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
from fm_radio_tpu_torch.utils.transfer import pack_iq_u8, split_iq_i8

GROUPS = [
    (0x1234, (0 << 12) | (1 << 10) | 0b00000, 0xE101, 0x4142),  # 0A
    (0x1234, (2 << 12) | 0b00000, 0x4845, 0x4C4C),              # 2A
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain loops run many small tensor ops; with pytest-xdist
    workers sharing the cores, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(**kw):
    """The port's and the JAX package's DemodConfig from the same keyword
    arguments."""
    return DemodConfig(**kw), JDemodConfig(**kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _start(jcfg, c):
    st_j = jdemod.demod_init_state(jcfg, c)
    return st_j, state_from_numpy(_np(st_j))


def _lsb(tol: float, scale: float) -> int:
    """The int16 bound for a float tolerance: ceil(tol * scale) + 1."""
    return math.ceil(tol * scale) + 1


def _i16_close(a, b, lsb: int, what: str, wrap: bool = False):
    """Two int16 tensors within ``lsb`` (phases wrapped around the 2^16
    cycle, so +-0.5 cycles on either side of the cut count as near);
    prints the share of samples that differ."""
    a = np.asarray(a).astype(np.int64)
    b = np.asarray(b).astype(np.int64)
    assert a.dtype == b.dtype
    d = a - b
    if wrap:
        d = (d + 32768) % 65536 - 32768
    share = float(np.mean(d != 0))
    print(f"{what}: {share:.3e} of samples differ, max {np.abs(d).max()} "
          f"LSB (bound {lsb})")
    assert np.abs(d).max() <= lsb, (what, np.abs(d).max(), lsb)


# q_i16 / dq_i16 on the edge values of the format: ties (half to even),
# the +-32767 clip, -0.0, the largest finite float32 inputs
EDGES = {
    "ties": [k + 0.5 for k in range(-4, 4)],
    "clip": [32766.5, 32767.0, 32767.49, 32767.5, 32768.0, 1e6,
             -32767.5, -32768.0, -1e6],
    "neg_zero": [-0.0, 0.0, -1e-30, 1e-30],
    "largest": [float(np.finfo(np.float32).max),
                -float(np.finfo(np.float32).max), 3.0e38, -3.0e38],
}


@pytest.mark.parametrize("scale", [tq.FM_SCALE, tq.IQ_SCALE, tq.PH_SCALE])
@pytest.mark.parametrize("edge", list(EDGES))
def test_q_dq_match_jax(edge, scale):
    """q_i16 on the edge values (given in LSB, so each lands on the
    format's boundary at every scale) and dq_i16 of every int16 value
    equal the JAX package's bit for bit."""
    x = (np.asarray(EDGES[edge], np.float64) / scale).astype(np.float32)
    if edge == "largest":
        x = np.asarray(EDGES[edge], np.float32)
    q_t = tq.q_i16(torch.from_numpy(x), scale).numpy()
    q_j = np.asarray(jq.q_i16(jnp.asarray(x), scale))
    assert q_t.dtype == q_j.dtype == np.int16
    np.testing.assert_array_equal(q_t, q_j)
    v = np.arange(-32768, 32768, dtype=np.int16)
    d_t = tq.dq_i16(torch.from_numpy(v), scale).numpy()
    d_j = np.asarray(jq.dq_i16(jnp.asarray(v), scale))
    assert d_t.dtype == d_j.dtype == np.float32
    np.testing.assert_array_equal(d_t.view(np.int32), d_j.view(np.int32))


def _baseband(c, n, seed):
    """(complex64 [C, n] off the u8 grid, u8 [C, n, 2] of it): channel 0 a
    stereo FM station, the others complex Gaussian noise of rms ~57."""
    rng = np.random.default_rng(seed)
    cf = (rng.standard_normal((c, n)) + 1j * rng.standard_normal((c, n))) * 40
    cf[0] = FMModulator(ModulatorConfig()).generate(n, left_hz=1000.0,
                                                    right_hz=3000.0)
    cf = cf.astype(np.complex64)
    u8 = np.clip(np.round(np.stack([cf.real, cf.imag], -1) + 127.0), 0, 255)
    return cf, u8.astype(np.uint8)


# K1's forms: (input from (cf, u8), int8 taps, the float32 tolerance of
# tests/test_torch_split.py:109 for fm_demod)
K1_FORMS = {
    "i8_direct": (lambda cf, u8: split_iq_i8(u8), True, 1e-6),
    "words_int8": (lambda cf, u8: pack_iq_u8(u8), True, 1e-6),
    "words_float": (lambda cf, u8: pack_iq_u8(u8), False, 1e-4),
    "planes_float": (lambda cf, u8: np.stack([cf.real, cf.imag])
                     .astype(np.float32), False, 1e-4),
}


def _jax_input(x):
    if x.dtype == np.float32 and x.ndim == 3:
        return jnp.asarray(x[0]), jnp.asarray(x[1])
    return jnp.asarray(x)


@pytest.mark.parametrize("form", list(K1_FORMS))
def test_frontend_out_i16_matches_pallas(form):
    """K1 with ``out_i16`` against ``ds4_disc_pallas(out_i16=True)``
    (interpret) on the same input, two blocks: fm_demod within
    ceil(tol * 2^15) + 1 LSB; in the port, fm_demod equal to q_i16 of the
    float32 output; the carried tail exact and the last phase within the
    float stage's 0.1 * tol."""
    make, int8_taps, tol = K1_FORMS[form]
    tcfg, jcfg = cfgs()
    co_j, co_t = jdemod.make_coeffs(jcfg), tdemod.make_coeffs(tcfg)
    c, b = 3, 8192
    cf, u8 = _baseband(c, 2 * b, seed=7)
    x = make(cf, u8)
    st_j, st_t = _start(jcfg, c)
    tail_j = (st_j["ds_fm_in"].real, st_j["ds_fm_in"].imag)
    prev_j = st_j["disc_prev_theta"]
    for blk in range(2):
        xb = np.ascontiguousarray(x[..., blk * b : (blk + 1) * b])
        tail_j, prev_j, y_j = frontend_pallas.ds4_disc_pallas(
            co_j.taps_fm_in, tail_j, prev_j, _jax_input(xb),
            jcfg.analog.f_wbfm_deviation, float(jcfg.rates.fs_fm_in),
            interpret=True, int_input=form != "planes_float",
            int8_dots=int8_taps, out_i16=True)
        xt = torch.from_numpy(xb)
        if form == "i8_direct":
            st_f, y_f = tfront.frontend_i8(co_t, tcfg, st_t, xt)
            st_t, y_t = tfront.frontend_i8(co_t, tcfg, st_t, xt, True)
        else:
            st_f, y_f = tfront.frontend(co_t, tcfg, st_t, xt, int8_taps)
            st_t, y_t = tfront.frontend(co_t, tcfg, st_t, xt, int8_taps,
                                        True)
        assert y_t.dtype == torch.int16 and np.asarray(y_j).dtype == np.int16
        assert torch.equal(y_t, tq.q_i16(y_f, tq.FM_SCALE))
        _i16_close(y_t, y_j, _lsb(tol, tq.FM_SCALE), f"{form} fm_demod")
        tail = st_t["ds_fm_in"].numpy()
        np.testing.assert_array_equal(tail.real, np.asarray(tail_j[0]))
        np.testing.assert_array_equal(tail.imag, np.asarray(tail_j[1]))
        np.testing.assert_allclose(st_t["disc_prev_theta"].numpy(),
                                   np.asarray(prev_j), atol=tol * 0.1,
                                   rtol=0)
        assert torch.equal(st_f["disc_prev_theta"], st_t["disc_prev_theta"])


def _fm_demod_i16(jcfg, co_j, c, n, seed):
    """fm_demod of a station and noise (XLA's float32 front end), as the
    int16 format [C, n/4] numpy, two blocks' worth."""
    cf, _ = _baseband(c, n, seed)
    st = jdemod.demod_init_state(jcfg, c)
    tail, fm_in = polyphase_decimate_p(
        co_j.taps_fm_in, st["ds_fm_in"],
        (jnp.asarray(cf.real), jnp.asarray(cf.imag)), 4)
    _, fmd = fm_discriminate_p(st["disc_prev_theta"], fm_in,
                               jcfg.analog.f_wbfm_deviation,
                               float(jcfg.rates.fs_fm_in))
    return np.asarray(jq.q_i16(fmd, jq.FM_SCALE))


@pytest.mark.parametrize("use_deemph", [False, True], ids=["de_off", "de_on"])
@pytest.mark.parametrize("out_i16", [False, True], ids=["out_f32", "out_i16"])
def test_midend_i16_matches_pallas(out_i16, use_deemph):
    """K2 on the same int16 fm_demod against ``midend_pallas`` (interpret),
    ``out_i16`` off and on, two blocks.  tests/test_torch_split.py:195-208's
    tolerances: re/im 2e-5 (int16: ceil(2e-5 * 2^14) + 1 = 2 LSB), theta
    1e-4 cycles on the station's channel and 1e-3 on the noise channels
    (8 and 67 LSB at 2^16, wrapped); the state as there, the ds x2 tail
    (the dequantised fm_demod) exact.  In the port the int16 outputs equal
    q_i16 of the float32 ones."""
    _midend_vs_pallas(True, out_i16, use_deemph)


@pytest.mark.parametrize("use_deemph", [False, True], ids=["de_off", "de_on"])
@pytest.mark.parametrize("out_i16", [False, True], ids=["out_f32", "out_i16"])
def test_midend_f32_in_matches_pallas(out_i16, use_deemph):
    """The other two formats: K2 on float32 fm_demod (the same values
    dequantised) against ``midend_pallas`` (interpret), ``out_i16`` off and
    on, with the tolerances of :func:`test_midend_i16_matches_pallas`; the
    ds x2 tail is the float32 fm_demod itself."""
    _midend_vs_pallas(False, out_i16, use_deemph)


def _midend_vs_pallas(in_i16: bool, out_i16: bool, use_deemph: bool):
    """K2 against ``midend_pallas`` (interpret) on fm_demod int16 or, as
    float32, its dequantised values: two blocks of C = 3."""
    tcfg, jcfg = cfgs(use_deemphasis_filter=use_deemph,
                      deemphasis_cutoff_us=50)
    co_j, co_t = jdemod.make_coeffs(jcfg), tdemod.make_coeffs(tcfg)
    c, b4 = 3, 2048
    fmd = _fm_demod_i16(jcfg, co_j, c, 8 * b4, seed=5)
    if not in_i16:
        fmd = tq.dq_i16(torch.from_numpy(fmd.copy()), tq.FM_SCALE).numpy()
    st_j, st_t = _start(jcfg, c)
    for blk in range(2):
        xb = np.ascontiguousarray(fmd[:, blk * b4 : (blk + 1) * b4])
        st_j, (re_j, im_j), th_j = midend_pallas.midend_pallas(
            co_j, jcfg, st_j, jnp.asarray(xb), interpret=True,
            out_i16=out_i16)
        xt = torch.from_numpy(xb)
        st_f, (re_f, im_f), th_f = tmid.midend(co_t, tcfg, st_t, xt)
        st_t, (re_t, im_t), th_t = tmid.midend(co_t, tcfg, st_t, xt, out_i16)
        if out_i16:
            for a, f, s in ((re_t, re_f, tq.IQ_SCALE), (im_t, im_f, tq.IQ_SCALE),
                            (th_t, th_f, tq.PH_SCALE)):
                assert torch.equal(a, tq.q_i16(f, s))
            _i16_close(re_t, re_j, _lsb(2e-5, tq.IQ_SCALE), "re")
            _i16_close(im_t, im_j, _lsb(2e-5, tq.IQ_SCALE), "im")
            _i16_close(th_t[:1], np.asarray(th_j)[:1],
                       _lsb(1e-4, tq.PH_SCALE), "theta (station)", wrap=True)
            _i16_close(th_t, th_j, _lsb(1e-3, tq.PH_SCALE), "theta",
                       wrap=True)
        else:
            np.testing.assert_allclose(re_t.numpy(), np.asarray(re_j),
                                       atol=2e-5)
            np.testing.assert_allclose(im_t.numpy(), np.asarray(im_j),
                                       atol=2e-5)
            d = th_t.numpy().astype(np.float64) - np.asarray(th_j)
            d = np.abs(d - np.round(d))
            assert d[0].max() <= 1e-4 and d.max() <= 1e-3, d.max(axis=1)
        sj, stn = _np(st_j), state_to_numpy(st_t)
        np.testing.assert_array_equal(stn["ds_fm_out"], sj["ds_fm_out"])
        np.testing.assert_array_equal(
            stn["ds_fm_out"],
            tq.dq_if_i16(xt[:, -stn["ds_fm_out"].shape[-1]:], tq.FM_SCALE))
        np.testing.assert_allclose(stn["hilbert"], sj["hilbert"], atol=2e-5)
        for key in ("peak_pilot", "deemph"):
            for h in ("x_hist", "y_hist"):
                np.testing.assert_allclose(stn[key][h], sj[key][h],
                                           atol=2e-5, err_msg=f"{key} {h}")
        np.testing.assert_allclose(stn["agc_pilot"], sj["agc_pilot"],
                                   rtol=2e-4)


def _pilot_theta_i16(c, n, seed):
    """The int16 pilot phase (PH_SCALE) of a noisy 19,015 Hz tone at the
    PLL's rate, so the loop locks (tests/test_torch_kernels.py)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / DemodConfig().rates.fs_fm_out
    x = np.exp(1j * (2 * np.pi * 19015.0 * t + 0.7))[None, :] + 0.01 * (
        rng.standard_normal((c, n)) + 1j * rng.standard_normal((c, n)))
    theta = (np.angle(x) / (2 * np.pi)).astype(np.float32)
    return np.asarray(jq.q_i16(jnp.asarray(theta), jq.PH_SCALE))


@pytest.mark.parametrize("c", [8, 5])
def test_pll_i16_matches_pallas(c):
    """The PLL on the same int16 theta against ``pilot_pll_pallas_theta``
    (interpret), two blocks of 1,024 steps.  At C = 8 (a channel-major tile)
    both emit int16 dt, within ceil(2e-6 * 2^16) + 1 = 2 LSB wrapped (the
    float32 test's 2e-6, tests/test_torch_kernels.py) and equal in the port
    to q_i16 of the float32 loop on the dequantised theta; at C = 5 both
    dequantise and emit float32 dt within 2e-6 cycles.  State within
    2 pi * 2e-6: the dt tolerance in the loop's radians (its phase errors
    and their filter), measured 1.1e-5 at C = 8, where XLA on the CPU
    contracts the loop's multiply-adds into FMAs and the port rounds each
    (ROADMAP.md section 3)."""
    tcfg, jcfg = cfgs()
    n = 1024
    theta = _pilot_theta_i16(c, 2 * n, seed=3)
    st_j, st_t = _start(jcfg, c)
    pj, pt = st_j["pll"], st_t["pll"]
    for blk in range(2):
        th = np.ascontiguousarray(theta[:, blk * n : (blk + 1) * n])
        pj, dt_j = pll_pallas.pilot_pll_pallas_theta(jcfg, pj, jnp.asarray(th),
                                                     interpret=True)
        tht = torch.from_numpy(th)
        pf, dt_f = tpll.pilot_pll_theta(tcfg, pt,
                                        tq.dq_i16(tht, tq.PH_SCALE))
        pt, dt_t = tpll.pilot_pll_theta(tcfg, pt, tht)
        for a, b in zip(pf, pt):
            assert torch.equal(a, b)
        if c == 8:
            assert dt_t.dtype == torch.int16
            assert torch.equal(dt_t, tq.q_i16(dt_f, tq.PH_SCALE))
            _i16_close(dt_t, dt_j, _lsb(2e-6, tq.PH_SCALE), "dt", wrap=True)
        else:
            assert dt_t.dtype == torch.float32
            assert np.asarray(dt_j).dtype == np.float32
            assert torch.equal(dt_t, dt_f)
            d = dt_t.numpy().astype(np.float64) - np.asarray(dt_j)
            assert np.abs(d - np.round(d)).max() <= 2e-6
        for name, a, b in zip(pj._fields, pt, pj):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=2 * np.pi * 2e-6, err_msg=name)


@pytest.mark.parametrize("combo", ["i16_i16", "i16_f32", "f32_f32"])
def test_extract_i16_matches_pallas(combo):
    """Extract on the same inputs against ``extract_pallas`` (interpret),
    two blocks: int16 planes (IQ_SCALE) with int16 dt (PH_SCALE), int16
    planes with float32 dt (where the PLL could not take int16), and both
    float32 (the dequantised values).  tests/test_torch_kernels.py's
    tolerances: the outputs 1e-5, the RDS power rtol 2e-4, the state 1e-5;
    the carried L+R tail is the dequantised planes', exact.  In the port
    the result equals the float32 extract on the dequantised values."""
    tcfg, jcfg = cfgs()
    co_j, co_t = jdemod.make_coeffs(jcfg), tdemod.make_coeffs(tcfg)
    c, n = 3, 2048
    rng = np.random.default_rng(13)
    planes = [np.asarray(jq.q_i16(jnp.asarray(
        rng.standard_normal((c, 2 * n)).astype(np.float32) * 0.4),
        jq.IQ_SCALE)) for _ in range(2)]
    dt = np.asarray(jq.q_i16(jnp.asarray(
        rng.random((c, 2 * n)).astype(np.float32) - 0.5), jq.PH_SCALE))
    if combo != "i16_i16":
        dt = np.asarray(jq.dq_i16(jnp.asarray(dt), jq.PH_SCALE))
    if combo == "f32_f32":
        planes = [np.asarray(jq.dq_i16(jnp.asarray(p), jq.IQ_SCALE))
                  for p in planes]
    off = rng.standard_normal((c,)).astype(np.float32) * 0.1
    st_j, st_t = _start(jcfg, c)
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
        out_f = textract.extract(
            co_t, tcfg, st_t, tuple(tq.dq_if_i16(p, tq.IQ_SCALE) for p in pt),
            tq.dq_if_i16(dtt, tq.PH_SCALE))
        st_t, lpr_t, lmr_t, rds_t, pow_t = out_t = textract.extract(
            co_t, tcfg, st_t, pt, dtt)
        for a, b in zip(jax.tree.leaves(out_t[1:]), jax.tree.leaves(out_f[1:])):
            assert torch.equal(a, b)
        np.testing.assert_allclose(lpr_t.numpy(), np.asarray(lpr_j),
                                   atol=1e-5)
        for k in range(2):
            np.testing.assert_allclose(lmr_t[k].numpy(), np.asarray(lmr_j[k]),
                                       atol=1e-5)
            np.testing.assert_allclose(rds_t[k].numpy(), np.asarray(rds_j[k]),
                                       atol=1e-5)
        np.testing.assert_allclose(pow_t.numpy(), np.asarray(pow_j),
                                   rtol=2e-4)
        sj, stn = _np(st_j), state_to_numpy(st_t)
        np.testing.assert_array_equal(stn["ds_audio_lpr"], sj["ds_audio_lpr"])
        for key in ("ds_audio_lmr", "ds_rds"):
            np.testing.assert_allclose(stn[key], sj[key], atol=1e-5,
                                       err_msg=key)


def _snr_db(sig, ref):
    sig, ref = np.asarray(sig, np.float64), np.asarray(ref, np.float64)
    return 10 * np.log10(np.sum(ref ** 2) / (np.sum((sig - ref) ** 2) + 1e-30))


def _rds_bytes(pred, valid):
    """The RDS bytes of one channel's BPSK output (the port's host chain
    on both packages' symbols)."""
    chain = make_rds_chain()
    chain.process_symbols(np.asarray(pred)[np.asarray(valid).astype(bool)])
    return (np.concatenate(chain.rds_bytes) if chain.rds_bytes
            else np.zeros(0, np.uint8))


@pytest.mark.parametrize("c", [8, 5])
def test_demod_block_i16_matches_jax(c):
    """``demod_block(interstage_i16=True)`` on int8 planes of a stereo+RDS
    station (L 1 kHz, R 3 kHz) with its own noise per channel, B = 32,768,
    4 blocks, against JAX ``demod_block(loop_impl="pallas",
    interstage_i16=True)`` (its int16 kernels in interpret mode; at C = 5
    the PLL dequantises on both sides): RDS bytes identical on every
    channel, audio >= 75 dB against JAX's int16 output (ROADMAP.md's bar);
    and the port's int16 route within 55 dB of its float32 route (the JAX
    package's bar for the format, tests/test_e2e.py:312-368), both after
    that test's 64 ms of lock-in.  Measured on the CPU at C = 8: 79.8-87.4
    dB against JAX and 57.1-80.9 dB against the float32 route; the JAX
    package's own int16 route scores the same against its float32 route,
    within 0.2 dB on every channel (a separate run on eight stations)."""
    b, blocks = 32768, 4
    kw = {"frontend_int8": True, "interstage_i16": True}
    tcfg = DemodConfig(**kw)
    jcfg = JDemodConfig(loop_impl="pallas", **kw)
    fcfg = DemodConfig(frontend_int8=True)
    co_j, co_t = jdemod.make_coeffs(jcfg), tdemod.make_coeffs(tcfg)
    mod = FMModulator(ModulatorConfig())
    rng = np.random.default_rng(9)
    iq = mod.generate(b * blocks, left_hz=1000.0, right_hz=3000.0,
                      rds_groups=GROUPS)
    cf = np.stack([iq + 2.0 * (rng.standard_normal(b * blocks)
                               + 1j * rng.standard_normal(b * blocks))
                   for _ in range(c)]).astype(np.complex64)
    x = split_iq_i8(c64_to_u8(cf))
    st_j, st_t = _start(jcfg, c)
    st_f = st_t
    outs = {"jax": [], "port": [], "float": []}
    for blk in range(blocks):
        xb = np.ascontiguousarray(x[..., blk * b : (blk + 1) * b])
        calls = {}
        st_j, oj = jdemod.demod_block(jcfg, co_j, st_j, jnp.asarray(xb))
        st_t, ot = tdemod.demod_block(tcfg, co_t, st_t, torch.from_numpy(xb),
                                      record=calls)
        st_f, of = tdemod.demod_block(fcfg, co_t, st_f, torch.from_numpy(xb))
        assert calls["midend"][3].dtype == torch.int16
        assert calls["extract"][4].dtype == (torch.int16 if c == 8
                                             else torch.float32)
        outs["jax"].append(_np(oj))
        outs["port"].append({k: v.numpy() for k, v in ot.items()})
        outs["float"].append({k: v.numpy() for k, v in of.items()})
    cat = {k: {key: np.concatenate([o[key] for o in v], axis=1)
               for key in v[0]} for k, v in outs.items()}
    settle = 2048  # the loops' lock-in, 64 ms (tests/test_e2e.py:354)
    n_bytes = 0
    for ch in range(c):
        rj = _rds_bytes(cat["jax"]["rds_pred"][ch], cat["jax"]["rds_valid"][ch])
        rt = _rds_bytes(cat["port"]["rds_pred"][ch],
                        cat["port"]["rds_valid"][ch])
        np.testing.assert_array_equal(rt, rj)
        n_bytes += rt.size
        a_t = cat["port"]["audio"][ch, settle:]
        snr_j = _snr_db(a_t, cat["jax"]["audio"][ch, settle:])
        snr_f = _snr_db(a_t, cat["float"]["audio"][ch, settle:])
        print(f"channel {ch}: {rt.size} RDS bytes, audio {snr_j:.1f} dB vs "
              f"JAX int16, {snr_f:.1f} dB vs the port's float32 route")
        assert snr_j >= 75.0 and snr_f >= 55.0, (ch, snr_j, snr_f)
    assert n_bytes > 0


class _Pallas:
    """Stands in for a JAX kernel module's ``pl``: every ``pallas_call``
    records the kernel's name, flags and argument dtypes and returns zeros
    of its output shapes, so only the wrappers' gates and glue run."""

    def __init__(self, real, seen):
        self._real, self._seen = real, seen

    def __getattr__(self, name):
        return getattr(self._real, name)

    def pallas_call(self, kern, *, out_shape, **kw):
        def call(*args):
            fn = getattr(kern, "func", kern)
            self._seen.append((fn.__name__, dict(getattr(kern, "keywords", {})),
                               [a.dtype for a in args]))
            shapes = out_shape if isinstance(out_shape, (list, tuple)) \
                else [out_shape]
            zeros = [jnp.zeros(s.shape, s.dtype) for s in shapes]
            return zeros if isinstance(out_shape, (list, tuple)) else zeros[0]
        return call


F32, I16 = "float32", "int16"


def _jax_route(seen):
    """(fm_demod into K2, K2's planes out, theta into the PLL loop, extract's
    planes and dt) from the recorded Pallas kernels; a stage that ran as
    XLA ops takes and gives float32.  "chain" for the megakernel."""
    by = {name: (kw, dts) for name, kw, dts in seen}
    if any(name.startswith("_chain_kernel") for name in by):
        return "chain"
    mid = by.get("_midend_kernel")
    pll = by.get("_pll_kernel")
    ext = by.get("_extract_kernel")
    return (str(mid[1][0]) if mid else F32,
            I16 if mid and mid[0].get("out_i16") else F32,
            I16 if pll and pll[0].get("io_i16") else F32,
            (I16 if ext and ext[0].get("iq_i16") else F32,
             I16 if ext and ext[0].get("dt_i16") else F32))


def _port_route(calls):
    """The same from the port's recorded arguments: the PLL loop takes
    int16 only on a channel-major tile (kernels/pll.py::channel_major)."""
    if "chain" in calls:
        return "chain"
    d = lambda t: str(t.dtype).removeprefix("torch.")
    pll = calls.get("pll")
    theta = (I16 if pll and pll[2].dtype == torch.int16
             and tpll.channel_major(pll[2].shape[0]) else F32)
    planes = d(calls["extract"][3][0])  # K2's output, as extract takes it
    return (d(calls["midend"][3]), planes, theta,
            (planes, d(calls["extract"][4])))


@pytest.mark.parametrize("case", [
    # (ingest form, C, B, DemodConfig kwargs)
    ("i8", 5, 8192, {}),
    ("i8", 8, 8192, {}),
    ("i8", 200, 8192, {}),        # C > 128, 128 does not divide: XLA / f32
    ("i8", 256, 8192, {}),
    ("i8", 8, 262144, {"pll_time_chunks": 4}),  # the chunked PLL
    ("words", 8, 8192, {"frontend_int8": False,
                        "assume_integer_input": True}),
    ("complex", 8, 8192, {"frontend_int8": False}),
    ("words", 8, 8192, {"frontend_int8": False, "chain_fusion": "auto"}),
    ("planes", 8, 8192, {"frontend_int8": False, "chain_fusion": "auto"}),
    ("i8", 8, 8192, {"chain_fusion": "auto"}),  # no megakernel for int8
], ids=["i8_c5", "i8_c8", "i8_c200", "i8_c256", "i8_c8_chunked",
        "words_c8", "complex_c8", "chain_words", "chain_planes",
        "chain_i8"])
def test_i16_route_matches_the_jax_gates(case, monkeypatch):
    """Under ``interstage_i16`` the dtypes the port hands K2, the PLL's
    loop and extract (and whether the megakernel runs) equal what the JAX
    gates hand theirs (demod.py:307-540, pll_pallas.py:197-238), on the
    same config and shape.  The JAX kernels' ``pallas_call`` is stubbed to
    record its kernel and flags and return zeros (outside jit), so only
    the gates and the glue run there."""
    form, c, b, extra = case
    kw = {"frontend_int8": True, "interstage_i16": True, **extra}
    tcfg = DemodConfig(**kw)
    jcfg = JDemodConfig(loop_impl="pallas", **kw)
    seen = []
    for mod in (frontend_pallas, midend_pallas, pll_pallas, extract_pallas,
                chain_pallas, k12_pallas, bpsk_pallas):
        monkeypatch.setattr(mod, "pl", _Pallas(mod.pl, seen))
    rng = np.random.default_rng(1)
    u8 = rng.integers(0, 256, (c, b, 2), dtype=np.uint8)
    x = {"i8": lambda: split_iq_i8(u8), "words": lambda: pack_iq_u8(u8),
         "complex": lambda: (u8[..., 0] - 127.0
                             + 1j * (u8[..., 1] - 127.0)).astype(np.complex64),
         "planes": lambda: np.moveaxis(u8.astype(np.float32) - 127.0, -1, 0)
         .copy()}[form]()
    with jax.disable_jit():
        jdemod.demod_block(jcfg, jdemod.make_coeffs(jcfg),
                           jdemod.demod_init_state(jcfg, c), jnp.asarray(x))
    calls = {}
    tdemod.demod_block(tcfg, tdemod.make_coeffs(tcfg),
                       tdemod.demod_init_state(tcfg, c), torch.from_numpy(x),
                       record=calls)
    assert _port_route(calls) == _jax_route(seen), (list(calls), seen)
