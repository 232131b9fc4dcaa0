"""The port's wideband slice against the JAX package: packed words, the
polyphase channelizer (plain version, CPU tensors), K12 on phase-split
planes and the wideband state (``wideband_demod_block`` end to end is in
tests/test_torch_wideband_e2e.py).

Inputs come from numpy seeds; both packages start from one state.  The
tolerances and their reasons are stated at each comparison.  The CUDA
kernels themselves are held against these plain versions on the card by
chip_smoke.py and tests/test_torch_gpu.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_radio_tpu.config import DemodConfig as JDemodConfig
from fm_radio_tpu.io.synth import FMModulator, ModulatorConfig
from fm_radio_tpu.kernels.channelizer_pallas import channelize_pallas
from fm_radio_tpu.kernels.k12_pallas import k12_pallas
from fm_radio_tpu.models import demod as jdemod
from fm_radio_tpu.models import wideband as jwide
from fm_radio_tpu.parallel import channelizer as jch
from fm_radio_tpu.utils import transfer as jtransfer
from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.kernels import k12 as tk12
from fm_radio_tpu_torch.models import demod as tdemod
from fm_radio_tpu_torch.models import wideband as twide
from fm_radio_tpu_torch.parallel import channelizer as tch
from fm_radio_tpu_torch.utils import transfer as ttransfer
from fm_radio_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

CFG = DemodConfig(frontend_int8=True)
JCFG = JDemodConfig(frontend_int8=True)
K = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small tensor ops; with pytest-xdist
    workers sharing the cores, torch's intra-op threads only contend
    (several times slower), so this module runs them on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _words(w, t, seed):
    """[W, T] packed words of random u8 IQ."""
    rng = np.random.default_rng(seed)
    return ttransfer.pack_iq_u8(
        rng.integers(0, 256, (w, t, 2)).astype(np.uint8))


def _planes(w, t, seed):
    """(re, im) [W, T] float32 planes, random normal x 50."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((w, t)).astype(np.float32) * 50.0
                 for _ in range(2))


def _zero_state(w, m, k=K):
    z = np.zeros((w, (k - 1) * m), np.float32)
    return z, z.copy()


def test_pack_unpack_match_jax():
    """Word for word: every u8 pair packs to the JAX package's word, and
    unpacks to its exact centred (re, im)."""
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (3, 1000, 2)).astype(np.uint8)
    every = np.stack(np.meshgrid(np.arange(256), np.arange(256),
                                 indexing="ij"), -1).reshape(-1, 2)
    for iq in (u8, every.astype(np.uint8)):
        w_t, w_j = ttransfer.pack_iq_u8(iq), jtransfer.pack_iq_u8(iq)
        assert w_t.dtype == np.float32
        np.testing.assert_array_equal(w_t, w_j)
        re_t, im_t = ttransfer.unpack_iq_words(torch.from_numpy(w_t))
        re_j, im_j = jtransfer.unpack_iq_words(jnp.asarray(w_j))
        np.testing.assert_array_equal(re_t.numpy(), np.asarray(re_j))
        np.testing.assert_array_equal(im_t.numpy(), np.asarray(im_j))
        np.testing.assert_array_equal(re_t.numpy(), iq[..., 0] - 127.0)
        np.testing.assert_array_equal(im_t.numpy(), iq[..., 1] - 127.0)
    with pytest.raises(ValueError, match="uint8"):
        ttransfer.pack_iq_u8(u8.astype(np.int16))


@pytest.mark.parametrize("m,k", [(8, 16), (32, 16), (32, 8), (128, 17)])
def test_make_channelizer_taps_bit_identical(m, k):
    a, b = tch.make_channelizer_taps(m, k), jch.make_channelizer_taps(m, k)
    assert a.dtype == np.float32 and a.shape == (m * k,)
    np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("m", [8, 32])
@pytest.mark.parametrize("packed", [True, False])
def test_channelize_plain_matches_xla_oracle(m, packed):
    """f32 output against ``_channelize_xla_p`` (vmapped by
    channelize_batch_p on the CPU), two blocks with carried state.  Only
    the order of the sums differs (the oracle's DFT is an XLA matmul), so
    the error is a few float32 ulp of max |y|: bound 8 ulp (measured
    ~2).  The carried state is raw input, so it is exact."""
    w, t = 2, 8192 * m
    taps = tch.make_channelizer_taps(m, K)
    x = _words(w, 2 * t, seed=m) if packed else _planes(w, 2 * t, seed=m)
    st_j = st_t = _zero_state(w, m)
    st_j = tuple(jnp.asarray(s) for s in st_j)
    st_t = tuple(torch.from_numpy(s) for s in st_t)
    for blk in range(2):
        sl = slice(blk * t, (blk + 1) * t)
        xb = x[:, sl] if packed else (x[0][:, sl], x[1][:, sl])
        xj = jnp.asarray(xb) if packed else tuple(jnp.asarray(a) for a in xb)
        xt = (torch.from_numpy(np.ascontiguousarray(xb)) if packed
              else tuple(torch.from_numpy(np.ascontiguousarray(a))
                         for a in xb))
        st_j, y_j = jch.channelize_batch_p(taps, st_j, xj, m)
        st_t, y_t = tch.channelize_batch_p(taps, st_t, xt, m)
        for a, b in zip(y_t, y_j):
            b = np.asarray(b)
            assert a.shape == (w, m, t // m)
            bound = 8 * np.finfo(np.float32).eps * np.abs(b).max()
            np.testing.assert_allclose(a.numpy(), b, atol=bound, rtol=0)
        for a, b in zip(st_t, st_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("m,out", [(8, "i8"), (32, "i8"), (32, "i8ps")])
def test_channelize_int8_matches_xla_bridge(m, out):
    """The int8 bridge against channelize_batch_p's XLA quantizer, two
    blocks: within 1 LSB, and fewer than 1e-3 of the samples differ (the
    f32 values differ by a few ulp, which can only move a value that lies
    on a rounding boundary)."""
    w, t = 2, 8192 * m
    taps = tch.make_channelizer_taps(m, K)
    x = _words(w, 2 * t, seed=3)
    st_j = tuple(jnp.asarray(s) for s in _zero_state(w, m))
    st_t = tuple(torch.from_numpy(s) for s in _zero_state(w, m))
    for blk in range(2):
        xb = x[:, blk * t : (blk + 1) * t]
        st_j, y_j = jch.channelize_batch_p(taps, st_j, jnp.asarray(xb), m,
                                           out=out)
        st_t, y_t = tch.channelize_batch_p(taps, st_t, torch.from_numpy(xb),
                                           m, out=out)
        assert y_t.dtype == torch.int8 and tuple(y_t.shape) == y_j.shape
        d = np.abs(y_t.numpy().astype(np.int32)
                   - np.asarray(y_j).astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() < 1e-3


def test_channelize_i8ps_is_i8_every_fourth():
    """Plane p of the phase-split output is the flat int8 output's samples
    p::4 of each channel, exactly."""
    m, w, t = 32, 2, 8192 * 32
    taps = tch.make_channelizer_taps(m, K)
    xb = torch.from_numpy(_words(w, t, seed=4))
    st = tuple(torch.from_numpy(s) for s in _zero_state(w, m))
    _, y8 = tch.channelize_batch_p(taps, st, xb, m, out="i8")
    _, yps = tch.channelize_batch_p(taps, st, xb, m, out="i8ps")
    flat = y8.reshape(2, w * m, -1)
    assert tuple(yps.shape) == (2, 4, w * m, t // m // 4)
    for p in range(4):
        assert torch.equal(yps[:, p], flat[:, :, p::4])


def test_channelize_i8ps_matches_pallas_interpret():
    """Against the TPU kernel itself (interpret mode, splits=3, its
    near-exact bf16x3 matrices): within 1 LSB with under 2% of the samples
    differing, the JAX package's own bound for its i8 bridge
    (tests/test_wideband.py:135)."""
    m, w, t = 32, 2, 512 * 32
    taps = tch.make_channelizer_taps(m, K)
    xs = _words(w, t, seed=7)
    z = _zero_state(w, m)
    _, y_j = channelize_pallas(taps, tuple(jnp.asarray(s) for s in z),
                               jnp.asarray(xs), m, interpret=True,
                               out="i8ps", splits=3)
    _, y_t = tch.channelize_batch_p(taps, tuple(torch.from_numpy(s)
                                                for s in z),
                                    torch.from_numpy(xs), m, out="i8ps")
    d = np.abs(y_t.numpy().astype(np.int32) - np.asarray(y_j).astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 0.02


def test_channelize_limits_and_quantised_modes_raise():
    """The limits raise; the quantised modes raise only where their
    kernel cannot run: an unknown ``splits``, or planes handed to the
    kernel wrapper in a matrix mode (``channelize_batch_p`` routes planes
    to the exact mode instead)."""
    from fm_radio_tpu_torch.kernels import channelizer as kch

    taps = tch.make_channelizer_taps(16, K)
    st = tuple(torch.from_numpy(s) for s in _zero_state(1, 16))
    x = torch.from_numpy(_words(1, 8192 * 16, seed=1))
    planes = ttransfer.unpack_iq_words(x)
    for splits in (1, 2):
        with pytest.raises(ValueError, match="packed words"):
            kch.channelize(kch.make_tables(taps, 16), st, planes, 16,
                           out="i8", splits=splits)
    for splits in (0, 4):
        with pytest.raises(ValueError, match=f"splits={splits}"):
            tch.channelize_batch_p(taps, st, x, 16, out="i8", splits=splits)
    with pytest.raises(ValueError, match="M = 32"):
        tch.channelize_batch_p(taps, st, x, 16, out="i8ps")
    with pytest.raises(ValueError, match="multiple of 4096"):
        tch.channelize_batch_p(taps, st, x[:, :1000], 16)
    with pytest.raises(ValueError, match="power of two"):
        tch.channelize_batch_p(tch.make_channelizer_taps(12, K),
                               _zero_state(1, 12), x, 12)


def test_channelize_complex_wrappers_match_planes():
    """channelize / channelize_packed / channelize_batch are the plane
    form on complex64 (exact: the same arithmetic)."""
    m, t = 8, 8192 * 8
    taps = tch.make_channelizer_taps(m, K)
    w = torch.from_numpy(_words(2, t, seed=9))
    st_c = tch.channelizer_init_state(m, K)
    st_p, (yr, yi) = tch.channelize_p(taps, (st_c.real, st_c.imag), w[0], m)
    st2, y = tch.channelize_packed(taps, st_c, w[0], m)
    assert torch.equal(y, torch.complex(yr, yi))
    assert torch.equal(st2, torch.complex(*st_p))
    xr, xi = ttransfer.unpack_iq_words(w)
    x = torch.complex(xr, xi)
    _, y1 = tch.channelize(taps, st_c, x[1], m)
    _, yb = tch.channelize_batch(taps, torch.stack([st_c, st_c]), x, m)
    assert torch.equal(yb[1], y1) and yb.shape == (2, m, t // m)


def _station_planes_ps(c, b, seed):
    """[2, 4, C, B/4] phase planes of random bytes with a stereo station on
    channel 0, and the same planes interleaved [2, C, B]."""
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, size=(c, b, 2), dtype=np.uint8)
    iq = FMModulator(ModulatorConfig()).generate(b, left_hz=1000.0,
                                                 right_hz=3000.0)
    u8[0, :, 0] = np.clip(np.round(iq.real + 127.0), 0, 255)
    u8[0, :, 1] = np.clip(np.round(iq.imag + 127.0), 0, 255)
    flat = ttransfer.split_iq_i8(u8)
    ps = np.ascontiguousarray(
        np.moveaxis(flat.reshape(2, c, b // 4, 4), 3, 1))
    return ps, flat


@pytest.mark.parametrize("use_deemph", [False, True])
def test_k12_ps_equals_flat_bit_for_bit(use_deemph):
    """K12 on phase planes equals K12 on the same planes interleaved, on
    every output and every state key, over two blocks."""
    cfg = dataclasses.replace(CFG, use_deemphasis_filter=use_deemph)
    co = tdemod.make_coeffs(cfg)
    c, b = 3, 8192
    ps, flat = _station_planes_ps(c, 2 * b, seed=11)
    st_a = st_b = tdemod.demod_init_state(cfg, c)
    for blk in range(2):
        xa = torch.from_numpy(np.ascontiguousarray(
            ps[..., blk * b // 4 : (blk + 1) * b // 4]))
        xb = torch.from_numpy(np.ascontiguousarray(
            flat[..., blk * b : (blk + 1) * b]))
        st_a, (re_a, im_a), th_a = tk12.k12_ps(co, cfg, st_a, xa)
        st_b, (re_b, im_b), th_b = tk12.k12(co, cfg, st_b, xb)
        for a, b_ in ((re_a, re_b), (im_a, im_b), (th_a, th_b)):
            assert torch.equal(a, b_)
        sa, sb = state_to_numpy(st_a), state_to_numpy(st_b)
        for key in ("ds_fm_in", "disc_prev_theta", "ds_fm_out", "hilbert",
                    "agc_pilot"):
            np.testing.assert_array_equal(sa[key], sb[key], err_msg=key)
        for key in ("peak_pilot", "deemph"):
            for h in ("x_hist", "y_hist"):
                np.testing.assert_array_equal(sa[key][h], sb[key][h])


def test_k12_ps_matches_pallas_interpret():
    """The port's K12 on phase planes against ``k12_pallas`` in interpret
    mode on the same phase planes (its _k12_kernel_ps), two blocks, within
    the flat K12's tolerances (tests/test_torch_kernels.py)."""
    co_j, co_t = jdemod.make_coeffs(JCFG), tdemod.make_coeffs(CFG)
    c, b = 4, 8192
    ps, _ = _station_planes_ps(c, 2 * b, seed=7)
    st_j = jdemod.demod_init_state(JCFG, c)
    st_t = state_from_numpy(_np(st_j))
    for blk in range(2):
        xb = np.ascontiguousarray(ps[..., blk * b // 4 : (blk + 1) * b // 4])
        st_j, (re_j, im_j), th_j = k12_pallas(co_j, JCFG, st_j,
                                              jnp.asarray(xb), interpret=True)
        st_t, (re_t, im_t), th_t = tk12.k12_ps(co_t, CFG, st_t,
                                               torch.from_numpy(xb))
        np.testing.assert_allclose(re_t, np.asarray(re_j), atol=2e-5)
        np.testing.assert_allclose(im_t, np.asarray(im_j), atol=2e-5)
        d = th_t.numpy().astype(np.float64) - np.asarray(th_j)
        assert np.abs(d - np.round(d)).max() <= 1e-4  # cycles, wrapped
        sj, stn = _np(st_j), state_to_numpy(st_t)
        np.testing.assert_array_equal(stn["ds_fm_in"], sj["ds_fm_in"])
        np.testing.assert_allclose(stn["ds_fm_out"], sj["ds_fm_out"],
                                   atol=1e-6)
        np.testing.assert_allclose(stn["hilbert"], sj["hilbert"], atol=2e-5)
        np.testing.assert_allclose(stn["agc_pilot"], sj["agc_pilot"],
                                   rtol=2e-4)


def test_wideband_state_round_trip_and_layout():
    """The wideband state has the JAX layout (same leaves, shapes, dtypes)
    and round-trips through state_{to,from}_numpy leaf for leaf."""
    m, w = 8, 2
    st_j = _np(jwide.wideband_init_state(JCFG, m, w))
    st_t = twide.wideband_init_state(CFG, m, w)
    co = tdemod.make_coeffs(CFG)
    st_t, _ = twide.wideband_demod_block(
        CFG, co, None, st_t, torch.from_numpy(_words(w, 8192 * m, seed=2)), m)
    back = state_from_numpy(state_to_numpy(st_t))
    lt = jax.tree_util.tree_leaves_with_path(state_to_numpy(st_t))
    lj = jax.tree_util.tree_leaves_with_path(st_j)
    assert [str(p) for p, _ in lt] == [str(p) for p, _ in lj]
    for (_, a), (_, b) in zip(lt, lj):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert isinstance(back["chan"], tuple) and len(back["chan"]) == 2
    assert type(back["demod"]["pll"]).__module__.startswith(
        "fm_radio_tpu_torch")
    for a, b in zip(jax.tree_util.tree_leaves(state_to_numpy(back)),
                    jax.tree_util.tree_leaves(state_to_numpy(st_t))):
        np.testing.assert_array_equal(a, b)

