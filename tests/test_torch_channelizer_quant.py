"""The channelizer's quantised-matrix modes (``splits`` 1 and 2) in the
port, plain versions on CPU tensors, against the JAX package's TPU kernel
run in interpret mode (``channelize_pallas(..., interpret=True,
splits=s)``) and against the port's exact mode.

Inputs come from numpy seeds; both packages start from one state.  The
CUDA kernel (csrc/channelizer_wgmma.cu, int8 and bf16) is held against
these plain versions on the card by chip_smoke.py and
tests/test_torch_gpu.py.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_radio_tpu.config import DemodConfig as JDemodConfig
from fm_radio_tpu.io.synth import (
    FMModulator,
    ModulatorConfig,
    make_wideband,
    station_group_schedule,
)
from fm_radio_tpu.kernels.channelizer_pallas import (
    channelize_pallas,
    pick_tile_chan,
)
from fm_radio_tpu.kernels.frontend_pallas import _split_bf16
from fm_radio_tpu.models import demod as jdemod
from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.kernels import channelizer as kch
from fm_radio_tpu_torch.models import demod as tdemod
from fm_radio_tpu_torch.models import wideband as twide
from fm_radio_tpu_torch.parallel import channelizer as tch
from fm_radio_tpu_torch.rds.chain import make_rds_chain
from fm_radio_tpu_torch.utils import transfer as ttransfer
from fm_radio_tpu_torch.utils.convert import state_from_numpy

K = 16
W = 2
SNR_MIN_DB = 75.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small tensor ops; with pytest-xdist
    workers sharing the cores, torch's intra-op threads only contend, so
    this module runs them on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(w, t, seed):
    """[W, T] packed words of random u8 IQ (every value of the range)."""
    rng = np.random.default_rng(seed)
    return ttransfer.pack_iq_u8(
        rng.integers(0, 256, (w, t, 2)).astype(np.uint8))


def _zero_state(w, m, k=K):
    z = np.zeros((w, (k - 1) * m), np.float32)
    return z, z.copy()


def _jax_axes(qt: kch.QuantTables) -> kch.QuantTables:
    """``qt`` with the +1 corrections summed as channelizer_pallas.py:
    395-396 sums them (axes (0, 1) of [n_c, o, s]: per input column s)."""
    mats = qt.mats.numpy()
    q_m = 1.0 / float(qt.aux[0, 0])
    s_re = mats[0].sum(axis=(0, 1)).astype(np.float64) / q_m
    s_im = mats[1].sum(axis=(0, 1)).astype(np.float64) / q_m
    aux = qt.aux.numpy().copy()
    aux[1] = (s_re - s_im).astype(np.float32)
    aux[2] = (s_im + s_re).astype(np.float32)
    return qt._replace(aux=torch.from_numpy(aux))


def _both(splits, m, out, blocks=2, t=512 * 32, seed=0, tables=None):
    """Pallas (interpret) and the port's plain matrix mode on the same
    words, ``blocks`` blocks with carried state.  ``tables(qt)`` may
    replace the port's tables.  Returns a list over blocks of ((y_jax,
    state_jax), (y_port, state_port)) as numpy."""
    taps = tch.make_channelizer_taps(m, K)
    tab = kch.make_tables(taps, m)
    words = _words(W, blocks * t, seed)
    st_j = tuple(jnp.asarray(s) for s in _zero_state(W, m))
    st_t = tuple(torch.from_numpy(s) for s in _zero_state(W, m))
    qt = kch.quant_tables(tab, splits, out)
    if tables is not None:
        qt = tables(qt)
    plain = (kch.channelize_i8mat_plain if splits == 1
             else kch.channelize_bf16mat_plain)
    res = []
    for blk in range(blocks):
        xb = words[:, blk * t : (blk + 1) * t]
        st_j, y_j = channelize_pallas(taps, st_j, jnp.asarray(xb), m,
                                      interpret=True, out=out, splits=splits)
        st_t, y_t = plain(qt, st_t, torch.from_numpy(xb), m, out)
        as_np = (lambda y: tuple(np.asarray(a) for a in y)
                 if isinstance(y, tuple) else np.asarray(y))
        res.append(((as_np(y_j), tuple(np.asarray(s) for s in st_j)),
                    (as_np(tuple(a.numpy() for a in y_t) if out == "f32"
                           else y_t.numpy()),
                     tuple(s.numpy() for s in st_t))))
    return res


CASES = [(32, "i8ps"), (32, "i8"), (32, "f32"), (16, "i8")]


@pytest.mark.parametrize("m,out", CASES)
def test_i8mat_plain_equals_pallas_given_jax_axes(m, out):
    """Given a table whose +1 corrections are summed on the JAX package's
    axes, the port's plain int8-matrix mode equals the TPU kernel's
    splits=1 body (interpret mode) bit for bit on every output form, over
    two blocks with carried state: the same int8 matrices, exact integer
    products, and the same float32 epilogue."""
    for (y_j, s_j), (y_t, s_t) in _both(1, m, out, tables=_jax_axes):
        for a, b in zip(y_t if out == "f32" else [y_t],
                        y_j if out == "f32" else [y_j]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        for a, b in zip(s_t, s_j):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("m,out", CASES)
def test_i8mat_correct_axes_differ_by_the_corrections(m, out):
    """With its own tables (corrections per output, axes (c, s)) the port
    differs from the TPU kernel only by the corrections: float32 outputs
    by at most max |corr_port - corr_jax| plus one rounding of the final
    add (2 ulp of max |y|); int8 outputs by at most 1 LSB, on fewer than
    1e-3 of the samples (measured at M = 32, K = 16, f32: 0.0137 at an
    output rms of 12.3, the corrections' largest difference; int8: 1 LSB
    on 3e-5 to 8e-5 of the samples)."""
    tab = kch.make_tables(tch.make_channelizer_taps(m, K), m)
    qt = kch.quant_tables(tab, 1, out)
    d_corr = float(np.abs(qt.aux[1:].numpy()
                          - _jax_axes(qt).aux[1:].numpy()).max())
    assert d_corr > 0.0  # the two sums do differ
    for (y_j, s_j), (y_t, s_t) in _both(1, m, out, seed=5):
        if out == "f32":
            for a, b in zip(y_t, y_j):
                ulp = np.finfo(np.float32).eps * np.abs(b).max()
                assert np.abs(a - b).max() <= d_corr + 2 * ulp
        else:
            d = np.abs(y_t.astype(np.int32) - y_j.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3
        for a, b in zip(s_t, s_j):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("m,out", CASES)
def test_bf16mat_plain_matches_pallas(m, out):
    """The port's plain single-bf16 mode against the TPU kernel's splits=2
    body (interpret mode), two blocks: the same bf16 matrices and exact
    bf16 inputs, so only the float32 summation order differs (the port
    rounds each column shift's exact product once; XLA sums each dot in
    its own order): float32 outputs within 8 ulp of max |y| (measured
    ~1.1e-5 at max |y| ~50, about 4 ulp), int8 outputs within 1 LSB on
    fewer than 1e-3 of the samples (measured: none), state exact."""
    for (y_j, s_j), (y_t, s_t) in _both(2, m, out, seed=9):
        if out == "f32":
            for a, b in zip(y_t, y_j):
                bound = 8 * np.finfo(np.float32).eps * np.abs(b).max()
                np.testing.assert_allclose(a, b, atol=bound, rtol=0)
        else:
            d = np.abs(y_t.astype(np.int32) - y_j.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3
        for a, b in zip(s_t, s_j):
            np.testing.assert_array_equal(a, b)


def test_bf16_tables_equal_split_bf16():
    """The bf16 matrices are the hi plane of ``_split_bf16(..., True)``
    (round to nearest even once) of the float32 Karatsuba matrices, bit
    for bit, with and without the 1/M descale."""
    m = 32
    taps = tch.make_channelizer_taps(m, K)
    for descale in (False, True):
        m_re, m_im = kch.fused_operators(taps, m, descale)
        mats = np.swapaxes(np.stack([m_re, m_im, m_re + m_im]), 2, 3)
        hi, _ = _split_bf16(jnp.asarray(mats.astype(np.float32)), True)
        ours = kch.bf16_operators(taps, m, descale).view(torch.int16).numpy()
        np.testing.assert_array_equal(ours, np.asarray(hi).view(np.int16))


@pytest.mark.parametrize("m,k", [(32, 16), (8, 16), (128, 17)])
def test_wgmma_order_is_the_stage_layout(m, k):
    """The bf16 tables' ``frag`` is the operators in the wgmma kernel's
    stage order: un-permuted it gives ``bf16_operators`` (the Karatsuba
    matrices of ``fused_operators``, rounded once), and read as bytes it is
    the layout the kernel's descriptors address: stage (g, c, kh) at
    ((g n_c + c) 4 + kh) 8192 bytes, input chunk kc (8 inputs, 16 bytes)
    of output row o at kc 2048 + o 16 (no-swizzle core matrices: rows 16
    bytes apart, the K chunks 2048 apart)."""
    taps = tch.make_channelizer_taps(m, k)
    n_c = kch.tail_columns(k, m) + 1
    qt = kch.make_quant_tables(taps, m, 2, True)
    mats = kch.bf16_operators(taps, m, True).view(torch.int16)
    assert qt.frag.dtype == torch.int16
    assert tuple(qt.frag.shape) == (3, n_c, 4, 4, 128, 8)
    back = qt.frag.permute(0, 1, 4, 2, 3, 5).reshape(3, n_c, 128, 128)
    assert torch.equal(back, mats)
    m_re, m_im = kch.fused_operators(taps, m, True)
    ref = torch.from_numpy(np.swapaxes(
        np.stack([m_re, m_im, m_re + m_im]), 2, 3).astype(np.float32))
    assert torch.equal(back.view(torch.bfloat16), ref.to(torch.bfloat16))
    flat = qt.frag.numpy().reshape(-1).view(np.uint8)
    src = mats.numpy().view(np.uint8).reshape(3, n_c, 128, 256)
    rng = np.random.default_rng(m + k)
    for _ in range(200):
        g, c = rng.integers(3), rng.integers(n_c)
        o, s = rng.integers(128), rng.integers(128)
        kh, kc, e = s // 32, (s % 32) // 8, s % 8
        at = ((g * n_c + c) * 4 + kh) * 8192 + kc * 2048 + o * 16 + e * 2
        np.testing.assert_array_equal(flat[at : at + 2],
                                      src[g, c, o, 2 * s : 2 * s + 2])


def test_wgmma_operator_bytes():
    """The bf16 operator bytes the wgmma kernel moves from L2 per call:
    every tile of 128 columns streams all 3 x n_c x 32 KB once; at the
    wideband cell (W = 64, T = 2^22, M = 32, K = 16: 16,384 tiles, n_c = 5)
    8.05 GB, half of the 16.1 GB the bf16 mode's earlier mma.sync kernel's
    32,768 tiles of 64 columns read; at M = 128, K = 17 n_c = 17."""
    assert kch.wgmma_operator_bytes(64, 1 << 22, 16, 32, 2) == \
        16384 * 3 * 5 * 32768 == 8_053_063_680
    assert kch.wgmma_operator_bytes(2, 65536, 17, 128, 2) == \
        8 * 3 * 17 * 32768


@pytest.mark.parametrize("splits", [1, 2])
def test_mat_state_equals_exact_and_planes_run_exact(splits):
    """The carried state of a matrix mode is the exact mode's, bit for
    bit; and on (re, im) planes ``splits`` changes nothing (the TPU kernel
    takes its near-exact form on planes whatever ``splits`` is): the
    output equals splits=3's exactly."""
    m, t = 32, 16384
    taps = tch.make_channelizer_taps(m, K)
    xw = torch.from_numpy(_words(W, t, seed=2))
    st = tuple(torch.from_numpy(s) for s in _zero_state(W, m))
    st_q, _ = tch.channelize_batch_p(taps, st, xw, m, out="i8ps",
                                     splits=splits)
    st_e, _ = tch.channelize_batch_p(taps, st, xw, m, out="i8ps", splits=3)
    for a, b in zip(st_q, st_e):
        assert torch.equal(a, b)
    planes = ttransfer.unpack_iq_words(xw)
    _, y_q = tch.channelize_batch_p(taps, st, planes, m, out="i8ps",
                                    splits=splits)
    _, y_e = tch.channelize_batch_p(taps, st, planes, m, out="i8ps",
                                    splits=3)
    assert torch.equal(y_q, y_e)


def test_splits_resolution_and_gate():
    """``splits`` None reads FMTPU_WB_SPLITS once at import (default 3);
    the quantised modes apply to packed words where the TPU kernel runs
    (the port's copy of ``pick_tile_chan`` agrees with the JAX one on
    every shape tried); elsewhere the exact mode runs."""
    assert kch.SPLITS_DEFAULT == int(os.environ.get("FMTPU_WB_SPLITS", "3"))
    code = ("from fm_radio_tpu_torch.kernels import channelizer as k; "
            "print(k.SPLITS_DEFAULT)")
    for env, want in (("1", "1"), ("2", "2")):
        e = dict(os.environ)
        e.pop("FMTPU_WB_SPLITS", None)
        if env is not None:
            e["FMTPU_WB_SPLITS"] = env
        r = subprocess.run([sys.executable, "-c", code], env=e,
                           capture_output=True, text=True, timeout=120)
        assert r.stdout.strip() == want, r.stderr
    for n_frames in (256, 512, 1024, 4096, 131072, 131072 + 512, 300):
        for m in (4, 8, 16, 24, 32, 64, 128, 256):
            for k in (8, 16, 17):
                assert (tch.pick_tile_chan(n_frames, m, k)
                        == pick_tile_chan(n_frames, m, 1, k))
    w32 = torch.zeros((1, 16384))
    for splits in (1, 2):
        assert tch.resolve_splits(splits, w32, 32, 16) == splits
        assert tch.resolve_splits(splits, w32.reshape(1, -1, 128), 32,
                                  16) == splits
        # planes, M % 8 != 0, a partial frame tile, K - 1 > 16
        assert tch.resolve_splits(splits, (w32, w32), 32, 16) == 3
        assert tch.resolve_splits(splits, torch.zeros((1, 8192)), 4, 16) == 3
        assert tch.resolve_splits(splits, torch.zeros((1, 8192)), 32,
                                  16) == 3
        assert tch.resolve_splits(splits, w32, 32, 18) == 3
    assert tch.resolve_splits(None, w32, 32, 16) == kch.SPLITS_DEFAULT
    with pytest.raises(ValueError, match="splits=4"):
        tch.resolve_splits(4, w32, 32, 16)


def test_mat_dispatch_never_falls_back(monkeypatch, tmp_path):
    """The matrix modes dispatch by device as every wrapper does: a tensor
    on another device is refused, a failed build raises (in either mode),
    and the kernel wrapper refuses what its kernel does not take (planes,
    M % 8 != 0, T not a multiple of its tile of 16,384 samples) instead of
    running the exact kernel."""
    from fm_radio_tpu_torch.kernels import _build

    m = 32
    tab = kch.make_tables(np.ones(16 * m, np.float32), m)
    zeros = torch.zeros((1, 15 * m), device="meta")
    words = torch.zeros((1, 512 * m), device="meta")
    for splits in (1, 2):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            kch.channelize(tab, (zeros, zeros), words, m, out="i8ps",
                           splits=splits)
        st = (torch.zeros((1, 15 * m)), torch.zeros((1, 15 * m)))
        w = torch.zeros((1, 512 * m))
        with pytest.raises(ValueError, match="packed words"):
            kch.channelize(tab, st, (w, w), m, out="i8ps", splits=splits)
        t_mult = kch.MAT_T_MULTIPLE[splits]
        with pytest.raises(ValueError, match=f"multiple of {t_mult}"):
            kch.channelize(tab, st, w[:, : t_mult // 2], m, out="i8ps",
                           splits=splits)
    assert kch.MAT_T_MULTIPLE == {1: 16384, 2: 16384}
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "nvcc", lambda: "false")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError,
                       match="nvcc failed on channelizer_wgmma"):
        _build.function("channelizer_wgmma", "fmt_channelize_wgmma", [])
    # the launches themselves (run here on CPU tensors past the device
    # dispatch), in both modes
    for splits in (1, 2):
        with pytest.raises(RuntimeError,
                           match="nvcc failed on channelizer_wgmma"):
            kch._launch_mat(tab, st, torch.zeros((1, 16384)), m, "i8ps",
                            splits)


def _station_words(m, n, channel):
    """[2, n*M] packed words: capture 0 silent, capture 1 one stereo+RDS
    station on ``channel`` at the u8 range's full swing."""
    groups = station_group_schedule(0xBEEF, ps="WIDEBAND")
    iq = FMModulator(ModulatorConfig()).generate(
        n, left_hz=800.0, right_hz=1600.0, rds_groups=groups)
    wide = make_wideband({channel: iq}, m)
    wide *= 100.0 / np.abs(wide).max()
    u8 = np.clip(np.stack([np.round(wide.real + 127.0),
                           np.round(wide.imag + 127.0)], -1),
                 0, 255).astype(np.uint8)
    w1 = ttransfer.pack_iq_u8(u8)
    return np.stack([np.full_like(w1, 127.0 * 256 + 127.0), w1])


def _rds_bytes(pred, valid):
    chain = make_rds_chain()
    sym = pred[valid]
    if sym.size:
        chain.process_symbols(sym)
    return (np.concatenate(chain.rds_bytes) if chain.rds_bytes
            else np.zeros(0, np.uint8))


def test_wideband_splits1_matches_jax_pallas():
    """The slice end to end: the port's ``wideband_demod_block(splits=1)``
    (M = 32, the phase-split bridge) against the JAX package's
    ``channelize_pallas(interpret=True, splits=1, out="i8ps")`` followed
    by its ``demod_block`` (loop_impl="pallas", Pallas kernels in
    interpret mode), W = 2 captures, 5 blocks of 32,768 per channel from
    one start state.  Given the JAX-axes tables (passed in the
    ``ChannelizerTables``' cache) the bridge is the same, and the
    station's RDS bytes are identical and its audio >= 75 dB SNR against
    JAX (the golden bar; measured 85.0).  With the port's own tables (corrections per
    output) the bridge differs by 1 LSB on a few samples in 1e4, which
    the discriminator turns into clicks: RDS bytes still identical, audio
    >= 60 dB (measured 67.0).  The silent capture stays silent and the
    record names mode 1."""
    m, b, blocks, channel = 32, 32768, 5, 3
    cfg_j = JDemodConfig(frontend_int8=True, loop_impl="pallas")
    cfg_t = DemodConfig(frontend_int8=True)
    co_j, co_t = jdemod.make_coeffs(cfg_j), tdemod.make_coeffs(cfg_t)
    taps = tch.make_channelizer_taps(m, K)
    words = _station_words(m, b * blocks, channel)
    tabs = {"jax_axes": kch.make_tables(taps, m),
            "port": kch.make_tables(taps, m)}
    jt = tabs["jax_axes"]
    jt.quant[(1, True)] = _jax_axes(kch.quant_tables(jt, 1, "i8ps"))
    st_dj = jdemod.demod_init_state(cfg_j, W * m)
    st_cj = tuple(jnp.asarray(s) for s in _zero_state(W, m))
    st_t = {}
    for key in tabs:
        st_t[key] = twide.wideband_init_state(cfg_t, m, W)
        st_t[key]["demod"] = state_from_numpy(jax.tree.map(np.asarray,
                                                           st_dj))
    t = m * b
    outs = {src: [] for src in ("jax", *tabs)}
    for blk in range(blocks):
        xb = words[:, blk * t : (blk + 1) * t]
        st_cj, y = channelize_pallas(taps, st_cj, jnp.asarray(xb), m,
                                     interpret=True, out="i8ps", splits=1)
        st_dj, oj = jdemod.demod_block(cfg_j, co_j, st_dj, y)
        outs["jax"].append({k: np.asarray(v) for k, v in oj.items()})
        for key, tab in tabs.items():
            calls = {}
            st_t[key], ot = twide.wideband_demod_block(
                cfg_t, co_t, tab, st_t[key], torch.from_numpy(xb), m,
                splits=1, record=calls)
            assert calls["channelizer"][4:] == ("i8ps", 1)
            outs[key].append({k: v.numpy() for k, v in ot.items()})
    row = m + channel
    cat = {src: {k: np.concatenate([o[k] for o in o_], axis=1)
                 for k in ("audio", "rds_pred", "rds_valid")}
           for src, o_ in outs.items()}
    a_j = cat["jax"]["audio"][row].astype(np.float64)
    by_j = _rds_bytes(cat["jax"]["rds_pred"][row],
                      cat["jax"]["rds_valid"][row])
    assert by_j.size > 0
    for key, snr_min in (("jax_axes", SNR_MIN_DB), ("port", 60.0)):
        a_t = cat[key]["audio"][row]
        snr = 10 * np.log10(np.sum(a_j ** 2) / np.sum((a_t - a_j) ** 2))
        assert snr >= snr_min, f"{key}: audio SNR {snr:.1f} dB vs JAX"
        np.testing.assert_array_equal(
            _rds_bytes(cat[key]["rds_pred"][row],
                       cat[key]["rds_valid"][row]), by_j)
        assert not cat[key]["audio"][:m].any()
        for a, b_ in zip(st_t[key]["chan"], st_cj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b_))
    assert not cat["jax"]["audio"][:m].any()
