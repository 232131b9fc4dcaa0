"""The int8-matrix channelizer on wgmma and BPSK's branch, on the host.

The kernels run only on the card (``chip_smoke.py`` and
``tests/test_torch_gpu.py`` hold them against their plain versions, max
abs error 0).  Here: the int8 tables' stage layout that
``csrc/channelizer_wgmma.cu``'s descriptors address, the operator bytes
it streams, and the wide blocks T the JAX gate admits at splits=1 (every
one a multiple of the kernel's tile of 16,384 samples); for
``csrc/bpsk.cu``, a torch model of its branch (the dump's phase error
evaluated only on the warps in which some channel's TED clock fires,
``bpsk_plain`` with the skipped values made NaN) against ``bpsk_plain``
bit for bit, and a numpy model of the share of steps a warp skips
against the fire pattern of a station.
"""

import numpy as np
import pytest
import torch

from fm_radio_tpu.kernels.channelizer_pallas import pick_tile_chan
from fm_radio_tpu_torch.apps.cli import selftest_planes
from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.kernels import bpsk as tbpsk
from fm_radio_tpu_torch.kernels import channelizer as kch
from fm_radio_tpu_torch.models import demod as tdemod
from fm_radio_tpu_torch.models.bpsk import bpsk_init_state
from fm_radio_tpu_torch.ops.cmath import atan2_poly
from fm_radio_tpu_torch.parallel import channelizer as tch

CFG = DemodConfig(frontend_int8=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain loops run many small tensor ops; with pytest-xdist
    workers sharing the cores, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("m,k", [(32, 16), (8, 16), (128, 17)])
def test_wgmma_order_int8_is_the_stage_layout(m, k):
    """The int8 tables' ``frag`` is A_re, A_im and -A_im (the quantised
    operators of ``int8_operators``; no entry at -128, so the negation is
    exact) in the wgmma kernel's stage order, checked byte by byte at the
    address its descriptors read: stage (g, c, kh) at ((g n_c + c) 2 + kh)
    8192 bytes, input chunk kc (16 inputs, 16 bytes) of output row o at
    kc 2048 + o 16, input s = 64 kh + 16 kc + e at byte e."""
    taps = tch.make_channelizer_taps(m, k)
    n_c = kch.tail_columns(k, m) + 1
    qt = kch.make_quant_tables(taps, m, 1, True)
    mats, _ = kch.int8_operators(taps, m, True)
    assert torch.equal(qt.mats, torch.from_numpy(mats))
    assert int(qt.mats.min()) >= -127
    tables = np.stack([mats[0], mats[1], -mats[1]]).view(np.uint8)
    assert qt.frag.dtype == torch.int8
    assert tuple(qt.frag.shape) == (3, n_c, 2, 4, 128, 16)
    flat = qt.frag.numpy().reshape(-1).view(np.uint8)
    g, c, o, s = np.meshgrid(np.arange(3), np.arange(n_c), np.arange(128),
                             np.arange(128), indexing="ij")
    kh, kc, e = s // 64, (s % 64) // 16, s % 16
    at = ((g * n_c + c) * 2 + kh) * 8192 + kc * 2048 + o * 16 + e
    assert flat.size == 3 * n_c * 128 * 128
    np.testing.assert_array_equal(flat[at], tables[g, c, o, s])


def test_wgmma_operator_bytes_int8():
    """The int8 tables the kernel streams per call: every tile of 128
    columns reads 3 x n_c x 16 KB once (A_re, A_im, -A_im), half the bf16
    mode's bytes; at the wideband cell (W = 64, T = 2^22, M = 32, K = 16:
    16,384 tiles, n_c = 5) 4.03 GB (the int8 mode's earlier mma.sync
    kernel read A_re and A_im, 160 KB, into each of 32,768 CTAs of 64
    columns: 5.37 GB)."""
    assert kch.wgmma_operator_bytes(64, 1 << 22, 16, 32, 1) == \
        16384 * 3 * 5 * 16384 == 4_026_531_840
    assert 2 * kch.wgmma_operator_bytes(64, 1 << 22, 16, 32, 1) == \
        kch.wgmma_operator_bytes(64, 1 << 22, 16, 32, 2)
    assert kch.wgmma_operator_bytes(2, 65536, 17, 128, 1) == \
        8 * 3 * 17 * 16384


def test_splits1_t_gate():
    """The wgmma kernel takes T in whole tiles of 128 columns (16,384
    samples) in both modes; the JAX gate (``channelizer_pallas.py::
    pick_tile_chan``) and the port's copy admit at splits=1 no T that
    16,384 does not divide, at the channel counts the port's channelizer
    takes (M a power of two; M = 24, which the JAX gate also admits, every
    mode of the port refuses, as before), so every shape the JAX package
    runs at splits=1 is one the kernel takes."""
    assert kch.MAT_T_MULTIPLE == {1: 16384, 2: 16384}
    assert kch.WGMMA_TILE == 16384
    admitted = 0
    for m in (8, 16, 32, 64, 128, 256):
        for k in (2, 8, 16, 17):
            for n_frames in range(64, 70000, 64):
                jt = pick_tile_chan(n_frames, m, 1, k)
                assert tch.pick_tile_chan(n_frames, m, k) == jt
                t = n_frames * m
                w = torch.empty((1, t), device="meta")
                want = 1 if jt is not None and k - 1 <= 16 else 3
                assert tch.resolve_splits(1, w, m, k) == want
                if jt is not None:
                    assert t % kch.WGMMA_TILE == 0, (m, k, n_frames)
                    admitted += 1
    assert admitted > 1000


@pytest.fixture(scope="module")
def station_rds():
    """The selftest station's RDS baseband [1, 4096] (re, im) and the RDS
    AGC gain [1] of its last block, as ``demod_block`` hands them to BPSK
    (four blocks of 65,536 samples, int8 planes through K12)."""
    co = tdemod.make_coeffs(CFG)
    x = torch.from_numpy(selftest_planes(0.25, 65536))
    st = tdemod.demod_init_state(CFG, 1)
    re, im = [], []
    for b in range(4):
        calls = {}
        st, _ = tdemod.demod_block(
            CFG, co, st, x[..., b * 65536 : (b + 1) * 65536].contiguous(),
            record=calls)
        _, _, (xr, xi), gain = calls["bpsk"]
        re.append(xr)
        im.append(xi)
    return torch.cat(re, 1), torch.cat(im, 1), gain


def _shifted(rds, c, n, seed):
    """[c, n] windows of the station's baseband at random offsets: channels
    whose symbol clocks fire at independent phases."""
    re, im, _ = rds
    offs = np.random.default_rng(seed).integers(0, re.shape[1] - n, c)
    return (torch.stack([re[0, o : o + n] for o in offs]).contiguous(),
            torch.stack([im[0, o : o + n] for o in offs]).contiguous())


def _inputs(kind, rds, c, n):
    if kind == "zeros":
        z = torch.zeros((c, n))
        return z, z.clone()
    if kind == "station":
        return _shifted(rds, c, n, seed=3)
    rng = np.random.default_rng(7)
    return tuple(torch.from_numpy((0.7 * rng.standard_normal((c, n)))
                                  .astype(np.float32)) for _ in range(2))


def _warp_fired(valid: np.ndarray, lanes: int) -> np.ndarray:
    """[C, N] bool: channel c's warp of ``lanes`` channels (c // lanes) has
    some channel whose TED clock fires at step n, for the fire pattern
    ``valid`` [C, N]; the last warp's missing lanes repeat the last
    channel, as the kernel runs them (which changes no warp's vote)."""
    c, n = valid.shape
    v = np.concatenate([valid, np.repeat(valid[-1:], -c % lanes, 0)])
    fired = v.reshape(-1, lanes, n).any(axis=1)
    return np.repeat(fired, lanes, 0)[:c]


def _skip_share_np(valid: np.ndarray, lanes: int) -> float:
    """The share of (warp, step) pairs in which no channel of a warp of
    ``lanes`` channels fires: the steps on which the kernel's warp skips
    the dump's phase error."""
    return float((~_warp_fired(valid, lanes)[::lanes]).mean())


def _branch_model(monkeypatch, args, valid: np.ndarray, lanes: int):
    """``bpsk_plain`` on ``args`` with the kernel's branch modelled: the
    dump's arctangent of each step comes out NaN on every channel whose
    warp of ``lanes`` channels has no TED clock firing there (``valid``
    [C, N], the reference's fire pattern), as if the kernel had not
    evaluated it.  Any consumer of a skipped value would carry the NaN."""
    fired = torch.from_numpy(_warp_fired(valid, lanes))
    step = iter(range(valid.shape[1]))

    def atan2_where_evaluated(y, x):
        return torch.where(fired[:, next(step)], atan2_poly(y, x),
                           float("nan"))

    with monkeypatch.context() as mp:
        mp.setattr(tbpsk, "atan2_poly", atan2_where_evaluated)
        return tbpsk.bpsk_plain(*args)


@pytest.mark.parametrize("with_gain", [True, False], ids=["gain", "nogain"])
@pytest.mark.parametrize("kind", ["random", "zeros", "station"])
def test_branch_schedule_is_the_plain_loop(monkeypatch, station_rds, kind,
                                           with_gain):
    """The kernel's branch, modelled: with the dump's phase error left
    unevaluated (NaN) on the warps (L = 32, 8, 4, 1 channels) in which no
    channel's TED clock fires, every output and the carried state equal
    ``bpsk_plain``'s bit for bit, two blocks with carried state, at C =
    10 (the last warp partial), on random input, on zeros and on the
    selftest station's RDS baseband, with the station's RDS AGC gain and
    without.  On random and station input some steps are skipped."""
    c, n = 10, 256
    xr, xi = _inputs(kind, station_rds, c, 2 * n)
    gain = (station_rds[2].expand(c).contiguous() if with_gain else None)
    st0 = bpsk_init_state(c)
    ref, st = [], st0
    for blk in range(2):
        sl = slice(blk * n, (blk + 1) * n)
        st, o = tbpsk.bpsk_plain(CFG, st, (xr[:, sl], xi[:, sl]), gain)
        ref.append((st, o))
    for lanes in (32, 8, 4, 1):
        st = st0
        for blk in range(2):
            sl = slice(blk * n, (blk + 1) * n)
            rst, ro = ref[blk]
            valid = ro["valid"].numpy()
            st, o = _branch_model(monkeypatch,
                                  (CFG, st, (xr[:, sl], xi[:, sl]), gain),
                                  valid, lanes)
            for f in rst._fields:
                assert torch.equal(getattr(st, f), getattr(rst, f)), \
                    (lanes, blk, f)
            for key in ro:
                assert torch.equal(o[key], ro[key]), (lanes, blk, key)
            if kind != "zeros":
                assert _skip_share_np(valid, lanes) > 0.0, (lanes, blk)


def test_warp_skip_share_against_a_station(station_rds):
    """The share of steps on which a warp of L channels skips the phase
    error, on the fire pattern BPSK measures on the selftest station's
    baseband at 256 random offsets (N = 512): the TED clock fires about
    once in 8 steps (16 kHz over the 2 kHz symbol rate); and with
    independent symbol phases the share a warp skips is (1 - p)^L within
    0.05 for L = 1, 4, 8 and 32, p the measured fire rate: 88%, 59%, 34%
    and 1.4% at p = 1/8."""
    c, n = 256, 512
    x = _shifted(station_rds, c, n, seed=11)
    _, o = tbpsk.bpsk_plain(CFG, bpsk_init_state(c), x, station_rds[2]
                            .expand(c).contiguous())
    valid = o["valid"].numpy()
    p = float(valid.mean())
    assert 0.11 < p < 0.14, p
    for lanes in (1, 4, 8, 32):
        share = _skip_share_np(valid, lanes)
        assert abs(share - (1.0 - p) ** lanes) < 0.05, (lanes, share, p)
