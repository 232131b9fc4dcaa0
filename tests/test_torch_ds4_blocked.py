"""The redesigned ds x4 kernels' schedules, the complex64 load, and the two
refusals that moved before any launch.

The CUDA kernels (``csrc/k12_stages.cuh::ds4_i8_blocked_kernel``,
``csrc/k12.cu::k12_ds4_ps_blocked_kernel``, ``csrc/frontend.cu::
k1_tile_kernel``) run only on the card; here numpy models of their
schedules (the staged tile, the register windows and their refills, the
zero-padded taps, the phase-split byte alignments, fir_block's tap order)
are held bit for bit against the plain versions the kernels are compared
with on the card (``kernels/frontend.py::ds4_theta_plain``, which
``frontend_plain`` and ``k12_plain`` run).  Then K1 on complex64 against
the stacked planes, ``demod_block`` on complex64 against the JAX package,
and the refusals of ``check_slice`` (carriers) and ``bpsk_sync`` (step
count) on every device, before any launch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_radio_tpu.config import DemodConfig as JDemodConfig
from fm_radio_tpu.models import demod as jdemod
from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.kernels import bpsk as tbpsk
from fm_radio_tpu_torch.kernels import frontend as tfront
from fm_radio_tpu_torch.kernels import k12 as tk12
from fm_radio_tpu_torch.models import demod as tdemod
from fm_radio_tpu_torch.ops.cmath import atan2_poly
from fm_radio_tpu_torch.ops.fir import correlate
from fm_radio_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

TILE = 1024  # csrc/k12_stages.cuh::kDs4Tile: ds x4 outputs a CTA
RUN = 8  # csrc/k12_stages.cuh::kDs4Run: outputs a thread


def _cfg(nn: int):
    return dataclasses.replace(tdemod.INT8_CONFIG,
                               order_poly_ds_lpf_fm_out=nn)


def _state(cfg, c: int, seed: int) -> dict:
    """demod_init_state with a random carried ds x4 tail (u8 - 127
    integers) and phase."""
    st = tdemod.demod_init_state(cfg, c)
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 256, (2,) + tuple(st["ds_fm_in"].shape)) - 127.0
    t = torch.from_numpy(t.astype(np.float32))
    st["ds_fm_in"] = torch.complex(t[0], t[1])
    st["disc_prev_theta"] = torch.from_numpy(
        rng.uniform(-3.0, 3.0, c).astype(np.float32))
    return st


def _u8(c: int, b: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (2, c, b)).astype(
        np.float32)


def _theta(y1r, y2r, y1i, y2i, s_row):
    """ds4_i8_theta: y1 + y2 / 128 + s_row in float32, then atan2_poly."""
    f = np.float32

    def comb(y1, y2):
        return (y1.astype(f) + y2.astype(f) * f(1.0 / 128.0)) + f(s_row)

    return atan2_poly(torch.from_numpy(comb(y1i, y2i)),
                      torch.from_numpy(comb(y1r, y2r))).numpy()


def _dp4a(words, tap):
    """__dp4a over bytes: words [..., 4] int8, tap [4] int8 -> int32."""
    return (words.astype(np.int32) * tap.astype(np.int32)).sum(-1)


def _flat_model(x8, tail8, b1, b2, s_row, run):
    """ds4_i8_blocked_kernel's schedule on int8 planes x8 [2, C, B] and
    tail8 [2, C, nn - 4]: per channel and tile of TILE outputs, words
    q = t0 - h + e staged at e (the tail before the row, zeros before it
    and past the row), the taps padded at the oldest end to whole blocks of
    ``run`` words; thread t's outputs t0 + run t + r summed from a sliding
    window of ``run`` words (slot (r + qq) % run, refilled with the word
    ``run`` steps on).  Returns theta1 [C, B/4]."""
    _, c, b = x8.shape
    n, nw = b // 4, len(b1) // 4
    nwp = -(-nw // run) * run
    h = -(-nwp // 4) * 4
    taps = np.zeros((nwp, 2, 4), np.int8)  # [w, (b1, b2), byte]
    taps[nwp - nw:, 0] = b1.reshape(nw, 4)
    taps[nwp - nw:, 1] = b2.reshape(nw, 4)
    row = np.concatenate([np.zeros((2, c, 4 * (h + 1)), np.int8), tail8,
                          x8, np.zeros((2, c, 4 * (TILE + 1)), np.int8)],
                         axis=-1).reshape(2, c, -1, 4)
    off = h + 1 + (nw - 1)  # row word index of q = 0
    n_t = -(-n // TILE)
    threads = TILE // run
    out = np.zeros((c, n_t * TILE), np.float32)
    for tile in range(n_t):
        t0 = tile * TILE
        stage = row[:, :, off + t0 - h: off + t0 + TILE + 1]  # e = 0..
        # zeros before the tail's first word (q < 1 - nw)
        q = t0 - h + np.arange(stage.shape[2])
        stage = np.where((q < 1 - nw)[None, None, :, None], 0, stage)
        eb = h - nwp + 1 + run * np.arange(threads)  # [threads]
        v = stage[:, :, eb[:, None] + np.arange(run)]  # [2, c, thr, run, 4]
        y = np.zeros((2, 2, c, threads, run), np.int32)  # [plane, tap, ...]
        for qb in range(0, nwp, run):
            for qq in range(run):
                for r in range(run):
                    k = (r + qq) % run
                    for tp in range(2):
                        y[:, tp, :, :, r] += _dp4a(v[:, :, :, k],
                                                   taps[qb + qq, tp])
                v[:, :, :, qq] = stage[:, :, eb + run + qb + qq]
        th = _theta(y[0, 0], y[0, 1], y[1, 0], y[1, 1], s_row)
        out[:, t0: t0 + TILE] = th.reshape(c, TILE)
    return out[:, :n]


def _ps_model(x8, tail8, b1, b2, s_row, run):
    """k12_ds4_ps_blocked_kernel's schedule: the planes split into phases
    (x_p[u] = x[4u + p]), each phase row's bytes cut at the four alignments
    (sub-plane s holds bytes 4 i + s .. 4 i + s + 3 of word i), the taps
    per phase b[4e + p] padded to whole blocks of run / 4 words; output r of
    a thread's run is alignment s = (r + 1) % 4's k-th, r = 4 k + (s + 3) %
    4, summed over phases from a window of run / 4 words of its sub-plane
    starting at h - nwqp + (s == 0) + run / 4 t + k."""
    _, c, b = x8.shape
    n, nn = b // 4, len(b1)
    ne, nwq = nn // 4, nn // 16
    rs = run // 4
    nwqp = -(-nwq // rs) * rs
    h = nwqp
    x4 = x8.reshape(2, c, n, 4).transpose(0, 3, 1, 2)  # [2, 4, C, n]
    t4 = tail8.reshape(2, c, ne - 1, 4).transpose(0, 3, 1, 2)
    pad = np.zeros((2, 4, c, 4 * (h + 1)), np.int8)
    rows = np.concatenate([pad, np.zeros((2, 4, c, 1), np.int8), t4, x4,
                           np.zeros((2, 4, c, 4 * (TILE // 4 + 2)),
                                    np.int8)], axis=-1)
    off = 4 * (h + 1) + ne  # byte index of row byte 0
    # zeros before the tail (bytes < -ne)
    rows[..., : off - ne] = 0
    taps = np.zeros((4, nwqp, 2, 4), np.int8)  # [phase, w, tap, byte]
    taps[:, nwqp - nwq:, 0] = b1.reshape(nwq, 4, 4).transpose(2, 0, 1)
    taps[:, nwqp - nwq:, 1] = b2.reshape(nwq, 4, 4).transpose(2, 0, 1)
    n_t = -(-n // TILE)
    threads = TILE // run
    out = np.zeros((c, n_t * TILE), np.float32)
    for tile in range(n_t):
        t0 = tile * TILE
        n_e = h + TILE // 4 + 1
        i = t0 // 4 - h + np.arange(n_e)  # word index of e
        byte = off + 4 * i[:, None, None] + np.arange(4)[None, :, None] \
            + np.arange(4)[None, None, :]  # [e, s, byte]
        sub = rows[:, :, :, byte]  # [2, 4, C, e, s, 4]
        y = np.zeros((2, 2, c, threads, run), np.int32)
        for p in range(4):
            for s in range(4):
                eb = h - nwqp + (s == 0) + rs * np.arange(threads)
                v = sub[:, p][:, :, eb[:, None] + np.arange(rs), s]
                for qb in range(0, nwqp, rs):
                    for qq in range(rs):
                        for k in range(rs):
                            r = 4 * k + (s + 3) % 4
                            for tp in range(2):
                                y[:, tp, :, :, r] += _dp4a(
                                    v[:, :, :, (k + qq) % rs],
                                    taps[p, qb + qq, tp])
                        v[:, :, :, qq] = sub[:, p][:, :,
                                                   eb + rs + qb + qq, s]
        th = _theta(y[0, 0], y[0, 1], y[1, 0], y[1, 1], s_row)
        out[:, t0: t0 + TILE] = th.reshape(c, TILE)
    return out[:, :n]


def _i8_args(co, st):
    b1, b2, s_row = co.k1_i8
    tail = st["ds_fm_in"]
    tail8 = (torch.stack([tail.real, tail.imag]) - 1.0).to(torch.int8)
    return b1.numpy(), b2.numpy(), s_row, tail8.numpy()


# (C, B): one channel, two tiles; odd C with a last tile of 32 outputs;
# four tiles; odd C with a last tile of 32 outputs past two
DS4_SHAPES = [(1, 8192), (3, 4224), (2, 16384), (5, 8320)]


@pytest.mark.parametrize("nn", [64, 48])
@pytest.mark.parametrize("shape", DS4_SHAPES, ids=str)
def test_k12_flat_run_schedule_equals_plain(nn, shape):
    """The flat form's run schedule (the tail entering only the channel's
    first tile, a last tile of 32 outputs at B = 4,224 and 8,320, the taps
    padded at nn = 48) gives theta1 bit for bit as k12_plain computes
    it."""
    c, b = shape
    cfg = _cfg(nn)
    co, st = tdemod.make_coeffs(cfg), _state(cfg, c, seed=nn + c)
    x8 = torch.from_numpy(_u8(c, b, seed=RUN + b) - 128.0).to(torch.int8)
    ref, _ = tfront.ds4_theta_plain(co, st, x8, True)
    b1, b2, s_row, tail8 = _i8_args(co, st)
    got = _flat_model(x8.numpy(), tail8, b1, b2, s_row, RUN)
    np.testing.assert_array_equal(got, ref.numpy())


@pytest.mark.parametrize("nn", [64, 48])
@pytest.mark.parametrize("shape", DS4_SHAPES, ids=str)
def test_k12_phase_split_schedule_equals_plain(nn, shape):
    """The phase-split form's schedule (four byte alignments of each phase
    row, the tail's pad byte, the taps per phase padded at nn = 48 to
    whole blocks of two words) gives theta1 bit for bit as k12_ps_plain
    computes it."""
    c, b = shape
    cfg = _cfg(nn)
    co, st = tdemod.make_coeffs(cfg), _state(cfg, c, seed=nn + c + 1)
    x8 = torch.from_numpy(_u8(c, b, seed=RUN + b + 1) - 128.0).to(torch.int8)
    ref, _ = tfront.ds4_theta_plain(co, st, x8, True)
    b1, b2, s_row, tail8 = _i8_args(co, st)
    got = _ps_model(x8.numpy(), tail8, b1, b2, s_row, RUN)
    np.testing.assert_array_equal(got, ref.numpy())
    # and the plain phase-split K12 reads the same planes
    x4 = x8.reshape(2, c, b // 4, 4).permute(0, 3, 1, 2).contiguous()
    torch.testing.assert_close(tk12.interleave_ps(x4), x8, atol=0, rtol=0)


def _fir_block_model(plane, w, lanes):
    """extract_stages.cuh::fir_block<4, 8, 64, 4> on one staged plane
    (index e = sample 4 t0 - nn + e of the tile): lane L's outputs
    8 L + r sum w[k] * x[32 L + 4 + 4 r + k] from 0.0 in float32, k = 4 q
    + p ascending (a step q, its four phases), each product and sum
    rounded, sample read from the phase's window slot (r + qq) % 8."""
    f = np.float32
    R, M, NQ = 8, 4, 16
    L = np.arange(lanes)[:, None]
    v = np.stack([plane[32 * L + 4 + M * np.arange(R)[None] + p]
                  for p in range(M)])  # [p, lanes, R]
    acc = np.zeros((lanes, R), f)
    for qb in range(0, NQ, R):
        for qq in range(R):
            for p in range(M):
                wk = w[M * (qb + qq) + p]
                for r in range(R):
                    acc[:, r] = (acc[:, r]
                                 + f(wk) * v[p, :, (r + qq) % R]).astype(f)
                last = qb + R >= NQ and qq + 1 == R
                if not last:
                    v[p, :, qq] = plane[32 * L[:, 0] + 4
                                        + M * (R + qb + qq) + p]
    return acc.reshape(-1)


@pytest.mark.parametrize("form", ["planes", "words", "complex", "i8"])
def test_k1_fir_block_order_equals_plain(form):
    """The float K1's staged tile summed in fir_block<4, 8, 64>'s order
    (warp quarter wq of the tile's 1,024 outputs at plane offset 1024 wq,
    the carried tail before the channel's first tile) equals frontend_plain's
    fm_in exactly, and so its theta1, on every load form."""
    c, b = 2, 8192
    cfg = DemodConfig()
    co, st = tdemod.make_coeffs(cfg), _state(cfg, c, seed=3)
    u8 = _u8(c, b, seed=4)
    x = {"planes": torch.from_numpy(u8 - 127.0),
         "words": torch.from_numpy(u8[0] * 256.0 + u8[1]),
         "complex": torch.complex(torch.from_numpy(u8[0] - 127.0),
                                  torch.from_numpy(u8[1] - 127.0)),
         "i8": torch.from_numpy(u8 - 128.0).to(torch.int8)}[form]
    nn = co.taps_fm_in.shape[0]
    w = co.taps_fm_in.flip(0).numpy()
    theta, xf = tfront.ds4_theta_plain(co, st, x, False)
    fm = correlate(w.tolist(), xf, 4, b // 4)  # frontend_plain's fm_in
    halo = nn - 4
    xs = xf.numpy()  # [2, C, halo + B]: sample n at halo + n
    got = np.zeros((2, c, b // 4), np.float32)
    for t0 in range(0, b // 4, TILE):
        # the tile's plane: samples 4 t0 - nn ..; before the tail, zeros
        lo = 4 * t0 - nn + halo
        plane = np.zeros((2, c, nn + 4 * TILE), np.float32)
        src = xs[:, :, max(lo, 0): lo + nn + 4 * TILE]
        plane[:, :, nn + 4 * TILE - src.shape[-1]:] = src
        for wq in range(4):
            for pl in range(2):
                for ch in range(c):
                    got[pl, ch, t0 + 256 * wq: t0 + 256 * (wq + 1)] = \
                        _fir_block_model(plane[pl, ch, 1024 * wq:], w, 32)
    np.testing.assert_array_equal(got, fm.numpy())
    th = atan2_poly(torch.from_numpy(got[1]), torch.from_numpy(got[0]))
    torch.testing.assert_close(th, theta, atol=0, rtol=0)


@pytest.mark.parametrize("int8_taps", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("out_i16", [False, True], ids=["f32", "i16"])
def test_frontend_plain_complex_equals_planes(int8_taps, out_i16):
    """K1's plain version on complex64 (the form the kernel now reads in
    place) equals it on the stacked planes bit for bit: fm_demod and the
    carried state, two blocks."""
    c, b = 3, 8192
    cfg = DemodConfig()
    co = tdemod.make_coeffs(cfg)
    rng = np.random.default_rng(5)
    xc = (rng.standard_normal((c, 2 * b)) * 40
          + 1j * rng.standard_normal((c, 2 * b)) * 40).astype(np.complex64)
    if int8_taps:  # integers on the u8 grid, as int8 taps need
        xc = (np.clip(np.round(xc.real), -127, 128)
              + 1j * np.clip(np.round(xc.imag), -127, 128)).astype(
                  np.complex64)
    assert tfront.input_form(torch.from_numpy(xc)) == "complex"
    st_c = st_p = _state(cfg, c, seed=6)
    for blk in range(2):
        xb = torch.from_numpy(np.ascontiguousarray(xc[:, blk * b:
                                                      (blk + 1) * b]))
        xp = torch.stack([xb.real, xb.imag]).contiguous()
        st_c, yc = tfront.frontend(co, cfg, st_c, xb, int8_taps, out_i16)
        st_p, yp = tfront.frontend(co, cfg, st_p, xp, int8_taps, out_i16)
        torch.testing.assert_close(yc, yp, atol=0, rtol=0)
        for k in ("ds_fm_in", "disc_prev_theta"):
            torch.testing.assert_close(st_c[k], st_p[k], atol=0, rtol=0)


def _k1_views(form: str, b: int):
    """(a contiguous K1 input of one channel in ``form``, a strided view of
    the same values, a contiguous view of them that starts one element
    into its storage)."""
    rng = np.random.default_rng(9)
    u8 = rng.integers(0, 256, (2, 1, b)).astype(np.float32)
    if form == "complex":
        x = torch.complex(torch.from_numpy(u8[0] - 127.0),
                          torch.from_numpy(u8[1] - 127.0))
    elif form == "words":
        x = torch.from_numpy(u8[0] * 256.0 + u8[1])
    else:
        x = torch.from_numpy(u8 - (127.0 if form == "planes" else 128.0))
        if form == "i8":
            x = x.to(torch.int8)
    strided = torch.stack([x, x], dim=-1)[..., 0]  # every other element
    store = torch.empty(x.numel() + 1, dtype=x.dtype)
    offset = store[1:].view(x.shape).copy_(x)
    return x, strided, offset


@pytest.mark.parametrize("form", ["complex", "planes", "words", "i8"])
def test_k1_input_read_in_place_or_copied(form):
    """K1 reads its input in place where it can (contiguous, aligned as it
    loads: 16 bytes, 4 for int8) and copies it into a new allocation
    otherwise: a strided view, or a one-channel slice that starts between
    vectors, gives the same values, contiguous and aligned, and the same
    K1 output as the contiguous block."""
    b = 8192
    x, strided, offset = _k1_views(form, b)
    align = 4 if form == "i8" else 16
    assert tfront.readable(x) is x
    assert not strided.is_contiguous() and offset.is_contiguous()
    assert offset.data_ptr() % align != 0
    cfg = DemodConfig()
    co = tdemod.make_coeffs(cfg)
    st = _state(cfg, 1, seed=3)
    _, want = tfront.frontend(co, cfg, st, x, False)
    for v in (strided, offset):
        got = tfront.readable(v)
        assert got.is_contiguous() and got.data_ptr() % align == 0
        assert got.data_ptr() != v.data_ptr()
        torch.testing.assert_close(got, v, atol=0, rtol=0)
        _, y = tfront.frontend(co, cfg, st, v, False)
        torch.testing.assert_close(y, want, atol=0, rtol=0)


@pytest.mark.parametrize("kw", [{}, {"frontend_int8": True,
                                     "assume_integer_input": True}],
                         ids=["default", "int8_taps"])
def test_demod_block_complex_matches_jax(kw):
    """demod_block on complex64 (K1 reads it in place) against the JAX
    package's split path (its Pallas kernels in interpret mode, which split
    the planes in XLA), at C = 3, two blocks: rds_valid and the RDS bits
    (the sign of pred where valid) identical, audio and pred within 1e-4
    (tests/test_torch_split_e2e.py's block tolerances), the carried input
    tail exact."""
    c, b = 3, 8192
    tcfg = DemodConfig(**kw)
    jcfg = JDemodConfig(loop_impl="pallas", **kw)
    rng = np.random.default_rng(7)
    xc = (rng.standard_normal((c, 2 * b)) * 40
          + 1j * rng.standard_normal((c, 2 * b)) * 40)
    if kw:  # the int8 taps take integers on the u8 grid (u8 - 127)
        xc = (np.clip(np.round(xc.real), -127, 128)
              + 1j * np.clip(np.round(xc.imag), -127, 128))
    xc = xc.astype(np.complex64)
    co_j, co_t = jdemod.make_coeffs(jcfg), tdemod.make_coeffs(tcfg)
    st_j = jdemod.demod_init_state(jcfg, c)
    st_t = state_from_numpy(jax.tree.map(np.asarray, st_j))
    for blk in range(2):
        xb = np.ascontiguousarray(xc[:, blk * b: (blk + 1) * b])
        st_j, oj = jdemod.demod_block(jcfg, co_j, st_j, jnp.asarray(xb))
        st_t, ot = tdemod.demod_block(tcfg, co_t, st_t, torch.from_numpy(xb))
        valid = np.asarray(oj["rds_valid"])
        np.testing.assert_array_equal(ot["rds_valid"].numpy(), valid)
        np.testing.assert_array_equal(ot["rds_pred"].numpy()[valid] > 0,
                                      np.asarray(oj["rds_pred"])[valid] > 0)
        np.testing.assert_allclose(ot["audio"].numpy(),
                                   np.asarray(oj["audio"]), atol=1e-4, rtol=0)
        np.testing.assert_allclose(ot["rds_pred"].numpy()[valid],
                                   np.asarray(oj["rds_pred"])[valid],
                                   atol=1e-4, rtol=0)
        np.testing.assert_array_equal(state_to_numpy(st_t)["ds_fm_in"],
                                      np.asarray(st_j["ds_fm_in"]))


def _counting(monkeypatch, names):
    """Wrap demod_block's kernel wrappers to count their calls."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(tdemod, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(tdemod, name, wrapped)
    return calls


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("carrier", ["f_audio_lmr_center", "f_rds_center"])
def test_carriers_raise_before_any_launch(monkeypatch, device, carrier):
    """An L-R or RDS carrier that is not the pilot's 2nd or 3rd harmonic
    raises NotImplementedError from check_slice, before K12, K1, K2, the
    PLL or extract is called, on the CPU and on the card's device type
    (on meta a reached wrapper would raise ValueError instead)."""
    names = ("k12", "frontend", "frontend_i8", "midend", "pilot_pll_theta",
             "extract", "chain")
    calls = _counting(monkeypatch, names)
    base = tdemod.INT8_CONFIG
    cfg = dataclasses.replace(base, analog=dataclasses.replace(
        base.analog, **{carrier: getattr(base.analog, carrier) + 1000.0}))
    co = tdemod.make_coeffs(cfg)
    x = torch.zeros((2, 1, 8192), dtype=torch.int8, device=device)
    with pytest.raises(NotImplementedError, match="harmonics"):
        tdemod.demod_block(cfg, co, tdemod.demod_init_state(cfg, 1, device),
                           x)
    assert calls == dict.fromkeys(names, 0)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_bpsk_step_count_refused_on_every_device(device):
    """bpsk_sync refuses N % 16 != 0 with the same ValueError on the CPU and
    on the card's device type, before any launch (on meta a kernel launch
    would raise "no kernel for device meta"); N = 32 passes the check."""
    cfg = DemodConfig()
    st = tdemod.demod_init_state(cfg, 2, device)["bpsk"]
    before = tbpsk.launches
    for n in (24, 8):
        x = torch.zeros((2, n), device=device)
        with pytest.raises(ValueError, match="multiple of 16"):
            tbpsk.bpsk_sync(cfg, st, (x, x))
    x = torch.zeros((2, 32), device=device)
    if device == "cpu":
        tbpsk.bpsk_sync(cfg, st, (x, x))
    else:
        with pytest.raises(ValueError, match="no kernel for device meta"):
            tbpsk.bpsk_sync(cfg, st, (x, x))
    assert tbpsk.launches == before
