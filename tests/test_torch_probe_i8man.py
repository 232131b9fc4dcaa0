"""The K1 engine probe's manual-pipeline kernel, on the host.

``csrc/frontend_probe.cu::fp_i8man_kernel`` runs only on the card.  Here a
numpy model of its schedule is held bit for bit against the plain version
it must equal (``probes/frontend_probe.py::i8man_plain``) and against the
TPU tool's ``build_i8manual`` run in Pallas interpret mode: one CTA per
c_blk rows walking the time tiles; each tile's rows landed unskewed in the
input ring at a pitch of t_blk / 4 + MAN_PAD words (the words past a row
left as garbage here, which only zero taps meet); thread e of
MAN_THREADS taking run e (row e % c_blk, outputs 8 (e // c_blk) ..), two
passes where a tile has more runs than threads; the window read 16 bytes
at a time, three quads a plane, stepping 4 of the 36 padded tap words at
a time (words eb + 4g .. eb + 4g + 11 before step g); the run's window
starting at its first output's word (outputs j < no: the tile's words j
.. j + 32) or 32 words before it (the others); the float combine of
``ds4_i8_words``; full's atan2 and the difference from the run before
(its last theta in shared memory, the tile's first output from itself);
the outputs through the output ring, each written once.  Also the
layout's claim that a quarter warp's 16-byte reads and stores fall in 8
distinct bank groups at the lens's c_blk = 8, the host copy of the
kernel's shared memory, and the refusals before any launch.

The integer sums are exact and the model rounds the float combine, atan2
(``ops/cmath.py::atan2_poly``, the plain version's own) and the
difference to float32 as ``-fmad=false`` makes the kernel do: equality is
exact.  Against the tool in interpret mode: dots exact; full within 1e-6
(XLA contracts the tool's atan2 polynomial into FMAs on the CPU), compared
modulo the wrap 2 pi 0.123.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.frontend_probe as tfp
from fm_radio_tpu_torch.ops.cmath import atan2_poly
from fm_radio_tpu_torch.probes import frontend_probe as fp

F = np.float32
C, B = 16, 16384
HALO_W = (fp.NN - fp.M) // fp.M  # 32: the window's reach in words
NW = fp.NN // fp.M  # 33 tap words
SCALE = F(0.123)
PI, TWO_PI = F(np.pi), F(2 * np.pi)
WRAP = F(2 * np.pi) * SCALE
# (c_blk, t_blk, no): the lens's tiles; no at its least and most; one row
# a CTA; two passes (more runs than threads)
TILES = ((8, 2048, 128), (8, 4096, 128), (8, 4096, 32), (8, 2048, 480),
         (1, 512, 32), (16, 1024, 64), (16, 2048, 128))


@pytest.fixture(scope="module")
def x8():
    return fp.make_inputs(C, B, "cpu", seed=4)["u8"]


@pytest.fixture(scope="module")
def tb():
    return fp.tables()


def _words(b: np.ndarray) -> np.ndarray:
    """int8 bytes [..., 4 n] as their little-endian int32 words [..., n]."""
    return np.ascontiguousarray(b).view(np.int32)


def _bytes(w: np.ndarray) -> np.ndarray:
    """int32 words [...] as their four signed bytes [..., 4] (int64)."""
    return np.ascontiguousarray(w).view(np.int8).reshape(
        w.shape + (4,)).astype(np.int64)


def disc(theta, prev):
    """``k12_stages.cuh::disc_value`` at kFpScale in float32."""
    d = (theta - prev).astype(F)
    d = np.where(d >= PI, d - TWO_PI, d).astype(F)
    d = np.where(d <= -PI, d + TWO_PI, d).astype(F)
    return (d * SCALE).astype(F)


def man_model(x8: torch.Tensor, full: bool, c_blk: int, t_blk: int, no: int,
              tb: dict, seed: int = 0, trace: dict | None = None):
    """fp_i8man_kernel's schedule (module docstring): out [C, B / 4];
    ``trace`` collects each tile's word reads and output stores by
    (thread, pass) for the bank checks."""
    rng = np.random.default_rng(seed)
    planes = x8.numpy()
    c, b = planes.shape[1:]
    tw, pitch = t_blk // fp.M, t_blk // fp.M + fp.MAN_PAD
    runs = c_blk * (tw // fp.MAN_RUN)
    assert runs <= fp.MAN_PASSES * fp.MAN_THREADS
    taps = np.zeros((fp.MAN_TAP_WORDS, 2), np.int32)  # (b1, b2) word pairs
    taps[:NW, 0] = _words(tb["b1"].numpy())
    taps[:NW, 1] = _words(tb["b2"].numpy())
    tap_b = _bytes(taps)  # [36, 2, 4]
    out = np.full((c, b // fp.M), np.nan, F)
    s_row = F(tb["s_row"])
    for c0 in range(0, c, c_blk):
        for i in range(b // t_blk):
            # the slot: [2 planes][c_blk rows][pitch words], garbage past
            # each row's tw words (never written by the bulk copies)
            slot = rng.integers(-2 ** 31, 2 ** 31, (2, c_blk, pitch),
                                dtype=np.int64).astype(np.int32)
            for p in range(2):
                rows = planes[p, c0:c0 + c_blk, i * t_blk:(i + 1) * t_blk]
                slot[p, :, :tw] = _words(rows)
            ys = np.full((c_blk, pitch), np.nan, F)
            sb = _bytes(slot)  # [2, c_blk, pitch, 4]
            v, s_last = {}, np.full(runs, np.nan, F)
            for k in range(fp.MAN_PASSES):
                e = np.arange(fp.MAN_THREADS) + k * fp.MAN_THREADS
                e = e[e < runs]
                if e.size == 0:
                    continue
                r, j0 = e % c_blk, fp.MAN_RUN * (e // c_blk)
                eb = np.where(j0 < no, j0, j0 - HALO_W)
                assert (eb % 4 == 0).all()
                y = np.zeros((4, e.size, fp.MAN_RUN), np.int64)
                reads = []

                def quad(at):
                    """a 16-byte read of words at .. at + 3 of each plane's
                    row (its word indices)"""
                    assert (at >= 0).all() and (at + 4 <= pitch).all()
                    reads.extend([r * pitch + at] * 2)
                    return at[:, None] + np.arange(4)

                q0, q1 = quad(eb), quad(eb + 4)
                # slot u + kk of the 12 words holds output u's word at tap
                # word 4 g + kk
                uk = np.arange(fp.MAN_RUN)[:, None] + np.arange(4)
                for g in range(fp.MAN_TAP_WORDS // 4):
                    q2 = quad(eb + 4 * g + 8)
                    win = np.concatenate([q0, q1, q2], axis=1)[:, uk]
                    t = tap_b[4 * g:4 * g + 4]  # [4 kk, 2 (b1, b2), 4]
                    for pl in (0, 1):
                        wb = sb[pl, r[:, None, None], win]  # [n, 8, 4, 4]
                        for h in (0, 1):
                            y[2 * pl + h] += (wb * t[:, h]).sum((2, 3))
                    q0, q1 = q1, q2
                fr = (y[0].astype(F) + y[1].astype(F) * F(1 / 128)) + s_row
                fi = (y[2].astype(F) + y[3].astype(F) * F(1 / 128)) + s_row
                if full:
                    vals = atan2_poly(torch.from_numpy(fi),
                                      torch.from_numpy(fr)).numpy()
                    s_last[e] = vals[:, -1]
                else:
                    vals = (fr + fi).astype(F)
                v[k] = (e, r, j0, vals)
                if trace is not None:
                    trace.setdefault("reads", []).append((e, reads))
            for k, (e, r, j0, vals) in v.items():
                o = vals
                if full:
                    prev0 = np.where(j0 == 0, vals[:, 0],
                                     s_last[np.maximum(e - c_blk, 0)])
                    prev = np.concatenate([prev0[:, None], vals[:, :-1]], 1)
                    o = disc(vals, prev)
                idx = r[:, None] * pitch + j0[:, None] + np.arange(8)
                assert np.isnan(ys.reshape(-1)[idx]).all()  # written once
                ys.reshape(-1)[idx] = o
                if trace is not None:
                    trace.setdefault("stores", []).append(
                        (e, [r * pitch + j0, r * pitch + j0 + 4]))
            out[c0:c0 + c_blk, i * tw:(i + 1) * tw] = ys[:, :tw]
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("full", [False, True], ids=["dots", "full"])
@pytest.mark.parametrize("c_blk,t_blk,no", TILES,
                         ids=[f"{c}x{t}:no={n}" for c, t, n in TILES])
def test_man_schedule_equals_plain(x8, tb, c_blk, t_blk, no, full):
    """The model equals i8man_plain bit for bit: both runs of each tile,
    the quads of the window, the padded taps, the difference across runs
    and passes."""
    want = fp.i8man_plain(x8, full, t_blk, no, tb).numpy()
    got = man_model(x8, full, c_blk, t_blk, no, tb)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("t_blk", [2048, 4096])
@pytest.mark.parametrize("mode", ["dots", "full"])
def test_man_schedule_matches_tool(monkeypatch, tb, mode, t_blk):
    """The model against build_i8manual in Pallas interpret mode (C = 8,
    B = 4,096, the tool's c_blk = C): dots exact, full within 1e-6."""
    monkeypatch.setattr(tfp, "_INTERPRET", True)
    c, b = 8, 4096
    inp = fp.make_inputs(c, b, "cpu", seed=2)
    y = np.asarray(tfp.build_i8manual(c, b, 128, mode, c_blk=c, t_blk=t_blk)(
        jnp.asarray(inp["u8"][0].numpy()), jnp.asarray(inp["u8"][1].numpy())))
    got = man_model(inp["u8"], mode == "full", 8, t_blk, 128, tb)
    if mode == "dots":
        np.testing.assert_array_equal(got, y)
    else:
        d = np.abs(got - y)
        d = np.minimum(d, np.abs(d - WRAP))
        assert d.max() <= 1e-6, d.max()


@pytest.mark.parametrize("t_blk", [2048, 4096])
def test_quarter_warps_read_and_store_distinct_bank_groups(x8, tb, t_blk):
    """At the lens's c_blk = 8 every quarter warp (8 neighbouring threads)
    reads its window's quads and stores its outputs at 16-byte offsets
    that fall in 8 distinct bank groups (offset / 4 mod 8): one wavefront
    each, no conflict."""
    trace = {}
    man_model(x8[:, :8, :t_blk].contiguous(), True, 8, t_blk, 128, tb,
              trace=trace)
    for kind in ("reads", "stores"):
        for e, addrs in trace[kind]:
            for a in addrs:
                groups = (np.asarray(a) // 4 % 8).reshape(-1, 8)
                assert all(len(set(q)) == 8 for q in groups), kind


def test_smem_host_copy_and_refusals():
    """The host copy of the kernel's shared memory counts the model's
    buffers; the lens's largest tile (8 x 4,096 full) fits, with the 32 KB
    theta tile of the earlier design gone; a tile past the threads or the
    shared memory and a ``no`` that is not a multiple of 8 inside [32,
    t_blk / 4 - 32] are refused before any launch, on the CPU too."""
    for c_blk, t_blk in ((8, 2048), (8, 4096), (1, 512), (16, 2048)):
        for full in (False, True):
            pitch = t_blk // 4 + fp.MAN_PAD
            runs = c_blk * t_blk // 4 // 8
            want = (2 * 2 * c_blk * pitch * 4 + 2 * c_blk * pitch * 4
                    + fp.MAN_TAP_WORDS * 8 + (4 * runs if full else 0))
            assert fp.i8man_smem(c_blk, t_blk, full) == want
    # fits; the earlier design took 6 c_blk t_blk + c_blk t_blk (229,376)
    assert fp.i8man_smem(8, 4096, True) <= fp.SMEM_BYTES - 64
    assert fp.i8man_smem(8, 4096, True) < 7 * 8 * 4096
    x = fp.make_inputs(16, 8192, "cpu")["u8"]
    for c_blk, t_blk, no in ((16, 4096, 128), (8, 2048, 36), (8, 2048, 24),
                             (8, 2048, 488)):
        with pytest.raises(ValueError):
            fp.i8manual(x, True, c_blk, t_blk, no)
