"""The redesigned exact channelizer's schedule, and its limits.

The CUDA kernel (``csrc/channelizer.cu::chan_kernel<kPacked, kOut, M>``)
runs only on the card.  Here a numpy model of its schedule (the persistent
walk of the tiles, the skewed staging, the filter's sliding windows of
ZRUN frames, the z buffer in slot order with the phase-split permutation,
the register-blocked DFT of R channels x S slots and the output stores)
is held bit for bit against ``kernels/channelizer.py::channelize_plain``,
which the kernel is compared with on the card.  The model also checks that
every staged sample, z value and output is written exactly once and that
every read finds the sample the plain version reads there.  Then the
wrapper's limits (one instantiation per power of two M in [2, 128], the
phase-split form only at M = 32) refused before any launch on the meta
device, and ``probes/chan_phases.py``'s edits against the kernel's source.
"""

import numpy as np
import pytest
import torch

from fm_radio_tpu_torch.kernels import _build
from fm_radio_tpu_torch.kernels import channelizer as kch
from fm_radio_tpu_torch.parallel.channelizer import make_channelizer_taps
from fm_radio_tpu_torch.probes import chain_phases, chan_phases
from fm_radio_tpu_torch.utils.transfer import unpack_iq_words

F = np.float32
# csrc/channelizer.cu's schedule: persistent CTAs of THREADS threads walk
# tiles of TILE samples; a thread filters ZRUN frames of one phase and
# computes the DFT of R channels x S slots (ChanPlan, chan_pos, chan_plane)
THREADS, TILE, ZRUN = 256, kch.T_MULTIPLE, 16


def chan_plan(m: int):
    """ChanPlan<M>: (frames a tile, DFT channels a thread, DFT slots a
    thread, DFT threads a channel group, z row stride)."""
    frames = TILE // m
    r = 4 if m >= 4 else m
    s = 16 // r
    return frames, r, s, frames // s, frames + 4


def chan_pos(i, m: int):
    """Where staged sample ``i`` of a tile lies: M words of skew a block of
    ZRUN frames."""
    return i + m * (i // (ZRUN * m))


def chan_plane(m: int, k: int) -> int:
    """A staged plane's floats (a whole float4)."""
    return (chan_pos((TILE // m + k - 1) * m - 1, m) + 1 + 3) // 4 * 4


def _q8(y, m):
    """chan_q8: clip(rint(y * (1/M)) - 1, -128, 127) in float32."""
    v = np.rint(y * F(1.0 / m)) - F(1.0)
    return np.clip(v, -128.0, 127.0).astype(np.int8)


def _model(tab, state, xp, m: int, out: str):
    """chan_kernel's schedule on one call.  Returns y as channelize gives
    it (numpy), checking the index maps on the way."""
    plan = chan_plan(m)
    n_t, big_r, big_s, n_g, zs = plan
    w_rev = tab.w_rev.numpy()
    cos, sin = tab.cos.numpy().reshape(-1), tab.sin.numpy().reshape(-1)
    k = w_rev.shape[0]
    if isinstance(xp, tuple):
        xr, xi = (v.numpy() for v in xp)
    else:
        xr, xi = (v.numpy() for v in unpack_iq_words(xp))
    sr, si = (v.numpy() for v in state)
    n_w, t = xr.shape
    n_state = (k - 1) * m
    nf = t // m
    ch = n_w * m
    if out == "f32":
        y = np.full((2, n_w, m, nf), np.nan, F)
    elif out == "i8":
        y = np.zeros((2, n_w, m, nf), np.int8)
    else:
        y = np.zeros((2, 4, ch, nf // 4), np.int8)
    written = np.zeros(y.shape, np.int32)
    tid = np.arange(THREADS)
    ns = (n_t + k - 1) * m
    plane = chan_plane(m, k)
    i = np.arange(ns)
    pos = chan_pos(i, m)
    assert len(np.unique(pos)) == ns and pos.max() < plane
    # which staged sample sits where (-1: none)
    src = np.full(plane, -1)
    src[pos] = i
    for tile in range(n_w * (t // TILE)):  # the persistent walk
        w, f0 = divmod(tile, t // TILE)
        f0 *= n_t
        s = f0 * m + i  # x_pad samples of the tile
        xs = np.full((2, plane), np.nan, F)
        for v, (st, x) in enumerate(((sr, xr), (si, xi))):
            old = st[w, np.minimum(s, n_state - 1)] if n_state else 0.0
            xs[v, pos] = np.where(s < n_state, old,
                                  x[w, np.maximum(s - n_state, 0)])
        # 2. the filter: phase fp of frames ZRUN fb + j
        fp, fb = tid % m, tid // m
        base = chan_pos(ZRUN * fb * m, m) + fp

        def read(at, frame):
            got = src[at]
            assert (got == frame * m + fp).all(), "filter read"
            return xs[:, at]

        v = np.stack([read(base + j * m, ZRUN * fb + j)
                      for j in range(ZRUN)], -1)  # [2, thr, ZRUN]
        z = np.zeros_like(v)
        for rb in range(0, k, ZRUN):
            xb = base + rb * m + m * (rb // ZRUN)
            for qq in range(ZRUN):
                r = rb + qq
                if r >= k:
                    break
                wv = w_rev[r, fp]
                for j in range(ZRUN):
                    z[:, :, j] = (z[:, :, j]
                                  + v[:, :, (j + qq) % ZRUN] * wv)
                if r + 1 < k:
                    v[:, :, qq] = read(xb + (qq + ZRUN) * m + m,
                                       ZRUN * fb + r + ZRUN)
        # the z buffer [p][slot]: the frame of each slot
        zb = np.full((2, m * zs), np.nan, F)
        zsrc = np.full(m * zs, -1)
        for c in range(ZRUN // 4):
            for e in range(4):
                if out == "i8ps":
                    at, j = fp * zs + c * (n_t // 4) + 4 * fb + e, c + 4 * e
                else:
                    at, j = fp * zs + ZRUN * fb + 4 * c + e, 4 * c + e
                assert (zsrc[at] == -1).all(), "z written twice"
                zb[:, at] = z[:, :, j]
                zsrc[at] = (ZRUN * fb + j) * m + fp
        # 3. the DFT: channels R kg + a, slots 4 (sg + q G) + e
        sg, kg = tid % n_g, tid // n_g
        slots = np.stack([4 * (sg + q * n_g) + e for q in range(big_s // 4)
                          for e in range(4)], -1)  # [thr, S]
        frame = (4 * (slots % (n_t // 4)) + slots // (n_t // 4)
                 if out == "i8ps" else slots)
        acc = np.zeros((4, THREADS, big_r, big_s), F)
        for p in range(m):
            at = p * zs + slots
            assert (zsrc[at] == frame * m + p).all(), "DFT read"
            vr, vi = zb[0, at][:, None, :], zb[1, at][:, None, :]
            kk = p * m + big_r * kg[:, None] + np.arange(big_r)
            cs, sn = cos[kk][:, :, None], sin[kk][:, :, None]
            acc[0] = acc[0] + vr * cs
            acc[1] = acc[1] + vi * sn
            acc[2] = acc[2] + vr * sn
            acc[3] = acc[3] + vi * cs
        yr, yi = acc[0] - acc[1], acc[2] + acc[3]
        kch_ = big_r * kg[:, None, None] + np.arange(big_r)[None, :, None]
        kch_ = np.broadcast_to(kch_, yr.shape)
        fr = np.broadcast_to(frame[:, None, :], yr.shape)
        for v, yv in enumerate((yr, yi)):
            if out == "f32":
                idx = (v, w, kch_, f0 + fr)
                y[idx] = yv
            elif out == "i8":
                idx = (v, w, kch_, f0 + fr)
                y[idx] = _q8(yv, m)
            else:
                sl = np.broadcast_to(slots[:, None, :], yr.shape)
                idx = (v, sl // (n_t // 4), w * m + kch_,
                       f0 // 4 + sl % (n_t // 4))
                # the kernel's phase-split store is the frame's plane
                assert ((f0 + fr) % 4 == sl // (n_t // 4)).all()
                assert ((f0 + fr) // 4 == f0 // 4 + sl % (n_t // 4)).all()
                y[idx] = _q8(yv, m)
            np.add.at(written, idx, 1)
    assert (written == 1).all(), "every output written once"
    return tuple(torch.from_numpy(a) for a in y) if out == "f32" else \
        torch.from_numpy(y)


def _inputs(m: int, k: int, n_w: int, t: int, packed: bool, seed: int):
    rng = np.random.default_rng(seed)
    if packed:
        x = torch.from_numpy(
            (rng.integers(0, 256, (n_w, t)) * 256
             + rng.integers(0, 256, (n_w, t))).astype(np.float32))
    else:
        x = tuple(torch.from_numpy(rng.normal(0, 40.0, (n_w, t))
                                   .astype(np.float32)) for _ in range(2))
    st = tuple(torch.from_numpy(rng.normal(0, 40.0, (n_w, (k - 1) * m))
                                .astype(np.float32)) for _ in range(2))
    return x, st


CASES = ([(m, 16, out, True) for m in (2, 16, 32, 128)
          for out in ("f32", "i8")]
         + [(32, 16, "i8ps", True), (32, 1, "f32", False),
            (32, 17, "i8ps", False), (2, 17, "f32", False)])


@pytest.mark.parametrize("m,k,out,packed", CASES)
def test_chan_schedule_model_equals_plain(m, k, out, packed):
    """The model of chan_kernel's schedule equals channelize_plain bit for
    bit over two blocks with carried state, 2 captures x 2 tiles."""
    tab = kch.make_tables(make_channelizer_taps(m, k), m)
    x, st = _inputs(m, k, 2, 2 * TILE, packed, seed=m + k)
    st2, want = kch.channelize_plain(tab, st, x, m, out)
    got = _model(tab, st, x, m, out)
    if out == "f32":
        for g, wv in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), wv.numpy())
    else:
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    # the second block reads the carried state
    x2, _ = _inputs(m, k, 2, 2 * TILE, packed, seed=m + k + 1)
    _, want2 = kch.channelize_plain(tab, st2, x2, m, out)
    got2 = _model(tab, st2, x2, m, out)
    if out == "f32":
        np.testing.assert_array_equal(got2[0].numpy(), want2[0].numpy())
    else:
        np.testing.assert_array_equal(got2.numpy(), want2.numpy())


@pytest.mark.parametrize("m", [2, 4, 8, 16, 32, 64, 128])
def test_chan_plan_covers_the_tile(m):
    """Each M's plan: one filter run and one DFT block a thread, the tile
    covered once, whole float4 groups (csrc/channelizer.cu's
    static_asserts), and a z buffer and staging plane that fit the
    card's shared memory at K = 17."""
    n_t, r, s, g, zs = chan_plan(m)
    assert (m // r) * g == THREADS
    assert (n_t // ZRUN) * m == THREADS
    assert s % 4 == 0 and n_t % 4 == 0 and zs % 4 == 0
    floats = (max(2 * chan_plane(m, 17), 2 * m * zs) + 2 * m * m
              + 17 * m)
    assert 4 * floats <= 232448


def _meta_args(m=32, k=16, t=8192, packed=True, n_w=2):
    tab = kch.ChannelizerTables(
        taps=np.zeros(k * m, np.float32),
        w_rev=torch.empty((k, m), device="meta"),
        cos=torch.empty((m, m), device="meta"),
        sin=torch.empty((m, m), device="meta"), quant={})
    st = (torch.empty((n_w, (k - 1) * m), device="meta"),) * 2
    x = (torch.empty((n_w, t), device="meta") if packed else
         (torch.empty((n_w, t), device="meta"),) * 2)
    return tab, st, x


@pytest.mark.parametrize("kw,out,match", [
    (dict(m=1), "f32", "power of two"),
    (dict(m=3), "f32", "power of two"),
    (dict(m=48), "f32", "power of two"),
    (dict(m=256), "f32", "power of two"),
    (dict(m=16), "i8ps", "M = 32"),
    (dict(m=64), "i8ps", "M = 32"),
    (dict(k=18), "f32", "taps per phase"),
    (dict(t=4096 + 128), "f32", "multiple of 4096"),
    (dict(t=4096 + 128, packed=False), "i8", "multiple of 4096"),
])
def test_chan_limits_refused_before_launch_on_meta(kw, out, match):
    """Arguments outside the kernel's instantiations raise before any
    launch, on the meta device as on the card."""
    m = kw.get("m", 32)
    tab, st, x = _meta_args(**kw)
    before = kch.launches
    with pytest.raises(ValueError, match=match):
        kch.channelize(tab, st, x, m, out)
    assert kch.launches == before


@pytest.mark.parametrize("m", [2, 4, 8, 16, 32, 64, 128])
def test_chan_every_instantiation_dispatches_by_device(m):
    """Every M the kernel is instantiated for passes the limits and then
    dispatches by device: meta has no kernel, so it raises there (the card
    launches)."""
    tab, st, x = _meta_args(m=m)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        kch.channelize(tab, st, x, m, "f32")


@pytest.mark.parametrize("name", sorted(chan_phases.VARIANTS))
def test_chan_phases_edits_apply(name):
    """Every variant of probes/chan_phases.py finds each statement it edits
    in csrc/channelizer.cu exactly once (a variant that found none would
    time the full kernel under another name)."""
    src = (_build.CSRC / "channelizer.cu").read_text()
    out = chain_phases.variant_source(src, chan_phases.VARIANTS[name])
    assert (out == src) == (not chan_phases.VARIANTS[name])
