"""A numpy model of the K3 probe's value schedule (``csrc/k3_probe.cu::
k3_value_kernel``), bit for bit against extract's plain version on zero
tails (``probes/k3_probe.py::extract_plain``, what ``full`` computes).

The model walks the kernel warp by warp, as the card runs it: a warp's
window of ``32 R`` float4 steps of re, im and dt from ``hr`` steps before
its first audio output (lane L's ``R`` float4 loads a plane, zero before
the row and past its end), each sample mixed once into five planes of
four phases (``kernels/extract.py::mix``, the kernel's op order), the FIRs
one step at a time: at step m every accumulator at window position P
adds its tap ``4 m + p`` times phase p of position P + m, phases in turn,
each product and sum rounded in float32; after the step every
plane-phase window slides by one (the physical slot m % R takes the next
lane's, lane 31 its own: what enters there is marked unreadable).  Then
the audio accumulators are taken ``d`` positions on (the kernel's
realigning shuffles) and the first ``lanes`` lanes store.

Each case checks, at the probe's orders (64 / 128 taps) and the kernel's
run (R = 4), on a row's first and last warps (every warp of
the small rows): each lane's window after every shuffle step (the step
index each slot holds); the addresses each warp loads (whole aligned
float4s, its window's, each once); that every stored output adds its
products in ``fir_dot``'s order (k ascending from 0, sample 4 j - halo +
k); that no stored output reads what entered lane 31; and the outputs
bit for bit against the plain version.  The refusals of other orders are
checked before any launch, on the CPU and the meta device.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fm_radio_tpu_torch.kernels import extract as _extract
from fm_radio_tpu_torch.probes import k3_probe as k3

F = np.float32
GONE = -(1 << 30)  # the step index of what entered lane 31


def _planes(xs):
    """The five planes the kernel mixes each sample into: re (L+R),
    L-R re / im, RDS re / im, as float32 numpy [C, N]."""
    xr, xi, dt = xs
    off = torch.zeros((xr.shape[0],))
    (mr, mi), (rr, ri) = _extract.mix(xr, xi, dt, off)
    return [p.numpy() for p in (xr, mr, mi, rr, ri)]


def _taps(co):
    """The reversed taps as the kernel reads them (wa, wm, wr)."""
    return [getattr(co, k).flip(0).numpy()
            for k in ("taps_audio_lpr", "taps_audio_lmr", "taps_rds")]


def warp_model(planes, taps, g: dict, c: int, b: int, n: int):
    """One warp (channel c, block b): (its loads [(lane, slot, float
    index)], audio {j: (value, products)} for the three audio planes,
    RDS {i: (value, products)} for the two RDS planes), checking every
    lane's window after each shuffle step."""
    run, nu = g["run"], g["nu"]
    na = n // 4
    j0 = b * nu
    t0 = j0 - g["hr"]
    lanes = np.arange(32)
    # window positions: lane L slot r is step t0 + R L + r
    t = t0 + run * lanes[:, None] + np.arange(run)[None, :]  # [32, R]
    inside = (t >= 0) & (t < na)
    loads = [(int(L), r, int(4 * t[L, r])) for L in range(32)
             for r in range(run) if inside[L, r]]
    # v[plane][lane, p, slot], idx[lane, p, slot]: the step each slot holds
    v = []
    for pl in planes:
        a = np.zeros((32, 4, run), F)
        for p in range(4):
            s = 4 * t + p
            ok = inside & (t >= 0)
            a[:, p, :][ok] = pl[c, s[ok]]
        v.append(a)
    idx = np.repeat(t[:, None, :], 4, axis=1)  # [32, 4, R]
    sa, sr = g["sa"], g["sr"]
    wa, wm, wr = taps
    acc = [np.zeros((32, run), F) for _ in range(3)] + [
        np.zeros((32, run // 2), F) for _ in range(2)]
    prods = {k: [[[] for _ in range(acc[k].shape[1])] for _ in range(32)]
             for k in range(5)}
    aidx = [idx.copy() for _ in range(3)] + [idx.copy() for _ in range(2)]
    for m in range(sr):
        for p in range(4):
            for k in range(5):
                if k < 3 and m >= sa:
                    continue
                w = (wa if k == 0 else wm if k < 3 else wr)[4 * m + p]
                nout = run if k < 3 else run // 2
                for r in range(nout):
                    logical = r if k < 3 else 2 * r
                    phys = (logical + m) % run
                    # the window after m shuffle steps: logical slot r
                    # holds step t0 + R L + r + m (or what entered lane 31)
                    want = t[:, logical] + m
                    got = aidx[k][:, p, phys]
                    assert np.all((got == want) | (got == GONE))
                    acc[k][:, r] = acc[k][:, r] + F(w) * v[k][:, p, phys]
                    for L in range(32):
                        prods[k][L][r].append(
                            (4 * m + p, int(4 * got[L] + p)
                             if got[L] != GONE else GONE))
                # the slide: slot m % R takes the next lane's
                s = m % run
                v[k][:31, p, s] = v[k][1:, p, s]
                v[k][31, p, s] = np.nan
                aidx[k][:31, p, s] = aidx[k][1:, p, s]
                aidx[k][31, p, s] = GONE
    audio = [{}, {}, {}]
    rds = [{}, {}]
    d = g["d"]
    for L in range(g["lanes"]):
        for r in range(run):
            src_l, src_r = L + (r + d) // run, (r + d) % run
            j = j0 + run * L + r
            if j < na:
                for k in range(3):
                    audio[k][j] = (acc[k][src_l, src_r],
                                   prods[k][src_l][src_r])
        for q in range(run // 2):
            i = j0 // 2 + run // 2 * L + q
            if i < n // 8:
                for k in range(2):
                    rds[k][i] = (acc[3 + k][L, q], prods[3 + k][L][q])
    return loads, audio, rds


def _xs(c: int, n: int, seed: int):
    return k3.make_inputs(c, n, "cpu", seed=seed)


@pytest.mark.parametrize("n", [64, 448, 1024, 32768])
def test_value_schedule_matches_plain(n):
    """The value schedule, warp by warp, bit for bit against the plain
    version on a row's first and last warps (every warp where N is
    small), with its windows, loads and sum order."""
    g = k3.value_geom()
    c = 2
    xs = _xs(c, n, seed=n)
    co = k3.coeffs()
    planes = _planes(xs)
    taps = _taps(co)
    want = [p.numpy() for p in k3.extract_plain(xs, co)]
    na, nr = n // 4, n // 8
    nb = -(-na // g["nu"])
    blocks = range(nb) if nb <= 12 else (0, 1, nb - 2, nb - 1)
    halo = (taps[0].size - 4, taps[2].size - 8)
    stored_a, stored_r = set(), set()
    for ch in range(c):
        for b in blocks:
            loads, audio, rds = warp_model(planes, taps, g, ch, b, n)
            # whole aligned float4s of the window, each once, in the row
            idx = [a for _, _, a in loads]
            assert len(idx) == len(set(idx))
            t0 = b * g["nu"] - g["hr"]
            assert set(idx) == {4 * t for t in range(t0, t0 + g["w"])
                                if 0 <= t < na}
            assert all(a % 4 == 0 for a in idx)
            for k, plane in enumerate(audio):
                for j, (val, pr) in plane.items():
                    assert [kk for kk, _ in pr] == list(range(taps[0].size))
                    assert [s for _, s in pr] == [4 * j - halo[0] + kk
                                                  for kk in range(len(pr))]
                    assert val == want[k][ch, j] or (
                        np.isnan(val) and np.isnan(want[k][ch, j]))
                    stored_a.add((k, ch, j))
            for k, plane in enumerate(rds):
                for i, (val, pr) in plane.items():
                    assert [kk for kk, _ in pr] == list(range(taps[2].size))
                    assert [s for _, s in pr] == [8 * i - halo[1] + kk
                                                  for kk in range(len(pr))]
                    assert val == want[3 + k][ch, i]
                    stored_r.add((k, ch, i))
    # every output of the walked warps is stored once: all of them where
    # every warp was walked
    if nb <= 12:
        assert len(stored_a) == 3 * c * na and len(stored_r) == 2 * c * nr


def test_value_geometry():
    """The block of a warp: R outputs a lane on the first ``lanes`` lanes,
    the rest of the window the RDS halo; 1.33x the loads at R = 4."""
    g = k3.value_geom()
    run = g["run"]
    assert g["nu"] == run * g["lanes"] and g["lanes"] + g["g"] == 32
    # the RDS output at the last stored position reads the window's end
    # at most, and so does the last audio output
    assert g["nu"] - 2 + g["sr"] - 1 <= g["w"] - 1
    assert g["d"] + g["nu"] - 1 + g["ha"] <= g["w"] - 1
    assert (run, g["nu"], g["g"]) == (k3.VALUE_RUN, 96, 8)
    assert g["threads"] == k3.VALUE_THREADS == 128


def _other(co, audio=None, rds=None):
    t = dict(vars(co))
    if audio is not None:
        t["taps_audio_lpr"] = t["taps_audio_lmr"] = torch.ones(audio) / audio
    if rds is not None:
        t["taps_rds"] = torch.ones(rds) / rds
    return SimpleNamespace(**t)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("audio,rds", [(96, 128), (64, 96), (32, 64),
                                       (132, 136)])
def test_value_refuses_other_orders_before_a_launch(device, audio, rds):
    """Only the probe's orders are built: any other (even one extract
    takes) is refused on every device before any launch or plain run."""
    xs = tuple(torch.zeros((2, 1024), device=device) for _ in range(3))
    co = _other(k3.coeffs(), audio, rds)
    before = k3.launches_value
    with pytest.raises(ValueError, match="built for"):
        k3.value(xs, co)
    assert k3.launches_value == before


def test_value_refuses_a_length_off_its_steps():
    xs = _xs(2, 1024, 0)
    with pytest.raises(ValueError, match="N % 64"):
        k3.value(tuple(x[:, :1000].contiguous() for x in xs))


def test_value_on_meta_reaches_the_dispatch():
    """At the probe's orders the checks pass and the device decides: the
    meta device has no kernel."""
    xs = tuple(torch.zeros((2, 1024), device="meta") for _ in range(3))
    with pytest.raises(ValueError, match="no kernel for device"):
        k3.value(xs, k3.coeffs())


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("build", ["default", "checked"])
def test_value_edges_on_card(build):
    """value equals its plain version and, where extract admits N, full
    (extract's kernel) bit for bit at C = 5 and 40, N = 64 (the smallest
    the entry admits), 448, 1,024, 5,120 and 32,768, on the default and
    the bounds-checked build (a trap fails the test); its geometry's C
    side equals the host copy; other orders are refused before any
    launch, by the wrapper and by the C entry
    (chip_smoke.compare_value_edges)."""
    _need_card()
    import contextlib

    import chip_smoke
    from fm_radio_tpu_torch.kernels import _build

    ctx = (_build.checked_build() if build == "checked"
           else contextlib.nullcontext())
    with ctx:
        rows = chip_smoke.compare_value_edges()
    n = len(chip_smoke.VALUE_EDGE_CS) * sum(
        1 + (n % 1024 == 0) for n in chip_smoke.VALUE_EDGE_NS)
    assert len(rows) == 1 + n + len(chip_smoke.VALUE_REFUSED) + 2
    assert all(r["ok"] for r in rows), [r for r in rows if not r["ok"]]
