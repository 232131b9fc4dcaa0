"""The K1 probe's int8-direct forms on K12's staged ds x4 tile, on the host.

``fmt_fp_i8d`` runs every form on ``k12_stages.cuh::ds4_i8_blocked_kernel``
(a CTA a channel's segment of 1,024 outputs, staged behind 40 words of
head; a thread's run of 8 outputs from a sliding window over the 33 tap
words padded to 40), through ``FpI8dStore``'s rule: noasm starts the
window of a tile's outputs j < no 32 words later.  The kernel runs only
on the card (``chip_smoke.compare_i8d_edges``, max abs error 0).  Here a
numpy model of that schedule: every run's loads (its first window and
each refill) lie in its CTA's staged words for each t_blk the entry
admits, noasm's tile seams included, and the model's outputs, summed
from the staged words, equal ``i8d_plain`` bit for bit on every form;
and the wrapper's refusals, before any launch, on the CPU and on
another device.
"""

import numpy as np
import pytest
import torch

from fm_radio_tpu_torch.ops.cmath import atan2_poly
from fm_radio_tpu_torch.probes import frontend_probe as fp

TILE, RUN = fp.DS4_TILE, fp.DS4_RUN     # K12's kDs4Tile, kDs4Run
NW = fp.NN // 4                         # tap words: 33
NWP = (NW + RUN - 1) // RUN * RUN       # padded to whole runs: 40
HEAD = (NWP + 3) // 4 * 4               # staged words before a segment
F32 = np.float32
PI, TWO_PI = F32(np.pi), F32(2 * np.pi)


def _disc(theta, prev):
    """k12_stages.cuh::disc_value at the probe's scale, elementwise."""
    d = (theta - prev).astype(F32)
    d = np.where(d >= PI, d - TWO_PI, d).astype(F32)
    d = np.where(d <= -PI, d + TWO_PI, d).astype(F32)
    return (d * fp.SCALE).astype(F32)


def i8d_model(x8, full, t_blk, no, noasm, tb):
    """fp_i8d on K12's tile, CTA by CTA: stage words t0 - HEAD .. t0 +
    TILE of each row (zeros before and past it), each run's window from
    word HEAD - NWP + 1 + 8 run + shift, the int32 sums of the padded taps
    over the staged bytes, the value (fr + fi or atan2), and full's
    in-tile difference as the runs finish it (each run's first output
    after the previous run's last theta, from shared memory; a tile's
    first output after itself: 0; a CTA that starts inside a tile, its
    first output after theta(t0 - 1), summed once more from the staged
    head).  Asserts every load lies in the staged words."""
    c, b = x8.shape[1:]
    n, tw = b // 4, t_blk // 4
    taps = np.stack([np.concatenate([np.zeros(4 * (NWP - NW), np.int64),
                                     np.asarray(tb[k], np.int64)])
                     for k in ("b1_list", "b2_list")], axis=1)  # [160, 2]
    s_row = F32(tb["s_row"])
    n_e = HEAD + TILE + 1
    # each row's bytes behind HEAD zero words, zeros past it
    rows = np.zeros((2, c, 4 * (HEAD + n + TILE + 1)), np.int64)
    rows[:, :, 4 * HEAD : 4 * (HEAD + n)] = x8.numpy()
    runs = np.arange(TILE // RUN)
    out = np.zeros((c, n), F32)
    for t0 in range(0, n, TILE):
        staged = rows[:, :, 4 * t0 : 4 * (t0 + n_e)]  # word e: t0 - HEAD + e
        shift = np.array([fp.i8d_shift(t0 + RUN * r, t_blk, no, noasm)
                          for r in runs])
        eb = HEAD - NWP + 1 + RUN * runs + shift
        # a run's first window (eb .. eb + 7) and its refills (eb + 8 ..
        # eb + 8 + NWP - 1): all staged
        assert eb.min() >= 0 and (eb + RUN + NWP - 1).max() < n_e, t0
        start = (eb[:, None] + np.arange(RUN)[None, :]).reshape(-1)
        idx = 4 * start[:, None] + np.arange(4 * NWP)[None, :]
        y = staged[:, :, idx] @ taps  # [2 planes, C, TILE, 2 tap planes]
        fr, fi = (((y[p, ..., 0].astype(F32) + y[p, ..., 1].astype(F32)
                    * F32(1 / 128)).astype(F32) + s_row).astype(F32)
                  for p in (0, 1))
        if not full:
            v = (fr + fi).astype(F32)
        else:
            th = atan2_poly(torch.from_numpy(fi), torch.from_numpy(fr)).numpy()
            head = th[:, :1]
            if t0 % tw:  # the tile began in the CTA before: theta(t0 - 1)
                e = HEAD - NWP  # K12's window of output t0 - 1: staged
                assert e >= 0
                ye = staged[:, :, 4 * e : 4 * (e + NWP)] @ taps  # [2, C, 2]
                er, ei = (((ye[p, :, 0].astype(F32) + ye[p, :, 1].astype(F32)
                            * F32(1 / 128)).astype(F32) + s_row).astype(F32)
                          for p in (0, 1))
                head = atan2_poly(torch.from_numpy(ei),
                                  torch.from_numpy(er)).numpy()[:, None]
            prev = np.concatenate([head, th[:, :-1]], axis=1)
            first = (t0 + np.arange(TILE)) % tw == 0
            prev[:, first] = th[:, first]
            v = _disc(th, prev)
        m = min(TILE, n - t0)
        out[:, t0 : t0 + m] = v[:, :m]
    return out


def _cases():
    cases = []
    for b in (16384, 14336):
        # 3,584 and 8,192 straddle a CTA's 1,024 outputs (K12's windows)
        for t_blk in (512, 1024, 2048, 4096, 3584, 8192, 48):
            if b % t_blk:
                continue
            tw = t_blk // 4
            nos = sorted({n for n in (32, 128, tw - 32) if 32 <= n <= tw - 32})
            cases += [(b, t_blk, False, min(128, tw))]
            if (4 * TILE) % t_blk == 0 and t_blk % 32 == 0:
                cases += [(b, t_blk, True, no) for no in nos]
    return cases


CASES = _cases()


@pytest.mark.parametrize("b,t_blk,noasm,no", CASES,
                         ids=[f"B{b}_t{t}_{'noasm' if a else 'k12'}_no{n}"
                              for b, t, a, n in CASES])
def test_i8d_tile_model_is_plain(b, t_blk, noasm, no):
    x8 = fp.make_inputs(2, b, "cpu", seed=t_blk + no)["u8"]
    tb = fp.tables("cpu")
    for full in (False, True):
        want = fp.i8d_plain(x8, full, t_blk, no, noasm, tb).numpy()
        got = i8d_model(x8, full, t_blk, no, noasm, tb)
        assert np.array_equal(got, want), (full, np.abs(got - want).max())


@pytest.mark.parametrize("t_blk,no", [(8192, 128), (2048, 44), (2048, 24),
                                      (1024, 232), (256, 64), (480, 32)])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_i8d_refusals_before_any_launch(t_blk, no, device):
    """noasm tiles past one CTA's segment of 4,096 samples (not staged),
    no off the runs of 8 or outside [32, t_blk / 4 - 32], and a t_blk
    that does not tile B are refused on every device before any launch."""
    x8 = torch.zeros((2, 3, 16384), dtype=torch.int8, device=device)
    before = fp.launches_i8d
    with pytest.raises(ValueError, match="i8direct: (t_blk|a noasm|no =)"):
        fp.i8direct(x8, True, t_blk, no, True)
    assert fp.launches_i8d == before


def test_i8d_admits_the_lens_tiles():
    """The TPU lens's forms stay admitted: t_blk 512-4,096 at no = 128
    where the tile holds it, and any t_blk dividing B without noasm."""
    for t_blk in (1024, 2048, 4096):
        fp.i8d_check(262144, t_blk, 128, True)
    for t_blk in (512, 8192, 16384):
        fp.i8d_check(262144, t_blk, 128, False)
