"""The mid end's two routes on the host: the route and launch plan that
``csrc/k12_stages.cuh::launch_midend`` takes (``kernels/midend.py::
midend_route`` and ``midend_plan`` are their host copies, by which the K12
and K2 wrappers allocate), and the carried state the split route builds
from the ds x2 tail its kernel writes and from fm_out, with de-emphasis
off and on.

The tiled kernels themselves run only on the card: tests/test_torch_gpu.py
and chip_smoke.py hold them against the plain versions (max abs error 0).
"""

import dataclasses

import pytest
import torch

from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.kernels import midend as tmid
from fm_radio_tpu_torch.models import demod as tdemod
from fm_radio_tpu_torch.ops.iir import iir_filter

CFG = DemodConfig(frontend_int8=True)
CO = tdemod.make_coeffs(CFG)
CFG_DE = dataclasses.replace(CFG, use_deemphasis_filter=True,
                             deemphasis_cutoff_us=50)
CO_DE = tdemod.make_coeffs(CFG_DE)


def _co_taps(nn2=None, nh=None, co=CO):
    """``co`` with the ds x2 or Hilbert filter of another order."""
    if nn2 is not None:
        co = co._replace(taps_fm_out=torch.ones(nn2) / nn2)
    if nh is not None:
        co = co._replace(taps_hilbert=torch.ones(nh) / nh)
    return co


# (label, coeffs, cfg, n4, route): K12 and K2 alike, K2 in every format
ROUTES = [
    ("k12_cell", CO, CFG, 32768, "split"),
    ("k2_f32", CO, CFG, 32768, "split"),
    ("deemphasis_on", CO_DE, CFG_DE, 32768, "split"),
    ("deemphasis_on_smallest_block", CO_DE, CFG_DE, 128, "split"),
    # de-emphasis at other orders takes the split route too (the tiled
    # kernels' any-order forms); a block below the tails keeps the
    # launches
    ("deemphasis_on_other_ds2_order", _co_taps(nn2=48, co=CO_DE), CFG_DE,
     32768, "split"),
    ("deemphasis_on_other_hilbert_order", _co_taps(nh=33, co=CO_DE), CFG_DE,
     32768, "split"),
    ("deemphasis_on_block_one_below_the_hilbert_tail", CO_DE, CFG_DE, 126,
     "launches"),
    ("deemphasis_on_block_below_the_tails", CO_DE, CFG_DE, 96, "launches"),
    ("other_ds2_order", _co_taps(nn2=48), CFG, 32768, "split"),
    ("other_hilbert_order", _co_taps(nh=33), CFG, 32768, "split"),
    ("both_orders_other", _co_taps(nn2=48, nh=33), CFG, 32768, "split"),
    # the smallest block that holds both carried tails (B/4 >= 62, B/8 >=
    # 64), and below it
    ("smallest_block", CO, CFG, 128, "split"),
    ("block_one_below_the_hilbert_tail", CO, CFG, 126, "launches"),
    ("block_below_the_tails", CO, CFG, 96, "launches"),
    # the longest tails the halo admits (130 / 129 taps: B/4 >= 128, B/8
    # >= 128), the smallest block that holds them and one below
    ("halo_orders_smallest_block", _co_taps(nn2=130, nh=129), CFG, 256,
     "split"),
    ("halo_orders_block_one_below_the_hilbert_tail",
     _co_taps(nn2=130, nh=129), CFG, 254, "launches"),
    # past the halo: refused
    ("ds2_order_past_the_halo", _co_taps(nn2=131), CFG, 32768, "refused"),
    ("hilbert_order_past_the_halo", _co_taps(nh=130), CFG, 32768,
     "refused"),
]


@pytest.mark.parametrize("case", ROUTES, ids=[r[0] for r in ROUTES])
def test_midend_route(case):
    """The route of each configuration: at every filter order within the
    128-sample halo (the receiver's 64 and 65 taps on the kernels built
    for them, any other on their any-order forms) and a block that holds
    both carried tails, the split route with de-emphasis off and on; on a
    shorter block the launches; past the halo refused.  The format
    (float32 or int16) does not enter."""
    _, co, _cfg, n4, want = case
    assert tmid.midend_route(co, n4) == want


def test_tiled_taps_are_the_receivers_filters():
    """The orders the split route's tiled kernels are built for are those
    every config's coefficients have, with and without de-emphasis."""
    for co in (CO, CO_DE, tdemod.make_coeffs(DemodConfig())):
        assert (co.taps_fm_out.shape[0],
                co.taps_hilbert.shape[0]) == tmid.TILED_TAPS


@pytest.mark.parametrize("c,n4", [(2048, 32768), (40, 4096), (40, 4160),
                                  (33, 128)])
def test_midend_plan_split(c, n4):
    """The split plan with de-emphasis off: the ds x2 and Hilbert kernels
    one CTA per (tile of MID_TILE outputs, channel), the last tile partial
    where B/8 is not a multiple of it; one warp per PEAK_LANES channels; a
    theta pass of four outputs a thread."""
    n8 = n4 // 2
    plan = tmid.midend_plan(CO, CFG, c, n4)
    assert [k for k, _ in plan] == ["k12_mid_ds2_kernel",
                                    "k12_mid_hilb_kernel",
                                    "k12_peak_rec_kernel",
                                    "k12_theta_kernel"]
    tiles = plan[0][1][0]
    assert tiles * tmid.MID_TILE >= n8 > (tiles - 1) * tmid.MID_TILE
    assert plan[0][1] == plan[1][1] == (tiles, c)
    assert plan[2][1][0] * tmid.PEAK_LANES >= c
    assert plan[3][1][0] * 4 * 256 >= c * n8


@pytest.mark.parametrize("cfg,co,n4,kernels", [
    (CFG_DE, CO_DE, 32768, ["k12_mid_ds2_kernel", "k12_deemph_kernel",
                            "k12_mid_hilb_kernel", "k12_peak_rec_kernel",
                            "k12_theta_kernel"]),
    (CFG, CO, 32768, ["k12_mid_ds2_kernel", "k12_mid_hilb_kernel",
                      "k12_peak_rec_kernel", "k12_theta_kernel"]),
    (CFG, _co_taps(nn2=48), 32768,
     ["k12_mid_ds2_any_kernel", "k12_mid_hilb_kernel",
      "k12_peak_rec_kernel", "k12_theta_kernel"]),
    (CFG_DE, _co_taps(nh=33, co=CO_DE), 32768,
     ["k12_mid_ds2_kernel", "k12_deemph_kernel", "k12_mid_hilb_any_kernel",
      "k12_peak_rec_kernel", "k12_theta_kernel"]),
    (CFG, _co_taps(nn2=96, nh=97), 32768,
     ["k12_mid_ds2_any_kernel", "k12_mid_hilb_any_kernel",
      "k12_peak_rec_kernel", "k12_theta_kernel"]),
    (CFG, CO, 96, ["fir_decimate_kernel", "k12_hilbert_kernel",
                   "k12_peak_rec_kernel", "k12_theta_kernel"]),
    (CFG_DE, _co_taps(nn2=96, nh=97, co=CO_DE), 128,
     ["fir_decimate_kernel", "k12_deemph_kernel", "k12_hilbert_kernel",
      "k12_peak_rec_kernel", "k12_theta_kernel"]),
], ids=["deemphasis_on", "receiver_orders_split", "other_ds2_order",
        "deemphasis_on_other_hilbert_order", "both_orders_other_split",
        "block_below_the_tails", "deemphasis_on_block_below_other_tails"])
def test_midend_plan_launches(cfg, co, n4, kernels):
    """The split route runs its ds x2 and Hilbert kernels (each built for
    the receiver's order, or its any-order form), with the de-emphasis
    between them where it is on; the launches route (a block shorter than
    a carried tail) keeps one launch per stage up to Hilbert (ds x2, the
    de-emphasis where it is on, Hilbert); each then the peak IIR's
    recurrence and the theta pass."""
    assert [k for k, _ in tmid.midend_plan(co, cfg, 256, n4)] == kernels


def test_midend_plan_refuses_orders_past_the_halo():
    """A filter past the halo has no plan: ValueError, as the wrappers
    raise on every device before any launch."""
    with pytest.raises(ValueError, match="halo"):
        tmid.midend_plan(_co_taps(nn2=132), CFG, 256, 32768)


@pytest.mark.parametrize("c,n4", [(2048, 32768), (40, 4096), (40, 4160),
                                  (1, 128)])
def test_midend_plan_deemph(c, n4):
    """The split route's plan with de-emphasis on: its ds x2 and Hilbert
    kernels one CTA per (tile of MID_TILE outputs, channel),
    the last tile partial where B/8 is not a multiple of it; the
    de-emphasis one thread a channel, DEEMPH_LANES a block."""
    n8 = n4 // 2
    plan = dict(tmid.midend_plan(CO_DE, CFG_DE, c, n4))
    tiles = plan["k12_mid_ds2_kernel"][0]
    assert tiles * tmid.MID_TILE >= n8 > (tiles - 1) * tmid.MID_TILE
    assert plan["k12_mid_ds2_kernel"] == plan["k12_mid_hilb_kernel"] \
        == (tiles, c)
    assert plan["k12_deemph_kernel"][0] * tmid.DEEMPH_LANES >= c
    # one run of 8 outputs a thread of the ds x2 kernel, 4 of the Hilbert
    assert tmid.DS2_THREADS * 8 == tmid.HILB_THREADS * 4 == tmid.MID_TILE


@pytest.mark.parametrize("c,n4", [(5, 4096), (3, 128)])
def test_state_from_the_split_tails(c, n4):
    """On the split route with de-emphasis off the ds x2 kernel writes only
    the new ds x2 tail (the last ds x2 taps - 2 fm_demod samples) and the
    host takes the Hilbert tail from fm_out's last Hilbert taps - 1
    samples; the state built from them equals midend_plain's on a seeded
    block, the pilot AGC gain from the block's own output count.  The
    launches route keeps fmd and fm_out whole, and the same yi scratch."""
    g = torch.Generator().manual_seed(3 + c + n4)
    st = tdemod.demod_init_state(CFG, c)
    st["ds_fm_out"] = torch.randn(c, 62, generator=g)
    st["hilbert"] = torch.randn(c, 64, generator=g)
    fmd = 0.3 * torch.randn(c, n4, generator=g)
    new, _, _ = tmid.midend_plain(CO, CFG, st, fmd)
    w2_rev = CO.taps_fm_out.flip(0).contiguous()
    fm_out, tail = tmid.mid_ds2_plain(w2_rev, st["ds_fm_out"], fmd)
    a = {"tail2": st["ds_fm_out"], "htail": st["hilbert"]}
    buf = tmid.mid_buffers("split", a, c, n4 // 2, "cpu")
    assert buf["tails"].shape == (c, 62) and buf["fm_out"].shape \
        == buf["yi"].shape == (c, n4 // 2)
    buf.update(tails=tail, fm_out=fm_out)
    fmd_t, fm_t = tmid.mid_tails("split", buf, None)
    assert fmd_t is tail and fm_t is fm_out
    power = torch.rand(c, generator=g)
    got = tmid.mid_new_state(st, fmd_t, fm_t, st["deemph"],
                             new["peak_pilot"], power, n4 // 2)
    whole = tmid.mid_new_state(st, fmd, fm_out, st["deemph"],
                               new["peak_pilot"], power)
    for key in ("ds_fm_out", "hilbert"):
        assert torch.equal(got[key], new[key]), key
    for key in ("ds_fm_out", "hilbert", "agc_pilot"):
        assert torch.equal(got[key], whole[key]), key
    launches = tmid.mid_buffers("launches", a, c, n4 // 2, "cpu")
    assert launches["fm_out"].shape == launches["yi"].shape == (c, n4 // 2)
    assert launches["tails"] is None
    fmd_l, fm_l = tmid.mid_tails("launches", launches, fmd)
    assert fmd_l is fmd and fm_l is launches["fm_out"]


@pytest.mark.parametrize("c,n4", [(5, 4096), (3, 128)])
def test_state_from_the_deemph_tails(c, n4):
    """On the split route with de-emphasis on the ds x2 kernel writes only
    the new ds x2 tail (the last ds x2 taps - 2 fm_demod samples) and the
    host takes the Hilbert tail from fm_out's last Hilbert taps - 1
    (de-emphasised) samples; the state built from them equals
    midend_plain's on a seeded block, the pilot AGC gain from the block's
    own output count."""
    g = torch.Generator().manual_seed(c + n4)
    st = tdemod.demod_init_state(CFG_DE, c)
    st["ds_fm_out"] = torch.randn(c, 62, generator=g)
    st["hilbert"] = torch.randn(c, 64, generator=g)
    fmd = 0.3 * torch.randn(c, n4, generator=g)
    new, _, _ = tmid.midend_plain(CO_DE, CFG_DE, st, fmd)
    # the route's intermediates, as its kernels leave them: fm_out after
    # the de-emphasis, the ds x2 tail the kernel wrote
    w2_rev = CO_DE.taps_fm_out.flip(0).contiguous()
    fm_out, tail = tmid.mid_ds2_plain(w2_rev, st["ds_fm_out"], fmd)
    deemph, fm_out = iir_filter(CO_DE.deemph_b, CO_DE.deemph_a, st["deemph"],
                                fm_out)
    a = {"tail2": st["ds_fm_out"], "htail": st["hilbert"]}
    buf = tmid.mid_buffers("split", a, c, n4 // 2, "cpu")
    assert buf["tails"].shape == (c, 62) and buf["fm_out"].shape \
        == buf["yi"].shape == (c, n4 // 2)
    buf.update(tails=tail, fm_out=fm_out)
    fmd_t, fm_t = tmid.mid_tails("split", buf, None)
    assert fmd_t is tail and fm_t is fm_out
    got = tmid.mid_new_state(st, fmd_t, fm_t, deemph, new["peak_pilot"],
                             torch.zeros(c), n4 // 2)
    for key in ("ds_fm_out", "hilbert"):
        assert torch.equal(got[key], new[key]), key
    for key in ("x_hist", "y_hist"):
        assert torch.equal(got["deemph"][key], new["deemph"][key]), key
