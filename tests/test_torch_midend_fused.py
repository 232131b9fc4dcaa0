"""The mid end's two routes on the host: the route and launch plan that
``csrc/k12_stages.cuh::launch_midend`` takes (``kernels/midend.py::
midend_route`` and ``midend_plan`` are their host copies, by which the K12
and K2 wrappers allocate), and the carried state the fused route builds
from the tails its kernel writes.

The fused kernels themselves run only on the card: tests/test_torch_gpu.py
and chip_smoke.py hold them against the plain versions (max abs error 0).
"""

import dataclasses

import pytest
import torch

from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.kernels import midend as tmid
from fm_radio_tpu_torch.models import demod as tdemod

CFG = DemodConfig(frontend_int8=True)
CO = tdemod.make_coeffs(CFG)
CFG_DE = dataclasses.replace(CFG, use_deemphasis_filter=True,
                             deemphasis_cutoff_us=50)
CO_DE = tdemod.make_coeffs(CFG_DE)


def _co_taps(nn2=None, nh=None):
    """CO with the ds x2 or Hilbert filter of another order."""
    co = CO
    if nn2 is not None:
        co = co._replace(taps_fm_out=torch.ones(nn2) / nn2)
    if nh is not None:
        co = co._replace(taps_hilbert=torch.ones(nh) / nh)
    return co


# (label, coeffs, cfg, n4, route): K12 and K2 alike, K2 in every format
ROUTES = [
    ("k12_cell", CO, CFG, 32768, "fused"),
    ("k2_f32", CO, CFG, 32768, "fused"),
    ("deemphasis_on", CO_DE, CFG_DE, 32768, "launches"),
    ("deemphasis_on_smallest_block", CO_DE, CFG_DE, 128, "launches"),
    ("other_ds2_order", _co_taps(nn2=48), CFG, 32768, "launches"),
    ("other_hilbert_order", _co_taps(nh=33), CFG, 32768, "launches"),
    ("both_orders_other", _co_taps(nn2=48, nh=33), CFG, 32768, "launches"),
    # the smallest block that holds both carried tails (B/4 >= 62, B/8 >=
    # 64), and below it
    ("smallest_block", CO, CFG, 128, "fused"),
    ("block_one_below_the_hilbert_tail", CO, CFG, 126, "launches"),
    ("block_below_the_tails", CO, CFG, 96, "launches"),
]


@pytest.mark.parametrize("case", ROUTES, ids=[r[0] for r in ROUTES])
def test_midend_route(case):
    """The route of each configuration: fused with de-emphasis off, at the
    receiver's filter orders (64 and 65 taps, which the fused kernel is
    built for) and a block that holds both carried tails; the format
    (float32 or int16) does not enter."""
    _, co, cfg, n4, want = case
    assert tmid.midend_route(co, cfg, n4) == want


def test_fused_taps_are_the_receivers_filters():
    """The orders the fused kernel is built for are those every config's
    coefficients have, with and without de-emphasis."""
    for co in (CO, CO_DE, tdemod.make_coeffs(DemodConfig())):
        assert (co.taps_fm_out.shape[0],
                co.taps_hilbert.shape[0]) == tmid.FUSED_TAPS


@pytest.mark.parametrize("c,n4", [(2048, 32768), (40, 4096), (40, 4160),
                                  (33, 128)])
def test_midend_plan_fused(c, n4):
    """The fused plan: one CTA per (tile of MID_TILE outputs, channel), the
    last tile partial where B/8 is not a multiple of it; one warp per
    PEAK_LANES channels; a theta pass of four outputs a thread."""
    n8 = n4 // 2
    plan = tmid.midend_plan(CO, CFG, c, n4)
    assert [k for k, _ in plan] == ["k12_mid_fused_kernel",
                                    "k12_peak_rec_kernel",
                                    "k12_theta_kernel"]
    tiles = plan[0][1][0]
    assert tiles * tmid.MID_TILE >= n8 > (tiles - 1) * tmid.MID_TILE
    assert plan[0][1][1] == c
    assert plan[1][1][0] * tmid.PEAK_LANES >= c
    assert plan[2][1][0] * 4 * 256 >= c * n8


@pytest.mark.parametrize("cfg,co,kernels", [
    (CFG_DE, CO_DE, ["fir_decimate_kernel", "k12_deemph_kernel",
                     "k12_hilbert_kernel", "k12_peak_rec_kernel",
                     "k12_theta_kernel"]),
    (CFG, CO, ["k12_mid_fused_kernel", "k12_peak_rec_kernel",
               "k12_theta_kernel"]),
    (CFG, _co_taps(nn2=48), ["fir_decimate_kernel", "k12_hilbert_kernel",
                             "k12_peak_rec_kernel", "k12_theta_kernel"]),
], ids=["deemphasis_on", "receiver_orders_fused", "other_ds2_order"])
def test_midend_plan_launches(cfg, co, kernels):
    """The launches route keeps one launch per stage up to Hilbert (ds x2,
    the de-emphasis where it is on, Hilbert), then the peak IIR's
    recurrence and the theta pass, as the fused route ends."""
    assert [k for k, _ in tmid.midend_plan(co, cfg, 256, 32768)] == kernels


def test_state_from_the_fused_tails():
    """On the fused route the kernel writes only the carried tails (the
    last ds x2 taps - 2 fm_demod samples, the last Hilbert taps - 1 fm_out
    samples); the state built from them, with the block's own output
    count for the pilot AGC, equals the state built from the whole
    planes."""
    g = torch.Generator().manual_seed(3)
    c, n4 = 5, 4096
    st = tdemod.demod_init_state(CFG, c)
    fmd = torch.randn(c, n4, generator=g)
    fm_out = torch.randn(c, n4 // 2, generator=g)
    power = torch.rand(c, generator=g)
    a = {"tail2": st["ds_fm_out"], "htail": st["hilbert"]}
    tails = torch.cat([fmd[:, n4 - 62:], fm_out[:, n4 // 2 - 64:]], dim=1)
    buf = {"fm_out": None, "yi": None, "tails": tails}
    fmd_t, fm_t = tmid.mid_tails("fused", a, buf, None)
    whole = tmid.mid_new_state(st, fmd, fm_out, st["deemph"],
                               st["peak_pilot"], power)
    from_tails = tmid.mid_new_state(st, fmd_t, fm_t, st["deemph"],
                                    st["peak_pilot"], power, n4 // 2)
    for key in ("ds_fm_out", "hilbert", "agc_pilot"):
        assert torch.equal(whole[key], from_tails[key]), key
    assert tmid.mid_buffers("fused", a, c, n4 // 2, "cpu")["tails"].shape \
        == (c, 62 + 64)
    launches = tmid.mid_buffers("launches", a, c, n4 // 2, "cpu")
    assert launches["fm_out"].shape == (c, n4 // 2)
    # the launches route ends with the fused route's recurrence: its own
    # yi scratch, fm_out kept for the carried Hilbert tail
    assert launches["yi"].shape == (c, n4 // 2)
    assert launches["tails"] is None
