"""A numpy model of the mid end's split route with de-emphasis off (the
receiver's default) in K2's four formats, bit for bit against the port's
plain version (``kernels/midend.py::midend_plain``).

The model walks ``csrc/k12_stages.cuh``'s split route as the card runs
it, with no de-emphasis launch: ``k12_mid_ds2_kernel<false, In>`` one CTA
per (channel, tile of ``MID_TILE`` outputs), fm_demod staged over the
tile's window from the block (int16 dequantised where it is staged, as
``dq_i16`` at FM_SCALE) and from the carried ds x2 tail, each output
summed tap by tap from the oldest sample into fm_out, the new ds x2 tail
(the dequantised values) written by each channel's last tile;
``k12_mid_hilb_kernel<kOut16>`` one CTA per (channel, tile), fm_out's
window staged with the carried Hilbert tail before the block, re and im
stored as float32 and, with the int16 outputs, as ``q_i16`` at IQ_SCALE
(tests/test_torch_midend_deemph.py's ``ds2_model`` and ``hilb_model``);
the new Hilbert tail fm_out's last samples; then
``k12_peak_rec_kernel`` (the two biquads in time order, the pilot power
summed in double) and ``k12_theta_kernel<kI16>`` (theta = atan2 / 2 pi in
float32, with the int16 outputs stored as ``q_i16`` at PH_SCALE).

C = 3 at B = 512 (one partial tile) and 8,320 (a whole tile and a partial
one), two blocks with carried state.  re, im, theta and the carried state
equal the plain version's bit for bit; the pilot AGC gain, which the
plain version forms from a float32 sum and the kernel from its double sum
in time order, agrees within chip_smoke.py's POWER_RTOL (1e-5).  The
kernels themselves are held against the plain version on the card
(chip_smoke.py::compare_mid_edges, tests/test_torch_gpu.py).
"""

import math

import numpy as np
import pytest
import torch

from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.kernels import midend as tmid
from fm_radio_tpu_torch.kernels.qformat import FM_SCALE, IQ_SCALE, PH_SCALE
from fm_radio_tpu_torch.models import demod as tdemod
from fm_radio_tpu_torch.ops.cmath import _ATAN_C
from test_torch_midend_deemph import ds2_model, dq16, hilb_model, q16

F = np.float32
CFG = DemodConfig(frontend_int8=True)
CO = tdemod.make_coeffs(CFG)
NN2, NH = tmid.TILED_TAPS
H2, HH, D = NN2 - 2, NH - 1, (NH - 1) // 2
POWER_RTOL = 1e-5


def atan2(y: np.ndarray, x: np.ndarray) -> np.ndarray:
    """``common.cuh::atan2_poly`` in float32, op by op."""
    ax, ay = np.abs(x), np.abs(y)
    mx, mn = np.maximum(ax, ay), np.minimum(ax, ay)
    r = mn / np.maximum(mx, F(1e-37))
    s = r * r
    p = np.full_like(s, F(_ATAN_C[-1]))
    for c in _ATAN_C[-2::-1]:
        p = p * s + F(c)
    a = p * r
    a = np.where(ay > ax, F(math.pi / 2.0) - a, a)
    a = np.where(x < 0, F(math.pi) - a, a)
    return np.where(y < 0, -a, a)


def split_model(fmd: np.ndarray, w2_rev, tail2, wh_rev, htail):
    """The split route up to Hilbert with no de-emphasis: (re, im [C, n8]
    float32, the new tails [C, H2 + HH]: the one the ds x2 kernel writes,
    then fm_out's last HH samples); fmd float32, or int16 at FM_SCALE."""
    fm_out, tail = ds2_model(fmd, w2_rev, tail2)
    re, im = hilb_model(fm_out, wh_rev, htail, False)
    return re, im, np.concatenate([tail, fm_out[:, -HH:]], axis=1)


def peak_model(re, im, pk: np.ndarray, b, a):
    """``k12_peak_rec_kernel``: the two biquads (peak_step) in time order
    from pk [C, 8] (re x1 x2 y1 y2, im x1 x2 y1 y2); returns (yr, yi, the
    state [C, 8], the power in double)."""
    b0, b1, b2 = (F(v) for v in b)
    a1, a2 = F(a[1]), F(a[2])
    out, st = [], []
    for plane, s in ((re, pk[:, 0:4]), (im, pk[:, 4:8])):
        x1, x2, y1, y2 = (s[:, k].copy() for k in range(4))
        y = np.empty_like(plane)
        for t in range(plane.shape[1]):
            v = plane[:, t]
            f = (x2 * b2 + x1 * b1) + v * b0
            yt = (f - y1 * a1) - y2 * a2
            x2, x1, y2, y1 = x1, v, y1, yt
            y[:, t] = yt
        out.append(y)
        st += [x1, x2, y1, y2]
    yr, yi = out
    pw = np.zeros(re.shape[0])
    for t in range(re.shape[1]):
        pw += (yr[:, t] * yr[:, t] + yi[:, t] * yi[:, t]).astype(np.float64)
    return yr, yi, np.stack(st, axis=1), pw


def midend_model(state: dict, fmd: np.ndarray, out_i16: bool):
    """The split route after fm_demod, de-emphasis off: ((re, im), theta,
    the carried tails, the peak state [C, 8], the power)."""
    a = tmid.mid_args("model", CO, CFG, state, fmd.shape[0],
                      torch.device("cpu"))
    re, im, tails = split_model(fmd, *(a[k].numpy() for k in (
        "w2_rev", "tail2", "wh_rev", "htail")))
    yr, yi, pk, pw = peak_model(re, im, a["pk_in"].numpy(), CO.peak_b,
                                CO.peak_a)
    theta = atan2(yi, yr) * F(1.0 / (2.0 * math.pi))
    if out_i16:
        return ((q16(re, IQ_SCALE), q16(im, IQ_SCALE)),
                q16(theta, PH_SCALE), tails, pk, pw)
    return (re, im), theta, tails, pk, pw


@pytest.mark.parametrize("b", [512, 8320], ids=["partial_tile",
                                                 "whole_and_partial"])
@pytest.mark.parametrize("in_i16,out_i16", [(False, False), (True, False),
                                            (False, True), (True, True)],
                         ids=["f32", "in_i16", "out_i16", "i16_both"])
def test_split_model_matches_plain(b, in_i16, out_i16):
    """Every format on the split route with de-emphasis off, its tiles,
    halos and carried tails bit for bit against midend_plain over two
    blocks; the plan has no de-emphasis launch."""
    assert tmid.midend_route(CO, b // 4) == "split"
    assert "k12_deemph_kernel" not in dict(tmid.midend_plan(CO, CFG, 3,
                                                            b // 4))
    c = 3
    rng = np.random.default_rng(b + 2 * in_i16 + out_i16)
    st = tdemod.demod_init_state(CFG, c)
    for _ in range(2):
        x = (0.3 * rng.standard_normal((c, b // 4))).astype(F)
        fmd = q16(x, FM_SCALE) if in_i16 else x
        (mr, mi), mth, tails, pk, pw = midend_model(st, fmd, out_i16)
        new, (pr, pi), pth = tmid.midend_plain(CO, CFG, st,
                                               torch.from_numpy(fmd), out_i16)
        for m, p in ((mr, pr), (mi, pi), (mth, pth)):
            assert m.dtype == p.numpy().dtype
            np.testing.assert_array_equal(m, p.numpy())
        np.testing.assert_array_equal(tails[:, :H2], new["ds_fm_out"].numpy())
        np.testing.assert_array_equal(tails[:, H2:], new["hilbert"].numpy())
        px, py = new["peak_pilot"]["x_hist"], new["peak_pilot"]["y_hist"]
        want = torch.stack([px[:c, 0], px[:c, 1], py[:c, 0], py[:c, 1],
                            px[c:, 0], px[c:, 1], py[c:, 0], py[c:, 1]],
                           dim=-1)
        np.testing.assert_array_equal(pk, want.numpy())
        # the pilot AGC gain from the model's double power sum
        gain = tmid.mid_new_state(st, new["ds_fm_out"], new["hilbert"],
                                  st["deemph"], new["peak_pilot"],
                                  torch.from_numpy(pw.astype(F)),
                                  b // 8)["agc_pilot"]
        np.testing.assert_allclose(gain.numpy(), new["agc_pilot"].numpy(),
                                   rtol=POWER_RTOL)
        st = new

