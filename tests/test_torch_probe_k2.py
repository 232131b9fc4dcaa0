"""The K2 engine probe of the port (fm_radio_tpu_torch/probes/k2_probe.py)
against the TPU tool (tools/k2_probe.py) in Pallas interpret mode, on the
same N(0, 1) fm_demod (numpy seed), at C = 8 x B4 = 4096 in tiles of
1024.

The tool never writes its carried buffers and IIR state.  In interpret
mode they hold NaN, so ds2 and hilb leave out their first tile's first
sub-window (counted below) and full and restruct every output (all of
them depend on the IIR state); with that scratch read as zeros (the
port's reading) every output is held.

Tolerances, each with its reason: the FIRs run in float32 where the tool
uses bf16 hi/lo products (``_dot3`` drops lo*lo: ~2^-16 relative; atol
3e-5 on outputs up to 2.1, measured 1.25e-5).  theta is atan2 of the peak
IIR's output, a narrowband resonator (poles at radius 0.9999) that passes
the FIRs' difference on, and atan2 turns an absolute error into an angle
error inversely proportional to the magnitude: theta is held to 1e-3
cycles where the peak output's magnitude is at least 0.1 of its rms (the
outputs left out, counted, at most 15%: measured 11%; the worst kept,
5.5e-4).  The tool's ``full`` runs the peak IIR as blocked Toeplitz
products at li = 128 (``_midend_body``), so its theta is held against the
port's ``restruct:128``; the port's ``full`` is the production K2's serial
recurrence, whose re and im are held, and whose theta is held against the
same recurrence in float64 (scipy's ``lfilter``) on its own re and im:
the float32 recurrence's rounding, which the resonator's gain (~1e4)
amplifies and which grows with the length (measured 9.8e-5 cycles over
1024 outputs and 2.1e-4 over 2048, where the magnitude is at least 0.1 of
its rms): held to THETA64_TOL = 5e-4 over 2048.  The blocked tables are
computed in float32 (``iir_tile_mats``) as XLA on the CPU computes them:
bit for bit.
"""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax._src.pallas import primitives as pallas_primitives
from scipy.signal import lfilter

import tools.k2_probe as tk2
from fm_radio_tpu.kernels.midend_pallas import _iir_tile_mats
from fm_radio_tpu_torch.ops.iir import iir_filter
from fm_radio_tpu_torch.probes import k2_probe as k2

C, B4, T = 8, 4096, 1024
ATOL = 3e-5
THETA_TOL = 1e-3
THETA64_TOL = 5e-4
MAG_REL = 0.1
LEFT_OUT_MAX = 0.15


@pytest.fixture(scope="module")
def x():
    return k2.make_input(C, B4, "cpu")


@pytest.fixture
def tool(monkeypatch):
    monkeypatch.setattr(tk2, "_INTERPRET", True)
    return tk2


def _zero_scratch(monkeypatch):
    monkeypatch.setattr(pallas_primitives, "uninitialized_value",
                        lambda shape, dtype: jnp.zeros(shape, dtype))


def _run_tool(tool, mode, x):
    return [np.asarray(v) for v in
            tool.build(C, B4, mode, c_blk=C, t_blk=T)(jnp.asarray(x.numpy()))]


@pytest.mark.parametrize("li", [64, 128, 256, 512])
@pytest.mark.parametrize("filt", ["deemph", "peak"])
def test_iir_tile_mats_match_jax(li, filt):
    """The port's float32 copy of ``_iir_tile_mats`` (T, hm, pm) equals
    the JAX package's bit for bit, for the probe's de-emphasis and peak."""
    co = k2.coeffs()
    b, a = ((co.deemph_b, co.deemph_a) if filt == "deemph"
            else (co.peak_b, co.peak_a))
    ref = _iir_tile_mats(jnp.asarray(b, jnp.float32),
                         jnp.asarray(a, jnp.float32), li)
    for port, r in zip(k2.iir_tile_mats(b, a, li), ref):
        np.testing.assert_array_equal(port.numpy(), np.asarray(r))


def test_stream_matches_tool(tool, x):
    """stream: the halves of each tile copied, bit for bit."""
    for port, y in zip(k2.variant("stream", x, T), _run_tool(tool, "stream",
                                                             x)):
        np.testing.assert_array_equal(port.numpy(), y)


# outputs of the first tile (t_blk / 2 = 512 per row) that depend on the
# never-written buffers in interpret mode: [start, stop) per output
LEFT_OUT = {"ds2": [(0, 128)] * 3,
            "hilb": [(32, 160), (0, 256), (0, 256)]}


@pytest.mark.parametrize("mode", ["ds2", "hilb"])
@pytest.mark.parametrize("zero", [False, True])
def test_ds2_hilb_match_tool(tool, monkeypatch, x, mode, zero):
    """ds2 and hilb.  In interpret mode the never-written ds x2 head makes
    the first sub-window of the first tile NaN (128 per row); hilb's im
    reads it through two sub-windows (256), and its re, each tile rotated
    by the delay (the tool reads re after carrying the tail), carries the
    NaN to [32, 160).  Those are left out; with zero scratch all held."""
    if zero:
        _zero_scratch(monkeypatch)
    port = [p.numpy() for p in k2.variant(mode, x, T)]
    for p, y, (lo, hi) in zip(port, _run_tool(tool, mode, x),
                              LEFT_OUT[mode]):
        m = np.zeros_like(y, dtype=bool)
        if not zero:
            m[:, lo:hi] = True
            assert np.isnan(y[m]).all() and np.isfinite(y[~m]).all()
            assert int(m.sum()) == C * (hi - lo)
        np.testing.assert_allclose(p[~m], y[~m], rtol=0, atol=ATOL)


def test_full_and_restruct_depend_on_unwritten_state(tool, x):
    """In interpret mode every output of full and restruct is NaN: the
    IIR state the tool never writes feeds them all (3 x 8 x 2048 left
    out), so they are held with the scratch at zero below."""
    for mode in ("full", "restruct:128"):
        ys = _run_tool(tool, mode, x)
        assert all(np.isnan(y).all() for y in ys)
        assert sum(y.size for y in ys) == 3 * C * B4 // 2


def _theta_close(port_theta, tool_theta, re, im, li):
    """theta within THETA_TOL cycles (wrapped) where the peak output (the
    port's, blocked at li) is at least MAG_REL of its rms."""
    h, hm, pm = k2.block_mats(li)["pk"]
    pr = k2.block_iir_plain(re, h, hm, pm)
    pi = k2.block_iir_plain(im, h, hm, pm)
    mag = torch.hypot(pr, pi).numpy()
    keep = mag >= MAG_REL * np.sqrt((mag ** 2).mean(axis=1, keepdims=True))
    assert (~keep).mean() <= LEFT_OUT_MAX, (~keep).mean()
    d = np.abs((port_theta - tool_theta + 0.5) % 1.0 - 0.5)
    assert d[keep].max() <= THETA_TOL, d[keep].max()


@pytest.mark.parametrize("mode", ["full", *(f"restruct:{li}{s}"
                                            for li in (64, 128, 256, 512)
                                            for s in ("", ":stk"))])
def test_full_restruct_match_tool_zero_scratch(tool, monkeypatch, x, mode):
    """full and restruct:li[:stk] with the scratch at zero: re and im
    within ATOL; theta as :func:`_theta_close` (full's against the port's
    restruct:128, the tool's own block width)."""
    _zero_scratch(monkeypatch)
    ys = _run_tool(tool, mode, x)
    port = k2.variant(mode, x, T)
    for p, y in zip(port[:2], ys[:2]):
        np.testing.assert_allclose(p.numpy(), y, rtol=0, atol=ATOL)
    li = 128 if mode == "full" else int(mode.split(":")[1])
    theta = (k2.variant("restruct:128", x, T)[2] if mode == "full"
             else port[2])
    _theta_close(theta.numpy(), ys[2], port[0], port[1], li)


def test_full_theta_matches_float64_recurrence(x):
    """The port's own full theta (the production serial peak IIR) against
    the peak biquad run in float64 on the port's re and im (an
    independent recurrence): within THETA64_TOL cycles (wrapped) where the
    float64 peak output's magnitude is at least MAG_REL of its rms (the
    left out, counted, at most LEFT_OUT_MAX)."""
    re, im, theta = k2.variant("full", x, T)[:3]
    co = k2.coeffs()
    b, a = np.float64(co.peak_b), np.float64(co.peak_a)
    pr = lfilter(b, a, re.numpy().astype(np.float64), axis=1)
    pi = lfilter(b, a, im.numpy().astype(np.float64), axis=1)
    ref = np.arctan2(pi, pr) / (2 * np.pi)
    mag = np.hypot(pr, pi)
    keep = mag >= MAG_REL * np.sqrt((mag ** 2).mean(axis=1, keepdims=True))
    assert theta.shape == (C, B4 // 2)
    assert (~keep).mean() <= LEFT_OUT_MAX, (~keep).mean()
    d = np.abs((theta.numpy() - ref + 0.5) % 1.0 - 0.5)
    assert d[keep].max() <= THETA64_TOL, d[keep].max()


@pytest.mark.parametrize("li", [64, 512])
def test_block_deemphasis_is_the_recurrence(x, li):
    """The block-Toeplitz de-emphasis (order 1) against the serial
    recurrence of ops/iir.py on the same input: float32 rounding only
    (1e-6; outputs up to 1.1)."""
    co = k2.coeffs()
    st = {"x_hist": torch.zeros((C, 1)), "y_hist": torch.zeros((C, 1))}
    _, ref = iir_filter(co.deemph_b, co.deemph_a, st, x)
    got = k2.block_iir_plain(x, *k2.block_mats(li)["de"])
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)


def test_cpu_main(capsys):
    """The command line runs the plain versions at a tiny shape."""
    assert k2.main(["--device", "cpu", "--sections",
                    "stream,ds2,hilb,full,restruct:64"]) == 0
    out = capsys.readouterr().out
    assert out.count('"variant"') == 5
    kernels = {json.loads(ln)["kernel"] for ln in out.splitlines()
               if '"variant"' in ln}
    assert kernels == set(k2.counts())
