"""The extract (K3) engine probe of the port (fm_radio_tpu_torch/probes/
k3_probe.py) against the TPU tool (tools/k3_probe.py) in Pallas interpret
mode, on the same three N(0, 1) planes (numpy seed), at C = 8 x B8 = 4096,
c_blk = 8.

The stream-style variants return the tool's [C, 128] output (the LAST
time tile's sums; ``stream31`` the first c_blk rows of each row group
only) and every tile's sums; the tool's output is held against the
former, the plain per-tile sums against the latter.  ``full`` and
``value`` are extract on zero carried tails: the tool never writes them,
so in interpret mode its first tile's first sub-window is NaN in all five
outputs (128 per row each, left out); with the scratch read as zeros
every output is held.

Tolerances, each with its reason: the sums add float32 in another order
(atol 5e-5 on sums up to ~150, measured 1.5e-5); the FIRs run in float32
where the tool uses bf16 hi/lo products (atol 2e-5 on outputs up to ~4,
measured 7.5e-6).
"""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax._src.pallas import primitives as pallas_primitives

import tools.k3_probe as tk3
from fm_radio_tpu_torch.probes import k3_probe as k3

C, B8 = 8, 4096
SUM_ATOL = 5e-5
FIR_ATOL = 2e-5


@pytest.fixture(scope="module")
def xs():
    return k3.make_inputs(C, B8, "cpu")


@pytest.fixture
def tool(monkeypatch):
    monkeypatch.setattr(tk3, "_INTERPRET", True)
    return tk3


def _jax(xs):
    return tuple(jnp.asarray(x.numpy()) for x in xs)


@pytest.mark.parametrize("mode,t_blk", [("stream1", 1024), ("stream1", 2048),
                                        ("stream", 1024), ("stream", 2048),
                                        ("stream", 4096), ("phasor", 1024)])
def test_stream_phasor_match_tool(tool, xs, mode, t_blk):
    """stream1, stream (the read alone; chain_probe's stream3 at 1024) and
    phasor: the tool's last-tile output, and every tile summed."""
    y = np.asarray(tool.build(C, B8, mode, c_blk=C, t_blk=t_blk)(*_jax(xs)))
    last, sums = k3.tile_sum(mode, xs, t_blk, C)
    assert sums.shape == (C, B8 // t_blk)
    np.testing.assert_allclose(last.numpy(), y, rtol=0, atol=SUM_ATOL)
    np.testing.assert_array_equal(last.numpy()[:, 0], sums.numpy()[:, -1])


@pytest.mark.parametrize("t_blk", [1024, 2048])
def test_stream31_matches_tool(tool, xs, t_blk):
    """stream31 on the row-stacked plane: the tool keeps the first c_blk
    rows (re) of each 3 c_blk row group; the port sums all 3C rows per
    tile."""
    x3 = k3.stack31(xs, C)
    y = np.asarray(tool.build_stream31(C, B8, c_blk=C, t_blk=t_blk)(
        jnp.asarray(x3.numpy())))
    last, sums = k3.tile_sum("stream31", (x3,), t_blk, C)
    assert sums.shape == (3 * C, B8 // t_blk)
    np.testing.assert_allclose(last.numpy(), y, rtol=0, atol=SUM_ATOL)
    np.testing.assert_array_equal(last.numpy()[:, 0], sums.numpy()[:C, -1])


def test_stream_sums_catch_a_kernel_reading_only_the_last_tile(xs):
    """A stand-in that sums only the last tile matches the tool's output
    but not the per-tile sums."""
    last, sums = k3.sum_plain("stream", xs, 1024, C)
    tail = tuple(x[:, B8 - 1024:].contiguous() for x in xs)
    l2, s2 = k3.sum_plain("stream", tail, 1024, C)
    stand_in = torch.cat([torch.zeros((C, B8 // 1024 - 1)), s2], dim=-1)
    assert torch.equal(l2, last)
    assert not torch.equal(stand_in, sums)


@pytest.mark.parametrize("mode", ["full", "value"])
@pytest.mark.parametrize("zero", [False, True])
def test_full_value_match_tool(tool, monkeypatch, xs, mode, zero):
    """full (the production extract kernel's plain version on the probe's
    taps) and value, five outputs each."""
    if zero:
        monkeypatch.setattr(pallas_primitives, "uninitialized_value",
                            lambda shape, dtype: jnp.zeros(shape, dtype))
    ys = tool.build(C, B8, mode, c_blk=C, t_blk=1024)(*_jax(xs))
    port = (k3.full if mode == "full" else k3.value)(xs)
    for p, y in zip(port, ys):
        y = np.asarray(y)
        m = np.zeros_like(y, dtype=bool)
        if not zero:
            m[:, :128] = True
            assert np.isnan(y[m]).all() and np.isfinite(y[~m]).all()
            assert int(m.sum()) == C * 128
        np.testing.assert_allclose(p.numpy()[~m], y[~m], rtol=0,
                                   atol=FIR_ATOL)


def test_value_is_full(xs):
    """value and full compute one function (extract on zero tails)."""
    for a, b in zip(k3.value(xs), k3.full(xs)):
        assert torch.equal(a, b)


def test_cpu_main(capsys):
    """The command line runs the plain versions at a tiny shape."""
    assert k3.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count('"variant"') == len(k3.CASES)
    # full is the production extract kernel, counted by its own wrapper
    kernels = {json.loads(ln)["kernel"] for ln in out.splitlines()
               if '"variant"' in ln}
    assert kernels == set(k3.counts()) | {"k3_full"}
