"""The K1 engine probe of the port (fm_radio_tpu_torch/probes/
frontend_probe.py) against the TPU tool (tools/frontend_probe.py) in
Pallas interpret mode, on the same uniform random u8 IQ (numpy seed), at
C = 8 x B = 4096 in tiles of 1024.

Every variant's plain version (the CPU side of each wrapper) is held
against the tool's kernel twice:

* as the tool runs on the CPU: interpret mode leaves the scratch the TPU
  kernel never writes at NaN (float) or the type's minimum (int8), so the
  outputs that depend on it are left out, counted by the structure of the
  kernel (and, for float scratch, checked NaN there: the band dots spread
  a NaN over the whole 128-output sub-window);
* with the never-written scratch read as zeros, the port's reading
  (probes/frontend_probe.py's docstring): every output.

Tolerances, each with its reason: the stream sums add float32 in another
order (words up to 3.4e7: rtol 1e-6, measured 6e-8); the float taps run
in float32 where the tool uses bf16 hi/lo band products (dots rtol 1e-5
of the largest output, measured 2.1e-6); full's atan2 of those sums and
their difference (1e-4 of output, measured 2.1e-5), compared modulo the
wrap 2*pi*0.123 (a difference near +-pi may wrap on one side only); the
int8 taps are exact integers (dots equal), their atan2 polynomial
contracted into FMAs by XLA on the CPU (full 1e-6, measured 6e-8).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax._src.pallas import primitives as pallas_primitives

import tools.frontend_probe as tfp
from fm_radio_tpu.kernels.frontend_pallas import (
    _band_matrix,
    quantize_band_int8,
)
from fm_radio_tpu_torch.probes import frontend_probe as fp

C, B, T = 8, 4096, 1024
NO = 128
HEAD_OUT = fp.HEAD // fp.M  # outputs whose window reaches the tile head
WRAP = np.float32(2 * np.pi) * np.float32(0.123)


@pytest.fixture(scope="module")
def inputs():
    return fp.make_inputs(C, B, "cpu")


@pytest.fixture
def tool(monkeypatch):
    monkeypatch.setattr(tfp, "_INTERPRET", True)
    return tfp


@pytest.fixture
def zero_scratch(monkeypatch):
    """Interpret mode's never-written scratch read as zeros, as the port
    reads it."""
    monkeypatch.setattr(pallas_primitives, "uninitialized_value",
                        lambda shape, dtype: jnp.zeros(shape, dtype))


def _jax_args(inp, form):
    if form == "u8":
        return (jnp.asarray(inp["u8"][0].numpy()),
                jnp.asarray(inp["u8"][1].numpy()))
    return (jnp.asarray(inp[form].numpy()),)


def _close(port, ref, mode, int8):
    """Assert the stated tolerance (module docstring) on kept outputs."""
    if mode == "full":
        d = np.abs(port - ref)
        d = np.minimum(d, np.abs(d - WRAP))
        assert d.max() <= (1e-6 if int8 else 1e-4), d.max()
    elif int8:
        np.testing.assert_array_equal(port, ref)
    else:
        np.testing.assert_allclose(port, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def _mask(first_tile_only, width, n_out=B // 4, t_out=T // 4):
    """True where an output depends on never-written scratch: the first
    ``width`` outputs of every tile (or of the first tile only)."""
    j = np.arange(n_out)
    m = (j % t_out) < width
    if first_tile_only:
        m &= j < t_out
    return np.broadcast_to(m, (C, n_out))


def _check_left_out(y, m, float_scratch, count):
    assert int(m.sum()) == count, (int(m.sum()), count)
    assert np.isfinite(y[~m]).all()
    if float_scratch:
        assert np.isnan(y[m]).all()


def test_band_and_int8_tables_match_jax():
    """The port's window offsets and int8 taps, laid into the TPU band:
    equal to ``_band_matrix`` (no = 128 and 256) and to
    ``quantize_band_int8`` of it (b1, b2 exact, s_row in every column)."""
    taps = fp.taps()
    tb = fp.tables()
    for no in (128, 256):
        band = np.asarray(_band_matrix(jnp.asarray(taps), no))
        np.testing.assert_array_equal(fp.band(tb["w_rev"].numpy(), no), band)
        b1, b2, s_row = (np.asarray(v) for v in quantize_band_int8(band))
        np.testing.assert_array_equal(fp.band(tb["b1"].numpy(), no), b1)
        np.testing.assert_array_equal(fp.band(tb["b2"].numpy(), no), b2)
        assert (s_row == np.float32(tb["s_row"])).all()


def check_stream(port, ref_last, ref_sums):
    """A stream-style output against the tool's [C, 128] output (the last
    tile's sums) and against the plain per-tile sums: every tile read."""
    last, sums = port
    np.testing.assert_allclose(last.numpy(), ref_last, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(sums.numpy(), ref_sums.numpy())


@pytest.mark.parametrize("form", ["f32w", "i16", "u8"])
@pytest.mark.parametrize("mode", ["stream", "unpack"])
def test_stream_unpack_match_tool(tool, inputs, form, mode):
    """build's stream and unpack: the tool's output holds only the LAST
    time tile's row sums; the port returns it and every tile's sums, both
    held (no scratch: nothing left out)."""
    y = np.asarray(tool.build(C, B, NO, mode, False, c_blk=C, t_blk=T,
                              fmt=form)(*_jax_args(inputs, form)))
    port = fp.tile_sum(inputs[form], form, mode == "unpack", C, T)
    ref = fp.sum_plain(inputs[form], form, mode == "unpack", T)
    # the tool's value is the last tile's sum (4 tiles here)
    assert port[1].shape == (C, B // T)
    check_stream(port, y, ref[1])


def test_stream_check_catches_a_kernel_reading_only_the_last_tile(inputs):
    """A stand-in that reads only the last tile gives the tool's output
    exactly, and the per-tile sums catch it."""
    x = inputs["f32w"]
    last, sums = fp.sum_plain(x, "f32w", False, T)

    def last_tile_only(x):
        tail = x[:, B - T:].contiguous()
        l, s = fp.sum_plain(tail, "f32w", False, T)
        return l, torch.cat([torch.zeros((C, B // T - 1)), s], dim=-1)

    stand_in = last_tile_only(x)
    torch.testing.assert_close(stand_in[0], last, rtol=0, atol=0)
    with pytest.raises(AssertionError):
        check_stream(stand_in, last.numpy(), sums)
    check_stream((last, sums), last.numpy(), sums)


# (form, mode, int8 taps, tile-major)
FIR_CASES = [("f32w", "dots", False, False), ("f32w", "full", False, False),
             ("f32w", "dots", True, False), ("f32w", "full", True, False),
             ("i16", "full", False, False), ("u8", "dots", False, False),
             ("u8", "full", False, False), ("f32w", "full", False, True),
             ("u8", "full", False, True)]


def _fir_pair(tool, inputs, form, mode, int8, tm):
    x = inputs[form]
    args = _jax_args(inputs, form)
    if tm:
        x = fp.tile_major(x, form, T)
        args = tuple(jnp.asarray(np.ascontiguousarray(
            np.asarray(a).reshape(C, B // T, T).transpose(1, 0, 2)))
            for a in args)
    y = np.asarray(tool.build(C, B, NO, mode, int8, c_blk=C, t_blk=T,
                              fmt=form, tile_major=tm)(*args))
    port = fp.fir(x, form, int8, mode == "full", C, T, tile_major=tm)
    return port.numpy(), y


@pytest.mark.parametrize("form,mode,int8,tm", FIR_CASES)
def test_fir_matches_tool_outside_scratch(tool, inputs, form, mode, int8,
                                          tm):
    """build's dots and full: every tile's first window reaches 128 samples
    of never-written scratch.  Left out: float taps, the whole first
    sub-window of each tile (128 outputs, +1 for full's difference); int8
    taps, the outputs whose window reaches the head (32, +1)."""
    port, y = _fir_pair(tool, inputs, form, mode, int8, tm)
    width = (HEAD_OUT if int8 else NO) + (mode == "full")
    m = _mask(False, width)
    _check_left_out(y, m, not int8, C * (B // T) * width)
    _close(port[~m], y[~m], mode, int8)


@pytest.mark.parametrize("form,mode,int8,tm", FIR_CASES)
def test_fir_matches_tool_zero_scratch(tool, zero_scratch, inputs, form,
                                       mode, int8, tm):
    """build's dots and full, every output, the scratch at zero."""
    port, y = _fir_pair(tool, inputs, form, mode, int8, tm)
    _close(port, y, mode, int8)


@pytest.mark.parametrize("mode", ["dots", "full"])
@pytest.mark.parametrize("zero", [False, True])
def test_dbuf_matches_tool(tool, monkeypatch, inputs, mode, zero):
    """build_dbuf: the tail carried between tiles, the other buffer unset
    at the first tile (its first sub-window left out in interpret mode:
    128 outputs per row, +1 for full; all with the scratch at zero)."""
    if zero:
        monkeypatch.setattr(pallas_primitives, "uninitialized_value",
                            lambda shape, dtype: jnp.zeros(shape, dtype))
    y = np.asarray(tool.build_dbuf(C, B, NO, mode, c_blk=C, t_blk=T)(
        *_jax_args(inputs, "f32w")))
    port = fp.dbuf(inputs["f32w"], mode == "full", C, T, 2).numpy()
    m = np.zeros_like(y, dtype=bool)
    if not zero:
        width = NO + (mode == "full")
        m = _mask(True, width)
        _check_left_out(y, m, True, C * width)
    _close(port[~m], y[~m], mode, False)


@pytest.mark.parametrize("mode", ["dots", "full"])
@pytest.mark.parametrize("noasm", [False, True])
@pytest.mark.parametrize("zero", [False, True])
def test_i8direct_matches_tool(tool, monkeypatch, inputs, mode, noasm, zero):
    """build_i8direct: the int8 tail carried, unset at the first tile
    (interpret mode fills it with -128: the outputs whose window reaches it
    are left out, 32 per row, +1 for full); with noasm nothing reads it."""
    if zero:
        monkeypatch.setattr(pallas_primitives, "uninitialized_value",
                            lambda shape, dtype: jnp.zeros(shape, dtype))
    y = np.asarray(tool.build_i8direct(C, B, NO, mode, c_blk=C, t_blk=T,
                                       noasm=noasm)(*_jax_args(inputs, "u8")))
    port = fp.i8direct(inputs["u8"], mode == "full", T, NO, noasm).numpy()
    m = np.zeros_like(y, dtype=bool)
    if not zero and not noasm:
        width = HEAD_OUT + (mode == "full")
        m = _mask(True, width)
        _check_left_out(y, m, False, C * width)
    _close(port[~m], y[~m], mode, True)


@pytest.mark.parametrize("mode", ["dots", "full"])
@pytest.mark.parametrize("t_blk", [2048, 4096])
def test_i8manual_matches_tool(tool, inputs, mode, t_blk):
    """build_i8manual: each tile's first 128 outputs mis-filtered (their
    window from the tile's start), nothing reads unset scratch: every
    output held."""
    y = np.asarray(tool.build_i8manual(C, B, NO, mode, c_blk=C,
                                       t_blk=t_blk)(*_jax_args(inputs, "u8")))
    port = fp.i8manual(inputs["u8"], mode == "full", C, t_blk, NO).numpy()
    _close(port, y, mode, True)


def test_float_planes_form_and_cpu_main(capsys):
    """The port's own form (float32 planes, K1 on the complex cell's
    planes) decodes to the same samples as the others, and the command
    line runs the plain versions at a tiny shape on the CPU."""
    inp = fp.make_inputs(C, B, "cpu")
    for form in ("i16", "u8", "f32p"):
        for a, b in zip(fp.decode(inp[form], form), fp.decode(inp["f32w"],
                                                               "f32w")):
            assert torch.equal(a, b), form
    assert fp.main(["--device", "cpu", "--sections", "engines,split"]) == 0
    rows = [ln for ln in capsys.readouterr().out.splitlines()
            if '"variant"' in ln]
    assert len(rows) == 6 + 8 and all('"ms": null' in r for r in rows)


def test_rows_name_their_kernel():
    """Every row of every section names the kernel that ran it, by its
    launch counter's name, and every kernel of the probe runs a row."""
    rows = fp.run(C, B, {"ingest", "tm", "engines", "split", "tiles", "dbuf",
                         "i8d", "i8x", "man", "sem"}, 1, torch.device("cpu"),
                  check=False, emit=lambda r: None)
    assert {r["kernel"] for r in rows} == set(fp.counts())
