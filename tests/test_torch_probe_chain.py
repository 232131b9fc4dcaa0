"""The chain probe of the port (fm_radio_tpu_torch/probes/chain_probe.py)
against the TPU tool (tools/chain_probe.py), on the tool's own signal (a
random phase walk on the u8 grid, numpy seed) as int8 planes, C = 8 x
B = 8192, one block from the same start state.

``fused_prefix`` at each upto (K1; + K2; + PLL; + extract; + RDS AGC and
BPSK) against the tool's, whose Pallas kernels run in interpret mode: the
carried state after the prefix and the completion probe (one element of
each output).  ``chain_prefix`` (the unfused ops) likewise at the peak
IIR stage and at the end.

Tolerances, each with its reason (measured in brackets): the int8 K1 is
exact integers and the same atan2 (exact here; the unfused
discriminator's torch.atan2 and XLA's arctan2 differ by an ulp: 1e-6,
1.2e-7); K2's tails and IIR
histories 2e-5 as tests/test_torch_split.py (the tool's FIRs use bf16
hi/lo products; 1.8e-6), its ds x2 tail 1e-6 (7.5e-8); the PLL state 1e-4
cycles (XLA on the CPU contracts multiply-adds into FMAs, the port does
not: the serial loop drifts; 1.7e-5); extract's tails 2e-5 (6.0e-6); the
BPSK state 1e-4 (2.3e-5); the AGC gains rtol 2e-4 (their power sums run
in another order); the fused probe (one element per output) rtol 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tools.chain_probe as tcp
from fm_radio_tpu.config import DemodConfig as JDemodConfig
from fm_radio_tpu.kernels import bpsk_pallas, extract_pallas, frontend_pallas
from fm_radio_tpu.kernels import midend_pallas, pll_pallas
from fm_radio_tpu.models import demod as jdemod
from fm_radio_tpu_torch.probes import chain_probe as cp
from fm_radio_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

C, B = 8, 8192
ATOL = {"ds_fm_in": 0.0, "disc_prev_theta": 1e-6, "ds_fm_out": 1e-6,
        "hilbert": 2e-5, "peak_pilot": 2e-5, "deemph": 2e-5, "pll": 1e-4,
        "ds_audio_lpr": 2e-5, "ds_audio_lmr": 2e-5, "ds_rds": 2e-5,
        "bpsk": 1e-4, "lmr_phase_err": 1e-6}
RTOL = {"agc_pilot": 2e-4, "agc_rds": 2e-4}


@pytest.fixture
def interpret(monkeypatch):
    """The tool's kernels in Pallas interpret mode (it passes no flag)."""
    for mod, name in ((frontend_pallas, "ds4_disc_pallas"),
                      (midend_pallas, "midend_pallas"),
                      (pll_pallas, "pilot_pll_pallas_theta"),
                      (pll_pallas, "pilot_pll_pallas"),
                      (extract_pallas, "extract_pallas"),
                      (bpsk_pallas, "bpsk_sync_pallas")):
        monkeypatch.setattr(mod, name, functools.partial(
            getattr(mod, name), interpret=True))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(kind):
    x = cp.make_input(C, B, kind, "cpu")
    jcfg = JDemodConfig(assume_integer_input=kind != "planes",
                        frontend_int8=kind == "i8")
    tcfg = cp.config(kind)
    st_j = jdemod.demod_init_state(jcfg, C)
    return (x, jcfg, jdemod.make_coeffs(jcfg), st_j, tcfg,
            cp.make_coeffs(tcfg), state_from_numpy(_np(st_j)))


def _states_close(sj, st):
    a, b = _np(sj), state_to_numpy(st)
    assert a.keys() == b.keys()
    for k in a:
        for u, v in zip(jax.tree.leaves(a[k]), jax.tree.leaves(b[k])):
            u, v = np.asarray(u), np.asarray(v)
            if k in RTOL:
                np.testing.assert_allclose(v, u, rtol=RTOL[k], err_msg=k)
            else:
                np.testing.assert_allclose(v, u, rtol=0, atol=ATOL[k],
                                           err_msg=k)


@pytest.mark.parametrize("upto", range(len(cp.FUSED_STAGES)))
def test_fused_prefix_matches_tool(interpret, upto):
    """Each prefix of the split kernels on int8 planes: state and probe."""
    x, jcfg, jco, st_j, tcfg, tco, st_t = _setup("i8")
    sj, pj = tcp.fused_prefix(jcfg, jco, st_j, jnp.asarray(x.numpy()), upto)
    st, pt = cp.fused_prefix(tcfg, tco, st_t, x, upto)
    _states_close(sj, st)
    np.testing.assert_allclose(float(pt), float(pj), rtol=1e-4, atol=1e-12)


@pytest.mark.parametrize("upto", [5, 10])
def test_chain_prefix_matches_tool(interpret, upto):
    """The unfused ops on float32 planes, through the peak IIR and AGC (5)
    and to the end (10): state, and the probe (here full sums of every
    output, added in another order, with the PLL's drift in them: rtol
    2e-3, measured 4.7e-4)."""
    x, jcfg, jco, st_j, tcfg, tco, st_t = _setup("planes")
    xj = (jnp.asarray(x[0].numpy()), jnp.asarray(x[1].numpy()))
    sj, pj = tcp.chain_prefix(jcfg, jco, st_j, xj, upto)
    st, pt = cp.chain_prefix(tcfg, tco, st_t, (x[0], x[1]), upto)
    _states_close(sj, st)
    np.testing.assert_allclose(float(pt), float(pj), rtol=2e-3)


def test_k3iso_rows_leave_the_state_of_their_prefix():
    """The k3iso rows: glue and stream3 stop before extract (the state of
    upto 2), barrier, twice and preread run it once into the state (the
    state of upto 3)."""
    x, _, _, _, tcfg, tco, st_t = _setup("i8")
    ref = {u: cp.fused_prefix(tcfg, tco, st_t, x, u)[0] for u in (2, 3)}
    for iso, _ in cp.K3ISO:
        st, probe = cp.fused_prefix(tcfg, tco, st_t, x, 3, iso)
        want = ref[2 if iso in ("glue", "stream3") else 3]
        assert np.isfinite(float(probe)), iso
        for k in want:
            for u, v in zip(jax.tree.leaves(state_to_numpy(want)[k]),
                            jax.tree.leaves(state_to_numpy(st)[k])):
                np.testing.assert_array_equal(u, v, err_msg=f"{iso} {k}")


def test_cpu_main(capsys):
    """The command line runs the plain versions at a tiny shape."""
    assert cp.main(["8", "8192", "1", "--k3iso", "--iters", "1",
                    "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count('"variant"') == len(cp.FUSED_STAGES) + len(cp.K3ISO) + 1
