"""``demod_block`` with de-emphasis off (the receiver's default), whose mid
end takes the split route at the receiver's filter orders, against JAX
``demod_block(loop_impl="pallas")`` (its Pallas kernels in interpret mode)
over three blocks with carried state, on the int8 K12 path (int8 planes,
``frontend_int8=True``) and the split float path (complex64,
``DemodConfig()``: K1 then K2).

On the CPU the route does not change the plain versions the port runs;
these cases guard the state the route carries between blocks (the ds x2
tail, the Hilbert tail from fm_out, the IIR states, the pilot AGC): RDS
validity identical, audio and RDS predictions within 1e-4 (the block-level
tolerance of tests/test_torch_demod.py), the mid end's carried tails
within K2's 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_radio_tpu.config import DemodConfig as JDemodConfig
from fm_radio_tpu.io.pcm import c64_to_u8
from fm_radio_tpu.io.synth import FMModulator, ModulatorConfig
from fm_radio_tpu.models import demod as jdemod
from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.kernels import midend as tmid
from fm_radio_tpu_torch.models import demod as tdemod
from fm_radio_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
from fm_radio_tpu_torch.utils.transfer import split_iq_i8

GROUPS = [
    (0x1234, (0 << 12) | (1 << 10) | 0b00000, 0xE101, 0x4142),  # 0A
    (0x1234, (2 << 12) | 0b00000, 0x4845, 0x4C4C),              # 2A
]
C, B, BLOCKS = 3, 8192, 3


def _stations(c: int, n: int, seed: int) -> np.ndarray:
    """complex64 [C, n]: a stereo+RDS station a channel, its own tones,
    plus noise."""
    rng = np.random.default_rng(seed)
    mod = FMModulator(ModulatorConfig())
    rows = []
    for ch in range(c):
        iq = mod.generate(n, left_hz=700.0 + 300 * ch, right_hz=2500.0,
                          rds_groups=GROUPS)
        rows.append(iq + 2.0 * (rng.standard_normal(n)
                                + 1j * rng.standard_normal(n)))
    return np.stack(rows).astype(np.complex64)


@pytest.mark.parametrize("path", ["k12_int8", "split_complex64"])
def test_demod_block_deemphasis_off_matches_jax_pallas(path):
    kw = {"frontend_int8": True} if path == "k12_int8" else {}
    cfg, jcfg = DemodConfig(**kw), JDemodConfig(loop_impl="pallas", **kw)
    assert not cfg.use_deemphasis_filter
    co_t, co_j = tdemod.make_coeffs(cfg), jdemod.make_coeffs(jcfg)
    assert tmid.midend_route(co_t, B // 4) == "split"
    iq = _stations(C, B * BLOCKS, seed=11)
    x = split_iq_i8(c64_to_u8(iq)) if path == "k12_int8" else iq
    st_j = jdemod.demod_init_state(jcfg, C)
    st_t = state_from_numpy(jax.tree.map(np.asarray, st_j))
    n_valid = 0
    for blk in range(BLOCKS):
        xb = x[..., blk * B : (blk + 1) * B]
        calls = {}
        st_j, oj = jdemod.demod_block(jcfg, co_j, st_j, jnp.asarray(xb))
        st_t, ot = tdemod.demod_block(cfg, co_t, st_t, torch.from_numpy(xb),
                                      record=calls)
        assert ("k12" if path == "k12_int8" else "midend") in calls
        valid = np.asarray(oj["rds_valid"])
        np.testing.assert_array_equal(ot["rds_valid"].numpy(), valid)
        n_valid += int(valid.sum())
        np.testing.assert_allclose(ot["audio"].numpy(),
                                   np.asarray(oj["audio"]), atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(ot["rds_pred"].numpy()[valid],
                                   np.asarray(oj["rds_pred"])[valid],
                                   atol=1e-4, rtol=0)
        sj, stn = jax.tree.map(np.asarray, st_j), state_to_numpy(st_t)
        for key in ("ds_fm_out", "hilbert"):
            assert stn[key].shape == sj[key].shape, key
            np.testing.assert_allclose(stn[key], sj[key], atol=2e-5,
                                       rtol=0, err_msg=key)
        np.testing.assert_allclose(stn["agc_pilot"], sj["agc_pilot"],
                                   rtol=2e-4)
    assert n_valid > BLOCKS * C * (B // 64) // 16
