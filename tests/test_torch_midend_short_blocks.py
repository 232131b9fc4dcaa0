"""The mid end on blocks shorter than a carried tail, on the host.

A block whose fm_demod is shorter than the ds x2 tail (B/4 < taps - 2) or
whose fm_out is shorter than the Hilbert tail (B/8 < taps - 1) takes the
launches route (``kernels/midend.py::midend_route``).  The tails it
carries are the last samples of concat(old tail, block), as the JAX
package's ``ops/fir.py::_decimate_core`` keeps them, and not the block's
own samples alone (which would leave a tail shorter than the filter's
halo, refused by the next call).  Here, through ``midend``'s wrapper on
the CPU (its plain version):

- three short blocks, then a long one, equal the port run on the
  concatenated stream: every output and every carried state, with the
  de-emphasis off and on;
- the same blocks against JAX ``ops/fir.py::polyphase_decimate`` and
  ``hilbert_fir_p`` with their tails carried from block to block, within
  2e-5 (K2's tolerance in tests/test_torch_split.py);
- ``carried`` itself on blocks shorter than, as long as and longer than
  the tail.

The launches route's kernels are held against the plain version on such
blocks on the card (``chip_smoke.compare_mid_short_blocks``,
``tests/test_torch_gpu.py::test_mid_short_blocks_on_card``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_radio_tpu.ops import fir as jfir
from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.kernels import midend as tmid
from fm_radio_tpu_torch.models import demod as tdemod

CFG = DemodConfig()
CFG_DE = dataclasses.replace(CFG, use_deemphasis_filter=True,
                             deemphasis_cutoff_us=50)
# fm_demod samples a block: shorter than the ds x2 tail (62) and the
# Hilbert tail (64 at B/8 = 16), shorter than the Hilbert tail only (B/8
# = 48), the first again, then a block of the split route
BLOCKS = (32, 96, 32, 4096)
C = 3
TOL = 2e-5
STATE_KEYS = ("ds_fm_out", "hilbert", "deemph", "peak_pilot")


def _fmd():
    """fm_demod [C, sum(BLOCKS)] drawn as N(0, 0.3^2) from a seed."""
    rng = np.random.default_rng(23)
    return torch.from_numpy(
        (0.3 * rng.standard_normal((C, sum(BLOCKS)))).astype(np.float32))


def _start(cfg):
    """The start state with random carried tails (so that a tail lost or
    cut shows)."""
    st = tdemod.demod_init_state(cfg, C)
    rng = np.random.default_rng(5)
    for key in ("ds_fm_out", "hilbert"):
        st[key] = torch.from_numpy(
            rng.standard_normal(tuple(st[key].shape)).astype(np.float32))
    return st


def _leaves(v):
    return list(v.values()) if isinstance(v, dict) else [v]


@pytest.mark.parametrize("cfg", [CFG, CFG_DE], ids=["de_off", "de_on"])
def test_short_blocks_equal_the_concatenated_stream(cfg):
    co = tdemod.make_coeffs(cfg)
    fmd = _fmd()
    st, outs, at = _start(cfg), [], 0
    for n4 in BLOCKS:
        want_route = "split" if n4 == BLOCKS[-1] else "launches"
        assert tmid.midend_route(co, n4) == want_route
        st, (re, im), theta = tmid.midend(co, cfg, st, fmd[:, at : at + n4])
        assert st["ds_fm_out"].shape == (C, co.taps_fm_out.shape[0] - 2)
        assert st["hilbert"].shape == (C, co.taps_hilbert.shape[0] - 1)
        outs.append((re, im, theta))
        at += n4
    whole, (re_w, im_w), th_w = tmid.midend(co, cfg, _start(cfg), fmd)
    for got, want in zip(zip(*outs), (re_w, im_w, th_w)):
        assert torch.equal(torch.cat(got, dim=-1), want)
    for key in STATE_KEYS:
        for a, b in zip(_leaves(st[key]), _leaves(whole[key])):
            assert torch.equal(a, b), key


def test_short_blocks_match_jax_fir_ops():
    co = tdemod.make_coeffs(CFG)
    fmd = _fmd()
    st = _start(CFG)
    j_ds, j_hb = jnp.asarray(st["ds_fm_out"].numpy()), jnp.asarray(
        st["hilbert"].numpy())
    taps2 = jnp.asarray(co.taps_fm_out.numpy())
    tapsh = jnp.asarray(co.taps_hilbert.numpy())
    at = 0
    for n4 in BLOCKS:
        xb = fmd[:, at : at + n4]
        st, (re, im), _ = tmid.midend(co, CFG, st, xb)
        j_ds, fm_out = jfir.polyphase_decimate(taps2, j_ds,
                                               jnp.asarray(xb.numpy()), 2)
        j_hb, (j_re, j_im) = jfir.hilbert_fir_p(tapsh, j_hb, fm_out)
        for got, want in ((re, j_re), (im, j_im), (st["ds_fm_out"], j_ds),
                          (st["hilbert"], j_hb)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=TOL, rtol=0)
        at += n4


@pytest.mark.parametrize("n", [0, 5, 8, 13])
def test_carried_keeps_the_last_samples_of_tail_and_block(n):
    hist = torch.arange(8, dtype=torch.float32).repeat(2, 1)
    x = 100.0 + torch.arange(n, dtype=torch.float32).repeat(2, 1)
    want = torch.cat([hist, x], dim=-1)[:, -8:]
    assert torch.equal(tmid.carried(hist, x), want)
