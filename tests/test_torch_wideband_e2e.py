"""``wideband_demod_block`` end to end, port (plain versions, CPU tensors)
against the JAX package, and the port's phase-split bridge against its flat
int8 bridge.  Inputs come from numpy seeds; both packages start from one
state."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_radio_tpu.config import DemodConfig as JDemodConfig
from fm_radio_tpu.io.synth import (
    FMModulator,
    ModulatorConfig,
    make_wideband,
    station_group_schedule,
)
from fm_radio_tpu.models import demod as jdemod
from fm_radio_tpu.models import wideband as jwide
from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.models import demod as tdemod
from fm_radio_tpu_torch.models import wideband as twide
from fm_radio_tpu_torch.parallel import channelizer as tch
from fm_radio_tpu_torch.rds.chain import make_rds_chain
from fm_radio_tpu_torch.utils import transfer as ttransfer
from fm_radio_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

CFG = DemodConfig(frontend_int8=True)
SNR_MIN_DB = 75.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small tensor ops; with pytest-xdist
    workers sharing the cores, torch's intra-op threads only contend
    (several times slower), so this module runs them on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _station_capture(m, n, channel, seed=0):
    """[2, n*M] packed words: capture 0 silent (every sample at the u8
    centre), capture 1 one stereo+RDS station on ``channel``."""
    groups = station_group_schedule(0xBEEF, ps="WIDEBAND")
    iq = FMModulator(ModulatorConfig()).generate(
        n, left_hz=800.0, right_hz=1600.0, rds_groups=groups)
    wide = make_wideband({channel: iq}, m)
    wide *= 100.0 / np.abs(wide).max()
    u8 = np.clip(np.stack([np.round(wide.real + 127.0),
                           np.round(wide.imag + 127.0)], -1),
                 0, 255).astype(np.uint8)
    w1 = ttransfer.pack_iq_u8(u8)
    return np.stack([np.full_like(w1, 127.0 * 256 + 127.0), w1])


def _rds_bytes(pred, valid):
    chain = make_rds_chain()
    sym = pred[valid]
    if sym.size:
        chain.process_symbols(sym)
    return (np.concatenate(chain.rds_bytes) if chain.rds_bytes
            else np.zeros(0, np.uint8))


@pytest.mark.parametrize("m", [8, 32])
def test_wideband_demod_block_matches_jax(m):
    """Port vs JAX ``wideband_demod_block`` (bridge "i8"; JAX with
    loop_impl="pallas", so its Pallas kernels run in interpret mode, at
    M = 32 its K12 on phase planes), W = 2 captures, 5 blocks of 32,768
    per channel (160 ms: the RDS chain's first bytes come after ~130 ms)
    from one start state.  The station's RDS bytes are
    identical, its audio is >= 75 dB SNR against JAX (the golden bar),
    and the silent capture's rows are silent in both.  (``rds_valid`` is
    not compared sample for sample: over 160 ms the float32 differences of
    the two demodulators reach the BPSK clock, which may take a decision
    one sample apart without changing a decoded bit.)"""
    b, blocks, channel = 32768, 5, 3
    cfg_j = JDemodConfig(frontend_int8=True, loop_impl="pallas")
    co_j, co_t = jdemod.make_coeffs(cfg_j), tdemod.make_coeffs(CFG)
    words = _station_capture(m, b * blocks, channel)
    st_j = jwide.wideband_init_state(cfg_j, m, 2)
    st_t = state_from_numpy(_np(st_j))
    t = m * b
    outs_j, outs_t = [], []
    for blk in range(blocks):
        xb = words[:, blk * t : (blk + 1) * t]
        st_j, oj = jwide.wideband_demod_block(cfg_j, co_j, None, st_j,
                                              jnp.asarray(xb), m)
        st_t, ot = twide.wideband_demod_block(CFG, co_t, None, st_t,
                                              torch.from_numpy(xb), m)
        outs_j.append({k: np.asarray(v) for k, v in oj.items()})
        outs_t.append({k: v.numpy() for k, v in ot.items()})
    cat = {src: {k: np.concatenate([o[k] for o in outs], axis=1)
                 for k in ("audio", "rds_pred", "rds_valid")}
           for src, outs in (("jax", outs_j), ("port", outs_t))}
    row = m + channel  # capture 1, the station's channel
    a_j, a_t = cat["jax"]["audio"][row], cat["port"]["audio"][row]
    snr = 10 * np.log10(np.sum(a_j.astype(np.float64) ** 2)
                        / np.sum((a_t.astype(np.float64) - a_j) ** 2))
    assert snr >= SNR_MIN_DB, f"audio SNR {snr:.1f} dB vs JAX"
    assert np.sqrt(np.mean(a_t ** 2)) > 1e-3
    by = [_rds_bytes(cat[s]["rds_pred"][row], cat[s]["rds_valid"][row])
          for s in ("jax", "port")]
    assert by[0].size > 0
    np.testing.assert_array_equal(by[1], by[0])
    for src in ("jax", "port"):
        assert not cat[src]["audio"][:m].any(), f"{src}: silent rows"
    sj, stn = _np(st_j), state_to_numpy(st_t)
    for a, b_ in zip(stn["chan"], sj["chan"]):
        np.testing.assert_array_equal(a, b_)


def test_wideband_m32_phase_split_equals_flat_bridge():
    """At M = 32 the phase-split bridge gives the same outputs and state,
    bit for bit, as the same capture forced through flat int8 planes
    (channelizer out="i8", reshaped to [2, C, B], into the flat K12)."""
    m, b, blocks = 32, 8192, 2
    co = tdemod.make_coeffs(CFG)
    words = torch.from_numpy(_station_capture(m, b * blocks, 5))
    taps = tch.make_channelizer_taps(m)
    st_ps = st_fl = twide.wideband_init_state(CFG, m, 2)
    for blk in range(blocks):
        xb = words[:, blk * m * b : (blk + 1) * m * b]
        calls = {}
        st_ps, o_ps = twide.wideband_demod_block(CFG, co, taps, st_ps, xb, m,
                                                 record=calls)
        assert calls["channelizer"][4:] == ("i8ps", 3) and "k12_ps" in calls
        chan, y8 = tch.channelize_batch_p(taps, st_fl["chan"], xb, m,
                                          out="i8")
        demod, o_fl = tdemod.demod_block(CFG, co, st_fl["demod"],
                                         y8.reshape(2, 2 * m, -1))
        st_fl = {"chan": chan, "demod": demod}
        for k in o_ps:
            assert torch.equal(o_ps[k], o_fl[k]), k
    a, b_ = state_to_numpy(st_ps), state_to_numpy(st_fl)
    for (p, u), (q, v) in zip(jax.tree_util.tree_leaves_with_path(a),
                              jax.tree_util.tree_leaves_with_path(b_)):
        assert p == q
        np.testing.assert_array_equal(u, v, err_msg=str(p))
