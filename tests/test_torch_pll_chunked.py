"""The chunked pilot PLL (``pll_time_chunks = G > 1``), run here as its
plain PyTorch version (CPU tensors), against the JAX package.

``pilot_pll_theta`` against ``pilot_pll_pallas_theta`` (interpret mode) on
both sides of the chunk gate, two blocks from one start state; the chunked
run against the sequential one on a locked pilot (chunk 0 bit for bit, the
later chunks within the JAX package's own band, tests/test_kernels.py:
179-206); the route ``demod_block`` records; and a station through both
``App``s with ``pll_time_chunks=4``.  The kernel itself is held against
this plain version on the card (``chip_smoke.py``,
``tests/test_torch_gpu.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_radio_tpu.config import DemodConfig as JDemodConfig
from fm_radio_tpu.io.synth import FMModulator, ModulatorConfig
from fm_radio_tpu.kernels.pll_pallas import pilot_pll_pallas_theta
from fm_radio_tpu.models import demod as jdemod
from fm_radio_tpu.models.app import App as JaxApp
from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.io.pcm import c64_to_u8
from fm_radio_tpu_torch.kernels import pll as tpll
from fm_radio_tpu_torch.models import demod as tdemod
from fm_radio_tpu_torch.models.app import App
from fm_radio_tpu_torch.models.pilot_pll import pilot_pll_init_state
from fm_radio_tpu_torch.utils.convert import state_from_numpy
from fm_radio_tpu_torch.utils.transfer import split_iq_i8

SNR_MIN_DB = 75.0
GROUPS = [
    (0x1234, (0 << 12) | (1 << 10) | 0b00000, 0xE101, 0x4142),  # 0A
    (0x1234, (2 << 12) | 0b00000, 0x4845, 0x4C4C),              # 2A
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain loops run many small tensor ops; with pytest-xdist
    workers sharing the cores, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(**kw):
    """The port's and the JAX package's DemodConfig from the same keyword
    arguments."""
    return DemodConfig(**kw), JDemodConfig(**kw)


def _pilot_theta(c, n, seed):
    """Pilot phase (cycles) of a noisy 19,015 Hz tone at 128 kHz
    (tests/test_kernels.py::_pilot_signal), a different start phase per
    channel."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 128000.0
    x = np.exp(1j * (2 * np.pi * 19015.0 * t[None, :]
                     + rng.uniform(0, 2 * np.pi, (c, 1)))) + 0.01 * (
        rng.standard_normal((c, n)) + 1j * rng.standard_normal((c, n)))
    return (np.angle(x) / (2 * np.pi)).astype(np.float32)


# (C, N per block, G, W) -> C * G lanes; the gate is G > 1, N % G == 0
# and N / G > W
PALLAS_CASES = {
    "c2_g4": (2, 32768, 4, 4096),          # chunked, 8 lanes of 12,288 steps
    "c5_g4": (5, 32768, 4, 4096),          # odd C: 20 lanes, not 32k
    "c3_g4_short": (3, 2048, 4, 256),      # chunked, 12 lanes of 768 steps
    "short_chunks": (2, 1024, 4, 4096),    # N / G = 256 <= W: sequential
    "indivisible": (3, 1024, 3, 4096),     # N % G != 0: sequential
}


@pytest.mark.parametrize("case", list(PALLAS_CASES))
def test_pll_chunked_plain_matches_pallas(case):
    """Two blocks from one start state through ``pilot_pll_theta`` and
    ``pilot_pll_pallas_theta`` (interpret), each carrying its own state:
    the same gate taken, dt (wrapped) and the state compared.

    Tolerances: where every lane runs at most ~1,000 steps, the port's
    sequential PLL test's (tests/test_torch_kernels.py): dt 2e-6 cycles,
    state 1e-5 (measured 1.3e-6 and 6e-6).  XLA on the CPU contracts the
    step's multiply-adds into FMAs (measured: jit(a * b + c) equals the
    fused result on every element), while the port rounds each operation,
    as the card's -fmad=false build does; the difference walks with the
    loop's slow phase correction (time constant ~20k samples), so lanes
    of 12,288 steps hold dt 2e-4 cycles and the state 2*pi times that
    (its phase errors are radians; measured 5.6e-5 and 3.5e-4)."""
    c, n, g, w = PALLAS_CASES[case]
    tcfg, jcfg = cfgs(pll_time_chunks=g, pll_chunk_warmup=w)
    assert tpll.chunk_gate(tcfg, n) == (case not in ("short_chunks",
                                                     "indivisible"))
    long_lanes = n // g + w > 2048 and tpll.chunk_gate(tcfg, n)
    atol = 2e-4 if long_lanes else 2e-6
    st_atol = 2 * np.pi * 2e-4 if long_lanes else 1e-5
    theta = _pilot_theta(c, 2 * n, seed=3)
    pj = jdemod.demod_init_state(jcfg, c)["pll"]
    pt = state_from_numpy({"pll": jax.tree.map(np.asarray, pj)})["pll"]
    for blk in range(2):
        th = theta[:, blk * n : (blk + 1) * n]
        pj, dt_j = pilot_pll_pallas_theta(jcfg, pj, jnp.asarray(th),
                                          interpret=True)
        pt, dt_t = tpll.pilot_pll_theta(tcfg, pt, torch.from_numpy(th))
        d = dt_t.numpy().astype(np.float64) - np.asarray(dt_j)
        d = np.abs(d - np.round(d))
        assert d.max() <= atol, f"dt block {blk}: {d.max()}"
        for name, a, b in zip(pj._fields, pt, pj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=st_atol, rtol=0, err_msg=name)


def test_pll_chunked_matches_sequential_when_locked():
    """On a locked pilot (19 kHz, four blocks of warm-up): chunk 0 equals
    the sequential ``pll_plain`` bit for bit, and the later chunks, which
    start from the seeded state after W samples of warm-up, stay within
    1e-2 cycles max and 4e-3 rms of the sequential track (the JAX
    package's band, tests/test_kernels.py:179-206; measured here 2.2e-3
    and 1.0e-3)."""
    c, n, g = 2, 32768, 4
    cfg = DemodConfig(pll_time_chunks=g)
    t = np.arange(n) / 128000.0
    th = (np.angle(np.exp(2j * np.pi * 19000 * t)) / (2 * np.pi)).astype(
        np.float32)
    theta = torch.from_numpy(np.tile(th, (c, 1)))
    st, _ = tpll.pll_plain(cfg, pilot_pll_init_state(c), theta.repeat(1, 4))
    _, dt_par = tpll.pll_chunked_plain(cfg, st, theta)
    _, dt_seq = tpll.pll_plain(cfg, st, theta)
    l = n // g
    assert torch.equal(dt_par[:, :l], dt_seq[:, :l])
    e = (dt_par - dt_seq).double()
    e = e - torch.round(e)
    assert float(e.abs().max()) < 1e-2
    assert float(e.pow(2).mean().sqrt()) < 4e-3


@pytest.mark.parametrize("case", [
    # (G, B, int8 planes through K12 or packed words through K1 -> K2)
    (4, 262144, "i8"),     # N = 32768, N / G = 8192 > W: chunked after K12
    (4, 262144, "words"),  # chunked after K2
    (4, 32768, "i8"),      # N / G = 1024 <= W: sequential
    (1, 262144, "i8"),     # G = 1: sequential
], ids=["k12_chunked", "k2_chunked", "k12_short", "k12_g1"])
def test_demod_block_records_the_chunk_gate(case, monkeypatch):
    """``demod_block`` records ``pll_chunked`` exactly where
    ``pilot_pll_pallas_theta``'s gate sends the same theta shape and config
    to ``_pilot_pll_chunked`` (pll_pallas.py:204; its two runs stubbed to
    report the route and stop), after K12 and after K2, and ``pll``
    elsewhere; the recorded theta is the block's N = B / 8 steps."""
    from fm_radio_tpu.kernels import pll_pallas

    g, b, form = case
    tcfg, jcfg = cfgs(frontend_int8=form == "i8", pll_time_chunks=g)
    for name in ("_pilot_pll_chunked", "_pilot_pll_run"):
        def stub(*args, name=name, **kwargs):
            raise LookupError(name)
        monkeypatch.setattr(pll_pallas, name, stub)
    with pytest.raises(LookupError) as jax_route:
        pilot_pll_pallas_theta(jcfg, jdemod.demod_init_state(jcfg, 1)["pll"],
                               jnp.zeros((1, b // 8), jnp.float32))
    want = {"_pilot_pll_chunked": "pll_chunked",
            "_pilot_pll_run": "pll"}[jax_route.value.args[0]]
    x = (torch.zeros((2, 1, b), dtype=torch.int8) if form == "i8"
         else torch.full((1, b), 127.0 * 256 + 127.0))
    calls = {}
    tdemod.demod_block(tcfg, tdemod.make_coeffs(tcfg),
                       tdemod.demod_init_state(tcfg, 1), x, record=calls)
    assert want in calls and ({"pll", "pll_chunked"} - {want}).isdisjoint(
        calls)
    assert calls[want][2].shape == (1, b // 8)
    assert ("k12" if form == "i8" else "midend") in calls


def test_station_chunked_pll_matches_jax_app(monkeypatch):
    """A station through the port's App and the JAX App (loop_impl=
    "pallas") with ``DemodConfig(frontend_int8=True, pll_time_chunks=4)``
    at block 262,144, so that N / G = 8192 > W and both take the chunked
    PLL (the port's once per block): four blocks; RDS bytes identical over
    all four, audio >= 75 dB SNR against JAX over the last two.  The first
    two are the chunk lanes' acquisition from the zero start state, where
    each lane's own lock-in amplifies the FMA rounding of the JAX side
    (test_pll_chunked_plain_matches_pallas): measured 74.3 and 74.9 dB in
    blocks 0 and 1, 93.2 and 97.9 dB in blocks 2 and 3 (the sequential
    PLL: 79-83 dB in every block)."""
    block, blocks = 262144, 4
    iq = FMModulator(ModulatorConfig()).generate(
        block * blocks, left_hz=1000.0, right_hz=3000.0, rds_groups=GROUPS)
    x8 = split_iq_i8(c64_to_u8(iq.astype(np.complex64)))[:, None, :]
    tcfg, jcfg = cfgs(frontend_int8=True, pll_time_chunks=4)
    app = App(block_size=block, cfg=tcfg, channels=1, device="cpu")
    ja = JaxApp(block_size=block, channels=1,
                cfg=dataclasses.replace(jcfg, loop_impl="pallas"))
    runs = []
    plain = tpll.pll_chunked_plain
    monkeypatch.setattr(tpll, "pll_chunked_plain",
                        lambda *a: runs.append(1) or plain(*a))
    for a in (app, ja):
        a.process(x8)
    assert len(runs) == blocks
    assert app.rds_bytes(0).size > 0
    np.testing.assert_array_equal(app.rds_bytes(0), ja.rds_bytes(0))
    settle = 2 * block // 32
    sig, ref = (np.asarray(a.audio[0, settle:], np.float64) for a in (app, ja))
    snr = 10 * np.log10(np.sum(ref ** 2) / (np.sum((sig - ref) ** 2) + 1e-30))
    assert snr >= SNR_MIN_DB, f"audio SNR {snr:.1f} dB vs JAX"
