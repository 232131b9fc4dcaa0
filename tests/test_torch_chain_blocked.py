"""The redesigned megakernel's blocked stages, its probe and its limits.

The CUDA kernel (``csrc/chain.cu::chain_kernel``) runs only on the card.
Here numpy models of its two register-blocked stages, at the receiver's
filter orders, are held bit for bit against the plain versions' sums
(``ops/fir.py::correlate``, which ``frontend_plain`` and ``extract_plain``
run): ds x4 over the skewed input window of a tile (the float4 staging
and the first tile's scalar staging with its halo) and the five extract
FIRs over the six skewed planes in their slot order.  Each model checks
that every output is written exactly once, that each lane reads exactly
the samples its outputs' windows hold, and that the lanes of a warp load
from distinct banks.  Then ``probes/chain_phases.py``'s edits against the
kernel's source, and the kernel's shape limits refused before any launch
on the meta device.
"""

import numpy as np
import pytest
import torch

from fm_radio_tpu_torch.config import DemodConfig
from fm_radio_tpu_torch.kernels import _build
from fm_radio_tpu_torch.kernels import chain as tchain
from fm_radio_tpu_torch.models.demod import demod_init_state, make_coeffs
from fm_radio_tpu_torch.ops.fir import correlate
from fm_radio_tpu_torch.probes import chain_phases

F = np.float32
# csrc/chain.cu's tile and layout
T, H, CH, THREADS = 512, 128, 4, 128
IN_S, PL_S = 688, 226  # an input plane's and an extraction channel's stride
PL_B = CH * PL_S       # an extraction plane (4 channels)
DS4_TAPS, EXT_TAPS = 64, 128
PL = H + T // 8        # an extraction plane's samples
SLOT = {0: 0, 1: 5, 2: 1, 3: 2, 4: 3, 5: 4}  # ch_slot


def _skew(x):
    return x + (x >> 5)


def _fir_block(smem, x0, lane, w, m, r_outs, nn, b0):
    """extract_stages.cuh::fir_block for one lane over the plane at
    ``x0`` of ``smem``: (its R outputs, the addresses of its loads in
    order)."""
    xl, loads = x0 + 33 * lane, []

    def load(at):
        loads.append(at)
        return smem[at]

    v = [[load(xl + _skew(b0 + m * r + p)) for r in range(r_outs)]
         for p in range(m)]
    acc = [F(0.0)] * r_outs

    def steps(qb, last):
        xq, wq = xl + 33 * (qb // r_outs), m * qb
        for qq in range(r_outs):
            wk = w[wq + m * qq : wq + m * qq + m]
            for p in range(m):
                for r in range(r_outs):
                    acc[r] = F(acc[r] + F(wk[p] * v[p][(r + qq) % r_outs]))
                if not last or qq + 1 < r_outs:
                    v[p][qq] = load(xq + _skew(b0 + m * (r_outs + qq) + p))

    for qb in range(0, nn // m - r_outs, r_outs):
        steps(qb, False)
    steps(nn // m - r_outs, True)
    return np.array(acc, F), loads


def _banks_distinct(loads_by_lane):
    """Load j of every lane of a warp on a distinct bank."""
    n = len(next(iter(loads_by_lane.values())))
    for j in range(n):
        banks = [ld[j] % 32 for ld in loads_by_lane.values()]
        assert len(set(banks)) == len(banks), f"load {j} conflicts"


@pytest.mark.parametrize("first_tile", [False, True])
def test_ds4_blocked_tile_model(first_tile):
    """Phase 1 and 2a of a tile at nn1 = 64: the window staged skewed
    (float4 fetches from t0 - 64, or on a channel's first tile the scalar
    path from the carried tail), every plane's 128 outputs summed by
    fir_block<4, 8, 64, 68> two channel planes a warp, stored once (re to
    theta1's buffer, im to fm_demod's), equal to K1's plain sums."""
    rng = np.random.default_rng(int(first_tile))
    h1 = DS4_TAPS - 4
    # samples g = t0 - 64 .. t0 + T - 1 of 16 channel planes (re 0-7)
    x = rng.integers(-127, 129, (2 * CH, DS4_TAPS + T)).astype(F)
    w = rng.normal(0, 0.05, DS4_TAPS).astype(F)
    smem = np.full(2 * CH * IN_S, np.nan, F)
    src = {}  # address -> (channel plane, sample index g - t0)

    def put(cp, j):  # window index j holds sample j - H
        at = cp * IN_S + _skew(j)
        assert at not in src and _skew(j) < IN_S
        src[at] = (cp, j - H)
        smem[at] = x[cp, j - H + DS4_TAPS]

    if first_tile:  # the scalar loop: g from t0 - h1
        for e in range(CH * (h1 + T)):
            ch, j = divmod(e, h1 + T)
            put(ch, H - h1 + j)
            put(CH + ch, H - h1 + j)
    else:  # float4 fetches of samples t0 - 64 ..: kN rounds a thread
        n_g = (DS4_TAPS + T) // 4
        for e in range(CH * n_g):
            ch, g = divmod(e, n_g)
            for v in range(4):
                put(ch, H - DS4_TAPS + 4 * g + v)
                put(CH + ch, H - DS4_TAPS + 4 * g + v)
    out = {}
    for warp in range(THREADS // 32):
        loads = {}
        for lane in range(32):
            cp, li = 2 * warp + lane // 16, lane % 16
            acc, ld = _fir_block(smem, cp * IN_S, li, w, 4, 8, DS4_TAPS,
                                 H - h1)
            loads[lane] = ld
            got = {src[a] for a in ld}
            assert got == {(cp, 4 * (8 * li + r) - h1 + k)
                           for r in range(8) for k in range(DS4_TAPS)}
            for r in range(8):
                key = (cp, 8 * li + r)
                assert key not in out
                out[key] = acc[r]
        _banks_distinct(loads)
    assert len(out) == 2 * CH * (T // 4)
    # K1's plain sum: correlate over [tail | x] from sample t0 - h1
    want = correlate(w.tolist(), torch.from_numpy(x[:, DS4_TAPS - h1 :]),
                     4, T // 4)
    for (cp, j), v in out.items():
        assert v == want[cp, j].item()


def test_extract_blocked_tile_model():
    """Phase 11 at nn_a = nn_r = 128: the six planes skewed in their slot
    order, warps 0 and 1 run the five FIRs (fir_block<4, 8, 128, 4> on lpr
    and L-R, fir_block<8, 4, 128, 8> on RDS), two lanes a channel plane;
    every output written once, equal to extract's plain sums."""
    rng = np.random.default_rng(3)
    planes = rng.normal(0, 1, (6, CH, PL)).astype(F)
    wa, wm, wr = (rng.normal(0, 0.05, EXT_TAPS).astype(F) for _ in range(3))
    smem = np.full(6 * PL_B, np.nan, F)
    src = {}
    for p in range(6):
        for ch in range(CH):
            for i in range(PL):
                at = SLOT[p] * PL_B + ch * PL_S + _skew(i)
                assert at not in src and _skew(i) < PL_S
                src[at] = (p, ch, i)
                smem[at] = planes[p, ch, i]
    out = {}
    for warp in range(2):
        loads = {}
        for lane in range(32):
            q, ch, li = lane // 8, (lane % 8) // 2, lane % 2
            p = (0 if q == 0 else q + 1) if warp == 0 else 4 + q
            if q >= (3 if warp == 0 else 2):
                continue
            x0 = SLOT[p] * PL_B + ch * PL_S
            if p < 4:
                m, r_outs, w = 4, 8, wa if p == 0 else wm
            else:
                m, r_outs, w = 8, 4, wr
            acc, ld = _fir_block(smem, x0, li, w, m, r_outs, EXT_TAPS,
                                 H - (EXT_TAPS - m))
            loads[lane] = ld
            b0 = H - (EXT_TAPS - m)
            assert {src[a] for a in ld} == {
                (p, ch, b0 + m * (r_outs * li + r) + k)
                for r in range(r_outs) for k in range(EXT_TAPS)}
            for r in range(r_outs):
                key = (p, ch, r_outs * li + r)
                assert key not in out
                out[key] = acc[r]
        _banks_distinct(loads)
    assert len(out) == CH * (3 * T // 32 + 2 * T // 64)
    for (p, ch, j), v in out.items():
        m, w = (4, wa if p == 0 else wm) if p < 4 else (8, wr)
        b0 = H - (EXT_TAPS - m)
        want = correlate(w.tolist(), torch.from_numpy(planes[p, ch, b0:]),
                         m, PL // m - (b0 + EXT_TAPS - m) // m)
        assert v == want[j].item()


@pytest.mark.parametrize("name", sorted(chain_phases.VARIANTS))
def test_chain_phases_edits_apply(name):
    """Every variant of probes/chain_phases.py finds each statement it
    edits inside its phase of csrc/chain.cu (a variant that found none
    would time the full kernel under another name)."""
    src = (_build.CSRC / "chain.cu").read_text()
    out = chain_phases.variant_source(src, chain_phases.VARIANTS[name])
    assert (out == src) == (not chain_phases.VARIANTS[name])


@pytest.mark.parametrize("c,b", [(12, 8192), (8, 8192 + 256), (4, 512)])
def test_chain_limits_refused_before_launch_on_meta(c, b):
    """C % 8 and B % 512 (csrc/chain.cu's CTA and tile) raise before any
    launch on a device other than the CPU."""
    cfg = DemodConfig(assume_integer_input=True, chain_fusion="auto")
    co, st = make_coeffs(cfg), demod_init_state(cfg, c)
    before = tchain.launches
    with pytest.raises(ValueError, match="multiple of 8"):
        tchain.chain(co, cfg, st, torch.empty((c, b), device="meta"))
    assert tchain.launches == before


def test_chain_valid_shape_dispatches_by_device():
    """A shape within the limits passes them and then dispatches by
    device: meta has no kernel."""
    cfg = DemodConfig(assume_integer_input=True, chain_fusion="auto")
    co, st = make_coeffs(cfg), demod_init_state(cfg, 8)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tchain.chain(co, cfg, st, torch.empty((8, 8192), device="meta"))
