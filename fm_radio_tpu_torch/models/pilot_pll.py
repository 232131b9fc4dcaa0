"""19 kHz stereo-pilot phase-locked loop: state and loop constants.

Counterpart of ``fm_radio_tpu/models/pilot_pll.py`` and of
``pll_consts_from_cfg`` (``fm_radio_tpu/kernels/pll_pallas.py:158-175``).
The loop itself is ``kernels/pll.py`` (CUDA kernel and plain version).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fm_radio_tpu_torch.ops.cmath import f32
from fm_radio_tpu_torch.ops.design import create_iir_single_pole_lpf


class PilotPLLState(NamedTuple):
    """All [C]-shaped float32."""

    lpf_x1: torch.Tensor        # loop filter x[n-1]
    lpf_y1: torch.Tensor        # loop filter y[n-1]
    integ: torch.Tensor         # clamped PI integrator
    nco_t: torch.Tensor         # NCO phase (cycles, wrapped)
    prev_pe: torch.Tensor       # previous raw phase error (rad)


def pilot_pll_init_state(channels: int, device=None) -> PilotPLLState:
    return PilotPLLState(*(torch.zeros(channels, dtype=torch.float32,
                                       device=device) for _ in range(5)))


def pll_consts_from_cfg(cfg) -> dict:
    """Loop constants as float32-valued Python floats, in the order of the
    CUDA kernel's arguments (the TPU kernel rounds them to float32 too)."""
    r = cfg.rates
    ts = 1.0 / float(r.fs_fm_out)
    k_lpf = cfg.analog.f_pilot_deviation / (r.fs_fm_out / 2.0)
    lpf_b, lpf_a = create_iir_single_pole_lpf(k_lpf)
    return dict(
        ts=f32(ts),
        f_center=f32(-float(cfg.analog.f_pilot)),
        f_gain=f32(-float(cfg.analog.f_pilot_deviation)),
        ki_ts=f32(cfg.pilot_pll_integrator_gain * ts),
        kp=f32(cfg.pilot_pll_proportional_gain),
        lpf_b0=f32(lpf_b[0]),
        lpf_a1=f32(lpf_a[1]),
    )
