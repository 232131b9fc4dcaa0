"""BPSK symbol synchroniser for the RDS subcarrier: state and constants.

Counterpart of ``fm_radio_tpu/models/bpsk.py`` (``BPSKState``) and of
``bpsk_consts_from_cfg`` (``fm_radio_tpu/kernels/bpsk_pallas.py:175-201``).
The loop itself is ``kernels/bpsk.py`` (CUDA kernel and plain version).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fm_radio_tpu_torch.ops.cmath import f32
from fm_radio_tpu_torch.ops.design import create_iir_single_pole_lpf


class BPSKState(NamedTuple):
    """All [C]-shaped; ``cooldown`` int32, ``int_dump`` complex64, the rest
    float32."""

    pll_lpf_x1: torch.Tensor
    pll_lpf_y1: torch.Tensor
    pll_integ: torch.Tensor
    pll_nco_t: torch.Tensor
    pll_prev_pe: torch.Tensor
    zcd_prev_q: torch.Tensor
    cooldown: torch.Tensor      # int32 samples remaining
    ted_lpf_x1: torch.Tensor
    ted_lpf_y1: torch.Tensor
    ted_integ: torch.Tensor
    ted_prev_pe: torch.Tensor
    ted_ramp: torch.Tensor      # TED clock integrator voltage
    int_dump: torch.Tensor      # complex64 accumulator


def bpsk_init_state(channels: int, device=None) -> BPSKState:
    def z(dtype):
        return torch.zeros(channels, dtype=dtype, device=device)

    f = [z(torch.float32) for _ in range(11)]
    return BPSKState(*f[:6], z(torch.int32), *f[6:], z(torch.complex64))


def bpsk_consts_from_cfg(cfg) -> dict:
    """Loop constants as float32-valued Python floats, in the order of the
    CUDA kernel's arguments (the TPU kernel rounds them to float32 too)."""
    b = cfg.bpsk
    fs = b.f_sample_rate
    ts = 1.0 / fs
    ted_b, ted_a = create_iir_single_pole_lpf(b.ted_max_freq_offset / (fs / 2.0))
    pll_b, pll_a = create_iir_single_pole_lpf(b.pll_max_freq_offset / (fs / 2.0))
    k = b.f_symbol_rate / fs
    area = 0.5 * b.samples_per_symbol
    return dict(
        ts=f32(ts),
        pll_ki_ts=f32(b.pll_integrator_gain * ts * k),
        pll_kp=f32(b.pll_proportional_gain),
        pll_f_gain=f32(b.pll_max_freq_offset),
        pll_lpf_b0=f32(pll_b[0]),
        pll_lpf_a1=f32(pll_a[1]),
        ted_ki_ts=f32(b.ted_integrator_gain * ts * k),
        ted_kp=f32(b.ted_proportional_gain),
        ted_f_center=f32(b.f_symbol_rate),
        ted_f_gain=f32(b.ted_max_freq_offset),
        ted_lpf_b0=f32(ted_b[0]),
        ted_lpf_a1=f32(ted_a[1]),
        int_dump_kts=f32(1.0 / area),
        zcd_cooldown=f32(b.zcd_cooldown),
    )
