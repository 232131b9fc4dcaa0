"""The int16 inter-stage format (``DemodConfig.interstage_i16``).

Counterpart of ``fm_radio_tpu/kernels/qformat.py``: the split path's large
intermediates cross device memory as int16 fixed point instead of float32,
half the bytes:

  fm_demod  [C, B/4]  K1 -> K2        FM_SCALE = 2^15, values in (-0.86, 0.86)
  re / im   [C, B/8]  K2 -> extract   IQ_SCALE = 2^14, analytic planes
  theta     [C, B/8]  K2 -> PLL       PH_SCALE = 2^16, cycles in [-0.5, 0.5]
  dt        [C, B/8]  PLL -> extract  PH_SCALE

The kernels quantise at their stores and dequantise at their loads
(``csrc/common.cuh::q_i16``, ``dq_i16``), with the arithmetic of these two
functions, so on finite inputs kernel and plain version agree bit for bit.
NaN is not a value of the format: here ``torch.round`` and ``torch.clamp``
keep it and its conversion to int16 is whatever the host's float-to-int
conversion gives; the kernels' rounding conversion (``__float2int_rn``)
turns it into 0.
"""

from __future__ import annotations

import torch

from fm_radio_tpu_torch.ops.cmath import f32

FM_SCALE = 32768.0   # fm_demod (K1 -> K2)
IQ_SCALE = 16384.0   # analytic-signal planes (K2 -> extract)
PH_SCALE = 65536.0   # phases in cycles (theta, dt)


def q_i16(x: torch.Tensor, scale: float) -> torch.Tensor:
    """float32 -> int16 at ``scale``: round half to even, saturate to
    +-32767."""
    return torch.clamp(torch.round(x * f32(scale)), -32767.0,
                       32767.0).to(torch.int16)


def dq_i16(x: torch.Tensor, scale: float) -> torch.Tensor:
    """int16 -> float32 through int32, times float32(1 / scale)."""
    return x.to(torch.int32).to(torch.float32) * f32(1.0 / scale)


def dq_if_i16(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x`` dequantised if it is int16, else ``x`` itself."""
    return dq_i16(x, scale) if x.dtype == torch.int16 else x
