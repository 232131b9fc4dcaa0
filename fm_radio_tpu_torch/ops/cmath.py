"""Scalar/vector math shared by the demod stages and their CUDA kernels.

Counterpart of ``fm_radio_tpu/ops/cmath.py`` plus the polynomial arctangent
of ``fm_radio_tpu/kernels/pll_pallas.py:38-65``, which every kernel of the
slice uses instead of a library ``atan2``.  ``csrc/common.cuh`` holds the
same formulas for the device; both evaluate op by op in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# chebyshev_sine.h:13-20
_CHEB = (
    -25.13274193,
    64.83583069,
    -67.07687378,
    38.50016403,
    -14.07150173,
    3.20396066,
)

# atan(r)/r as a degree-8 polynomial in s = r^2 on [0, 1] (max f32 error
# 1.1e-7 rad), highest coefficient last
_ATAN_C = (
    0.9999999916871788, -0.3333312973773711, 0.19993671634515528,
    -0.14211695469412014, 0.10672057031714136, -0.07570506873136391,
    0.04347725565574077, -0.016555949161686706, 0.0029729183139991255,
)


def f32(v: float) -> float:
    """``v`` rounded to float32 and back: a Python scalar that multiplies a
    float32 tensor exactly as ``jnp.float32(v)`` does in the JAX package."""
    return float(np.float32(v))


def div_scalar(x: torch.Tensor, v: float) -> torch.Tensor:
    """x / v as a true float32 division, as the JAX package and the CUDA
    kernels divide.  (PyTorch on CUDA turns a division by a Python scalar
    into a multiplication by its reciprocal, which rounds twice.)"""
    return x / torch.full_like(x, f32(v))


def chebyshev_sine(x: torch.Tensor) -> torch.Tensor:
    """sin(2*pi*x) for x in [-0.5, +0.5] via Chebyshev polynomial (Horner)."""
    a0, a1, a2, a3, a4, a5 = (f32(c) for c in _CHEB)
    z = x * x
    b = z * a5 + a4
    b = b * z + a3
    b = b * z + a2
    b = b * z + a1
    b = b * z + a0
    return b * (z - 0.25) * x


def wrap_cycles(t: torch.Tensor) -> torch.Tensor:
    """Wrap to [-0.5, +0.5] cycles: t - round(t), half to even
    (``pll_mixer.cpp:18``)."""
    return t - torch.round(t)


def wrap_phase(x: torch.Tensor) -> torch.Tensor:
    """Wrap one turn into (-pi, pi]: single-branch wrap like
    ``fm_demod.cpp:6-10`` (assumes |x| < 3*pi, true for phase differences)."""
    pi = f32(math.pi)
    two_pi = f32(2.0 * math.pi)
    x = torch.where(x >= pi, x - two_pi, x)
    return torch.where(x <= -pi, x + two_pi, x)


def atan2_poly(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Four-quadrant arctangent by range reduction and the degree-8
    polynomial (C conventions: atan2(0, -1) = +pi, atan2(0, 0) = 0)."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    mx = torch.maximum(ax, ay)
    mn = torch.minimum(ax, ay)
    r = mn / torch.clamp(mx, min=f32(1e-37))
    s = r * r
    p = torch.full_like(s, f32(_ATAN_C[-1]))
    for c in _ATAN_C[-2::-1]:
        p = p * s + f32(c)
    a = p * r
    a = torch.where(ay > ax, f32(math.pi / 2.0) - a, a)
    a = torch.where(x < 0.0, f32(math.pi) - a, a)
    return torch.where(y < 0.0, -a, a)
