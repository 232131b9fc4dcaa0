"""Host-side filter designers (pure NumPy; run once per config, never traced).

A copy of ``fm_radio_tpu/ops/design.py``: importing that module runs
``fm_radio_tpu/ops/__init__.py``, which loads jax.  The copy must stay
bit-identical in output (tests/test_torch_design.py checks every tap).

Parity: ``src/dsp/filter_designer.cpp:84-384``.  The reference stores
coefficients *reversed* (``filter_designer.cpp:27-39``) purely so its SIMD dot
product can walk both arrays forward; the effective causal impulse response is
the array as designed.  We return taps ``h`` in natural (causal) order with the
convention ``y[n] = sum_j h[j] * x[n-j]``, which is mathematically identical to
the reference's ``apply_filter`` (``fir_filter.h:80-87``) given its reversed
storage.

IIR designers return ``(b, a)`` in SciPy convention:
``y[n] = sum_j b[j] x[n-j] - sum_{j>=1} a[j] y[n-j]``, ``a[0] == 1``.
This matches the reference's direct-form-I update (``iir_filter.h:33-70``)
once its reversed storage and negated-``a`` bookkeeping are unwound.
"""

from __future__ import annotations

import numpy as np

from fm_radio_tpu_torch.ops.windows import window_hamming

_Window = type(window_hamming)


def _sinc(x: np.ndarray) -> np.ndarray:
    """sin(pi x)/(pi x) with sinc(0)=1 (``filter_designer.cpp:20-25``)."""
    return np.sinc(x)  # np.sinc is the normalized sinc: sin(pi x)/(pi x)


def prewarp_normalised_frequency(kd: float) -> float:
    """Bilinear-transform frequency pre-warp (``filter_designer.cpp:42-64``).

    ka = 2/pi * tan(pi/2 * kd), with k = Fc/(Fs/2).
    """
    return 2.0 / np.pi * np.tan(np.pi / 2.0 * kd)


def _sinc_grid(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Windowed-sinc design grid shared by LPF/HPF/BPF: returns
    (window argument 2*pi*i/(n-1), centered index i-(n-1)/2).
    ``n > 1``: a single-tap sinc design divides by n-1 == 0."""
    assert n > 1, "windowed-sinc designers need n > 1 taps"
    i = np.arange(n, dtype=np.float64)
    m = float(n - 1)
    return 2.0 * np.pi * i / m, i - m / 2.0


def create_fir_lpf(n: int, k: float, window=window_hamming) -> np.ndarray:
    """Windowed-sinc low-pass FIR (``filter_designer.cpp:84-107``)."""
    assert 0.0 < k < 1.0
    t0, t1 = _sinc_grid(n)
    h = window(t0) * (k * _sinc(k * t1))
    return h.astype(np.float32)


def create_fir_hpf(n: int, k: float, window=window_hamming) -> np.ndarray:
    """Windowed-sinc high-pass FIR: h = sinc - k*sinc(k t)
    (``filter_designer.cpp:109-129``)."""
    assert 0.0 < k < 1.0
    t0, t1 = _sinc_grid(n)
    h = window(t0) * (_sinc(t1) - k * _sinc(k * t1))
    return h.astype(np.float32)


def create_fir_bpf(n: int, k1: float, k2: float, window=window_hamming) -> np.ndarray:
    """Band-pass as difference of two LPFs (``filter_designer.cpp:131-155``)."""
    assert 0.0 < k1 < k2 < 1.0
    t0, t1 = _sinc_grid(n)
    h = window(t0) * (k2 * _sinc(k2 * t1) - k1 * _sinc(k1 * t1))
    return h.astype(np.float32)


def create_fir_hilbert(n: int) -> np.ndarray:
    """Antisymmetric Hilbert FIR (``filter_designer.cpp:369-384``).

    Non-causal ideal taps h[m] = 2/(pi m) for odd m, 0 for even m, delayed by
    (n-1)/2.  ``n`` must be odd.
    """
    assert n > 0 and n % 2 == 1
    m = (n - 1) // 2
    idx = np.arange(n, dtype=np.int64) - m
    with np.errstate(divide="ignore"):
        h = np.where(idx % 2 == 0, 0.0, 2.0 / (np.pi * idx.astype(np.float64)))
    return h.astype(np.float32)


def create_iir_single_pole_lpf(k: float) -> tuple[np.ndarray, np.ndarray]:
    """First-order Butterworth LPF via pre-warped bilinear transform
    (``filter_designer.cpp:158-200``).

    Returns (b, a) with b=[b0, b0], a=[1, a1]; update
    y[n] = b0 (x[n] + x[n-1]) - a1 y[n-1].
    """
    assert 0.0 < k < 1.0
    k_warp = prewarp_normalised_frequency(k)
    big_a = 1.0 / (np.pi * k_warp)
    b0 = 1.0 / (1.0 + 2.0 * big_a)
    a1 = (1.0 - 2.0 * big_a) / (1.0 + 2.0 * big_a)
    b = np.array([b0, b0], dtype=np.float32)
    a = np.array([1.0, a1], dtype=np.float32)
    return b, a


def _phasor(x: float) -> complex:
    return complex(np.cos(x), np.sin(x))


def create_iir_notch_filter(k: float, r: float) -> tuple[np.ndarray, np.ndarray]:
    """Second-order z-plane notch: zeros on the unit circle at ±wn, poles at
    r·e^{±jwn} (``filter_designer.cpp:202-258``)."""
    assert 0.0 < k < 1.0 and 0.0 < r < 1.0
    wn = np.pi * k
    a0 = 2.0 * np.cos(wn)

    def h_z(k_z: float) -> complex:
        z = _phasor(np.pi * k_z)
        z0 = _phasor(+np.pi * k)
        z1 = _phasor(-np.pi * k)
        return ((z - z0) * (z - z1)) / ((z - r * z0) * (z - r * z1))

    # normalize the passband side furthest from the notch
    k_z = 0.0 if k > 0.5 else 1.0
    big_k = 1.0 / abs(h_z(k_z))

    b = big_k * np.array([1.0, -a0, 1.0], dtype=np.float64)
    a = np.array([1.0, -a0 * r, r * r], dtype=np.float64)
    return b.astype(np.float32), a.astype(np.float32)


def create_iir_peak_1_filter(k: float, r: float) -> tuple[np.ndarray, np.ndarray]:
    """Second-order all-pole peak filter: poles at r·e^{±jwn}, numerator z^-2,
    normalized to unity gain at the peak (``filter_designer.cpp:260-310``)."""
    assert 0.0 < k < 1.0 and 0.0 < r < 1.0
    wn = np.pi * k
    a0 = 2.0 * np.cos(wn)

    def h_z(k_z: float) -> complex:
        z = _phasor(np.pi * k_z)
        z0 = _phasor(+np.pi * k)
        z1 = _phasor(-np.pi * k)
        return 1.0 / ((z - r * z0) * (z - r * z1))

    big_k = 1.0 / abs(h_z(k))
    b = big_k * np.array([0.0, 0.0, 1.0], dtype=np.float64)
    a = np.array([1.0, -r * a0, r * r], dtype=np.float64)
    return b.astype(np.float32), a.astype(np.float32)


def create_iir_peak_2_filter(
    k: float, r: float, a_db: float
) -> tuple[np.ndarray, np.ndarray]:
    """Second-order zero+pole peak filter with controllable peak gain
    (``filter_designer.cpp:312-367``)."""
    assert 0.0 < k < 1.0 and 0.0 < r < 1.0
    big_a = 10.0 ** (a_db / 20.0)
    rc_scale = (1.0 - r) * 2.0
    r0 = 1.0 - rc_scale
    r1 = 1.0 - rc_scale / big_a

    wn = np.pi * k
    a0 = 2.0 * np.cos(wn)

    def h_z(k_z: float) -> complex:
        z = _phasor(np.pi * k_z)
        z0 = _phasor(+np.pi * k)
        z1 = _phasor(-np.pi * k)
        return ((z - r0 * z0) * (z - r0 * z1)) / ((z - r1 * z0) * (z - r1 * z1))

    big_k = 1.0 / abs(h_z(k))
    b = big_k * np.array([1.0, -r0 * a0, r0 * r0], dtype=np.float64)
    a = np.array([1.0, -r1 * a0, r1 * r1], dtype=np.float64)
    return b.astype(np.float32), a.astype(np.float32)
