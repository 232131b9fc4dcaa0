"""FIR design window functions.

A copy of ``fm_radio_tpu/ops/windows.py`` (see ``ops/design.py`` for why).

Parity: ``src/dsp/window_functions.h:10-36``.  Convention: for an N-tap
filter, tap i is evaluated at ``x = 2*pi*i/(N-1)``.
"""

from __future__ import annotations

import numpy as np


def window_hamming(x: np.ndarray) -> np.ndarray:
    """Hamming (the reference's default; ``window_functions.h:11-13``)."""
    return 0.53836 - 0.46164 * np.cos(x)


def window_hann(x: np.ndarray) -> np.ndarray:
    a = np.sin(x / 2.0)
    return a * a


def window_blackman(x: np.ndarray) -> np.ndarray:
    return 0.42659 - 0.49656 * np.cos(x) + 0.076849 * np.cos(2.0 * x)


def window_blackman_harris(x: np.ndarray) -> np.ndarray:
    return (
        0.35875
        - 0.48829 * np.cos(x)
        + 0.14128 * np.cos(2.0 * x)
        - 0.01168 * np.cos(3.0 * x)
    )
