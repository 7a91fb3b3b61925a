"""Code-replica construction helpers (NumPy): ZOH resampling, +/-1
mapping and the DLL/PLL brick-wall low-pass mask.

The port's copy of the JAX package's ``ops/prn.py`` numpy paths
(``processing/Octave/godual_ranging.m:63-66``,
``experiments/231001_DLL_PLL/rxcomplex.cpp:416-433``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["upsample_zoh", "chips_to_pm1", "lowpass_spectrum_mask"]


def upsample_zoh(code: np.ndarray, factor: int) -> np.ndarray:
    """Zero-order-hold upsampling: repeat each chip ``factor`` times
    (Octave ``repelems``, ``godual_ranging.m:63-64``)."""
    return np.repeat(code, factor)


def chips_to_pm1(chips: np.ndarray, dtype=np.float64) -> np.ndarray:
    """Map 0/1 chips to -1/+1 (``godual_ranging.m:65``)."""
    return chips.astype(dtype) * 2 - 1


def lowpass_spectrum_mask(n: int, df_hz: float, fmax: float, fmin: float):
    """Brick-wall mask on a natural-order length-``n`` spectrum: bin k is
    ``k*df_hz`` below n/2 and ``(k-n)*df_hz`` above; bins outside
    (fmin, fmax) are zeroed (``rxcomplex.cpp:416-433``)."""
    k = np.arange(n)
    freq = np.where(k < n / 2, k, k - n) * df_hz
    return ((freq > fmin) & (freq < fmax)).astype(np.float64)
