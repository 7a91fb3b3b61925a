"""Code-replica construction helpers (NumPy): ZOH resampling, +/-1
mapping, the ranging replica spectrum and the DLL/PLL brick-wall
low-pass mask.

The port's copy of the JAX package's ``ops/prn.py`` numpy paths
(``processing/Octave/godual_ranging.m:63-66``,
``experiments/231001_DLL_PLL/rxcomplex.cpp:416-433``).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "upsample_zoh",
    "chips_to_pm1",
    "hamming",
    "code_spectrum",
    "interp_code",
    "lowpass_spectrum_mask",
]


def upsample_zoh(code: np.ndarray, factor: int) -> np.ndarray:
    """Zero-order-hold upsampling: repeat each chip ``factor`` times
    (Octave ``repelems``, ``godual_ranging.m:63-64``)."""
    return np.repeat(code, factor)


def chips_to_pm1(chips: np.ndarray, dtype=np.float64) -> np.ndarray:
    """Map 0/1 chips to -1/+1 (``godual_ranging.m:65``)."""
    return chips.astype(dtype) * 2 - 1


def hamming(n: int, dtype=np.float64) -> np.ndarray:
    """Symmetric Hamming window 0.54 - 0.46 cos(2 pi k/(n-1)), the
    armadillo/Octave definition of ``processing/CPP/main.cpp:717``."""
    k = np.arange(n, dtype=dtype)
    return 0.54 - 0.46 * np.cos(2 * np.pi * k / (n - 1))


def code_spectrum(code_pm1, conj: bool = True, hamming_window: bool = False):
    """FFT of the +/-1 sampled replica, optionally conjugated (the
    godual/C++ convention, ``godual_ranging.m:66``) and multiplied, in
    natural bin order, by a symmetric Hamming window as the C++ chain
    does (``main.cpp:717-719``; the quirk weights the band edges up and
    DC down, and is kept for parity with the C producer)."""
    f = np.fft.fft(np.asarray(code_pm1).astype(np.float64))
    if conj:
        f = np.conj(f)
    if hamming_window:
        f = f * hamming(len(f))
    return f


def interp_code(code_pm1, interp_factor: int):
    """Replica on the interpolated correlation grid
    (``godual_ranging.m:42``), for the SNR estimate."""
    return upsample_zoh(code_pm1, interp_factor)


def lowpass_spectrum_mask(n: int, df_hz: float, fmax: float, fmin: float):
    """Brick-wall mask on a natural-order length-``n`` spectrum: bin k is
    ``k*df_hz`` below n/2 and ``(k-n)*df_hz`` above; bins outside
    (fmin, fmax) are zeroed (``rxcomplex.cpp:416-433``)."""
    k = np.arange(n)
    freq = np.where(k < n / 2, k, k - n) * df_hz
    return ((freq > fmin) & (freq < fmax)).astype(np.float64)
