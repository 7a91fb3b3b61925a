"""FFT-domain helpers (torch): zero-pad spectral interpolation, the
reference's frequency axis and precise local-oscillator phasors.

The port's counterpart of the JAX package's ``ops/fftutils.py``.  The
reference interpolates every correlation peak by zero-padding the middle
of the product spectrum before the inverse FFT (``godual_ranging.m:26-28``,
``processing/CPP/main.cpp:289-304``) and does not rescale after padding;
:func:`spectral_zoom` keeps that.  In complex64 the LO phase
``frac(k*c)`` is formed by the same exact 2048-split float32 arithmetic
(``fftutils.py:72-97``), so the port's phasor matches the JAX one to the
last few ulps of cos/sin.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["spectral_zoom", "spectral_zoom_signal", "fftfreq_shifted", "mix_phasor"]


def spectral_zoom(spectrum: torch.Tensor, nint: int) -> torch.Tensor:
    """Zero-pad a natural-order spectrum from L to (2*nint+1)*L along the
    last axis: bins [0, L/2) stay at the start, [L/2, L) move to the end
    (``main.cpp:289-294``; for even L the Nyquist bin is negative)."""
    L = spectrum.shape[-1]
    half = L // 2
    zeros = spectrum.new_zeros(spectrum.shape[:-1] + (2 * nint * L,))
    return torch.cat([spectrum[..., :half], zeros, spectrum[..., half:]], dim=-1)


def spectral_zoom_signal(ffty: torch.Tensor, nint: int) -> torch.Tensor:
    """Interpolated time signal ``ifft(spectral_zoom(ffty))``
    (``godual_ranging.m:38-41``, ``main.cpp:319-327``)."""
    return torch.fft.ifft(spectral_zoom(ffty, nint), dim=-1)


def fftfreq_shifted(n: int, fs: float) -> np.ndarray:
    """The reference's frequency axis ``linspace(-fs/2, fs/2, n)``: an
    INCLUSIVE linspace with step fs/(n-1), not ``fftshift(fftfreq)``
    (``godual_ranging.m:73``, ``main.cpp:399``); the df estimate is read
    off it."""
    return np.linspace(-fs / 2, fs / 2, n)


def _mix_phasor_f32(n: int, cycles_per_sample: torch.Tensor) -> torch.Tensor:
    """``exp(-2j*pi*frac(k*c))`` for k < n with k = q*2048 + r, reducing
    q*frac(2048*c) and r*c modulo 1 separately (~1e-4 cycles over 1e6
    samples instead of ~0.03 for the naive float32 product)."""
    c = cycles_per_sample.to(torch.float32)[..., None]
    c = c - torch.floor(c)
    c2048 = 2048.0 * c
    c2048 = c2048 - torch.floor(c2048)
    k = torch.arange(n, dtype=torch.int32, device=c.device)
    q = torch.div(k, 2048, rounding_mode="floor").to(torch.float32)
    r = torch.remainder(k, 2048).to(torch.float32)
    ph = q * c2048
    ph = ph - torch.floor(ph)
    ph2 = r * c
    ph2 = ph2 - torch.floor(ph2)
    phase = ph + ph2
    phase = phase - torch.floor(phase)
    ang = (-2.0 * math.pi) * phase
    return torch.complex(torch.cos(ang), torch.sin(ang))


def mix_phasor(
    n: int, df_hz: torch.Tensor, fs: float, dtype=torch.complex64
) -> torch.Tensor:
    """Local-oscillator phasor ``exp(-2j*pi*df*k/fs)``, k = 0..n-1, with
    shape ``df.shape + (n,)``; complex64 uses the modular split."""
    df_hz = torch.as_tensor(df_hz)
    if dtype == torch.complex128:
        k = torch.arange(n, dtype=torch.float64, device=df_hz.device)
        c = (df_hz.to(torch.float64) / fs)[..., None]
        ang = -2.0 * math.pi * c * k
        return torch.complex(torch.cos(ang), torch.sin(ang))
    return _mix_phasor_f32(n, df_hz / fs)
