"""Frequency-offset (Doppler + LO offset) estimation (torch).

The port's counterpart of the JAX package's ``ops/doppler.py`` for the
ranging chains.  A BPSK signal squared loses its modulation and shows a
spectral line at twice the frequency offset:

- per epoch: ``d2=fftshift(abs(fft(d.^2))); [~,df]=max(d2(k));
  df=freq(df)/2`` (``processing/Octave/godual_ranging.m:14-15``),
- per file: one decimated pre-pass fixing df for the whole record
  (``processing/CPP/main.cpp:363-450``),
- fine: a line fitted to the phase drift of the mixed signal
  (``godual_ranging_fftw.py:35-39``; redesigned, PARITY.md).

The masked argmax runs over the spectrum in natural bin order with the
mask rolled the other way, and the index is remapped to the shifted axis
(``doppler.py:128-137``); ``df`` is read off the reference's inclusive
linspace axis in the spectrum's real dtype, before the ``/2``
(``doppler.py:160,196``).  The claudio search and refresh estimators are
not ported yet.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from amaranth_twstft_tpu_torch.ops.fftutils import fftfreq_shifted

__all__ = [
    "PREPASS_MAX_SAMPLES",
    "bound_prepass_window",
    "window_mask",
    "squaring_spectrum",
    "squaring_df",
    "per_file_df",
    "per_file_df_ri",
    "fine_df_phase_drift",
]

#: Largest decimated-sample count the df pre-pass consumes
#: (:func:`bound_prepass_window` truncates to a power of two <= this);
#: ingest readers use it to read only the needed capture prefix.
PREPASS_MAX_SAMPLES = 1 << 21


def bound_prepass_window(
    x: np.ndarray, min_keep: int = 1 << 18, max_pow2: int = 21
) -> np.ndarray:
    """Cap the df pre-pass input at a power-of-two window: streams longer
    than ``min_keep`` decimated samples are truncated to the largest power
    of two <= min(len, 2**max_pow2) (PARITY.md deviation 6)."""
    n = x.shape[-1]
    if n <= min_keep:
        return x
    k = min(int(np.floor(np.log2(n))), max_pow2)
    return x[..., : 1 << k]


def window_mask(n: int, fs: float, lo_hz: float, hi_hz: float) -> np.ndarray:
    """Boolean mask over the SHIFTED squaring spectrum selecting the
    search window, given on the doubled-frequency axis
    (``godual_ranging.m:83-90``: +/-20 kHz selects |df| < 10 kHz)."""
    freq = fftfreq_shifted(n, fs)
    return (freq > lo_hz) & (freq < hi_hz)


def _squaring_spectrum_unshifted(d: torch.Tensor) -> torch.Tensor:
    """``abs(fft(d^2))`` along the last axis, natural bin order."""
    return torch.abs(torch.fft.fft(d * d, dim=-1))


def squaring_spectrum(d: torch.Tensor) -> torch.Tensor:
    """``fftshift(abs(fft(d^2)))`` along the last axis."""
    return torch.fft.fftshift(_squaring_spectrum_unshifted(d), dim=-1)


def _masked_argmax_shifted(sp_unshifted: torch.Tensor, mask_shifted) -> torch.Tensor:
    """argmax over ``fftshift(sp)`` restricted to ``mask_shifted``, without
    shifting the data: roll the mask by half, take the masked argmax in
    natural order (first maximum), remap the index to the shifted axis.
    Masked-out bins hold the dtype's finite minimum."""
    n = sp_unshifted.shape[-1]
    half = n // 2
    mask = torch.as_tensor(mask_shifted, device=sp_unshifted.device)
    mask_un = torch.roll(mask, half)
    neg = torch.finfo(sp_unshifted.dtype).min
    idx_un = torch.argmax(
        torch.where(mask_un, sp_unshifted, torch.full_like(sp_unshifted, neg)),
        dim=-1,
    )
    return torch.remainder(idx_un - half, n)


@functools.lru_cache(maxsize=8)
def _freq_axis_on(n: int, fs: float, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    return torch.as_tensor(fftfreq_shifted(n, fs), dtype=dtype, device=device)


def _freq_axis(n: int, fs: float, like: torch.Tensor) -> torch.Tensor:
    """The inclusive linspace axis in ``like``'s dtype on its device,
    uploaded once per geometry (a per-batch upload from pageable host
    memory would stall the stream)."""
    return _freq_axis_on(n, float(fs), like.dtype, like.device)


def squaring_df(d: torch.Tensor, fs: float, mask):
    """Per-epoch df: argmax of the squaring spectrum inside ``mask``.
    Returns (df_hz, bin_index) with df = ``freq[argmax]/2`` on the
    reference's inclusive linspace (``godual_ranging.m:14-15,73``)."""
    n = d.shape[-1]
    d2 = _squaring_spectrum_unshifted(d)
    idx = _masked_argmax_shifted(d2, mask)
    return _freq_axis(n, fs, d2)[idx] / 2.0, idx


def per_file_df(
    x: torch.Tensor,
    fs: float,
    decim: int,
    foffset_hz: float = 0.0,
    frange_hz: float = 8000.0,
    windowed: bool = True,
) -> torch.Tensor:
    """The C++ chain's fixed per-file df (``processing/CPP/main.cpp:
    363-450``) from the decimated stream ``x`` (every ``decim``-th complex
    sample): mix by ``exp(-2j*pi*foffset*t)``, remove the mean, square,
    FFT, argmax within +/-2*frange on the decimated axis
    (``windowed=False`` searches the whole spectrum, the ``main.cpp:442``
    quirk for channel 2).  Returns df in Hz, in the real dtype of ``x``."""
    m = x.shape[-1]
    real = torch.float64 if x.dtype == torch.complex128 else torch.float32
    t = torch.arange(m, dtype=real, device=x.device)
    ang = -2.0 * math.pi * (foffset_hz * decim / fs) * t
    xm = x * torch.complex(torch.cos(ang), torch.sin(ang)).to(x.dtype)
    xm = xm - torch.mean(xm, dim=-1, keepdim=True)
    d2 = _squaring_spectrum_unshifted(xm)
    freq = fftfreq_shifted(m, fs / decim)
    if windowed:
        # C++ kmin/kmax: a half-open window (``main.cpp:401-406``)
        mask = (freq > -2.0 * frange_hz) & (freq < 2.0 * frange_hz)
    else:
        mask = np.ones(m, dtype=bool)
    idx = _masked_argmax_shifted(d2, mask)
    return torch.as_tensor(freq, dtype=d2.dtype, device=d2.device)[idx] / 2.0 + foffset_hz


def per_file_df_ri(
    x_ri: torch.Tensor,
    fs: float,
    decim: int,
    foffset_hz: float = 0.0,
    frange_hz: float = 8000.0,
    windowed: bool = True,
) -> torch.Tensor:
    """:func:`per_file_df` of a (..., 2) re/im input in a transfer format:
    float16, int16 and int8 are taken in their own units, with no scale —
    the squaring-spectrum argmax is scale-invariant."""
    if x_ri.dtype in (torch.float16, torch.bfloat16, torch.int8, torch.int16):
        x_ri = x_ri.to(torch.float32)
    x = torch.complex(x_ri[..., 0], x_ri[..., 1])
    return per_file_df(x, fs, decim, foffset_hz, frange_hz, windowed)


def fine_df_phase_drift(
    y: torch.Tensor, fs: float, stride: int | None = None,
    boxcar: int | None = None,
) -> torch.Tensor:
    """Fine frequency from the phase drift of the coarsely mixed signal
    (``godual_ranging_fftw.py:35-39``, redesigned as the JAX package does,
    PARITY.md): square (strips BPSK), boxcar-average the complex square
    by a cumulative sum ('valid' support), unwrap increment-wise,
    least-squares slope -> ``df = slope / (4*pi)``.  Batched over the
    leading axes."""
    n = min(int(fs // 3), y.shape[-1])
    if boxcar is None:
        boxcar = max(2, min(100, n // 20))
    if stride is None:
        stride = max(1, n // 20000)
    s = y[..., :n]
    s = s * s
    cs = torch.cumsum(s, dim=-1)
    cs = torch.cat([cs.new_zeros(s.shape[:-1] + (1,)), cs], dim=-1)
    sm = (cs[..., boxcar:] - cs[..., :-boxcar]) / boxcar
    sm = sm[..., ::stride]
    dphi = torch.angle(sm[..., 1:] * torch.conj(sm[..., :-1]))
    phi = torch.cumsum(dphi, dim=-1)
    phi = torch.cat([torch.zeros_like(phi[..., :1]), phi], dim=-1)
    t = stride * torch.arange(sm.shape[-1], dtype=phi.dtype, device=y.device) / fs
    dt = t - torch.mean(t)
    pm = torch.mean(phi, dim=-1, keepdim=True)
    slope = torch.sum(dt * (phi - pm), dim=-1) / torch.sum(dt * dt)
    return slope / (4.0 * math.pi)
