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
(``doppler.py:160,196``).

The claudio chain's estimators (``claudio_...separate.m:27-47,168-169``):
:func:`search_df_candidates` validates spectral-line candidates above
20x the median by a trial correlation, and :func:`refresh_df` re-takes
the argmax within +/-3 bins of the locked line every block.  Two points
where torch differs from JAX are handled explicitly: the median averages
the two middle values (``torch.nanquantile(..., 0.5)``, as
``jnp.nanmedian`` does; ``torch.nanmedian`` would take the lower one;
a sort above ``nanquantile``'s 2^24-element limit),
and the refresh window's start is clipped by hand, as
``lax.dynamic_slice`` clamps it.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from amaranth_twstft_tpu_torch.ops.correlator import quick_xcorr_snr
from amaranth_twstft_tpu_torch.ops.fftutils import fftfreq_shifted

__all__ = [
    "PREPASS_MAX_SAMPLES",
    "bound_prepass_window",
    "window_mask",
    "squaring_spectrum",
    "squaring_df",
    "per_file_df",
    "per_file_df_ri",
    "search_df_candidates",
    "search_df_candidates_ri",
    "refresh_df",
    "refresh_df_ri",
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


def _ri_complex(x_ri: torch.Tensor) -> torch.Tensor:
    """(..., 2) re/im in a transfer format -> complex64: float16, int16
    and int8 are taken in their own units, with no scale."""
    if x_ri.dtype in (torch.float16, torch.bfloat16, torch.int8, torch.int16):
        x_ri = x_ri.to(torch.float32)
    return torch.complex(x_ri[..., 0], x_ri[..., 1])


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
    return per_file_df(_ri_complex(x_ri), fs, decim, foffset_hz, frange_hz,
                       windowed)


#: ``torch.quantile``/``nanquantile`` refuse inputs above this many
#: elements; a claudio block at 5 MS/s (10^7 bins) is below it, one at
#: more than 8.39 MS/s is not, and takes the median by a sort instead.
QUANTILE_MAX_ELEMENTS = 1 << 24


def _nan_median(d2: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of ``d2`` where ``mask``, averaging the two middle values as
    ``jnp.nanmedian`` does (NaN when nothing is masked in).  Up to
    ``QUANTILE_MAX_ELEMENTS`` bins it is ``torch.nanquantile(..., 0.5)``;
    above, the masked values are sorted and the two middle ones mixed
    with ``torch.lerp(lo, hi, 0.5)``, the step ``nanquantile`` takes."""
    nan = torch.full((), float("nan"), dtype=d2.dtype, device=d2.device)
    if d2.shape[-1] <= QUANTILE_MAX_ELEMENTS:
        return torch.nanquantile(torch.where(mask, d2, nan), 0.5)
    v = torch.sort(d2[mask]).values
    m = v.shape[0]
    if m == 0:
        return nan
    return torch.lerp(v[(m - 1) // 2], v[m // 2], 0.5)


def _search_df(d, dcode, fcode, mask, fs, threshold, snr_threshold,
               max_candidates, notch_halfwidth, freq_dtype):
    """``(best, n_above)`` as 0-d tensors (``doppler.py:203-234``)."""
    n = d.shape[-1]
    d2 = squaring_spectrum(d)
    mask = torch.as_tensor(mask, device=d2.device)
    zero = torch.zeros((), dtype=d2.dtype, device=d2.device)
    masked = torch.where(mask, d2, zero)
    med = _nan_median(d2, mask)
    above = masked > med * threshold
    # the top ``max_candidates`` bins among those above threshold; the
    # reference keeps the last passing candidate in ascending-bin order
    # (``claudio_...separate.m:33-44``), so only the passing ones decide
    neg = torch.full((), torch.finfo(d2.dtype).min, dtype=d2.dtype,
                     device=d2.device)
    score = torch.where(above, d2, neg)
    cand_idx = torch.topk(score, max_candidates).indices
    cand_valid = above[cand_idx]
    cand_df = _freq_axis_on(n, float(fs), freq_dtype, d2.device)[cand_idx] / 2.0
    snrs = quick_xcorr_snr(dcode[None, :], fcode, cand_df, fs,
                           notch_halfwidth=notch_halfwidth)
    passing = cand_valid & (snrs > snr_threshold)
    best = torch.max(torch.where(passing, cand_idx, torch.full_like(cand_idx, -1)))
    return best, torch.sum(above)


def search_df_candidates(
    d: torch.Tensor,
    dcode: torch.Tensor,
    fcode: torch.Tensor,
    fs: float,
    mask,
    threshold: float = 20.0,
    snr_threshold: float = 100.0,
    max_candidates: int = 32,
) -> tuple[int, int]:
    """claudio ``search_df`` (``claudio_...separate.m:27-47``).

    ``d`` is a whole block (squaring FFT input), ``dcode`` its first code
    period (trial-correlation input).  Returns ``(kbon, n_above)``:
    ``kbon`` is the shifted-spectrum bin of the validated spectral line,
    or -1 if none validated; ``n_above`` counts the bins over threshold.
    The candidates' df is read off the float64 frequency axis, as the JAX
    package's is under x64 (``doppler.py:257``)."""
    best, n_above = _search_df(
        d, dcode, fcode.to(d.dtype), mask, fs, threshold, snr_threshold,
        max_candidates, 5, torch.float64,
    )
    return int(best), int(n_above)


def search_df_candidates_ri(
    d_ri: torch.Tensor,
    dcode_ri: torch.Tensor,
    fcode_ri: torch.Tensor,
    fs: float,
    mask,
    threshold: float = 20.0,
    snr_threshold: float = 100.0,
    max_candidates: int = 32,
    notch_halfwidth: int = 5,
):
    """:func:`search_df_candidates` of (..., 2) re/im inputs, returning
    ``(best, n_above)`` as 0-d tensors on the inputs' device.  ``d_ri``
    may be int8, int16 or float16 with no scale: the line threshold (x the
    median) and the trial-correlation SNR are ratios, so a global scale,
    even one different from ``dcode_ri``'s, cancels.  The frequency axis
    is float32 (``doppler.py:412``)."""
    return _search_df(
        _ri_complex(d_ri), _ri_complex(dcode_ri), _ri_complex(fcode_ri), mask,
        fs, threshold, snr_threshold, max_candidates, notch_halfwidth,
        torch.float32,
    )


def refresh_df(d: torch.Tensor, fs: float, kbon: int, halfwidth: int = 3):
    """Per-block df refresh: argmax of the squaring spectrum within
    ``kbon +/- halfwidth`` (``claudio_...separate.m:168-169``).  Returns
    ``(df, idx)`` as 0-d tensors.  The window's start is clipped into the
    spectrum and the absolute index rebuilt from the clipped start, as the
    JAX package mirrors ``dynamic_slice``'s clamp (``doppler.py:278-284``).
    Only the window's bins are gathered from the unshifted spectrum."""
    n = d.shape[-1]
    w = 2 * halfwidth + 1
    if n < w:
        raise ValueError(f"refresh_df: {n} bins < the {w}-bin window")
    start = min(max(int(kbon) - halfwidth, 0), n - w)
    sp = _squaring_spectrum_unshifted(d)
    # shifted bin j is unshifted bin (j - n//2) mod n
    pos = torch.remainder(
        torch.arange(start, start + w, device=sp.device) - n // 2, n)
    idx = start + torch.argmax(sp[..., pos], dim=-1)
    return _freq_axis(n, fs, sp)[idx] / 2.0, idx


def refresh_df_ri(x_ri: torch.Tensor, fs: float, kbon: int, halfwidth: int = 3):
    """:func:`refresh_df` of a (..., 2) re/im input; int8, int16 and
    float16 are taken scale-free (the argmax is scale-invariant)."""
    return refresh_df(_ri_complex(x_ri), fs, kbon, halfwidth)


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
