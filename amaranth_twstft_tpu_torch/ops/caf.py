"""Dense cross-ambiguity function (delay x Doppler) search (torch).

The port's counterpart of the JAX package's ``ops/caf.py:45-175``.  The
DLL/PLL receiver acquires by scanning Doppler hierarchically — per
frequency: downconvert, FFT, cross-spectrum, IFFT, peak, halving the step
until < 1 Hz (``experiments/231001_DLL_PLL/rxcomplex.cpp:530-568``).  The
dense form kept here:

- subtract the mean and FFT the data **once**; a Doppler shift of ``k``
  spectrum bins is a circular roll of the data spectrum (exact when the
  hypothesis grid is integer-bin),
- for each chunk of hypotheses: roll by ``-s``, multiply by the code
  spectrum, one batched inverse FFT over the chunk (cuFFT on the card),
  and keep only each hypothesis' peak power and its first argmax,
- refine: the 2-point sinc interpolator across the Doppler axis, then one
  true mixed correlation (:func:`correlate_epochs`) at the refined
  frequency for the sub-sample delay.

No ``pallas_call`` is on this path: the JAX package's version is
XLA-fused, and the port's is torch with cuFFT.  Everything runs in the
dtype of the samples the caller passes (complex64 or complex128).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from amaranth_twstft_tpu_torch.ops.correlator import EpochResult, correlate_epochs

__all__ = ["CafPeaks", "CafResult", "doppler_bins", "caf_peaks", "caf_search",
           "caf_surface"]


@dataclass(frozen=True)
class CafPeaks:
    """Per-(epoch, hypothesis) peak summaries of the CAF."""

    power: torch.Tensor  # (..., H) peak |corr|^2
    index: torch.Tensor  # (..., H) int32 delay index (non-interpolated grid)


def doppler_bins(fs: float, n: int, doppler_min: float, doppler_max: float,
                 step: float) -> tuple[np.ndarray, np.ndarray]:
    """Integer-bin Doppler grid covering [doppler_min, doppler_max].

    Returns (shifts, freqs) as NumPy arrays: int32 spectrum-roll counts and
    their exact float64 frequencies (bin = fs/n).  The requested step is
    rounded to the nearest nonzero bin multiple.
    """
    bin_hz = fs / n
    step_bins = max(1, int(round(step / bin_hz)))
    lo = int(round(doppler_min / bin_hz))
    hi = int(round(doppler_max / bin_hz))
    shifts = np.arange(lo, hi + 1, step_bins, dtype=np.int32)
    return shifts, shifts.astype(np.float64) * bin_hz


def _spectrum(d: torch.Tensor) -> torch.Tensor:
    return torch.fft.fft(d - torch.mean(d, dim=-1, keepdim=True), dim=-1)


def _rolled(D: torch.Tensor, sh: torch.Tensor) -> torch.Tensor:
    """``roll(D, -s)`` for every shift of ``sh``: (..., L) -> (..., S, L),
    ``out[..., j, k] = D[..., (k + sh[j]) mod L]``."""
    L = D.shape[-1]
    k = torch.arange(L, device=D.device)
    idx = torch.remainder(k[None, :] + sh[:, None].to(torch.int64), L)
    return D[..., idx]


def caf_peaks(
    d: torch.Tensor,
    fcode: torch.Tensor,
    shifts,
    chunk: int = 8,
) -> CafPeaks:
    """Peak (power, index) for every Doppler hypothesis.

    ``d``: (..., L) epochs; ``shifts``: (H,) integer spectrum rolls.  Runs
    the hypothesis axis in chunks of ``chunk`` so that only (..., chunk, L)
    correlation maps exist at once; H is padded to a multiple of ``chunk``
    with shift 0 and the padding is sliced off before anything reads it.
    Mixing by ``exp(-2j pi f_shift t)`` equals rolling the data spectrum
    by ``-shift``.
    """
    D = _spectrum(d)
    fcode = fcode.to(D.dtype)
    sh = torch.as_tensor(np.asarray(shifts), device=d.device)
    H = sh.shape[0]
    pad = (-H) % chunk
    sh_p = torch.cat([sh, torch.zeros(pad, dtype=sh.dtype, device=sh.device)])
    pks, idxs = [], []
    for h0 in range(0, H + pad, chunk):
        corr = torch.fft.ifft(_rolled(D, sh_p[h0 : h0 + chunk]) * fcode, dim=-1)
        p = torch.abs(corr) ** 2
        idx = torch.argmax(p, dim=-1)  # the first maximum, as jnp.argmax
        pks.append(torch.gather(p, -1, idx[..., None])[..., 0])
        idxs.append(idx.to(torch.int32))
    return CafPeaks(power=torch.cat(pks, dim=-1)[..., :H],
                    index=torch.cat(idxs, dim=-1)[..., :H])


@dataclass(frozen=True)
class CafResult:
    """Refined CAF estimate per epoch."""

    df_hz: torch.Tensor  # refined Doppler
    df_coarse_hz: torch.Tensor  # best grid hypothesis
    epoch: EpochResult  # full correlator output at the refined df


def caf_search(
    d: torch.Tensor,
    fcode: torch.Tensor,
    code_interp: torch.Tensor,
    fs: float,
    doppler_min: float,
    doppler_max: float,
    step: float,
    *,
    nint: int = 1,
    refine: bool = True,
    chunk: int = 8,
) -> CafResult:
    """Full dense CAF acquisition: grid peaks -> Doppler sinc interpolator
    -> interpolated delay at the refined frequency.  ``d`` (B, L) on the
    device the search runs on; the frequencies are float64."""
    L = d.shape[-1]
    shifts, freqs = doppler_bins(fs, L, doppler_min, doppler_max, step)
    peaks = caf_peaks(d, fcode, shifts, chunk=chunk)
    h_best = torch.argmax(peaks.power, dim=-1)  # (B,)
    bin_hz = fs / L
    step_hz = float(freqs[1] - freqs[0]) if freqs.shape[0] > 1 else bin_hz
    f_best = torch.as_tensor(freqs, device=d.device)[h_best]
    if refine and freqs.shape[0] > 2:
        H = peaks.power.shape[-1]
        hm1 = torch.clamp(h_best - 1, 0, H - 1)
        hp1 = torch.clamp(h_best + 1, 0, H - 1)
        am1 = torch.sqrt(torch.gather(peaks.power, -1, hm1[..., None])[..., 0])
        ap1 = torch.sqrt(torch.gather(peaks.power, -1, hp1[..., None])[..., 0])
        # the correlation-peak amplitude vs Doppler offset follows
        # |sinc(pi * delta * T)| (coherent integration over one code, null
        # spacing one bin): the exact 2-point interpolator is
        # delta = step * (a+ - a-)/(a+ + a-); a 3-point parabola is badly
        # biased near the nulls (``caf.py:135-150``)
        den = ap1 + am1
        safe = torch.where(den == 0, torch.ones_like(den), den)
        delta = torch.where(den == 0, torch.zeros_like(den), (ap1 - am1) / safe)
        interior = (h_best > 0) & (h_best < H - 1)
        df = f_best + torch.where(interior, delta * step_hz, torch.zeros_like(delta))
    else:
        df = f_best
    res = correlate_epochs(
        d, fcode,
        df.to(torch.float32 if d.dtype == torch.complex64 else torch.float64),
        code_interp, fs, nint=nint,
    )
    return CafResult(df_hz=df, df_coarse_hz=f_best, epoch=res)


def caf_surface(d: torch.Tensor, fcode: torch.Tensor, shifts) -> torch.Tensor:
    """Full |CAF| surface (..., H, L) — diagnostics/plots only (large!)."""
    D = _spectrum(d)
    sh = torch.as_tensor(np.asarray(shifts), device=d.device)
    return torch.abs(torch.fft.ifft(_rolled(D, sh) * fcode.to(D.dtype), dim=-1))
