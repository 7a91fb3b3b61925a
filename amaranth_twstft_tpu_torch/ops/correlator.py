"""The batched FFT correlator (torch).

The port's counterpart of the JAX package's ``ops/correlator.py``.  One
function reproduces the per-epoch ``processing()`` of the reference chains
(``processing/Octave/godual_ranging.m:12-49``, ``processing/CPP/
main.cpp:224-361``, ``claudio_aligned_code_ranging_separate.m:49-102``):

    mix by exp(-2j*pi*df*t)  ->  FFT  ->  x (conj) code spectrum
    ->  (2*nint+1)x zero-pad IFFT  ->  |.| argmax + parabolic correction
    ->  code-aligned SNR and powers

batched over a leading epoch axis.  The FFTs are ``torch.fft`` calls
(cuFFT on the card), as they are XLA's library FFTs in the JAX package;
the fast path's window product is one IEEE-fp32 ``torch.matmul``.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from amaranth_twstft_tpu_torch.ops.fftutils import mix_phasor, spectral_zoom
from amaranth_twstft_tpu_torch.ops.peaks import (
    parabolic_correction,
    peak_neighbors,
    take_circular,
)
from amaranth_twstft_tpu_torch.ops.zoomdft import (
    fine_window,
    fine_window_matrix,
    zoom_point,
    zoom_positions,
)

__all__ = [
    "EpochResult",
    "correlate_epochs",
    "delay_seconds",
    "quick_xcorr_snr",
    "DEFAULT_FINE_WIDTH",
]

# Fine-interpolation window of the fast path: +/-16 interpolated samples
# around the coarse peak (``correlator.py:48-54``).
DEFAULT_FINE_WIDTH = 32


@dataclass(frozen=True)
class EpochResult:
    """Per-epoch outputs, field for field the reference's saved arrays
    (tensors, or NumPy arrays once fetched to the host).

    ``indice`` is 0-based (the reference's Octave ``indice`` is
    ``indice + 1``); ``xval*`` are the complex peak and its neighbours
    (``main.cpp:312-314``)."""

    indice: torch.Tensor  # int32, 0-based argmax on the interpolated grid
    correction: torch.Tensor  # parabolic sub-sample offset
    xval: torch.Tensor  # complex peak value
    xvalm1: torch.Tensor
    xvalp1: torch.Tensor
    snr_r: torch.Tensor  # mean(Re yincode)^2 / var(yincode)
    snr_i: torch.Tensor
    puissance: torch.Tensor  # var(y), the mixed signal's power
    puissance_code: torch.Tensor  # |mean(yincode)|^2
    puissance_noise: torch.Tensor  # var(yincode)

    @property
    def snr_db(self):
        return 10.0 * np.log10(_host(self.snr_r) + _host(self.snr_i))

    def to_host(self) -> "EpochResult":
        """The same result with every field as a NumPy array."""
        return EpochResult(**{f.name: _host(getattr(self, f.name))
                              for f in fields(self)})


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def delay_seconds(res: EpochResult, fs: float, interp_factor: int):
    """Delay estimate in seconds, ``(indice + correction) / fs /
    (2*nint+1)`` (``godual_ranging.m:96`` with a 0-based indice)."""
    return (res.indice + res.correction) / fs / interp_factor


def correlate_epochs(
    d: torch.Tensor,
    fcode: torch.Tensor,
    df_hz: torch.Tensor,
    code_interp: torch.Tensor,
    fs: float,
    *,
    nint: int = 1,
    conjugate_data: bool = False,
    compute_snr: bool = True,
    remove_mean: bool = True,
    fcode_interp: torch.Tensor | None = None,
    fast: bool = False,
    fine_matrix: torch.Tensor | None = None,
) -> EpochResult:
    """Correlate a batch of epochs against the code spectrum.

    Args:
      d: (..., L) complex64 or complex128 IQ, one code period per row.
      fcode: (L,) replica spectrum (conjugated for godual, plain for
        claudio).
      df_hz: (...,) per-epoch frequency offsets (broadcast ok).
      code_interp: ((2*nint+1)*L,) +/-1 replica on the interpolated grid
        (used for the SNR when ``fcode_interp`` is not given).
      conjugate_data: claudio's ``fcode * conj(ffty)`` instead of godual's
        ``ffty * fcode``.
      fcode_interp: conj FFT of the interpolated code, at full length M
        or already gathered at the zoom positions, (L,).
      fast: interpolate only a ``DEFAULT_FINE_WIDTH`` window around the
        coarse (un-zoomed) correlation peak (:func:`ops.zoomdft.
        fine_window`) instead of the full zero-padded IFFT; identical
        unless two peaks tie within noise.
      fine_matrix: (L, W) complex :func:`ops.zoomdft.fine_window_matrix`
        in the dtype of ``d`` for the fast path (built if omitted).

    Returns an :class:`EpochResult` of shape ``d.shape[:-1]``.
    """
    L = d.shape[-1]
    M = (2 * nint + 1) * L
    dtype = d.dtype
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    if remove_mean:
        d = d - torch.mean(d, dim=-1, keepdim=True)
    y = d * mix_phasor(L, df_hz, fs, dtype=dtype)
    ffty = torch.fft.fft(y, dim=-1)
    fcode = fcode.to(dtype)
    prod = fcode * torch.conj(ffty) if conjugate_data else ffty * fcode

    if fast:
        if fine_matrix is None:
            fine_matrix = torch.as_tensor(
                fine_window_matrix(L, nint, DEFAULT_FINE_WIDTH), device=d.device
            )
        fine_matrix = fine_matrix.to(dtype)
        W = fine_matrix.shape[1]
        # coarse peak on the un-zoomed grid: the zoomed map at multiples
        # of 2*nint+1 is the un-zoomed map scaled
        coarse = torch.fft.ifft(prod, dim=-1)
        ci = torch.argmax(torch.abs(coarse), dim=-1)
        win, base = fine_window(prod, ci, fine_matrix, nint)
        wi = torch.clamp(torch.argmax(torch.abs(win), dim=-1), 1, W - 2)
        indice = torch.remainder(base + wi, M).to(torch.int32)
        xm1 = take_circular(win, wi - 1)
        x0 = take_circular(win, wi)
        xp1 = take_circular(win, wi + 1)
    else:
        prnmap = torch.fft.ifft(spectral_zoom(prod, nint), dim=-1)
        indice = torch.argmax(torch.abs(prnmap), dim=-1).to(torch.int32)
        xm1, x0, xp1 = peak_neighbors(prnmap, indice)
    correction = parabolic_correction(torch.abs(xm1), torch.abs(x0), torch.abs(xp1))

    # puissance = var(y) with ddof=0 (``godual_ranging.m:46``)
    ym = y - torch.mean(y, dim=-1, keepdim=True)
    puissance = torch.mean(torch.abs(ym) ** 2, dim=-1)

    if compute_snr:
        # mean(yint[(n+s) mod M] * code3[n]) = zoom_point(ffty, g, s) / M
        # and mean|yincode|^2 = sum|ffty|^2 / M^2 (``correlator.py:208-
        # 244``); s = indice - 1 (godual) or -(indice + 1) mod M (claudio)
        if fcode_interp is None:
            fcode_interp = torch.conj(torch.fft.fft(code_interp.to(dtype)))
        g = fcode_interp.to(dtype)
        if g.shape[-1] == M:
            g = g[torch.as_tensor(zoom_positions(L, nint), device=g.device)]
        il = indice.long()
        s = torch.remainder(-(il + 1) if conjugate_data else il - 1, M)
        mu = zoom_point(ffty, g, s, nint) / float(M)
        mean_abs2 = torch.sum(torch.abs(ffty) ** 2, dim=-1) / float(M) ** 2
        var = mean_abs2 - torch.abs(mu) ** 2
        safe_var = torch.where(var == 0, torch.ones_like(var), var)
        snr_r = mu.real**2 / safe_var
        snr_i = mu.imag**2 / safe_var
        puis_code = mu.real**2 + mu.imag**2
        puis_noise = var
    else:
        zeros = torch.zeros(indice.shape, dtype=real, device=d.device)
        snr_r = snr_i = puis_code = puis_noise = zeros

    return EpochResult(
        indice=indice,
        correction=correction,
        xval=x0,
        xvalm1=xm1,
        xvalp1=xp1,
        snr_r=snr_r,
        snr_i=snr_i,
        puissance=puissance,
        puissance_code=puis_code,
        puissance_noise=puis_noise,
    )


def quick_xcorr_snr(
    d: torch.Tensor,
    fcode: torch.Tensor,
    df_hz: torch.Tensor,
    fs: float,
    notch_halfwidth: int = 5,
) -> torch.Tensor:
    """``prnmap=abs(ifft(fcode.*conj(ffty))); [pk,b]=max; prnmap(b-5:b+5)=0;
    snr = pk^2/var(prnmap)`` (``claudio_...separate.m:36-43``), batched
    over the leading axes of ``d``/``df_hz``; the variance is taken over
    the entries outside the notch."""
    L = d.shape[-1]
    lo = mix_phasor(L, df_hz, fs, dtype=d.dtype)
    y = d * lo
    ffty = torch.fft.fft(y, dim=-1)
    prnmap = torch.abs(torch.fft.ifft(fcode * torch.conj(ffty), dim=-1))
    pk, pk_idx = torch.max(prnmap, dim=-1)
    k = torch.arange(L, device=d.device)
    dist = torch.abs(
        torch.remainder(k - pk_idx[..., None] + L // 2, L) - L // 2
    )
    keep = dist > notch_halfwidth
    zero = torch.zeros_like(prnmap)
    masked = torch.where(keep, prnmap, zero)
    n_keep = torch.sum(keep, dim=-1)
    mu = torch.sum(masked, dim=-1) / n_keep
    var = torch.sum(
        torch.where(keep, (prnmap - mu[..., None]) ** 2, zero), dim=-1
    ) / n_keep
    return pk**2 / var
