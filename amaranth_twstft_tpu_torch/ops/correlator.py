"""Trial-correlation SNR of the acquisition gate (torch).

The port's counterpart of the JAX package's
``ops/correlator.quick_xcorr_snr`` (``correlator.py:265-296``).  The FFTs
are ``torch.fft`` calls (cuFFT on the card), as they are XLA's library
FFTs in the JAX package.
"""

from __future__ import annotations

import torch

from amaranth_twstft_tpu_torch.ops.fftutils import mix_phasor

__all__ = ["quick_xcorr_snr"]


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
