"""Sparse evaluation of the zero-padded (zoomed) inverse DFT (torch).

The port's counterpart of the JAX package's ``ops/zoomdft.py``.  The
reference interpolates correlations 3x by zero-padding the product
spectrum and running a full (2*nint+1)*L-point inverse FFT
(``godual_ranging.m:27``, ``processing/CPP/main.cpp:289-304``), then reads
back a handful of samples.  Here those samples are evaluated directly:

- :func:`zoom_point` — one output sample per epoch, an O(L) reduction
  (the SNR mean);
- :func:`fine_window` — W samples around the coarse correlation peak, a
  per-epoch L-periodic twiddle followed by one (B, L) x (L, W) complex
  ``torch.matmul`` in IEEE fp32 (TF32 off, PARITY deviation 12).

Phase indices are exact integers modulo M (int64 here; the JAX package
splits int32 products by 2048), and each angle is the float index times
the constant ``2*pi/M`` rounded to the real dtype — the same rounding as
``zoomdft.py:98-99,145-146``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from amaranth_twstft_tpu_torch.utils.platform import check_no_tf32

__all__ = [
    "zoom_positions",
    "zoom_gather",
    "zoom_point",
    "fine_window_matrix",
    "fine_window",
]


def _real_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.complex128 else torch.float32


def _twiddle(ph: torch.Tensor, m: int, real_dtype: torch.dtype) -> torch.Tensor:
    """exp(2j*pi*ph/m) with the angle ``float(ph) * float(2*pi/m)``."""
    # the Python float is rounded to the real dtype, as in the JAX package
    ang = ph.to(real_dtype) * (2.0 * math.pi / m)
    return torch.complex(torch.cos(ang), torch.sin(ang))


def zoom_positions(L: int, nint: int) -> np.ndarray:
    """Index in the length-M zero-padded spectrum of each of the L input
    bins: bins [0, L/2) keep their place, bins [L/2, L) move to the end
    (``main.cpp:289-294``, :func:`ops.fftutils.spectral_zoom`)."""
    k = np.arange(L)
    return np.where(k < L // 2, k, k + 2 * nint * L).astype(np.int64)


def zoom_gather(full: np.ndarray, L: int, nint: int) -> np.ndarray:
    """Sample a length-M spectrum at the zoom positions (host precompute,
    e.g. the interpolated-code spectrum of the SNR identity)."""
    return np.asarray(full)[zoom_positions(L, nint)]


def zoom_point(
    ffty: torch.Tensor, g: torch.Tensor, s: torch.Tensor, nint: int
) -> torch.Tensor:
    """``ifft(spectral_zoom(ffty) * G)[s]`` evaluated directly.

    ``ffty`` (..., L) complex, ``g`` (L,) the other factor already gathered
    at the zoom positions (:func:`zoom_gather`), ``s`` (...,) int output
    index in [0, M).  Returns ``zc[s]`` with the 1/M ifft scale — the
    sample the reference reads for the SNR mean (``godual_ranging.m:
    43-45``, ``main.cpp:332-336``)."""
    L = ffty.shape[-1]
    M = (2 * nint + 1) * L
    k = torch.arange(L, device=ffty.device)
    pos = torch.where(k < L // 2, k, k + 2 * nint * L)  # zoom_positions
    ph = torch.remainder(pos * torch.remainder(s.long(), M)[..., None], M)
    tw = _twiddle(ph, M, _real_dtype(ffty))
    return torch.sum(ffty * g * tw, dim=-1) / M


def fine_window_matrix(L: int, nint: int, width: int) -> np.ndarray:
    """Static (L, width) complex128 matrix E[k, w] =
    exp(2j*pi*f_k*(w - width//2)/M), f_k the signed frequency of bin k;
    cast to the compute dtype once, at bind time."""
    M = (2 * nint + 1) * L
    k = np.arange(L)
    f = np.where(k < L // 2, k, k - L).astype(np.float64)
    w = np.arange(width, dtype=np.float64) - width // 2
    return np.exp(2j * np.pi * np.outer(f, w) / M)


def fine_window(
    prod: torch.Tensor,
    center_coarse: torch.Tensor,
    ematrix: torch.Tensor,
    nint: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Zoomed-IFFT samples at fine indices ``(2*nint+1)*ci + w - W//2``.

    ``prod`` (..., L) product spectrum before zero-padding, ``center_coarse``
    (...,) int coarse index ci, ``ematrix`` (L, W) complex
    :func:`fine_window_matrix` in the dtype of ``prod``.  Returns
    ``(values, base)``: values (..., W) equal to the full zoomed IFFT at
    ``base + w`` with ``base = (2*nint+1)*ci - W//2 (mod M)``.  Since the
    zoom position of bin k is k (mod L), exp(2j*pi*pos_k*m/M) factors
    into an L-periodic twiddle exp(2j*pi*k*ci/L) and the static matrix.
    """
    L = prod.shape[-1]
    R = 2 * nint + 1
    M = R * L
    W = ematrix.shape[1]
    if prod.is_cuda:
        check_no_tf32()
    k = torch.arange(L, device=prod.device)
    ph = torch.remainder(k * torch.remainder(center_coarse.long(), L)[..., None], L)
    z = prod * _twiddle(ph, L, _real_dtype(prod))
    out = torch.matmul(z, ematrix)
    base = torch.remainder(R * center_coarse.long() - W // 2, M)
    return out / M, base
