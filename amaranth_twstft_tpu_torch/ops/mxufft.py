"""Mixed-radix FFT as dense-DFT matmul stages (torch).

The port's copy of the JAX package's ``ops/mxufft.py``, stage by stage.
There it is the TPU's fast path for the production length 200 000 =
2^6 * 5^5 samples (``flashZedBoard.py:229-231``, ``godual_ranging.m:4-5``),
where XLA's TPU FFT is slow at large radix-5 factors.  On Hopper cuFFT
handles these lengths, so no path of the port calls this module: it is
kept so the algorithm stays available and held against the JAX
package's, and ``chip_smoke.py`` times it beside ``torch.fft.fft``.

Cooley-Tukey with the length factored into pieces <= 128: each stage's
DFT is an (..., n) x (n, n) complex ``torch.matmul`` on the input's
device, in IEEE fp32 (complex64) or fp64 (complex128) — the JAX stages'
``precision="high"`` is a TPU setting with no counterpart here, and TF32
stays off (:func:`amaranth_twstft_tpu_torch.utils.platform.check_no_tf32`).
"""

from __future__ import annotations

import math
from functools import lru_cache

import torch

from amaranth_twstft_tpu_torch.utils.platform import check_no_tf32

__all__ = ["good_factors", "fft_factored", "ifft_factored"]

_MAX_FACTOR = 128


def _prime_factors(n: int) -> list[int]:
    out = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return out


@lru_cache(maxsize=None)
def _best_split(n: int, max_factor: int) -> tuple[int, ...] | None:
    """Factorization of n into parts <= max_factor: fewest parts first,
    then no part below 25 if avoidable, then lexicographically-largest
    descending (the JAX package's order)."""
    if n == 1:
        return ()
    if n <= max_factor:
        return (n,)
    best = None
    for d in range(max_factor, 1, -1):
        if n % d:
            continue
        sub = _best_split(n // d, max_factor)
        if sub is None:
            continue
        cand = tuple(sorted((d,) + sub, reverse=True))
        key = (len(cand), min(cand) < 25, tuple(-c for c in cand))
        if best is None or key < best[0]:
            best = (key, cand)
    return None if best is None else best[1]


@lru_cache(maxsize=None)
def good_factors(n: int, max_factor: int = _MAX_FACTOR) -> tuple[int, ...]:
    """Stage sizes for :func:`fft_factored`: fewest, balanced (largest
    minimum factor), largest stage first."""
    primes = sorted(_prime_factors(n))
    if primes and primes[-1] > max_factor:
        raise ValueError(
            f"N={n} has prime factor {primes[-1]} > {max_factor}; "
            "use torch.fft for this length"
        )
    split = _best_split(n, max_factor)
    assert split is not None
    return split


def _exp_outer(a: int, b: int, n: int, inverse: bool, dtype, device) -> torch.Tensor:
    """``exp(+-2j*pi*outer(arange(a), arange(b))/n)``, built in float64 and
    cast to ``dtype``."""
    k = torch.outer(torch.arange(a, dtype=torch.float64, device=device),
                    torch.arange(b, dtype=torch.float64, device=device))
    ang = (2.0 if inverse else -2.0) * math.pi * k / n
    return torch.polar(torch.ones_like(ang), ang).to(dtype)


@lru_cache(maxsize=64)
def _dft_matrix(n: int, inverse: bool, dtype, device) -> torch.Tensor:
    return _exp_outer(n, n, n, inverse, dtype, device)


@lru_cache(maxsize=64)
def _twiddle(n1: int, n2: int, inverse: bool, dtype, device) -> torch.Tensor:
    """W_{n1*n2}^{k1*n2'} of the Cooley-Tukey split, shape (n1, n2)."""
    return _exp_outer(n1, n2, n1 * n2, inverse, dtype, device)


def _ct(x: torch.Tensor, factors: tuple[int, ...], inverse: bool) -> torch.Tensor:
    """Recursive Cooley-Tukey over the last axis (no normalization)."""
    n = x.shape[-1]
    f = factors[0]
    m = _dft_matrix(f, inverse, x.dtype, x.device)
    if len(factors) == 1:
        return torch.matmul(x, m)
    n2 = n // f
    xr = x.reshape(x.shape[:-1] + (f, n2))  # [n1, n2], n = n2*n1_ + n2_
    # DFT over n1 (axis -2): A[k1, n2] = sum_a m[a, k1] xr[a, n2]
    a = torch.matmul(m.transpose(0, 1), xr)
    a = a * _twiddle(f, n2, inverse, x.dtype, x.device)
    # remaining transform over n2 (last axis) for each k1
    y = _ct(a, factors[1:], inverse)  # [k1, k2]
    # X[k1 + n1*k2] -> k2-major flatten
    return torch.swapaxes(y, -1, -2).reshape(x.shape[:-1] + (n,))


def fft_factored(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Drop-in ``torch.fft.fft`` (last axis) for lengths whose prime
    factors are <= 128, including the 1/N inverse normalization; complex64
    in and out unless ``x`` is complex128."""
    n = x.shape[-1]
    factors = good_factors(n)
    if x.device.type == "cuda":
        check_no_tf32()
    dtype = torch.complex128 if x.dtype == torch.complex128 else torch.complex64
    y = _ct(x.to(dtype), factors, inverse)
    if inverse:
        y = y / n
    return y


def ifft_factored(x: torch.Tensor) -> torch.Tensor:
    return fft_factored(x, inverse=True)
