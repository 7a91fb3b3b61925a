"""Peak refinement and robust statistics (torch).

Behavioral specs (as the JAX package's ``ops/peaks.py``):

- 3-point parabolic correction ``(|x-1|-|x+1|) / (|x-1|+|x+1|-2|x0|) / 2``
  (``processing/Octave/godual_ranging.m:29-33``,
  ``processing/CPP/main.cpp:305-310``),
- High-Resolution-Correlator two-parabola discriminator
  (``experiments/231001_DLL_PLL/rxcomplex.cpp:649-659``),
- median / IQR 3-sigma outlier rejection (``rxcomplex.cpp:699-700``;
  sigma = IQR/1.349),
- the weighted linear fit replacing ``gsl_fit_wlinear``
  (``rxcomplex.cpp:728-744``).

Median trap: ``torch.median``/``torch.nanmedian`` return the LOWER middle
value, while ``jnp.median``/``jnp.nanmedian`` average the two middles —
and the bank's code count (24) is even.  The linear ``torch.quantile``/
``torch.nanquantile`` at 0.5 matches the JAX definition.
"""

from __future__ import annotations

import torch

__all__ = [
    "take_circular",
    "peak_neighbors",
    "parabolic_correction",
    "hrc_correction",
    "median_iqr_sigma",
    "weighted_linear_fit",
]


def take_circular(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather along the last axis with circular (mod-N) indexing."""
    idx = torch.remainder(idx, x.shape[-1]).to(torch.int64)
    return torch.gather(x, -1, idx.unsqueeze(-1)).squeeze(-1)


def peak_neighbors(prnmap: torch.Tensor, indice: torch.Tensor):
    """(x[-1], x[0], x[+1]) around the peak, circularly
    (``godual_ranging.m:31-32``; claudio wraps explicitly)."""
    return (
        take_circular(prnmap, indice - 1),
        take_circular(prnmap, indice),
        take_circular(prnmap, indice + 1),
    )


def parabolic_correction(am1, a0, ap1):
    """Sub-sample offset of a peak from 3 magnitudes,
    ``(am1 - ap1) / (am1 + ap1 - 2*a0) / 2`` (``godual_ranging.m:33``);
    0 where the denominator is 0 (a flat triple), which the reference
    does not guard."""
    den = am1 + ap1 - 2.0 * a0
    num = am1 - ap1
    safe = torch.where(den == 0, torch.ones_like(den), den)
    return torch.where(den == 0, torch.zeros_like(den), num / safe / 2.0)


def _ratio(a, b, c):
    den = a - 2.0 * b + c
    safe = torch.where(den == 0, torch.ones_like(den), den)
    return torch.where(den == 0, torch.zeros_like(den), (a - c) / safe)


def hrc_correction(corr: torch.Tensor, pk_idx: torch.Tensor) -> torch.Tensor:
    """``(c[-1]-c[+1])/(c[-1]-2c[0]+c[+1]) - (c[-2]-c[+2])/(c[-2]-2c[0]+c[+2])``
    on the power lag bank ``corr`` (..., n_lags) at the integer peak."""
    cm2 = take_circular(corr, pk_idx - 2)
    cm1 = take_circular(corr, pk_idx - 1)
    c0 = take_circular(corr, pk_idx)
    cp1 = take_circular(corr, pk_idx + 1)
    cp2 = take_circular(corr, pk_idx + 2)
    return _ratio(cm1, c0, cp1) - _ratio(cm2, c0, cp2)


def median_iqr_sigma(x: torch.Tensor, w: torch.Tensor | None = None):
    """(median, IQR/1.349) along the last axis; ``w`` masks invalid
    entries (weight 0), which become NaN for the nan-aware quantiles.
    The callers reduce over a second's codes or a session's points, far
    below the 2^24 elements ``torch.quantile`` takes."""
    if w is not None:
        x = torch.where(w > 0, x, torch.full_like(x, float("nan")))
        q = torch.nanquantile
    else:
        q = torch.quantile
    med = q(x, 0.5, dim=-1)
    q3 = q(x, 0.75, dim=-1)
    q1 = q(x, 0.25, dim=-1)
    return med, (q3 - q1) / 1.349


def weighted_linear_fit(t: torch.Tensor, y: torch.Tensor, w: torch.Tensor):
    """Weighted least-squares line y ~ c0 + c1*t along the last axis ->
    (c0, c1, chi2); all-zero-weight rows return zeros."""
    sw = torch.sum(w, dim=-1)
    zero = torch.zeros_like(sw)
    safe_sw = torch.where(sw == 0, torch.ones_like(sw), sw)
    mt = torch.sum(w * t, dim=-1) / safe_sw
    my = torch.sum(w * y, dim=-1) / safe_sw
    dt = t - mt[..., None]
    dy = y - my[..., None]
    stt = torch.sum(w * dt * dt, dim=-1)
    safe_stt = torch.where(stt == 0, torch.ones_like(stt), stt)
    c1 = torch.sum(w * dt * dy, dim=-1) / safe_stt
    c1 = torch.where(stt == 0, zero, c1)
    c0 = my - c1 * mt
    resid = dy - c1[..., None] * dt
    chi2 = torch.sum(w * resid * resid, dim=-1)
    ok = sw > 0
    return (
        torch.where(ok, c0, zero),
        torch.where(ok, c1, zero),
        torch.where(ok, chi2, zero),
    )
