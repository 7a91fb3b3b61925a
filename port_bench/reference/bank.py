"""Plain reference of one tracked second of the DLL/PLL receiver, in
float64 PyTorch on any device, written again without the port from
``experiments/231001_DLL_PLL/rxcomplex.cpp`` as the port documents it:

- the replica: the +/-1 code held ``sps`` samples a chip, brick-wall
  low-passed to +-``filter_hz`` in the frequency domain (:416-433), and
  its mean power ``psbb`` (:437-438);
- per channel, from its state (code head ``pt``, carrier ``fc``, last
  phase): ``bps - 1`` code periods from ``pt``, mixed down by
  ``exp(-j2pi(fc/fs n + frac(pt fc/fs)))`` (:592-600), correlated with
  the replica at lags -nlag..nlag (:605); per code the best lag, the
  HRC discriminator (:649-659), the peak/median quality gate, the
  median/IQR 3-sigma gate (:699-700; each code's distance to it, in ns,
  is kept), the BPSK half-cycle phase unwrap
  (:702-720) and the two weighted fits (:728-744);
- the second's report (``fc_hz``, ``phi_cycles``, ``cnt``, ``gd_ns``,
  ``pk_dbm``, ``pnoise_dbm``) and the state it leaves: the carrier's
  whole hertz added, the next code head, the last phase.

The receiver's state is the program's own (its acquisition, then every
second's update), so the reference follows the program second by
second from the state each second starts from; the checks hold the
acquisition and each update to their own references.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["replicas", "track"]

TWO_PI = 2.0 * math.pi


def replicas(chips: np.ndarray, sps: int, fs: float, filter_hz: float, dev):
    """(C, nobs) float64 filtered replicas and their (C,) mean powers."""
    code = torch.from_numpy(np.repeat(chips.astype(np.float64) * 2 - 1, sps, axis=-1)).to(dev)
    nobs = code.shape[-1]
    k = torch.arange(nobs, device=dev, dtype=torch.float64)
    freq = torch.where(k < nobs / 2, k, k - nobs) * (fs / nobs)
    mask = (freq > -filter_hz) & (freq < filter_hz)
    wav = torch.fft.ifft(torch.fft.fft(code, dim=-1) * mask, dim=-1).real
    return wav, torch.mean(wav * wav, dim=-1)


def _take(x, idx):
    return torch.gather(x, -1, torch.remainder(idx, x.shape[-1]).unsqueeze(-1)).squeeze(-1)


def _ratio(a, b, c):
    den = a - 2.0 * b + c
    return torch.where(den == 0, 0.0, (a - c) / torch.where(den == 0, 1.0, den))


def _fit(t, y, w):
    sw = w.sum(-1)
    safe = torch.where(sw == 0, 1.0, sw)
    mt = (w * t).sum(-1) / safe
    my = (w * y).sum(-1) / safe
    dt, dy = t - mt[:, None], y - my[:, None]
    stt = (w * dt * dt).sum(-1)
    c1 = torch.where(stt == 0, 0.0, (w * dt * dy).sum(-1) / torch.where(stt == 0, 1.0, stt))
    c0 = my - c1 * mt
    chi2 = (w * (dy - c1[:, None] * dt) ** 2).sum(-1)
    ok = sw > 0
    return (torch.where(ok, c0, 0.0), torch.where(ok, c1, 0.0), torch.where(ok, chi2, 0.0))


def _dbm(v2):
    return 10.0 * torch.log10(torch.clamp(v2, min=1e-30) / 50.0 * 1000.0)


def track(x: torch.Tensor, rows: list[int], wav: torch.Tensor, psbb: torch.Tensor,
          pt: np.ndarray, fc: np.ndarray, last_phi: np.ndarray, *,
          fs: float, bps: int, nlag: int) -> dict:
    """One second for a chunk of channels.

    ``x`` (n_inputs, >= fs + nobs) complex128 samples of the second (the
    raw int16 values), ``rows`` each channel's input row, ``wav``/``psbb``
    its replica; ``pt``, ``fc``, ``last_phi`` its state at the second's
    start.  Returns float64 host arrays: the report's fields, ``locked``,
    the next state (``pt_next``, ``fc_next``, ``last_phi_next``) and
    ``gate_ns`` (C, codes): each code's ``|gd - median| - 3 sigma``, which
    the gate passes below 0, NaN where an earlier gate dropped the code."""
    dev = x.device
    C, nobs = wav.shape
    ncodes = bps - 1
    nl = 2 * nlag + 1
    span = ncodes * nobs
    seg = torch.stack([x[r, int(p):int(p) + span] for r, p in zip(rows, pt)])
    fc_t = torch.as_tensor(fc, dtype=torch.float64, device=dev)
    pt_t = torch.as_tensor(pt, dtype=torch.float64, device=dev)
    n = torch.arange(span, dtype=torch.float64, device=dev)
    r = fc_t[:, None] / fs
    phase = torch.remainder(r * n[None, :], 1.0) + torch.remainder(pt_t * fc_t / fs, 1.0)[:, None]
    obs = (seg * torch.exp(-1j * TWO_PI * phase)).reshape(C, ncodes, nobs)
    # lag l = 0..2*nlag is the replica rolled by l - nlag
    lag = torch.arange(nl, device=dev)
    idx = torch.remainder(torch.arange(nobs, device=dev)[:, None] + nlag - lag[None, :], nobs)
    W = wav[:, idx]  # (C, nobs, nl)
    re = torch.bmm(obs.real.contiguous(), W)
    im = torch.bmm(obs.imag.contiguous(), W)
    power = (2.0 / nobs ** 2) * (re * re + im * im)

    pk = torch.argmax(power, dim=-1)
    pkp = _take(power, pk)
    interior = (pk >= 2) & (pk < nl - 2)
    quality = pkp > 10.0 * torch.clamp(torch.quantile(power, 0.5, dim=-1), min=1e-30)
    w = (interior & quality).double()
    c = [_take(power, pk + o) for o in (-2, -1, 0, 1, 2)]
    hrc = _ratio(c[1], c[2], c[3]) - _ratio(c[0], c[2], c[4])
    gd_rel = (pk.double() - nlag + hrc) * (1e9 / fs)
    ps = pkp / psbb[:, None]
    res_phi = torch.atan2(_take(im, pk), _take(re, pk)) / TWO_PI

    g = torch.where(w > 0, gd_rel, torch.nan)
    med = torch.nanquantile(g, 0.5, dim=-1)
    sigma = (torch.nanquantile(g, 0.75, dim=-1) - torch.nanquantile(g, 0.25, dim=-1)) / 1.349
    dist = torch.abs(gd_rel - med[:, None]) - torch.clamp(3.0 * sigma, min=1e-6)[:, None]
    gate_ns = torch.where(w > 0, dist, torch.nan)
    w = w * (dist < 0)
    cnt = w.sum(-1)

    last = torch.as_tensor(last_phi, dtype=torch.float64, device=dev)
    unwrapped = torch.empty_like(res_phi)
    for p in range(ncodes):
        ph = res_phi[:, p]
        folded = ph - 0.5 * torch.round((ph - last) * 2.0)
        keep = w[:, p] > 0
        unwrapped[:, p] = torch.where(keep, folded, ph)
        last = torch.where(keep, folded, last)

    dur = nobs / fs
    p_ax = torch.arange(ncodes, dtype=torch.float64, device=dev) * dur
    c0p, c1p, _ = _fit(p_ax[None, :] + (pt_t / fs)[:, None], unwrapped, w)
    c0g, c1g, chi2 = _fit(p_ax[None, :].expand(C, -1), gd_rel, w)
    pk_mean = (ps * w).sum(-1) / torch.clamp(cnt, min=1.0)
    px = torch.mean(torch.abs(x[:, : int(fs)]) ** 2, dim=-1)[rows]
    gd_abs = c0g + pt_t * 1e9 / fs
    out = {
        "fc_hz": fc_t + c1p,
        "phi_cycles": torch.remainder(c0p + 1000.0, 1.0),
        "cnt": cnt,
        "gd_ns": gd_abs + 0.5 * c1g,
        "pk_dbm": _dbm(pk_mean),
        "pnoise_dbm": _dbm(torch.clamp(px - pk_mean, min=1e-30)),
        "locked": 2 * cnt > bps,
        "pt_next": torch.remainder(torch.round((gd_abs + c1g) * fs / 1e9), nobs),
        "fc_next": fc_t + torch.round(c1p),
        "last_phi_next": last,
        "gate_ns": gate_ns,
    }
    return {k: v.cpu().numpy() for k, v in out.items()}
