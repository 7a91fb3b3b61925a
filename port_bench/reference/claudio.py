"""Plain reference of the claudio chain (per-code aligned tracking of one
single-channel file), in float64 PyTorch on any device.

It follows ``acquisition/claudio_aligned_code_ranging_separate.m`` as the
port documents it, written again without the port:

- the hunt from ``skip_seconds`` on, one 2-s block at a time: the squaring
  spectrum's lines above ``df_threshold`` x its median inside the search
  window, the (at most 32) highest of them tried by a correlation of the
  block's first code period, the highest-bin line whose correlation SNR
  passes 100 kept (:27-47);
- then from the file's start, 2-s blocks with the leftover carry in
  front: per block the df at the squaring spectrum's argmax within +-3
  bins of the hunt's line, on the raw block (:168-169); each code window
  mixed to that df, correlated with the code (the data conjugated,
  ``fcode .* conj(ffty)``), interpolated 3x by zero-padding the product's
  spectrum, its peak's index, parabolic correction, complex value and
  code-aligned SNR (:49-102);
- slips: the first window whose peak lies away from the edge with an SNR
  over the gate moves the following windows by ``indice - 21`` samples
  and is correlated again, up to 4 passes (:171-193); the final partial
  block is dropped.

``quant_bits`` (the control) quantizes each block's int16 samples to that
many bits with the scale ``max|x| / (2**(bits-1) - 1)`` before anything
else sees them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["process"]


def _freq(n: int, fs: float, dev) -> torch.Tensor:
    # the chains' inclusive linspace axis
    return torch.linspace(-fs / 2, fs / 2, n, dtype=torch.float64, device=dev)


def _shifted_square_spectrum(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.fftshift(torch.abs(torch.fft.fft(x * x)))


def _median(v: torch.Tensor) -> torch.Tensor:
    s = torch.sort(v).values
    m = s.shape[0]
    return 0.5 * (s[(m - 1) // 2] + s[m // 2])


def _trial_snr(dcode: torch.Tensor, fcode: torch.Tensor, dfs: torch.Tensor,
               fs: float, notch: int = 5) -> torch.Tensor:
    """``prnmap = |ifft(fcode .* conj(fft(d mixed to df)))|``; peak^2 over
    the variance of the map outside +-``notch`` of the peak (:36-43)."""
    L = dcode.shape[-1]
    k = torch.arange(L, dtype=torch.float64, device=dcode.device)
    y = dcode[None, :] * torch.exp(-2j * math.pi * dfs[:, None] * k / fs)
    prnmap = torch.abs(torch.fft.ifft(fcode[None, :] * torch.conj(torch.fft.fft(y, dim=-1)), dim=-1))
    pk, b = torch.max(prnmap, dim=-1)
    dist = torch.abs(torch.remainder(k[None, :].long() - b[:, None] + L // 2, L) - L // 2)
    keep = dist > notch
    n = keep.sum(-1)
    mu = torch.where(keep, prnmap, 0.0).sum(-1) / n
    var = torch.where(keep, (prnmap - mu[:, None]) ** 2, 0.0).sum(-1) / n
    return pk ** 2 / var


def _correlate(wins: torch.Tensor, df: float, fcode: torch.Tensor, g3: torch.Tensor,
               fs: float, nint: int) -> dict:
    """Each row of ``wins`` (n, L): mixed to ``df`` after its mean is
    removed, correlated, 3x interpolated; peak, correction, SNR, power."""
    n, L = wins.shape
    M = (2 * nint + 1) * L
    d = wins - wins.mean(dim=-1, keepdim=True)
    k = torch.arange(L, dtype=torch.float64, device=wins.device)
    y = d * torch.exp(-2j * math.pi * df * k / fs)[None, :]
    ffty = torch.fft.fft(y, dim=-1)
    prod = fcode[None, :] * torch.conj(ffty)
    half = L // 2

    def zoom(z):
        return torch.cat([z[:, :half], z.new_zeros((n, M - L)), z[:, half:]], dim=-1)

    prnmap = torch.fft.ifft(zoom(prod), dim=-1)
    mag = torch.abs(prnmap)
    ind = torch.argmax(mag, dim=-1)
    rows = torch.arange(n, device=wins.device)
    xm1, x0, xp1 = (prnmap[rows, torch.remainder(ind + o, M)] for o in (-1, 0, 1))
    am1, a0, ap1 = torch.abs(xm1), torch.abs(x0), torch.abs(xp1)
    den = am1 + ap1 - 2.0 * a0
    corr = torch.where(den == 0, 0.0, (am1 - ap1) / torch.where(den == 0, 1.0, den) / 2.0)
    # code-aligned mean of the interpolated signal (the SNR's numerator)
    s = torch.remainder(-(ind + 1), M)
    zc = torch.fft.ifft(zoom(ffty) * g3[None, :], dim=-1)
    mu = zc[rows, s] / M
    var = torch.sum(torch.abs(ffty) ** 2, dim=-1) / M ** 2 - torch.abs(mu) ** 2
    var = torch.where(var == 0, 1.0, var)
    ym = y - y.mean(dim=-1, keepdim=True)
    return {"indice": ind, "correction": corr, "xval": x0,
            "snr_r": mu.real ** 2 / var, "snr_i": mu.imag ** 2 / var,
            "puissance": torch.mean(torch.abs(ym) ** 2, dim=-1)}


def _quantize(blk16: np.ndarray, bits: int | None) -> np.ndarray:
    if bits is None:
        return blk16.astype(np.float64)
    top = 2 ** (bits - 1) - 1
    m = float(np.abs(blk16.astype(np.int64)).max())
    scale = m / top if m else 1.0
    return np.clip(np.round(blk16 / scale), -top, top) * scale


def process(raw: np.ndarray, chips: np.ndarray, sig: dict, proc: dict,
            df_window_hz: tuple[float, float], dev, quant_bits: int | None = None) -> dict:
    """The chain over ``raw`` ((n, 2) int16 I/Q of one file); ``chips``
    the code (0/1), ``sig`` the signal's ``fs``/``chip_rate``, ``proc`` the
    processing parameters of the configuration.  Returns the per-code
    arrays (``indice`` on the sample grid, 0-based; ``correction`` on the
    interpolated grid), ``df`` per code, ``moved`` (1-based slip epochs)
    and ``found``."""
    fs = float(sig["fs"])
    sps = int(round(fs / sig["chip_rate"]))
    nint = int(proc["nint"])
    f = 2 * nint + 1
    code = torch.from_numpy(np.repeat(chips.astype(np.float64) * 2 - 1, sps)).to(dev)
    L = code.shape[0]
    fcode = torch.fft.fft(code)
    g3 = torch.conj(torch.fft.fft(code.repeat_interleave(f)))
    block = int(fs * proc["block_seconds"])
    n_total = raw.shape[0]

    def blk(pos):
        b = _quantize(raw[pos:pos + block], quant_bits)
        return torch.from_numpy(b[:, 0] + 1j * b[:, 1]).to(dev)

    # -- the hunt -----------------------------------------------------------
    freq = _freq(block, fs, dev)
    lo, hi = df_window_hz
    mask = (freq > lo) & (freq < hi)
    kbon = -1
    pos = int(proc["skip_seconds"] * fs)
    while pos + block <= n_total and kbon < 0:
        x = blk(pos)
        d2 = _shifted_square_spectrum(x)
        above = mask & (d2 > _median(d2[mask]) * proc["df_threshold"])
        score = torch.where(above, d2, -torch.inf)
        cand = torch.topk(score, 32).indices
        cand = cand[above[cand]]
        if len(cand):
            first = torch.from_numpy(raw[pos:pos + L].astype(np.float64)).to(dev)
            dcode = torch.complex(first[:, 0], first[:, 1])
            dcode = dcode - dcode.mean()
            snr = _trial_snr(dcode, fcode, freq[cand] / 2.0, fs)
            ok = cand[snr > 100.0]
            if len(ok):
                kbon = int(ok.max())
        pos += block
    if kbon < 0:
        return {"found": False}

    # -- the blocks -----------------------------------------------------------
    acc = {k: [] for k in ("indice", "correction", "xval", "snr_r", "snr_i",
                           "puissance", "df")}
    moved: list[int] = []
    dold = torch.zeros(0, dtype=torch.complex128, device=dev)
    p = 1
    pos = 0
    while pos + block <= n_total:
        x = blk(pos)
        pos += block
        sp = torch.abs(torch.fft.fft(x * x))
        start = min(max(kbon - 3, 0), block - 7)
        j = torch.arange(start, start + 7, device=dev)
        idx = start + int(torch.argmax(sp[torch.remainder(j - block // 2, block)]))
        df = float(freq[idx]) / 2.0
        dcat = torch.cat([dold, x])
        offsets = np.arange(0, len(dcat) - L + 1, L, dtype=np.int64)
        lane = torch.arange(L, device=dev)

        def corr(offs):
            o = torch.from_numpy(offs).to(dev)
            return _correlate(dcat[o[:, None] + lane], df, fcode, g3, fs, nint)

        res = corr(offsets)
        for _ in range(int(proc["max_slip_passes"])):
            ni = res["indice"].double().cpu().numpy() / f
            snr_db = 10 * np.log10(np.maximum((res["snr_r"] + res["snr_i"]).cpu().numpy(), 1e-30))
            slipped = (snr_db > proc["snr_gate_db"]) & (
                ((ni > 42) & (ni < L / 2)) | ((ni < L - 3) & (ni >= L / 2)))
            if not slipped.any():
                break
            first = int(np.argmax(slipped))
            shift = int(round(ni[first])) - 21
            offsets = offsets.copy()
            offsets[first:] -= shift
            if offsets[first] < 0:
                offsets[first:] += L
            offsets = offsets[offsets + L <= len(dcat)]
            if len(offsets) == 0:
                break
            moved.append(p + first)
            res = corr(offsets)
        n_win = len(offsets)
        if n_win:
            acc["indice"].append(res["indice"].double().cpu().numpy() / f)
            for key in ("correction", "xval", "snr_r", "snr_i", "puissance"):
                acc[key].append(res[key].cpu().numpy())
            acc["df"].append(np.full(n_win, df))
            p += n_win
            tail = int(offsets[-1]) + L
        else:
            tail = 0
        dold = dcat[tail:]
    out = {k: (np.concatenate(v) if v else np.zeros(0)) for k, v in acc.items()}
    out.update(found=True, moved=moved)
    return out
