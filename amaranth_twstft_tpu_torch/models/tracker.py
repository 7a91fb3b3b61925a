"""Device-resident multi-channel DLL/PLL tracking — the 120-channel bank.

The port's counterpart of the JAX package's ``models/tracker.py``.  The
reference receiver loops its (up to) 120 channels on the host, one DGEMM
+ host epilogue per channel per second
(``experiments/231001_DLL_PLL/rxcomplex.cpp:36,466-799``).  Here the
whole bank runs on the card each second:

- per channel group (``group`` channels, one batch dimension): the
  carrier-phase-continuous downconversion from the host's phase tables,
  then the lag bank through the hand-written kernel
  (:func:`amaranth_twstft_tpu_torch.ops.lagbank.lag_bank_windows`, which
  reads the lags as shifted windows of the circular replica extension);
- for all channels at once: peak, HRC discriminator, median/IQR gate,
  the BPSK half-cycle unwrap and both weighted linear fits
  (``rxcomplex.cpp:592-744``), returning ONE packed (C, 9) row block so
  the host pays one fetch per second;
- the host applies the tiny per-second state updates in float64.

Carrier-phase continuity in float32 uses host-computed float64 phase
tables: the LO phase ``frac(fc/fs * (pt + n))`` is split as
``theta[code] + t1[block] + t2[intra]`` (each < 1 cycle), so the device
only sums three small float32 numbers.

Real-sample input (``rx.cpp``): ``real_input=True`` multiplies the real
stream by ``sqrt(2)*exp(-j2pi(fc t + phi))`` (``rx.cpp:988-997``).

Kept bit for bit from the JAX package (PARITY deviations 3-5, 7-10): the
deterministic probe-epoch stride, the one-bin CAF grid, the squaring-FFT
fine frequency, the 10x peak/median quality gate, the negated
``atan2(-im, re)`` phase, working SIC and ``transfer="auto"`` choosing
f16 below a peak of 6e4.  Not yet ported: the channel-sharded multi-GPU
step (``make_sharded_tracker_step``).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from amaranth_twstft_tpu_torch.models.dllpll import (
    Channel,
    ChannelConfig,
    SecondReport,
    TrackState,
    _merge_param_row,
    _param_matches,
    _phase_unwrap_scan,
    _v2_to_dbm,
    build_channels_batch,
    dat_filename,
    log_line,
    parse_sdr_param,
)
from amaranth_twstft_tpu_torch.ops.correlator import quick_xcorr_snr
from amaranth_twstft_tpu_torch.ops.lagbank import lag_bank_windows
from amaranth_twstft_tpu_torch.ops.peaks import (
    hrc_correction,
    median_iqr_sigma,
    weighted_linear_fit,
)
from amaranth_twstft_tpu_torch.utils.platform import resolve_device

__all__ = [
    "TrackerBank",
    "BankedReceiver",
    "MultiBankReceiver",
    "PendingSecond",
    "banked_track_step",
    "banked_acquire_step",
    "build_bank",
    "phase_tables",
    "pack_int4_ri",
    "pack_int2_ri",
    "unpack_track_outputs",
]

_SQRT2 = 1.4142135623730951  # rx.cpp's real->complex power compensation
_TWO_PI = 2.0 * math.pi


def pack_int4_ri(bufs: np.ndarray) -> tuple[np.ndarray, float]:
    """Quantize (n_buf, S, 2) float I/Q to nibble-packed int4 -> one int8
    byte per complex sample (I = low nibble, Q = high nibble), a quarter
    of the f32 bytes (PARITY.md deviation 10)."""
    m = float(np.max(np.abs(bufs)))
    scale = (m / 7.0) if m > 0 else 1.0
    q = np.clip(np.round(bufs / scale), -8, 7).astype(np.int8)
    u = q.astype(np.uint8) & 0x0F
    return (u[..., 0] | (u[..., 1] << 4)).astype(np.int8), scale


def pack_int2_ri(bufs: np.ndarray) -> tuple[np.ndarray, float]:
    """Quantize (n_buf, S, 2) float I/Q to 2-bit sign/magnitude codes
    (levels +-1, +-3 in units of the threshold T ~ sigma), four codes
    (two complex samples) per uint8 byte.

    As in the JAX package, sigma is taken over ALL components — in
    real-input mode that includes the all-zero imaginary column (kept so
    the port matches; ROADMAP Queue 3)."""
    sigma = float(np.std(bufs))
    t = sigma if sigma > 0 else 1.0
    sign = (bufs > 0).astype(np.uint8)
    mag = (np.abs(bufs) > t).astype(np.uint8)
    code = (sign << 1) | mag  # (n_buf, S, 2) in 0..3
    n_buf, S, _ = code.shape
    if S % 2:
        code = np.concatenate(
            [code, np.zeros((n_buf, 1, 2), np.uint8)], axis=1
        )
    c = code.reshape(n_buf, -1, 2, 2)  # (n_buf, S2, sample, comp)
    byte = (c[:, :, 0, 0] | (c[:, :, 0, 1] << 2)
            | (c[:, :, 1, 0] << 4) | (c[:, :, 1, 1] << 6))
    return byte.astype(np.uint8), t


def _bufs_to_f32(iq_ri: torch.Tensor, scale: torch.Tensor | None):
    """Decode any transfer format to (n_buf, S, 2) float32 on the tensor's
    device: 2-bit-packed uint8 (:func:`pack_int2_ri`), nibble-packed int4
    (2-D int8), int8 + scale, f16/bf16, or f32."""
    if iq_ri.dtype == torch.uint8 and iq_ri.dim() == 2:
        if scale is None:
            raise ValueError("int2-packed iq_ri requires the threshold scale")
        b = iq_ri

        def lvl(c):
            # code = sign<<1 | mag -> value (2*sign-1) * (1 + 2*mag)
            c = c.to(torch.int8)
            return ((2 * (c >> 1) - 1) * (1 + 2 * (c & 1))).to(torch.float32)

        fields = torch.stack(
            [lvl(b & 3), lvl((b >> 2) & 3), lvl((b >> 4) & 3),
             lvl((b >> 6) & 3)],
            dim=-1,
        )  # (n_buf, S2, [I0, Q0, I1, Q1])
        iq = fields.reshape(b.shape[0], -1, 2)
        return iq * scale.to(torch.float32)
    if iq_ri.dtype == torch.int8 and iq_ri.dim() == 2:
        if scale is None:
            raise ValueError("int4-packed iq_ri requires the dequant scale")
        lo = (iq_ri << 4) >> 4  # I, sign-extended
        hi = iq_ri >> 4  # Q (arithmetic shift)
        iq = torch.stack([lo, hi], dim=-1).to(torch.float32)
        return iq * scale.to(torch.float32)
    if iq_ri.dtype == torch.int8:
        if scale is None:
            raise ValueError(
                "int8 iq_ri requires the per-second dequantization scale "
                "(q = round(x/scale))"
            )
        return iq_ri.to(torch.float32) * scale.to(torch.float32)
    if iq_ri.dtype in (torch.float16, torch.bfloat16):
        return iq_ri.to(torch.float32)
    return iq_ri


def _block_split(nobs: int) -> tuple[int, int]:
    """(nblk, B) with nblk*B == nobs and B the divisor just >= sqrt(nobs)
    — the intra-code split of the LO phase tables."""
    d = int(np.sqrt(nobs))
    while d >= 1:
        if nobs % d == 0:
            return d, nobs // d
        d -= 1
    return 1, nobs


def _clamped_start(start: int, size: int, extent: int) -> int:
    """``jax.lax.dynamic_slice``'s rule: a start that would run the
    ``size`` window past ``extent`` is clamped into range."""
    if size > extent:
        raise ValueError(f"slice of {size} exceeds the buffer's {extent}")
    return min(max(int(start), 0), extent - size)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -1, idx.unsqueeze(-1)).squeeze(-1)


# ----------------------------------------------------------------------
# The per-second tracking program
# ----------------------------------------------------------------------
def _downconvert(seg, theta, t1, t2, *, ncodes, nobs, real_input):
    """(G, ncodes*nobs, 2) samples -> obs (G, 2, ncodes, nobs): multiply by
    ``exp(-j2pi(theta[p] + t1[b] + t2[u]))`` (``rxcomplex.cpp:592-600``)."""
    G = seg.shape[0]
    nblk, B = t1.shape[-1], t2.shape[-1]
    sr = seg[..., 0].reshape(G, ncodes, nblk, B)
    si = seg[..., 1].reshape(G, ncodes, nblk, B)
    ang = _TWO_PI * (
        theta[:, :, None, None] + t1[:, None, :, None] + t2[:, None, None, :]
    )
    c = torch.cos(ang)
    s = torch.sin(ang)
    if real_input:
        # rx.cpp downconv_trk: sqrt(2) * smp * exp(-j 2pi (ff n + phi))
        obs_re = _SQRT2 * sr * c
        obs_im = -_SQRT2 * sr * s
    else:
        obs_re = sr * c + si * s
        obs_im = si * c - sr * s
    return torch.stack([obs_re, obs_im], dim=1).reshape(G, 2, ncodes, nobs)


def banked_track_step(
    iq_ri,
    wav_ext,
    psbb,
    phys,
    pt,
    theta,
    t1,
    t2,
    last_phi,
    scale=None,
    *,
    ncodes: int,
    nobs: int,
    nlag: int,
    bps: int,
    fs: float,
    real_input: bool = False,
    group: int = 4,
):
    """All channels' tracking second.

    ``iq_ri``: (n_buffers, S, 2) sample buffers in any transfer format
    (decoded here, on the device); per-channel arrays are stacked on axis
    0 (C channels).  Channels run through the downconversion and the lag
    bank ``group`` at a time (one batch dimension); the rest runs on all
    C at once.  Returns ONE packed (C, 9) float32 tensor with rows
    ``(c0p, c1p, c0g_rel, c1g, chi2, cnt, pk_mean, last_phi, locked)``
    (decode with :func:`unpack_track_outputs`).
    """
    iq = _bufs_to_f32(iq_ri, scale)
    n_buf, S, _ = iq.shape
    C = wav_ext.shape[0]
    L = ncodes * nobs
    nlags = 2 * nlag + 1
    # host copies of the slice starts, clamped as dynamic_slice clamps
    rows = [min(max(int(r), 0), n_buf - 1) for r in phys.tolist()]
    starts = [_clamped_start(p, L, S) for p in pt.tolist()]

    res = []
    for g0 in range(0, C, group):
        g1 = min(C, g0 + group)
        seg = torch.stack(
            [iq[rows[i], starts[i] : starts[i] + L] for i in range(g0, g1)]
        )
        obs = _downconvert(
            seg, theta[g0:g1], t1[g0:g1], t2[g0:g1],
            ncodes=ncodes, nobs=nobs, real_input=real_input,
        )
        # lag bank: 2*nlag+1 circularly shifted replicas, read as windows
        # of the circular extension (rxcomplex.cpp:430,605); power scaled
        # to per-sample amplitude as 0.5 * 4/nobs^2 * (re^2 + im^2)
        power, _, re, im = lag_bank_windows(
            obs, wav_ext[g0:g1], nlag, power_scale=0.5 * 4.0 / nobs**2
        )
        res.append((power, re, im))
    power = torch.cat([r[0] for r in res])
    re = torch.cat([r[1] for r in res])
    im = torch.cat([r[2] for r in res])

    pk_idx = torch.argmax(power, dim=-1)
    pkp = _take(power, pk_idx)
    interior = (pk_idx >= 2) & (pk_idx < nlags - 2)
    # peak-quality gate (see dllpll: the reference's power gate is
    # commented out; without one a pure-noise second keeps "lock")
    floor = torch.quantile(power, 0.5, dim=-1)
    quality = pkp > 10.0 * torch.clamp_min(floor, 1e-30)
    w = (interior & quality).to(torch.float32)

    hrc = hrc_correction(power, pk_idx)
    # code phase RELATIVE to pt, in ns; the host adds pt*1e9/fs in f64
    gd_rel = (pk_idx.to(torch.float32) - nlag + hrc) * (1e9 / fs)
    ps = pkp / torch.clamp_min(psbb, 1e-30)[:, None]
    # residual carrier phase in cycles: the negated lag-bank convention
    res_phi = torch.atan2(_take(im, pk_idx), _take(re, pk_idx)) / _TWO_PI

    med, sigma = median_iqr_sigma(gd_rel, w)
    ok = torch.abs(gd_rel - med[:, None]) < torch.clamp_min(3.0 * sigma, 1e-6)[:, None]
    w = w * ok
    cnt = torch.sum(w, dim=-1).to(torch.int32)
    locked = 2 * cnt > bps

    last_phi = last_phi.to(res_phi.dtype)
    res_phi_u = _phase_unwrap_scan(res_phi, w, last_phi)
    valid = (w > 0).to(torch.int32)
    has_valid = valid.any(dim=-1)
    idx_last = (ncodes - 1) - torch.argmax(valid.flip(-1), dim=-1)
    last_phi_new = torch.where(has_valid, _take(res_phi_u, idx_last), last_phi)

    duration = nobs / fs
    p_ax = torch.arange(ncodes, dtype=torch.float32, device=iq.device)
    tt_phi = p_ax * duration + (pt.to(torch.float32) / fs)[:, None]
    c0p, c1p, _ = weighted_linear_fit(tt_phi, res_phi_u, w)
    tt_gd = p_ax * duration
    c0g, c1g, chi2 = weighted_linear_fit(tt_gd, gd_rel, w)
    pk_mean = torch.sum(ps * w, dim=-1) / torch.clamp_min(cnt.to(torch.float32), 1.0)
    return torch.stack(
        [
            c0p,
            c1p,
            c0g,
            c1g,
            chi2,
            cnt.to(torch.float32),
            pk_mean,
            last_phi_new.to(torch.float32),
            locked.to(torch.float32),
        ],
        dim=-1,
    )


def unpack_track_outputs(packed: np.ndarray) -> tuple:
    """(C, 9) packed rows -> the nine (C,) host arrays
    ``(c0p, c1p, c0g_rel, c1g, chi2, cnt, pk_mean, last_phi, locked)``
    with integer/bool columns restored."""
    a = np.asarray(packed)
    cols = [a[:, i] for i in range(9)]
    cols[5] = cols[5].astype(np.int32)
    cols[8] = cols[8] > 0.5
    return tuple(cols)


# ----------------------------------------------------------------------
# The batched acquisition program
# ----------------------------------------------------------------------
def banked_acquire_step(
    iq_ri,
    fcode_ri,
    buf_idx,
    shifts,
    hyp_ok,
    start: int,
    scale=None,
    *,
    nobs: int,
    nsec: int,
    fs: float,
    win: int = 401,
    chunk: int = 4,
    real_input: bool = False,
):
    """Dense CAF acquisition for a batch of channels.

    - one code epoch per channel at sample ``start``, searched over the
      SHARED integer-bin Doppler grid ``shifts``; each channel's
      admissible hypotheses are selected by ``hyp_ok`` (C, H) — the
      union-grid equivalent of the per-channel hierarchical scan
      (``rxcomplex.cpp:522-586``); ``chunk`` hypotheses at a time,
    - Doppler refine: the 2-point sinc interpolator across hypotheses,
    - trial-correlation SNR per channel,
    - fine frequency: ONE squaring FFT per sample buffer over the whole
      second, then a ``win``-bin windowed argmax + parabola around each
      channel's doubled CAF frequency (``rxcomplex.cpp:560-568``).

    Returns (df_hz, pt_idx, snr, pk_power), all (C,).
    """
    f32 = torch.float32
    iq = _bufs_to_f32(iq_ri, scale)
    dev = iq.device
    fcode = torch.complex(fcode_ri[..., 0], fcode_ri[..., 1])

    # -- per-channel epoch (slice BEFORE the row gather) -----------------
    s0 = _clamped_start(start, nobs, iq.shape[1])
    segs = iq[:, s0 : s0 + nobs][buf_idx]  # (C, nobs, 2)
    if real_input:
        re = _SQRT2 * segs[..., 0]
        d = torch.complex(re, torch.zeros_like(re))
    else:
        d = torch.complex(segs[..., 0], segs[..., 1])
    d = d - torch.mean(d, dim=-1, keepdim=True)
    D = torch.fft.fft(d, dim=-1)

    # -- dense CAF over the shared grid, chunked ------------------------
    H = shifts.shape[0]
    k = torch.arange(nobs, device=dev)
    pks, idxs = [], []
    for h0 in range(0, H, chunk):
        sh = shifts[h0 : h0 + chunk].to(torch.int64)
        # roll(D, -s)[k] = D[(k + s) mod nobs]
        roll_idx = torch.remainder(k[None, :] + sh[:, None], nobs)
        corr = torch.fft.ifft(D[:, roll_idx] * fcode[:, None, :], dim=-1)
        pk_h, ix_h = torch.max(torch.abs(corr) ** 2, dim=-1)
        pks.append(pk_h)
        idxs.append(ix_h)
    power = torch.cat(pks, dim=-1)  # (C, H)
    index = torch.cat(idxs, dim=-1)

    neg = torch.full_like(power, torch.finfo(power.dtype).min)
    h_best = torch.argmax(torch.where(hyp_ok, power, neg), dim=-1)
    pk = _take(power, h_best)
    pt_idx = _take(index, h_best)
    bin_hz = fs / nobs
    f_best = shifts[h_best].to(f32) * bin_hz
    # sinc 2-point Doppler refine (see the JAX ops/caf.caf_search)
    am1 = torch.sqrt(_take(power, torch.clamp(h_best - 1, 0, H - 1)))
    ap1 = torch.sqrt(_take(power, torch.clamp(h_best + 1, 0, H - 1)))
    step_bins = float(shifts[1] - shifts[0]) if H > 1 else 1.0
    den = ap1 + am1
    safe = torch.where(den == 0, torch.ones_like(den), den)
    delta = torch.where(den == 0, torch.zeros_like(den), (ap1 - am1) / safe)
    interior = (h_best > 0) & (h_best < H - 1)
    df_caf = f_best + torch.where(
        interior, delta * step_bins * bin_hz, torch.zeros_like(delta)
    )

    # -- trial-correlation SNR gate (claudio_...separate.m:33-44) --------
    snr = quick_xcorr_snr(d, torch.conj(fcode), df_caf, fs)

    # -- fine df: squaring FFT per buffer, windowed per channel ----------
    if real_input:
        x = iq[:, :nsec, 0] * _SQRT2
        x2c = torch.complex(x * x, torch.zeros_like(x))
    else:
        xc = torch.complex(iq[:, :nsec, 0], iq[:, :nsec, 1])
        xc = xc - torch.mean(xc, dim=-1, keepdim=True)
        x2c = xc * xc
    spec2 = torch.abs(torch.fft.fft(x2c, dim=-1))  # (n_buf, nsec)
    spec2 = torch.cat([spec2, spec2[:, :win]], dim=-1)
    bin2 = fs / nsec
    center = torch.round(2.0 * df_caf / bin2).to(torch.int64)
    startw = torch.remainder(center - win // 2, nsec)
    w_ = spec2[buf_idx[:, None], startw[:, None] + torch.arange(win, device=dev)]
    kk = torch.argmax(w_, dim=-1)
    am = _take(w_, torch.clamp(kk - 1, 0, win - 1))
    a0 = _take(w_, kk)
    ap = _take(w_, torch.clamp(kk + 1, 0, win - 1))
    den2 = am + ap - 2.0 * a0
    sd = torch.where(den2 == 0, torch.ones_like(den2), den2)
    corr = torch.where(den2 == 0, torch.zeros_like(den2), (am - ap) / sd / 2.0)
    pos = startw.to(f32) + kk.to(f32) + corr
    pos = torch.remainder(pos, nsec)
    signed = torch.where(pos > nsec / 2, pos - nsec, pos)
    df_fine = signed * bin2 / 2.0
    return df_fine, pt_idx, snr, pk


# ----------------------------------------------------------------------
# Host orchestration
# ----------------------------------------------------------------------
@dataclass
class TrackerBank:
    """Stacked replica arrays + geometry for a homogeneous channel group."""

    channels: list[Channel]
    fs: float
    nobs: int
    bps: int
    nlag: int
    nblk: int
    B: int
    wav_ext: np.ndarray  # (C, nobs + 2*nlag) f32
    psbb: np.ndarray  # (C,) f32
    fcode_ri: np.ndarray  # (C, nobs, 2) f32, conjugated replica spectra

    @property
    def ncodes(self) -> int:
        return self.bps - 1

    @property
    def n_channels(self) -> int:
        return len(self.channels)


def build_bank(channels: list[Channel], fs: float) -> TrackerBank:
    geoms = {(c.nobs, c.cfg.codes_per_second, c.cfg.nlag) for c in channels}
    if len(geoms) != 1:
        raise ValueError(
            f"banked tracking needs homogeneous channel geometry, got {geoms}"
        )
    nobs, bps, nlag = next(iter(geoms))
    nblk, B = _block_split(nobs)
    # wav_ext[m] = wav[(m - nlag) % nobs]; the slice starting at
    # (2*nlag - l) is then wav[(n + nlag - l) % nobs] = roll(wav, l - nlag)
    # — the same lag bank as Receiver._lag_matrix
    wav_ext = np.stack(
        [
            np.concatenate([c.wav[-nlag:], c.wav, c.wav[:nlag]])
            for c in channels
        ]
    ).astype(np.float32)
    psbb = np.array([c.psbb for c in channels], dtype=np.float32)
    fcode_ri = np.stack(
        [
            np.stack([c.fcode.real, c.fcode.imag], axis=-1).astype(np.float32)
            for c in channels
        ]
    )
    return TrackerBank(
        channels=channels,
        fs=fs,
        nobs=nobs,
        bps=bps,
        nlag=nlag,
        nblk=nblk,
        B=B,
        wav_ext=wav_ext,
        psbb=psbb,
        fcode_ri=fcode_ri,
    )


def phase_tables(
    bank: TrackerBank, pt: np.ndarray, fc: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side float64 LO phase bookkeeping -> three f32 tables.

    ``frac(fc/fs * (pt + p*nobs + b*B + u))`` == ``theta[c,p] + t1[c,b] +
    t2[c,u]`` (mod 1) — each term carries the f64-exact fractional part,
    so the device-side sum is accurate to ~2e-7 cycles regardless of how
    many carrier cycles elapse in the second (the f32 answer to
    ``downconv_trk``'s running double phase, ``rxcomplex.cpp:592-600``).
    """
    r = np.asarray(fc, np.float64) / bank.fs
    pt = np.asarray(pt, np.float64)
    p = np.arange(bank.ncodes, dtype=np.float64)
    theta = np.mod((pt[:, None] + p[None, :] * bank.nobs) * r[:, None], 1.0)
    t1 = np.mod(r[:, None] * (bank.B * np.arange(bank.nblk))[None, :], 1.0)
    t2 = np.mod(r[:, None] * np.arange(bank.B)[None, :], 1.0)
    return (
        theta.astype(np.float32),
        t1.astype(np.float32),
        t2.astype(np.float32),
    )


@dataclass
class PendingSecond:
    """One second of samples, packed for transfer and (possibly already)
    in flight to the device.  On the card the pinned host copy is uploaded
    ``non_blocking`` on the receiver's copy stream and ``copied`` is
    recorded after it, so a prefetched second's upload runs beside the
    previous second's compute; :meth:`BankedReceiver.process_second` makes
    the compute stream wait on ``copied`` before it reads ``dev``."""

    dev: torch.Tensor  # device tensor in the transfer format
    scale: torch.Tensor | None  # device scalar for int8/int4/int2, else None
    px_rows: np.ndarray  # (n_buf,) noise power, computed PRE-quantization
    have: np.ndarray  # (C,) which channels have samples this second
    host: torch.Tensor | None = None  # the pinned source of ``dev``
    copied: torch.cuda.Event | None = None  # the upload's end (card only)


class BankedReceiver:
    """Multi-channel receiver with device-batched tracking + acquisition.

    The port of the JAX ``BankedReceiver`` on homogeneous channel
    geometry: one batched pass per second for the whole bank, on
    ``device`` (default ``cuda``; ``"cpu"`` runs the plain versions of the
    kernels).  ``real_input=True`` is the ``rx.cpp`` real-sample mode;
    ``out_dir`` writes the reference's per-channel ``.dat`` rows and
    ``rxcomplex.log``.

    ``transfer`` picks the H2D sample format: ``"auto"`` (f16 when the
    samples fit its range, else f32), ``"f16"``, ``"f32"``, ``"int8"``,
    ``"int4"`` (nibble-packed) or ``"int2"`` (sign/magnitude).  Drive
    seconds through :meth:`run_stream` to prefetch the next upload.
    """

    def __init__(
        self,
        channels: list[ChannelConfig],
        fs: float = 5e6,
        *,
        group: int = 4,
        real_input: bool = False,
        out_dir: str | None = None,
        acq_chunk: int = 4,
        transfer: str = "auto",
        device: str | torch.device | None = None,
    ):
        self._setup(fs, group=group, real_input=real_input, out_dir=out_dir,
                    acq_chunk=acq_chunk, transfer=transfer, device=device)
        self._init_bank(build_channels_batch(channels, fs))

    @classmethod
    def from_reference(
        cls,
        channels: list[ChannelConfig],
        bank_arrays: dict[str, np.ndarray],
        states: list[dict],
        fs: float = 5e6,
        *,
        acq_attempt: int = 0,
        **kw,
    ) -> "BankedReceiver":
        """A receiver holding exactly another receiver's bank and state.

        ``bank_arrays`` carries the reference bank's ``wav_ext`` (C, nobs +
        2*nlag), ``psbb`` (C,), ``fcode_ri`` (C, nobs, 2) and the
        receiver's ``_buf_idx`` (C,) as numpy; ``states`` one dict of
        :class:`TrackState` fields per channel; ``acq_attempt`` the
        probe-epoch counter.  Used to start the port and the JAX package
        from identical state mid-track."""
        wav_ext = np.asarray(bank_arrays["wav_ext"], np.float32)
        psbb = np.asarray(bank_arrays["psbb"], np.float32)
        fcode_ri = np.asarray(bank_arrays["fcode_ri"], np.float32)
        buf_idx = np.asarray(bank_arrays["_buf_idx"], np.int32)
        C = len(channels)
        if not (wav_ext.shape[0] == psbb.shape[0] == fcode_ri.shape[0]
                == buf_idx.shape[0] == len(states) == C):
            raise ValueError("bank arrays, states and channels disagree on C")
        nlag = channels[0].nlag
        nobs = wav_ext.shape[1] - 2 * nlag
        built = [
            Channel(
                cfg=cfg,
                nobs=nobs,
                wav=wav_ext[i, nlag : nlag + nobs].copy(),
                fcode=fcode_ri[i, :, 0] + 1j * fcode_ri[i, :, 1],
                psbb=float(psbb[i]),
                sps_per_chip=int(round(fs / cfg.chip_rate)),
            )
            for i, cfg in enumerate(channels)
        ]
        rx = cls.__new__(cls)
        rx._setup(fs, **kw)
        rx._init_bank(built)
        rx.bank.wav_ext = wav_ext
        rx.bank.psbb = psbb
        rx.bank.fcode_ri = fcode_ri
        if buf_idx.shape != rx._buf_idx.shape:
            raise ValueError("_buf_idx does not match the channel list")
        rx._buf_idx = buf_idx
        rx.states = [TrackState(**s) for s in states]
        rx._acq_attempt = acq_attempt
        return rx

    # -- setup ----------------------------------------------------------
    def _setup(self, fs, *, group=4, real_input=False, out_dir=None,
               acq_chunk=4, transfer="auto", device=None) -> None:
        if transfer not in ("auto", "f16", "f32", "int8", "int4", "int2"):
            raise ValueError(f"unknown transfer format {transfer!r}")
        self.device = resolve_device(device)
        self.fs = fs
        self.real_input = real_input
        self.group = group
        self.out_dir = out_dir
        self.acq_chunk = acq_chunk
        self.transfer = transfer
        self.log: list[str] = []
        self._acq_attempt = 0  # probe-epoch diversity counter
        self._copy_stream = (torch.cuda.Stream(device=self.device)
                             if self.device.type == "cuda" else None)

    def _init_bank(self, built: list[Channel]) -> None:
        self.bank = build_bank(built, self.fs)
        self.channels = built
        self.states = [TrackState(fc=c.cfg.fc_init_hz) for c in built]
        self._phys_names = sorted({c.cfg.physical for c in built})
        self._sic_any = any(c.cfg.is_sic for c in built)
        n_phys = len(self._phys_names)
        # buffer row per channel: raw phys, or the SIC-cleaned row
        self._buf_idx = np.array(
            [
                self._phys_names.index(c.cfg.physical)
                + (n_phys if c.cfg.is_sic else 0)
                for c in built
            ],
            dtype=np.int32,
        )
        # device-resident constants (wav_ext is ~96 MB at production
        # geometry), uploaded on first use
        self._dev_const: dict | None = None

    def _const(self) -> dict:
        if self._dev_const is None:
            b, dev = self.bank, self.device
            self._dev_const = {
                "wav_ext": torch.from_numpy(b.wav_ext).to(dev),
                "psbb": torch.from_numpy(b.psbb).to(dev),
                "buf_idx": torch.from_numpy(self._buf_idx).to(dev),
                "fcode_ri": torch.from_numpy(b.fcode_ri).to(dev),
            }
        return self._dev_const

    def reload_params(self, text: str) -> list[int]:
        """``sdr.param`` hot-reload (``rxcomplex.cpp:257-285``): unchanged
        rows keep their tracking state, changed rows re-acquire."""
        known = {c.cfg.prn_id: c.cfg for c in self.channels}
        new_cfgs = parse_sdr_param(text)
        changed: list[int] = []
        plan: list[Channel | int] = []  # kept Channel | index into builds
        states: list[TrackState] = []
        to_build: list[ChannelConfig] = []
        for i, cfg in enumerate(new_cfgs):
            if i < len(self.channels) and _param_matches(
                self.channels[i].cfg, cfg
            ):
                plan.append(self.channels[i])
                states.append(self.states[i])
            else:
                base = known.get(
                    cfg.prn_id, self.channels[0].cfg if self.channels else None
                )
                if base is not None:
                    cfg = _merge_param_row(base, cfg)
                plan.append(len(to_build))
                to_build.append(cfg)
                states.append(TrackState(fc=cfg.fc_init_hz))
                changed.append(i)
        # only the CHANGED rows are rebuilt, in one batched pass
        new_built = (
            build_channels_batch(to_build, self.fs) if to_build else []
        )
        built = [new_built[p] if isinstance(p, int) else p for p in plan]
        changed.extend(range(len(new_cfgs), len(self.channels)))
        old_states = states
        self._init_bank(built)
        self.states = old_states
        return changed

    def _pack_second(self, iq_by_phys: dict[str, np.ndarray]):
        """Host half of a second: fill the (2*n_phys, S, 2) buffer (raw
        rows + SIC-cleaned rows), measure the noise power at full
        precision, and quantize/cast to the transfer format."""
        b = self.bank
        n_phys = len(self._phys_names)
        S = int(self.fs) + b.nobs

        # second-start snapshot: SIC reconstruction must use THIS second's
        # alignment (the reference's pt_prev, rxcomplex.cpp:513)
        snapshot = [(s.pt, s.fc, s.df) for s in self.states]

        bufs = np.zeros((2 * n_phys, S, 2), dtype=np.float32)
        raw = {}
        for k, name in enumerate(self._phys_names):
            smp = iq_by_phys.get(name)
            if smp is None:
                continue
            m = min(len(smp), S)
            raw[name] = smp
            if self.real_input:
                bufs[k, :m, 0] = np.real(smp[:m])
            else:
                bufs[k, :m, 0] = np.real(smp[:m])
                bufs[k, :m, 1] = np.imag(smp[:m])
            bufs[n_phys + k] = bufs[k]
        if self._sic_any:
            for k, name in enumerate(self._phys_names):
                if name in raw:
                    cleaned = self._mai_free(name, raw[name], snapshot)
                    m = min(len(cleaned), S)
                    bufs[n_phys + k, :m, 0] = np.real(cleaned[:m])
                    if not self.real_input:
                        bufs[n_phys + k, :m, 1] = np.imag(cleaned[:m])

        # noise floor per buffer row (rxcomplex px) at FULL precision,
        # before any transfer quantization touches the samples (rx.cpp
        # keeps px as the plain mean square of the raw samples — no
        # sqrt(2) compensation — so real mode matches it)
        nsec = int(self.fs)
        px_rows = np.mean(
            bufs[:, :nsec, 0] ** 2 + bufs[:, :nsec, 1] ** 2, axis=1
        )

        peak = float(np.max(np.abs(bufs)))
        scale = None
        t = self.transfer
        if t == "int4":
            packed, s = pack_int4_ri(bufs)
            scale = np.float32(s)
        elif t == "int8":
            s = peak / 127.0 if peak > 0 else 1.0
            packed = np.clip(np.round(bufs / s), -127, 127).astype(np.int8)
            scale = np.float32(s)
        elif t == "f16" or (t == "auto" and peak < 6.0e4):
            # f16 fits any int16-derived capture; overflow would poison
            # the FFTs with inf, hence the range check in auto mode
            packed = bufs.astype(np.float16)
        else:
            packed = bufs

        have = np.array(
            [self._phys_names[i % n_phys] in raw for i in self._buf_idx]
        )
        return packed, scale, px_rows, have

    def upload_second(self, iq_by_phys: dict[str, np.ndarray]) -> PendingSecond:
        """Pack a second into pinned host memory and START its upload
        (``non_blocking`` on the copy stream, an event recorded after it);
        pass the handle to :meth:`process_second` later.  The handle holds
        the pinned buffer until that second has been processed."""
        packed, scale, px_rows, have = self._pack_second(iq_by_phys)
        host = torch.from_numpy(packed)
        copied = None
        if self._copy_stream is not None:
            host = host.pin_memory()
            with torch.cuda.stream(self._copy_stream):
                dev = host.to(self.device, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(self._copy_stream)
        else:
            dev = host
        sdev = (
            None if scale is None
            else torch.tensor(float(scale), dtype=torch.float32,
                              device=self.device)
        )
        return PendingSecond(dev=dev, scale=sdev, px_rows=px_rows,
                             have=have, host=host, copied=copied)

    def process_second(
        self,
        iq_by_phys: dict[str, np.ndarray] | None = None,
        *,
        pending: PendingSecond | None = None,
    ):
        """One second for every channel: arrays of >= fs samples per
        physical channel (real arrays in ``real_input`` mode), or
        ``pending`` from :meth:`upload_second`."""
        if pending is None:
            if iq_by_phys is None:
                raise ValueError(
                    "process_second needs iq_by_phys or pending"
                )
            pending = self.upload_second(iq_by_phys)
        if pending.copied is not None:
            # the compute stream reads the upload only once it has landed;
            # the copy-stream allocation must outlive that reader
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(pending.copied)
            pending.dev.record_stream(compute)
        C = self.bank.n_channels
        have = pending.have
        cold = [
            i
            for i in range(C)
            if have[i] and not self.states[i].is_trk
        ]
        acquired = self._acquire_batch(pending, cold) if cold else set()

        warm = [
            i
            for i in range(C)
            if have[i] and self.states[i].is_trk and i not in acquired
        ]
        reports: list[SecondReport | None] = [None] * C
        if warm:
            self._track_all(pending, warm, reports)
        return reports

    def run_stream(self, seconds, *, prefetch: bool = True):
        """Drive the receiver over an iterable of per-second sample dicts,
        uploading second k+1 before second k is processed, so that on the
        card its copy runs on the copy stream beside second k's compute
        (the real-time bar is ``rxcomplex.cpp:36`` — 120 channels, 1 s of
        samples per s).  ``prefetch`` on and off give the same bits.

        Yields each second's reports list.  SIC configurations disable
        the prefetch: the cleaned rows must be rebuilt from the replica
        state of the second BEFORE them."""
        it = iter(seconds)
        if self._sic_any or not prefetch:
            for sec in it:
                yield self.process_second(sec)
            return
        try:
            cur = self.upload_second(next(it))
        except StopIteration:
            return
        for nxt_raw in it:
            nxt = self.upload_second(nxt_raw)
            yield self.process_second(pending=cur)
            cur = nxt
        yield self.process_second(pending=cur)

    # -- SIC (host; the JAX dllpll.Receiver._mai_free) -----------------------
    def _mai_free(self, phys: str, smp: np.ndarray, snapshot) -> np.ndarray:
        out = np.asarray(smp, dtype=np.complex128).copy()
        n = np.arange(len(smp), dtype=np.float64)
        for k, ch in enumerate(self.channels):
            st = self.states[k]
            if (
                ch.cfg.physical != phys
                or ch.cfg.is_sic
                or not st.is_trk
                or st.is_first
            ):
                continue
            pt_k, fc_k, df_k = snapshot[k]
            code = ch.wav.astype(np.float64)[
                (np.arange(len(smp)) - pt_k) % ch.nobs
            ]
            f = (fc_k + df_k) / self.fs
            rep = code * np.exp(2j * np.pi * np.mod(f * n, 1.0))
            nblk = len(smp) // ch.nobs
            if nblk == 0:
                continue
            m = nblk * ch.nobs
            rb = rep[:m].reshape(nblk, ch.nobs)
            sb = out[:m].reshape(nblk, ch.nobs)
            denom = np.sum(np.abs(rb) ** 2, axis=1)
            a = np.sum(np.conj(rb) * sb, axis=1) / np.maximum(denom, 1e-30)
            out[:m] -= (a[:, None] * rb).ravel()
            if m < len(smp):
                out[m:] -= a[-1] * rep[m:]
        return out

    # -- acquisition ------------------------------------------------------
    def _acquire_batch(
        self, pending: PendingSecond, cold: list[int]
    ) -> set[int]:
        b = self.bank
        bin_hz = self.fs / b.nobs
        # shared integer-bin hypothesis grid: union of cold ranges
        los, his = [], []
        for i in cold:
            cfg = self.channels[i].cfg
            los.append(cfg.fc_init_hz - cfg.acq_range_hz)
            his.append(cfg.fc_init_hz + cfg.acq_range_hz)
        # ONE-BIN hypothesis spacing regardless of the requested fstep:
        # the coherent integration is one code, whose ambiguity main lobe
        # is +/- one bin (PARITY deviation 4; the reference's fstep is
        # only the STARTING step of its halving loop, rxcomplex.cpp:530-568)
        lo_bin = int(np.floor(min(los) / bin_hz))
        hi_bin = int(np.ceil(max(his) / bin_hz))
        shifts = np.arange(lo_bin, hi_bin + 1, dtype=np.int32)
        freqs = shifts.astype(np.float64) * bin_hz
        hyp_ok = np.stack(
            [
                (freqs >= self.channels[i].cfg.fc_init_hz
                 - self.channels[i].cfg.acq_range_hz - bin_hz)
                & (freqs <= self.channels[i].cfg.fc_init_hz
                   + self.channels[i].cfg.acq_range_hz + bin_hz)
                for i in cold
            ]
        )
        nsec = b.bps * b.nobs
        # fine-squaring window on the DOUBLED-frequency axis: wide enough
        # for the CAF's post-refinement error, narrower than the spacing
        # to other channels' squaring lines
        bin2 = self.fs / nsec
        half_doubled = max(6.0 * bin2, 16.0)
        win = 2 * int(np.ceil(half_doubled / bin2)) + 1
        # probe-epoch diversity (rxcomplex.cpp:529 picks a random epoch):
        # attempt k probes code (bps//2 + k*stride) % bps with stride
        # coprime to bps (PARITY deviation 3)
        bps = int(self.fs) // b.nobs
        stride = max(1, bps // 3)
        while math.gcd(stride, bps) != 1:
            stride += 1
        start_code = (bps // 2 + self._acq_attempt * stride) % max(bps, 1)
        self._acq_attempt += 1
        start = start_code * b.nobs
        const, dev = self._const(), self.device
        cold_t = torch.as_tensor(cold, dtype=torch.int64, device=dev)
        df, pt_idx, snr, pk = banked_acquire_step(
            pending.dev,
            const["fcode_ri"][cold_t],
            const["buf_idx"][cold_t].to(torch.int64),
            torch.from_numpy(shifts).to(dev),
            torch.from_numpy(hyp_ok).to(dev),
            start,
            pending.scale,
            nobs=b.nobs,
            nsec=nsec,
            fs=self.fs,
            win=win,
            chunk=self.acq_chunk,
            real_input=self.real_input,
        )
        df = df.cpu().numpy()
        pt_idx = pt_idx.cpu().numpy()
        snr_db = 10.0 * np.log10(np.maximum(snr.cpu().numpy(), 1e-12))
        pk = pk.cpu().numpy()
        acquired: set[int] = set()
        for j, i in enumerate(cold):
            cfg, st = self.channels[i].cfg, self.states[i]
            if snr_db[j] < cfg.snr_min_db:
                self._log(log_line("acq failed  ", cfg, 0, b.bps))
                continue
            st.fc = float(df[j])
            st.pt = int((start + pt_idx[j]) % b.nobs)
            st.gd = st.pt * 1e9 / self.fs
            st.is_trk = True
            st.is_first = True
            st.pk = float(pk[j])
            acquired.add(i)
            self._log(
                f"acquisition : Ch. {cfg.physical}, PRN#{cfg.prn_id:2d}, "
                f"fc = {st.fc:.0f}, pt = {st.pt}"
            )
        return acquired

    # -- tracking ---------------------------------------------------------
    def _track_all(self, pending: PendingSecond, warm, reports) -> None:
        b = self.bank
        pt = np.array([s.pt for s in self.states], dtype=np.int32)
        fc = np.array([s.fc for s in self.states], dtype=np.float64)
        last_phi = np.array(
            [s.last_phi for s in self.states], dtype=np.float32
        )
        theta, t1, t2 = phase_tables(b, pt, fc)
        const, dev = self._const(), self.device
        outs = banked_track_step(
            pending.dev,
            const["wav_ext"],
            const["psbb"],
            self._buf_idx,
            torch.from_numpy(pt).to(dev),
            torch.from_numpy(theta).to(dev),
            torch.from_numpy(t1).to(dev),
            torch.from_numpy(t2).to(dev),
            torch.from_numpy(last_phi).to(dev),
            pending.scale,
            ncodes=b.ncodes, nobs=b.nobs, nlag=b.nlag, bps=b.bps,
            fs=self.fs, real_input=self.real_input, group=self.group,
        )
        # ONE fetch for the whole bank's second (packed rows)
        c0p, c1p, c0g, c1g, chi2, cnt, pk_mean, last_phi_new, locked = (
            unpack_track_outputs(outs.cpu().numpy())
        )
        px_rows = pending.px_rows

        for i in warm:
            st, cfg = self.states[i], self.channels[i].cfg
            if not locked[i]:
                st.is_trk = False
                st.last_phi = 0.0
                self._log(log_line("lock lost   ", cfg, int(cnt[i]), b.bps))
                continue
            st.fc += float(np.round(c1p[i]))
            st.df = float(c1p[i] - np.round(c1p[i]))
            st.phi = float(np.mod(c0p[i] + 1000.0, 1.0))
            gd_abs = float(c0g[i]) + st.pt * 1e9 / self.fs
            st.sdgd = float(np.sqrt(max(float(chi2[i]), 0.0) / max(int(cnt[i]), 1)))
            st.gd = gd_abs + 0.5 * float(c1g[i])
            st.dg = float(c1g[i])
            st.pt_prev = st.pt
            # wrap by one code period (the reference writes pt unguarded,
            # rxcomplex.cpp:744; a negative pt would be clamped by the
            # slice and mis-align the next second)
            st.pt = int(
                np.round((gd_abs + float(c1g[i])) * self.fs / 1e9)
            ) % b.nobs
            st.pk = float(pk_mean[i])
            st.last_phi = float(last_phi_new[i])
            if st.is_first:
                st.is_first = False
                self._log(log_line("code lock   ", cfg, int(cnt[i]), b.bps))
                continue
            px = float(px_rows[self._buf_idx[i]])
            rep = SecondReport(
                fc_hz=st.fc + st.df,
                phi_cycles=st.phi,
                cnt=int(cnt[i]),
                gd_ns=st.gd,
                dg_ns_per_s=st.dg,
                sdgd_ns=st.sdgd,
                pk_dbm=_v2_to_dbm(st.pk),
                pnoise_dbm=_v2_to_dbm(max(px - st.pk, 1e-30)),
                locked=True,
            )
            reports[i] = rep
            if self.out_dir:
                path = os.path.join(self.out_dir, dat_filename(cfg))
                with open(path, "a") as f:
                    f.write(rep.row(b.nobs / self.fs) + "\n")

    def _log(self, line: str) -> None:
        self.log.append(line)
        if self.out_dir:
            with open(os.path.join(self.out_dir, "rxcomplex.log"), "a") as f:
                f.write(line + "\n")


class MultiBankReceiver:
    """Heterogeneous-geometry receiver: one banked program per geometry.

    The banked receiver requires homogeneous (nobs, codes/s, nlag)
    geometry because the lag-bank and phase-table shapes are static per
    program.  ``sdr.param`` permits per-channel chip rates and filter
    settings (``rxcomplex.cpp:272-285``), so a mixed configuration is
    legal; here the channels partition into homogeneous GROUPS, each
    tracked by its own :class:`BankedReceiver` — k batched passes per
    second for k geometries instead of a per-channel host loop.

    Keyword arguments (``device`` included) go to every group's
    receiver.  Reports, ``channels`` and ``log`` present in the caller's original
    channel order.  Limitation: SIC reconstruction only sees channels
    within the same group (cross-group MAI cancellation would couple
    the groups' state; the reference's SIC block is single-geometry in
    practice, ``rxcomplex.cpp:506-520``).
    """

    def __init__(
        self,
        channels: list[ChannelConfig],
        fs: float = 5e6,
        **kw,
    ):
        self.fs = fs
        groups: dict[tuple, list[int]] = {}
        for i, c in enumerate(channels):
            sps = int(round(fs / c.chip_rate))
            key = (c.code_len * sps, c.codes_per_second, c.nlag)
            groups.setdefault(key, []).append(i)
        self.n_channels = len(channels)
        self._order: list[list[int]] = []
        self.receivers: list[BankedReceiver] = []
        for idxs in groups.values():
            self._order.append(idxs)
            self.receivers.append(
                BankedReceiver([channels[i] for i in idxs], fs=fs, **kw)
            )

    @property
    def channels(self):
        out = [None] * self.n_channels
        for idxs, rx in zip(self._order, self.receivers):
            for j, i in enumerate(idxs):
                out[i] = rx.channels[j]
        return out

    @property
    def states(self):
        out = [None] * self.n_channels
        for idxs, rx in zip(self._order, self.receivers):
            for j, i in enumerate(idxs):
                out[i] = rx.states[j]
        return out

    @property
    def log(self):
        out: list[str] = []
        for rx in self.receivers:
            out.extend(rx.log)
        return out

    def process_second(self, iq_by_phys):
        reports = [None] * self.n_channels
        for idxs, rx in zip(self._order, self.receivers):
            sub = rx.process_second(iq_by_phys)
            for j, i in enumerate(idxs):
                reports[i] = sub[j]
        return reports
