"""Estimator-validation studies — the reference's simulation campaigns
(torch).

The port's copy of the JAX package's ``studies.py``, with the same twelve
public names.  The reference validates its SNR estimators and
interpolation choices with synthetic sweeps (``experiments/221127_SNR/
simu_snr.m``, ``experiments/221127_SNR/interpolation_effect.m``,
``experiments/2209_SNR_simulations/simu_snr.m``; theory in
``experiments/221127_SNR/README.md:1-27``).  Conclusions encoded here and
asserted by ``tests/test_torch_studies.py``:

- the **despreading estimator** ("claudio", ``mean(x·c)^2 / var(x·c)``)
  tracks the true SNR across the whole range — it is the production
  estimator (``godual_ranging.m:44-48``);
- the **cross-correlation estimator** (peak² over correlation-floor
  variance) saturates at high SNR: the code's autocorrelation self-noise
  rises above the additive noise (README:20-24);
- code/correlation **interpolation factors do not change** the
  despreading estimate (``interpolation_effect.m:14-31``) — which is why
  the production chain interpolates only for *timing*, never for SNR.

Two groups: the device-free studies are NumPy, copied as they are; the
studies that run the correlator (:func:`qpsk_vs_bpsk_study`,
:func:`code_length_study`, :func:`timing_interpolation_study`,
:func:`gotracking_slope_study`) and the FFT chains of
:func:`f16_ingest_error_study` take ``device`` (``None`` is the card,
``"cpu"`` the host).  Inputs are synthesized on the host with NumPy from
the seed, as in the JAX package, and the correlator chains keep the
studies' dtypes (complex128 where the JAX package passes complex128).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from amaranth_twstft_tpu_torch.config import Modulation
from amaranth_twstft_tpu_torch.models.emitter import ChannelSim, synthesize_capture
from amaranth_twstft_tpu_torch.models.twoway import carrier_phase_refine
from amaranth_twstft_tpu_torch.ops.correlator import correlate_epochs, delay_seconds
from amaranth_twstft_tpu_torch.ops.fftutils import spectral_zoom_signal
from amaranth_twstft_tpu_torch.ops.lfsr import prn_chips
from amaranth_twstft_tpu_torch.ops.prn import (
    chips_to_pm1,
    code_spectrum,
    interp_code,
    upsample_zoh,
)
from amaranth_twstft_tpu_torch.utils.platform import resolve_device

__all__ = [
    "CODE_LENGTH_CAMPAIGN",
    "snr_despreading",
    "snr_xcorr_floor",
    "snr_estimator_sweep",
    "interpolation_effect",
    "qpsk_vs_bpsk_study",
    "slip_repair_study",
    "code_length_study",
    "timing_interpolation_study",
    "analyse_satre_series",
    "f16_ingest_error_study",
    "gotracking_slope_study",
]

#: The 221207 two-way code-length campaign's seven bitstream configurations
#: ``(bit_len, taps, code_len)`` (reference
#: ``experiments/221207_twoway_codes/README.md:10-19``).  Code lengths span
#: 5 kchip (2 ms codes) to 2.5 Mchip (the 230111 one-second code,
#: ``experiments/230111_twstft_2M5``); every sequence is the truncation of
#: the underlying m-sequence to ``code_len`` chips, exactly as the gateware
#: restarts the LFSR every ``code_len`` chips.
CODE_LENGTH_CAMPAIGN = (
    (13, 27, 5_000),
    (14, 43, 10_000),
    (15, 3, 25_000),
    (17, 9, 100_000),
    (18, 39, 250_000),
    (19, 39, 500_000),
    (22, 3, 2_500_000),
)


def snr_despreading(x: np.ndarray, code: np.ndarray) -> np.ndarray:
    """``mean(x.*c)^2 / var(x.*c)`` (``interpolation_effect.m:28``,
    ``godual_ranging.m:44-45``) — batched over leading axes of x."""
    y = x * code
    mu = np.mean(y, axis=-1)
    return mu**2 / np.var(y, axis=-1)


def snr_xcorr_floor(x: np.ndarray, code: np.ndarray) -> np.ndarray:
    """Correlation-peak SNR: ``max|xc|^2 / var(xc_floor) / sqrt(N)``
    (``interpolation_effect.m:26``).  The floor is the first half of the
    correlation away from the peak (the reference slices
    ``zc(1:end/2-10)``; with the peak at lag 0 we mask ±10 lags)."""
    n = x.shape[-1]
    xc = np.fft.ifft(
        np.fft.fft(x, axis=-1) * np.conj(np.fft.fft(code)), axis=-1
    )
    mag = np.abs(xc)
    pk = np.max(mag, axis=-1)
    pos = np.argmax(mag, axis=-1)
    k = np.arange(n)
    dist = np.abs((k[None, :] - pos[..., None] + n // 2) % n - n // 2)
    floor = np.where(dist > 10, xc, np.nan)
    var = np.nanvar(floor, axis=-1)
    return pk**2 / var / np.sqrt(n)


def snr_estimator_sweep(
    code: np.ndarray,
    snr_true: np.ndarray,
    seed: int = 0,
) -> dict:
    """One row of ``simu_snr.m``'s figure: both estimators vs truth.

    ``code`` is a ±1 PRN replica; ``snr_true`` the linear target SNRs
    (signal scaled as code/B with unit noise, ``simu_snr.m:22-27``).
    Returns dB arrays aligned with ``snr_true``.
    """
    rng = np.random.default_rng(seed)
    n = len(code)
    noise = rng.standard_normal((len(snr_true), n))
    noise = noise - noise.mean(axis=-1, keepdims=True)
    nvar = np.var(noise, axis=-1)
    scale = np.sqrt(snr_true * nvar / np.var(code))
    x = code[None, :] * scale[:, None] + noise
    return {
        "snr_th_db": 10 * np.log10(scale**2 * np.var(code) / nvar),
        "claudio_db": 10 * np.log10(snr_despreading(x, code.astype(float))),
        "xcorr_db": 10 * np.log10(np.real(snr_xcorr_floor(x, code.astype(float)))),
    }


def interpolation_effect(
    code: np.ndarray,
    factors=(1e-3, 1e-2, 1e-1, 1.0, 10.0, 100.0),
    interp_code: int = 1,
    seed: int = 3,
) -> dict:
    """``interpolation_effect.m``: the despreading estimate is invariant
    under code zero-order-hold interpolation; returns estimates for each
    noise ``factor`` (x = n/factor + c, true linear SNR = factor² · 12·
    var(c), uniform noise var 1/12)."""
    c = upsample_zoh(code.astype(float), interp_code)
    rng = np.random.default_rng(seed)
    n = rng.uniform(-0.5, 0.5, len(c))
    rows = {"factor_sq": [], "snr_claudio": [], "snr_th": []}
    for f in factors:
        x = n / f + c
        rows["factor_sq"].append(f**2)
        rows["snr_claudio"].append(float(snr_despreading(x, c)))
        rows["snr_th"].append(float(np.var(c) / np.var(n / f)))
    return {k: np.asarray(v) for k, v in rows.items()}


def _correlate(d: np.ndarray, fcode: np.ndarray, df_hz: np.ndarray,
               code_interp: np.ndarray, fs: float, dev: torch.device,
               nint: int = 1):
    """``correlate_epochs`` of host epochs ``d`` on ``dev``, in ``d``'s
    dtype (the JAX studies' ``jnp.asarray(d)``)."""
    return correlate_epochs(
        torch.as_tensor(d, device=dev),
        torch.as_tensor(fcode, device=dev),
        torch.as_tensor(df_hz, device=dev),
        torch.as_tensor(code_interp, device=dev),
        fs,
        nint=nint,
    )


def _delay_samples(res, fs: float, interp_factor: int) -> np.ndarray:
    """Per-epoch delays in samples, on the host."""
    return delay_seconds(res, fs, interp_factor).cpu().numpy() * fs


def qpsk_vs_bpsk_study(
    cfg,
    taps_b: int = 27,
    amplitude: float = 600.0,
    noise_sigma: float = 300.0,
    n_seconds: int = 1,
    seed: int = 3,
    device=None,
) -> dict[str, float]:
    """The 220822 campaign's question: does QPSK improve timing?

    Reference conclusion (``experiments/220822_qpsk_vs_bpsk/README.md:3-10``):
    **no** — at equal total transmit power each QPSK code carries 3 dB
    less, and the delay std is no better than BPSK.  Here the experiment
    is synthetic with known truth: the same channel is emitted BPSK and
    QPSK (Gray-mapped, ``mixer.py:28-34``), processed by the same
    correlator against code A on ``device``, and the per-epoch delay std
    is compared.

    Returns ``{"bpsk_std_samples", "qpsk_std_samples", "bpsk_mean",
    "qpsk_mean"}`` (delays in fractional samples).
    """
    dev = resolve_device(device)
    delay = 137.25
    chan = ChannelSim(
        delay_samples=delay, doppler_hz=40.0, amplitude=amplitude,
        noise_sigma=noise_sigma,
    )
    code = chips_to_pm1(
        upsample_zoh(
            prn_chips(cfg.bit_len, cfg.taps, cfg.code_len, cfg.seed),
            cfg.samples_per_chip,
        )
    )
    fcode = code_spectrum(code)
    code3 = interp_code(code, 3)
    L = cfg.samples_per_code

    out: dict[str, float] = {}
    for name, mod in (("bpsk", Modulation.BPSK), ("qpsk", Modulation.QPSK)):
        c = dataclasses.replace(
            cfg,
            modulation=mod,
            taps_b=taps_b if mod == Modulation.QPSK else None,
        )
        (stream,) = synthesize_capture(c, [chan], n_seconds=n_seconds, seed=seed)
        n_ep = len(stream) // L
        d = stream[: n_ep * L].reshape(n_ep, L)
        res = _correlate(d, fcode, np.full((n_ep,), 40.0), code3, cfg.fs, dev)
        dl = _delay_samples(res, cfg.fs, 3)
        out[f"{name}_mean"] = float(np.mean(dl))
        out[f"{name}_std_samples"] = float(np.std(dl))
    return out


def code_length_study(
    configs=((13, 27, 1_000), (15, 3, 4_000), (17, 9, 16_000)),
    samples_per_chip: int = 2,
    fs: float = 5e6,
    amplitude: float = 1.0,
    noise_sigma: float = 4.0,
    n_epochs: int = 48,
    delay_samples: int = 123,
    seed: int = 0,
    device=None,
) -> dict:
    """The 221207 campaign's question: how does timing precision scale
    with code length?

    The campaign flew seven bitstreams from 5 kchip to 2.5 Mchip
    (``experiments/221207_twoway_codes/README.md:10-19``,
    :data:`CODE_LENGTH_CAMPAIGN`) to measure the two-way std as a function
    of code length.  Matched-filter theory says the delay estimator std
    scales as ``1/sqrt(code_len)`` at fixed chip rate and per-sample SNR
    (longer coherent integration); the campaign's plots confirm it.  Here
    the experiment is synthetic with known truth: each configuration's
    truncated m-sequence is emitted at a fixed fractional delay with fixed
    noise, processed by the production correlator (FFT x conj(code FFT),
    3x interpolation, parabolic peak — ``godual_ranging.m:25-33``) on
    ``device``, and the per-epoch delay std is recorded.

    The epoch axis is batched into one call per configuration; defaults
    are scaled-down lengths so the study runs in seconds on the CPU.
    Pass ``configs=CODE_LENGTH_CAMPAIGN`` for the full campaign geometry
    (the 2.5 Mchip configuration holds 48 complex128 epochs of 5 M
    samples: 3.8 GB on the host, and about 12 GB per zoomed map on the
    device).

    Returns ``{"code_len", "std_samples", "mean_samples"}`` arrays aligned
    with ``configs``.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    rows = {"code_len": [], "std_samples": [], "mean_samples": []}
    for bit_len, taps, code_len in configs:
        code = chips_to_pm1(
            upsample_zoh(prn_chips(bit_len, taps, code_len), samples_per_chip)
        )
        L = len(code)
        sig = amplitude * np.roll(code, delay_samples)
        d = sig[None, :] + rng.normal(
            0, noise_sigma, (n_epochs, L)
        ) + 1j * rng.normal(0, noise_sigma, (n_epochs, L))
        res = _correlate(d, code_spectrum(code), np.zeros((n_epochs,)),
                         interp_code(code, 3), fs, dev)
        del d
        dl = _delay_samples(res, fs, 3)
        del res
        rows["code_len"].append(code_len)
        rows["std_samples"].append(float(np.std(dl)))
        rows["mean_samples"].append(float(np.mean(dl)))
    return {k: np.asarray(v) for k, v in rows.items()}


def timing_interpolation_study(
    code_len: int = 4_000,
    bit_len: int = 15,
    taps: int = 3,
    samples_per_chip: int = 2,
    fs: float = 5e6,
    noise_sigma: float = 0.2,
    n_epochs: int = 64,
    seed: int = 1,
    device=None,
) -> dict:
    """The 220830 SATRE-comparison campaign's interpolation conclusion.

    ``experiments/220830_OP/analysis.m`` (summary table at the bottom):
    correlation interpolation ``Nint > 0`` is **mandatory** for timing —
    without it the delay std inflates ~15x (6.1e-9 vs 4.0e-10 s) because
    the 3-point parabola is biased at fractional peak offsets — while
    ``Nint > 1`` brings nothing (4.5e-10 at Nint=2).

    Here each epoch carries an exact fractional delay drifting linearly
    across one full sample (frequency-domain phase-ramp synthesis, the
    fractional-offset sweep the satellite path produces over a session),
    and the same epochs are processed at Nint = 0, 1, 2 on ``device``.
    Returns ``{"nint", "std_samples", "mean_err_samples"}`` where std is
    of the (estimate - truth) error series.
    """
    dev = resolve_device(device)
    code = chips_to_pm1(
        upsample_zoh(prn_chips(bit_len, taps, code_len), samples_per_chip)
    )
    L = len(code)
    rng = np.random.default_rng(seed)
    truth = 123.0 + np.linspace(0.0, 1.0, n_epochs, endpoint=False)
    k = np.fft.fftfreq(L) * L
    fc = np.fft.fft(code)
    sig = np.fft.ifft(
        fc[None, :] * np.exp(-2j * np.pi * k[None, :] * truth[:, None] / L),
        axis=-1,
    )
    d = sig + rng.normal(0, noise_sigma, (n_epochs, L)) + 1j * rng.normal(
        0, noise_sigma, (n_epochs, L)
    )

    rows = {"nint": [], "std_samples": [], "mean_err_samples": []}
    fcode = code_spectrum(code)
    for nint in (0, 1, 2):
        res = _correlate(d, fcode, np.zeros((n_epochs,)),
                         interp_code(code, 2 * nint + 1), fs, dev, nint=nint)
        err = _delay_samples(res, fs, 2 * nint + 1) - truth
        rows["nint"].append(nint)
        rows["std_samples"].append(float(np.std(err)))
        rows["mean_err_samples"].append(float(np.mean(err)))
    return {k2: np.asarray(v) for k2, v in rows.items()}


def analyse_satre_series(
    x: np.ndarray,
    continuous: bool = False,
    outlier_s: float = 10e-9,
    smooth: int = 250,
) -> dict:
    """``analyse_satre`` cleaning policy (``experiments/220830_OP/
    analysis.m:9-40``): quadratic detrend, NaN any |residual| > 10 ns
    *and both neighbors*, drop the NaNs, and for continuous (SATRE
    250 Hz) series apply a 250-point sliding mean then decimate by 250.

    Two deliberate deviations from ``analysis.m`` (both make the policy
    stricter/simpler, neither changes any campaign conclusion):

    - an outlier at the very first/last sample is DROPPED here, while the
      Octave script trims edge indices from ``k`` before NaN-ing and so
      keeps such a sample (only its missing neighbor is spared);
    - the sliding mean uses a centered full-mode convolution sliced to
      ``n-1`` interior points, vs Octave's ``(125:end-125)`` (``n``
      points, half-window transients included at both ends).

    Returns ``{"clean": residual series (s), "std": float, "kept": mask
    into the original series}``.
    """
    t = np.arange(len(x), dtype=float)
    coef = np.polyfit(t, x, 2)
    r = x - np.polyval(coef, t)
    bad = np.abs(r) > outlier_s
    k = np.flatnonzero(bad)
    # analysis.m NaNs k-1 and k+1 too (edge indices trimmed first)
    k = k[(k > 0) & (k < len(r) - 1)]
    keep = np.ones(len(r), bool)
    keep[np.concatenate([k - 1, k, k + 1])] = False
    keep &= ~bad  # edge outliers themselves always go
    r = r[keep]
    if continuous and len(r) >= smooth:
        r = np.convolve(r, np.ones(smooth) / smooth, mode="full")[
            smooth // 2 : -(smooth // 2)
        ]
        r = r[::smooth]
    return {"clean": r, "std": float(np.std(r)), "kept": keep}


def slip_repair_study(
    n_codes: int = 600,
    slip_at: int = 300,
    slip_len: int = 25,
    slip_samples: float = -2.0,
    noise_sigma: float = 0.05,
    seed: int = 0,
) -> dict:
    """The 240527 campaign's 2-sample slip repair (``experiments/240527/
    go.m:53-59,96-106``, the ``corrige`` flag).

    The campaign saw occasional 2-sample (one chip at 2 S/chip) jumps in
    the per-code delay series; ``go.m`` detrends each series linearly,
    flags codes whose residual leaves the median by more than one sample,
    and pulls them back by 2 samples (plus the empirical +0.05 for the
    remote series).  This study reproduces the policy on a synthetic
    series with an injected slip and reports the 1 s-smoothed std with
    and without the repair — the campaign's acceptance criterion.

    Returns {"std_raw", "std_repaired", "n_flagged"} (samples).
    """
    rng = np.random.default_rng(seed)
    r = 100.0 + rng.normal(0, noise_sigma, n_codes)
    r[slip_at : slip_at + slip_len] += slip_samples  # slip .. re-seek
    t = np.arange(n_codes)

    def smoothed_std(x):
        c = np.convolve(x - x.mean(), np.ones(25) / 25.0, mode="full")
        return float(np.std(c[24:-25]))

    coef = np.polyfit(t, r, 1)
    resid = r - np.polyval(coef, t)
    flagged = np.abs(resid - np.median(resid)) > 1.0
    repaired = r.copy()
    repaired[flagged] -= slip_samples  # go.m: r(ktmp) = r(ktmp) - 2
    return {
        "std_raw": smoothed_std(r),
        "std_repaired": smoothed_std(repaired),
        "n_flagged": int(flagged.sum()),
    }


def f16_ingest_error_study(
    n_epochs: int = 1024,
    snr_db: float = -13.0,
    fs: float = 5e6,
    code_len: int = 100_000,
    bit_len: int = 17,
    taps: int = 9,
    doppler_hz: float = 130.0,
    nint: int = 1,
    seed: int = 0,
    chunk: int = 32,
    device=None,
) -> dict:
    """Delay-error distribution of the fast-ingest paths vs the float64
    oracle at the production operating point (VERDICT r02 item 3).

    The fast paths ship sc16 samples as float16 (exact below 2048,
    <=2^-11 relative above) or int8 and compute in float32 on the device.
    This study isolates both effects on the DELAY estimate over
    ``n_epochs`` independent noise draws at the ~-13 dB RF operating
    point (``experiments/221127_SNR/simu_snr.m:1-7``):

    - ``quant``: float64 chain on f16-quantized inputs vs float64 chain
      on exact int16 inputs — pure ingest-format quantization,
    - ``f32``: float32 chain on f16 inputs vs the float64/exact oracle —
      the end-to-end fast path,
    - ``int8``: float32 chain on int8-quantized inputs (per-epoch-batch
      scale ``max|x|/127``, the ``ingest_dtype="int8"`` transfer mode)
      vs the float64/exact oracle.

    Chain = GoRanging per-epoch semantics with a fixed known df (mix ->
    FFT -> x conj(code spectrum) -> (2*nint+1)x zero-pad IFFT -> argmax +
    parabolic correction).  The noise is drawn on the host with NumPy
    from ``seed``; quantization and all three chains run with torch on
    ``device`` (``torch.fft`` is cuFFT on the card; the float32 chains
    are checked to stay float32).  Returns percentile tables in ns.
    """
    dev = resolve_device(device)
    if torch.fft.fft(torch.ones(2, dtype=torch.complex64, device=dev)).dtype \
            != torch.complex64:
        raise RuntimeError("torch.fft upcasts complex64 here: the float32 "
                           "chains would measure quantization only")

    chips = prn_chips(bit_len, taps, code_len)
    code = chips_to_pm1(upsample_zoh(chips, 2), np.float64)
    L = len(code)
    fcode64_h = np.conj(np.fft.fft(code))
    fcode64 = torch.as_tensor(fcode64_h, device=dev)
    fcode32 = torch.as_tensor(fcode64_h.astype(np.complex64), device=dev)
    zoom = 2 * nint + 1
    M = zoom * L
    rng = np.random.default_rng(seed)
    # -13 dB: amplitude a over noise sigma with a^2/(2 sigma^2) = 10^-1.3
    sigma = 3000.0
    amp = sigma * np.sqrt(2.0 * 10.0 ** (snr_db / 10.0))
    t = np.arange(L) / fs
    lo = np.exp(2j * np.pi * doppler_hz * t)
    mix = torch.as_tensor(np.exp(-2j * np.pi * doppler_hz * t), device=dev)
    true_delay = 1234

    def _delays(prod):
        a = torch.abs(spectral_zoom_signal(prod, nint))
        idx = torch.argmax(a, dim=-1, keepdim=True)
        am1 = torch.gather(a, -1, torch.remainder(idx - 1, M))[:, 0]
        a0 = torch.gather(a, -1, idx)[:, 0]
        ap1 = torch.gather(a, -1, torch.remainder(idx + 1, M))[:, 0]
        corr = (am1 - ap1) / (am1 + ap1 - 2 * a0) / 2.0
        # samples on the fs grid, in float64 like NumPy's int64 + float
        return ((idx[:, 0].double() + corr.double()) / zoom).cpu().numpy()

    def _fft(x):
        return torch.fft.fft(x, dim=-1)

    deltas_q = []
    deltas_f32 = []
    deltas_i8 = []
    sig = amp * np.roll(code, true_delay) * lo
    sig_re = torch.as_tensor(sig.real, device=dev)
    sig_im = torch.as_tensor(sig.imag, device=dev)
    for c0 in range(0, n_epochs, chunk):
        b = min(chunk, n_epochs - c0)
        noise = torch.as_tensor(rng.normal(0, sigma, (b, 2, L)), device=dev)
        re = torch.round(torch.clamp(sig_re + noise[:, 0], -32768, 32767))
        im = torch.round(torch.clamp(sig_im + noise[:, 1], -32768, 32767))
        # exact ingest (float64 carries int16 exactly)
        d64 = torch.complex(re, im)
        # f16 ingest: quantize re/im separately like the packed reader
        d16 = torch.complex(re.half().double(), im.half().double())
        # int8 ingest: one scale per batch
        scale = torch.maximum(re.abs().max(), im.abs().max()) / 127.0
        d8 = torch.complex(torch.clamp(torch.round(re / scale), -127, 127) * scale,
                           torch.clamp(torch.round(im / scale), -127, 127) * scale)
        d64 = d64 - d64.mean(dim=-1, keepdim=True)
        d16 = d16 - d16.mean(dim=-1, keepdim=True)
        d8 = d8 - d8.mean(dim=-1, keepdim=True)
        ref = _delays(_fft(d64 * mix) * fcode64)
        qnt = _delays(_fft(d16 * mix) * fcode64)
        f32 = _delays(_fft((d16 * mix).to(torch.complex64)) * fcode32)
        i8 = _delays(_fft((d8 * mix).to(torch.complex64)) * fcode32)
        deltas_q.append(qnt - ref)
        deltas_f32.append(f32 - ref)
        deltas_i8.append(i8 - ref)

    def _stats(d):
        d_ns = np.abs(np.concatenate(d)) / fs * 1e9
        return {
            "p50_ns": float(np.percentile(d_ns, 50)),
            "p90_ns": float(np.percentile(d_ns, 90)),
            "p99_ns": float(np.percentile(d_ns, 99)),
            "max_ns": float(d_ns.max()),
            "n": int(d_ns.size),
        }

    return {"quant": _stats(deltas_q), "f32": _stats(deltas_f32),
            "int8": _stats(deltas_i8),
            "snr_db": snr_db, "amp": amp, "sigma": sigma}


def gotracking_slope_study(
    n_seconds: int = 20,
    fs: float = 1e5,
    code_len: int = 5_000,
    bit_len: int = 13,
    taps: int = 27,
    f_carrier_hz: float = 70e6,
    slope_s_per_s: float = 3e-12,
    df_lo_hz: float = 4.0,
    amplitude: float = 2000.0,
    noise_sigma: float = 30.0,
    seed: int = 0,
    device=None,
) -> dict:
    """Loopback carrier-tracking slope study (``gotracking_inv2.m``).

    The 230503 campaign tracks the loopback channel with a DLL/PLL and
    reads the **signal-delay slope** off the carrier phase; its top chart
    is quoted in 1e-13 s/s, "defining the noise on the correlation time
    delay" (``experiments/230503_100kchips_withcode/README.md:3``,
    ``gotracking_inv2.m:150-210`` PLL discriminator + slope readout).

    Synthetic loopback with a known delay drift ``tau(t) = tau0 +
    slope*t`` whose carrier phase term ``-f_carrier*tau(t)`` is embedded
    per epoch, processed by the per-epoch chain (correlate at the known
    LO -> complex peak) on ``device``, then the DLL/PLL refinement loop
    (:func:`models.twoway.carrier_phase_refine`) per 1 s window reads
    the carrier slope and converts it back to s/s.  Returns the
    recovered per-second slope series, its mean error vs the injected
    drift, the measured 1 s noise floor, and the sqrt(L)-scaled
    extrapolation to the production code length (the loopback floor the
    campaign measured at L=200 000).
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    chips = prn_chips(bit_len, taps, code_len)
    code = chips_to_pm1(upsample_zoh(chips, 2), np.float64)
    L = len(code)
    eps = int(fs) // L  # epochs (codes) per second
    n_ep = n_seconds * eps
    t_in = np.arange(L) / fs
    delay0 = 423
    sig_base = amplitude * np.roll(code, delay0)
    # per-epoch carrier phase: phi_i = df_lo*t_i - f_carrier*tau(t_i)
    t_ep = np.arange(n_ep) * (L / fs)
    tau = slope_s_per_s * t_ep  # tau0 folds into a constant phase
    phi = -f_carrier_hz * tau
    d = np.empty((n_ep, L), np.complex128)
    for i in range(n_ep):
        lo = np.exp(2j * np.pi * (df_lo_hz * (t_ep[i] + t_in) + phi[i]))
        d[i] = (sig_base * lo
                + rng.normal(0, noise_sigma, L)
                + 1j * rng.normal(0, noise_sigma, L))
    res = _correlate(d, code_spectrum(code), np.full(n_ep, df_lo_hz),
                     interp_code(code, 3), fs, dev)
    xval = res.xval.cpu().numpy()  # complex peak per epoch
    # phase-continuous downconversion (rxcomplex.cpp:592-600): the
    # godual-style correlator restarts its mixing ramp every epoch, so
    # the inter-epoch LO phase df_lo*t_ep survives in the peaks; remove
    # it like the receiver's continuous NCO would (the study knows the
    # LO exactly — in the field the residual LO-estimate error adds a
    # constant slope bias the campaign cannot separate from true drift,
    # which is why its chart reads as a NOISE floor)
    xval = xval * np.exp(-2j * np.pi * df_lo_hz * t_ep)

    # per-second carrier slope via the refinement loop, mapped to s/s
    slopes = np.empty(n_seconds)
    for s in range(n_seconds):
        ref = carrier_phase_refine(
            xval[s * eps : (s + 1) * eps], epochs_per_second=eps
        )
        # residual carrier slope (cycles/s) = -f_carrier * d tau/dt
        slopes[s] = -ref["df_hz"] / f_carrier_hz
    floor = float(np.std(slopes))
    prod_L = 200_000
    return {
        "slopes_s_per_s": slopes,
        "slope_mean": float(np.mean(slopes)),
        "slope_true": slope_s_per_s,
        "noise_floor_s_per_s": floor,
        "floor_production_extrapolated": floor * np.sqrt(L / prod_L),
        "epochs_per_second": eps,
        "L": L,
    }
