"""Two-way solver: from per-epoch archives to clock-offset products.

The TWSTFT observable: with ``lo`` = loopback delay and ``re`` = remote
(one-way) delay at each site,

    tw = 0.5 * ((OPre - OPlo) - (LTFBre - LTFBlo))

(``acquisition/go_1s.m:192``, ``processing/Octave/tw.m:37``,
``experiments/230315_analysis_100k/README.md:14-16``).  This module
implements the production robustness policies as explicit, tested
functions rather than the reference's scattered in-script patches
(SURVEY.md §7.3 "Ambiguity handling"):

- peak-amplitude gating: keep epochs with |xval| > max/2, drop the first
  11 codes, truncate at the first gap (``go_1s.m:80-91,109-118``),
- loopback sample-loss trim: cut at the first >2 ns jump (``go_1s.m:94-101``),
- SNR gating: keep rows within 10 dB of max (``gofinal_ltfb.m:52``,
  ``tw.m:31-34``),
- outlier NaN-ing: |res - median| > 5 ns (``go_1s.m:193-194``),
- the 200 ns sample ambiguity: fold residuals exceeding median +/- 10 ns
  by one interpolated-sample period 200/(2N+1) ns (``go_1s.m:207-211``),
- 1 s wraparound: add 1 s when the re-lo mean goes negative (``tw.m:35-36``),
- products: per-second linear-fit midpoints (``go_1s.m:251-268``),
  25-point sliding means (``go_1s.m:269-274``), dominant-spectral-line
  notch (``go_1s.m:279-290``), all MJD-stamped.

The port's copy of the JAX package's ``models/twoway.py``.  It is host
post-processing over a session's decoded archives and does no device
work: everything is NumPy, and :func:`carrier_phase_refine` runs the
receiver's unwrap scan and robust fits on CPU float64 tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from amaranth_twstft_tpu_torch.utils.mjd import mjd_from_unix

__all__ = [
    "GatingPolicy",
    "gate_epochs",
    "trim_sample_loss",
    "snr_gate",
    "fold_sample_ambiguity",
    "twoway_residual",
    "one_second_products",
    "sliding_mean",
    "notch_dominant_line",
    "TwoWaySolution",
    "solve_session",
    "carrier_phase_refine",
    "session_slope",
    "carrier_smooth_delays",
    "cn0_dbhz",
    "ranging_detrend",
    "pair_rows_by_time",
]


@dataclass(frozen=True)
class GatingPolicy:
    """All numeric policies of the production chain, in one place."""

    amplitude_ratio: float = 0.5  # |xval| > max/2 (go_1s.m:80)
    drop_first: int = 11  # first 275 ms (go_1s.m:86)
    loopback_jump_ns: float = 2.0  # sample-loss jump (go_1s.m:94)
    outlier_ns: float = 5.0  # median outlier NaN gate (go_1s.m:193)
    flag_ns: float = 3.0  # "PROBLEM NG" flag level (go_1s.m:235)
    snr_window_db: float = 10.0  # max(SNR)-10 keep (gofinal_ltfb.m:52)
    ambiguity_ns: float = 200.0 / 3.0  # one interpolated sample, N=1
    ambiguity_gate_ns: float = 10.0  # fold gate (go_1s.m:207-211)
    codes_per_second: int = 25

    @staticmethod
    def for_signal(signal, nint: int = 1, **overrides) -> "GatingPolicy":
        """Policy scaled to a signal geometry.

        The reference's numeric levels are written for its Ts = 200 ns
        sample period (``go_1s.m:10``): the ambiguity is one
        interpolated sample ``Ts/(2N+1)`` and the jump/outlier/flag/gate
        levels are fractions of Ts.  At any other ``fs`` those absolute
        nanosecond constants are meaningless (a "2 ns sample-loss jump"
        cannot detect the loss of a 10 us sample), so every
        Ts-derived level scales by ``Ts/200 ns``; the production
        geometry maps to the defaults exactly.  ``overrides`` replace
        individual fields afterwards.
        """
        ts_ns = 1e9 / signal.fs
        r = ts_ns / 200.0
        kw = dict(
            loopback_jump_ns=2.0 * r,
            outlier_ns=5.0 * r,
            flag_ns=3.0 * r,
            ambiguity_ns=ts_ns / (2 * nint + 1),
            ambiguity_gate_ns=10.0 * r,
            codes_per_second=int(round(signal.fs / signal.samples_per_code)),
        )
        kw.update(overrides)
        return GatingPolicy(**kw)


def gate_epochs(xval: np.ndarray, policy: GatingPolicy = GatingPolicy()):
    """Indices of usable epochs: |xval| above half the peak, first 11
    dropped, truncated at the first gap (``go_1s.m:80-91``)."""
    mag = np.abs(xval)
    k = np.flatnonzero(mag > mag.max() * policy.amplitude_ratio)
    if len(k) == 0:
        return k
    gaps = np.flatnonzero(np.diff(k) > 1)
    if len(gaps):
        k = k[policy.drop_first : gaps[0] + 1]
    else:
        k = k[policy.drop_first : -1] if len(k) > policy.drop_first else k[:0]
    return k


def trim_sample_loss(delay_ns: np.ndarray,
                     policy: GatingPolicy = GatingPolicy()) -> np.ndarray:
    """Cut the series at the first loopback jump > 2 ns (``go_1s.m:94-101``).

    Faithful to the reference's guard: when the jump sits at the very
    first step (``kk == 1``), its ``if (kk > 1)`` skips the trim and
    the whole series passes through (``go_1s.m:98-100``); downstream
    outlier NaN-ing absorbs it.
    """
    jumps = np.flatnonzero(np.abs(np.diff(delay_ns)) > policy.loopback_jump_ns)
    if len(jumps) and jumps[0] > 0:
        return delay_ns[: jumps[0]]
    return delay_ns


def snr_gate(snr_db: np.ndarray, policy: GatingPolicy = GatingPolicy()):
    """Rows within ``snr_window_db`` of the max (``gofinal_ltfb.m:52``)."""
    return np.flatnonzero(snr_db > snr_db.max() - policy.snr_window_db)


def fold_sample_ambiguity(res_ns: np.ndarray,
                          policy: GatingPolicy = GatingPolicy()) -> np.ndarray:
    """Fold residuals escaping by one interpolated-sample period.

    ``res(res > median+10) -= 200/(2N+1); res(res < median-10) += ...``
    (``go_1s.m:207-211``; the reference's second ``ki`` uses ``>`` by
    typo — the intended symmetric fold is implemented here and flagged
    as a deliberate deviation).
    """
    res = res_ns.copy()
    med = np.nanmedian(res)
    # both masks BEFORE mutating: folding down first and then testing
    # the mutated values would fold those elements straight back up,
    # silently undoing the positive-side fold (review r5)
    up = res > med + policy.ambiguity_gate_ns
    down = res < med - policy.ambiguity_gate_ns
    res[up] -= policy.ambiguity_ns
    res[down] += policy.ambiguity_ns
    return res


def twoway_residual(
    op_re: np.ndarray,
    op_lo: np.ndarray,
    lt_re: np.ndarray,
    lt_lo: np.ndarray,
    policy: GatingPolicy = GatingPolicy(),
) -> np.ndarray:
    """``res = 0.5*((opre-oplo)-(ltre-ltlo))`` with median-outlier NaN-ing
    (``go_1s.m:192-194``).  Inputs in ns, equal length."""
    res = 0.5 * ((op_re - op_lo) - (lt_re - lt_lo))
    bad = np.abs(res - np.nanmedian(res)) > policy.outlier_ns
    res = res.copy()
    res[bad] = np.nan
    return res


def sliding_mean(x: np.ndarray, n: int = 25) -> np.ndarray:
    """25-point (1 s) sliding mean, trimmed like ``conv(...)(25:end-25)``
    (``go_1s.m:269-274``)."""
    c = np.convolve(x, np.ones(n) / n, mode="full")
    return c[n - 1 : -n]


def notch_dominant_line(res: np.ndarray) -> tuple[np.ndarray, float, float]:
    """Remove the dominant spectral line of the residual (``go_1s.m:279-290``).

    Returns (filtered, line_bin, line_amplitude); the line position is the
    argmax of the positive-frequency half (bounded to 400 bins like the
    reference), and the reference's EXACT window — bins
    ``[peak-2, peak]``, i.e. skewed one bin low of center
    (``resf(half-2+fftmax : half+fftmax) = 0``, ``go_1s.m:284-285``) —
    is zeroed; a non-bin-centered line leaks into ``peak+1``, which the
    reference (and therefore this) leaves in.
    """
    n = len(res)
    base = res - res.mean()
    spec = np.fft.fftshift(np.fft.fft(base))
    half = n // 2
    hi = min(half + 400, n) if n > 800 else n
    seg = np.abs(spec[half:hi])
    k = int(np.argmax(seg))
    amp = float(seg[k])
    spec2 = np.fft.fftshift(np.fft.fft(res))
    lo = half - 2 + k
    spec2[max(lo, 0) : half + k + 1] = 0
    filtered = np.real(np.fft.ifft(np.fft.ifftshift(spec2)))
    return filtered, float(k), amp


def one_second_products(
    mjd0: float,
    op_lo: np.ndarray,
    op_re: np.ndarray,
    lt_lo: np.ndarray,
    lt_re: np.ndarray,
    codes_per_second: int = 25,
) -> np.ndarray:
    """Per-second linear-fit midpoints, MJD-stamped (``go_1s.m:251-268``).

    Returns rows [mjd, oplo, opre, ltlo, ltre] (ns), one per full second.
    """
    n = codes_per_second
    rows = []
    cpt = 0
    for k in range(0, len(op_re) - n, n):
        t = (np.arange(k, k + n)) / n
        row = [mjd0 + cpt / 86400.0]
        for series in (op_lo, op_re, lt_lo, lt_re):
            seg = series[k : k + n]
            good = ~np.isnan(seg)
            if good.sum() < 2:
                row.append(np.nan)
                continue
            a, b = np.polyfit(t[good], seg[good], 1)
            row.append(a * t[n // 2] + b)  # midpoint value (go_1s.m:260)
        rows.append(row)
        cpt += 1
    return np.asarray(rows)


@dataclass
class TwoWaySolution:
    """One session's two-way products."""

    res_ns: np.ndarray  # per-code residual, NaN-gated
    res_mean: float
    res_std: float
    res25_mean: float
    res25_std: float
    mjd: float
    n_flagged: int  # |res-mean| > 3 ns count (go_1s.m:235-238)
    one_second: np.ndarray  # rows [mjd, oplo, opre, ltlo, ltre]
    filtered_std: float  # after dominant-line notch


def solve_session(
    op_lo_ns: np.ndarray,
    op_re_ns: np.ndarray,
    lt_lo_ns: np.ndarray,
    lt_re_ns: np.ndarray,
    capture_end_unix: float,
    policy: GatingPolicy = GatingPolicy(),
) -> TwoWaySolution:
    """Full go_1s-style solve of one session (inputs already gated, in ns,
    equal sampling; lengths are truncated to the common minimum like
    ``go_1s.m:176-182``)."""
    n = min(map(len, (op_lo_ns, op_re_ns, lt_lo_ns, lt_re_ns)))
    op_lo, op_re = op_lo_ns[:n], op_re_ns[:n]
    lt_lo, lt_re = lt_lo_ns[:n], lt_re_ns[:n]

    res = twoway_residual(op_re, op_lo, lt_re, lt_lo, policy)
    # REFERENCE-FAITHFUL ORDER: outliers are NaN'd (inside
    # twoway_residual) BEFORE the ambiguity fold, exactly as
    # go_1s.m:193-194 precede :207-211 — so a whole-cluster one-sample
    # slip (66.7 ns >> the 5 ns outlier gate) is NaN'd rather than
    # folded, in the reference and here alike (its Octave median over
    # NaNs additionally deadens the fold; np.nanmedian keeps ours live
    # for the no-outlier case).
    res = fold_sample_ambiguity(res, policy)
    flagged = int(np.sum(np.abs(res - np.nanmean(res)) > policy.flag_ns))

    res25 = sliding_mean(np.nan_to_num(res, nan=np.nanmean(res)),
                         policy.codes_per_second)
    mjd0 = mjd_from_unix(capture_end_unix) - n / policy.codes_per_second / 86400.0
    one_s = one_second_products(
        mjd0, op_lo, op_re, lt_lo, lt_re, policy.codes_per_second
    )
    if n > 50:
        filtered, _, _ = notch_dominant_line(
            np.nan_to_num(res, nan=np.nanmean(res))
        )
        fstd = float(np.std(filtered))
    else:
        fstd = float(np.nanstd(res))
    return TwoWaySolution(
        res_ns=res,
        res_mean=float(np.nanmean(res)),
        res_std=float(np.nanstd(res)),
        res25_mean=float(np.mean(res25)) if len(res25) else float("nan"),
        res25_std=float(np.std(res25)) if len(res25) else float("nan"),
        mjd=mjd0,
        n_flagged=flagged,
        one_second=one_s,
        filtered_std=fstd,
    )


def carrier_phase_refine(
    xval: np.ndarray,
    epochs_per_second: float = 25.0,
    sigma_gate: float = 3.0,
) -> dict:
    """Carrier-phase refinement from the complex correlation peaks.

    The DLL/PLL receiver refines frequency and phase from the per-code
    carrier phases (``rxcomplex.cpp:702-744``): phase of each peak in
    cycles, sequential BPSK half-cycle ambiguity unwrap (each phase is
    folded by 0.5-cycle steps to within 0.25 of the previous accepted
    one, :702-720), median/IQR 3-sigma outlier weights (:699-700), then
    a weighted linear fit phase ~ phi0 + df*t whose slope is the refined
    frequency (:728-731).  Applied here to the two-way chains' saved
    ``xval`` peaks (BASELINE configs[2]: "per-second time offsets with
    carrier-phase refinement").

    Returns ``{"phi_cycles", "weights", "phi0_cycles", "df_hz", "sigma"}``.
    """
    import torch

    from amaranth_twstft_tpu_torch.models.dllpll import _phase_unwrap_scan
    from amaranth_twstft_tpu_torch.ops.peaks import (
        median_iqr_sigma,
        weighted_linear_fit,
    )

    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))  # noqa: E731
    xval = np.asarray(xval)
    n = len(xval)
    phi = np.angle(xval) / (2.0 * np.pi)  # cycles in (-0.5, 0.5]
    # the receiver's half-cycle unwrap scan, shared (all weights 1:
    # every phase participates, exactly the loop this replaced)
    unwrapped = _phase_unwrap_scan(
        f64(phi), f64(np.ones(n)), f64(phi[0] if n else 0.0)
    ).numpy()
    med, sig = median_iqr_sigma(f64(unwrapped))
    med, sig = float(med), float(sig)
    if sig == 0.0:
        w = np.ones(n)
    else:
        w = (np.abs(unwrapped - med) < sigma_gate * sig).astype(float)
    t = np.arange(n) / epochs_per_second
    c0, c1, _ = weighted_linear_fit(f64(t), f64(unwrapped), f64(w))
    return {
        "phi_cycles": unwrapped,
        "weights": w,
        "phi0_cycles": float(c0),
        "df_hz": float(c1),  # cycles/s = Hz
        "sigma": sig,
    }


def session_slope(
    series_ns: np.ndarray, codes_per_second: int = 25
) -> tuple[float, float]:
    """Per-session slope diagnostic of a delay series (the 240527
    campaign's ``go.m:78-84``): quadratic polyfit over epoch time, the
    LINEAR coefficient is the signal slope (``slopeltfb = u(2)``, ns/s),
    and the 25-point-smoothed detrended residual std
    (``stdltfb = std(conv(rslope - v.yf, ones(25,1)/25))``) is the
    session noise figure.  NaNs are ignored; returns (nan, nan) when
    fewer than 3 finite points remain.
    """
    s = np.asarray(series_ns, float)
    good = np.isfinite(s)
    if good.sum() < 3:
        return float("nan"), float("nan")
    t = np.arange(len(s)) / float(codes_per_second)
    coef = np.polyfit(t[good], s[good], 2)
    resid = s[good] - np.polyval(coef, t[good])
    sm = sliding_mean(resid, 25)
    if len(sm) == 0:
        sm = resid
    return float(coef[1]), float(np.std(sm))


def carrier_smooth_delays(
    delay_ns: np.ndarray,
    xval: np.ndarray,
    f_carrier_hz: float,
    epochs_per_second: float = 25.0,
    sigma_gate: float = 3.0,
) -> np.ndarray:
    """Carrier-smoothed delay series (ns) from the complex peaks.

    The code-tracking delay series is noisy at the correlator level; the
    carrier phase of the same peaks measures the delay FLUCTUATION far
    more finely (one cycle at the 70 MHz IF = 14.3 ns, and the phase
    resolves milli-cycles at loopback SNR) but is ambiguous in absolute
    cycles.  Classic carrier smoothing, built on the DLL/PLL receiver's
    refinement loop (``rxcomplex.cpp:702-744``: half-cycle unwrap,
    median/IQR 3-sigma weights, weighted linear fit — all via
    :func:`carrier_phase_refine`):

    - the CODE series contributes the absolute level and linear drift
      (a weighted linear fit over the epoch axis),
    - the CARRIER contributes the sub-second fluctuation about that
      drift: the detrended unwrapped phase residual, converted at
      ``delta_tau = -resid_cycles / f_carrier`` (a longer path rotates
      the peak phase negative at the carrier),
    - epochs the refinement flags as outliers fall back to the code
      trend (resid = 0).

    Returns the smoothed series, same length/units as ``delay_ns``.
    """
    delay_ns = np.asarray(delay_ns, float)
    n = len(delay_ns)
    if n < 3:
        return delay_ns.copy()
    ref = carrier_phase_refine(
        xval, epochs_per_second=epochs_per_second, sigma_gate=sigma_gate
    )
    t = np.arange(n) / epochs_per_second
    resid = ref["phi_cycles"] - (ref["phi0_cycles"] + ref["df_hz"] * t)
    resid = np.where(ref["weights"] > 0, resid, 0.0)
    # code-trend fit (NaN-safe): absolute level + linear drift
    good = np.isfinite(delay_ns)
    if good.sum() < 2:
        return delay_ns.copy()
    a, b = np.polyfit(t[good], delay_ns[good], 1)
    trend = a * t + b
    return trend + (-resid[:n] / f_carrier_hz) * 1e9


def cn0_dbhz(snr_r: np.ndarray, snr_i: np.ndarray, fs: float) -> float:
    """Carrier-to-noise density C/N0 in dB·Hz.

    ``median(10*log10(abs(SNRr+SNRi)*fs))`` (``go_1s.m:124``) — the
    per-sample SNR estimator scaled by the sample rate; the campaign
    operating point is ~44-57 dB·Hz (``go_1s.m:420-429``, SURVEY.md §6).
    """
    return float(np.median(10.0 * np.log10(np.abs(snr_r + snr_i) * fs)))


def ranging_detrend(delay_re_s: np.ndarray, delay_lo_s: np.ndarray,
                    drop_first: int = 9) -> dict:
    """Ranging-only daily statistic (``processing/Octave/ranging.m:23-31``).

    ``res = col10 - col7`` (remote minus loopback delay, seconds), first 9
    rows dropped, quadratic detrend, std in ns; also the reference's
    ``mean(1-res)`` report.
    """
    res = np.asarray(delay_re_s) - np.asarray(delay_lo_s)
    res = res[drop_first:]
    if len(res) < 3:
        return {"ok": False, "reason": "too few rows"}
    t = np.arange(1, len(res) + 1, dtype=float)
    coef = np.polyfit(t, res, 2)
    detrended = res - np.polyval(coef, t)
    return {
        "ok": True,
        "std_ns": float(np.std(detrended) * 1e9),
        "mean_one_minus": float(np.mean(1.0 - res)),
        "n": int(len(res)),
    }


def pair_rows_by_time(a_rows: np.ndarray, b_rows: np.ndarray,
                      max_offset_s: int = 180):
    """Integer-second alignment of two gofinal row tables by the
    month*31+day pseudo-time (``tw.m:16-28``, ``ranging.m:11-21``).

    Returns (a, b, offset) truncated to a common window, or None if the
    offset exceeds ``max_offset_s``.

    REFERENCE QUIRK (reproduced verbatim): the pseudo-time formula
    weighs days by 24 but hours AND minutes both by 60
    (``tempsop=((((m*31+d)*24)+h*60)+mi*60)+s``, ``tw.m:16-17`` — the
    intended ``(((m*31+d)*24+h)*60+mi)*60+s`` was mis-parenthesized in
    the reference), so the difference is NOT seconds; it is used only
    as the row-shift count and the <180 pairing gate, exactly as the
    reference uses it.
    """
    def pseudo_t(rows):
        return (
            ((rows[0, 1] * 31 + rows[0, 2]) * 24 + rows[0, 3] * 60)
            + rows[0, 4] * 60
            + rows[0, 5]
        )

    ta, tb = pseudo_t(a_rows), pseudo_t(b_rows)
    if ta > tb:
        diff = int(ta - tb)
        b_rows = b_rows[diff:]
    else:
        diff = int(tb - ta)
        a_rows = a_rows[diff:]
    if diff >= max_offset_s:
        return None
    m = min(len(a_rows), len(b_rows))
    return a_rows[:m], b_rows[:m], diff


# ----------------------------------------------------------------------
# tw.m daily pairing (text-file level)
# ----------------------------------------------------------------------
def pair_and_solve_daily(
    op_rows: np.ndarray,
    lt_rows: np.ndarray,
    policy: GatingPolicy = GatingPolicy(),
) -> dict:
    """The archived daily solver on gofinal-format row tables.

    Rows: [y m d h m s, delay_lo, df1, SNR1, delay_lo2, df2, SNR2,
    delay_re, df1rem, SNR1rem] — columns 10/13 (1-based) are the local
    and remote delays (``tw.m:35-37``), column 9 the gating SNR.

    Implements integer-second alignment by the (month*31+day)*86400-ish
    pseudo-time of ``tw.m:16-28``, SNR trimming, the +1 s wraparound fix
    and the residual statistics.
    """
    def pseudo_t(rows):
        return (
            ((rows[:, 1] * 31 + rows[:, 2]) * 24 + rows[:, 3] * 60)
            + rows[:, 4] * 60
            + rows[:, 5]
        )

    top, tlt = pseudo_t(op_rows), pseudo_t(lt_rows)
    if top[0] > tlt[0]:
        diff = int(top[0] - tlt[0])
        lt_rows = lt_rows[diff:]
        m = min(len(op_rows), len(lt_rows))
        op_rows, lt_rows = op_rows[:m], lt_rows[:m]
    else:
        diff = int(tlt[0] - top[0])
        op_rows = op_rows[diff:]
        m = min(len(op_rows), len(lt_rows))
        op_rows, lt_rows = op_rows[:m], lt_rows[:m]
    if diff >= 180:
        return {"ok": False, "reason": f"time offset {diff} s too large"}
    if len(op_rows) == 0 or len(lt_rows) == 0:
        # offset under the 180 s gate but beyond a table's row count
        # (e.g. a truncated capture): nothing overlaps
        return {"ok": False, "reason": "no overlapping rows after "
                "pseudo-time alignment"}

    # SNR criterion on col 9 (0-based 8), both stations (tw.m:31-34)
    for rows_pair in range(2):
        rows = (lt_rows, op_rows)[rows_pair]
        k = np.flatnonzero(rows[:, 8] > rows[:, 8].max() - policy.snr_window_db)
        if len(k) < 3:
            return {"ok": False, "reason": "SNR gate removed everything"}
        sl = slice(k[0] + 1, k[-1])
        lt_rows, op_rows = lt_rows[sl], op_rows[sl]

    lt_lo, lt_re = lt_rows[:, 9].copy(), lt_rows[:, 12].copy()
    op_lo, op_re = op_rows[:, 9].copy(), op_rows[:, 12].copy()
    # 1-s wraparound (tw.m:35-36)
    if np.mean(lt_lo - lt_re) < 0:
        lt_lo += 1.0
    if np.mean(op_lo - op_re) < 0:
        op_lo += 1.0
    res = 0.5 * ((lt_lo - lt_re) - (op_lo - op_re))
    keep = np.abs(res) < 1e-6  # seconds (tw.m:38)
    res = res[keep] * 1e9
    return {
        "ok": True,
        "res_ns": res,
        "mean_ns": float(np.mean(res)) if len(res) else float("nan"),
        "std_ns": float(np.std(res)) if len(res) else float("nan"),
    }
