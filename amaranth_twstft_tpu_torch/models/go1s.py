"""The go_1s session workflow: four archives per session -> ``.1s`` products.

Directory-level behavior of ``acquisition/go_1s.m:73-268``:

- scan the OP directory for loopback archives (``localclaudio<ts>_2``);
  the site's remote archive is the ``local``->``remote``, ``_2``->``_1``
  name substitution (``go_1s.m:101-103``); the LTFB pair is matched by
  timestamp decade (``dir(['LTFB/',name(1:21),'*'])``, ``go_1s.m:124``),
- per archive: amplitude gating (|xval1| > max/2, drop the first 11
  codes, truncate at the first gap; ``go_1s.m:80-91``), loopback
  sample-loss trim (2 ns jump, ``go_1s.m:94-101``), remote re-gating on
  the loopback's epoch set (``go_1s.m:108-121``; the LTFB branch adds
  the "truncated2" tail rule of ``go_1s.m:164-169``),
- common-length truncation of the four series (``go_1s.m:176-182``),
- the two-way solve with outlier NaN-ing and the 200 ns ambiguity fold
  (:mod:`amaranth_twstft_tpu_torch.models.twoway`),
- session dating from the LTFB capture name's unix timestamp
  (``go_1s.m:131-133``),
- per-second linear-fit midpoints written as ``<mjd>.1s`` text files,
  byte-compatible with ``go_1s.m:251-268`` (including the reference's
  ``LTBBremote`` header typo).

The port's NumPy copy of the JAX package's ``models/go1s.py``: host
post-processing of a session's archives, with no device work.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from amaranth_twstft_tpu_torch.models.twoway import (
    GatingPolicy,
    TwoWaySolution,
    gate_epochs,
    solve_session,
    trim_sample_loss,
)
from amaranth_twstft_tpu_torch.utils import matio
from amaranth_twstft_tpu_torch.utils.mjd import julian_day, timestamp_from_name

__all__ = [
    "SessionFiles",
    "find_sessions",
    "site_delays",
    "go1s_mjd",
    "write_1s_file",
    "process_sessions",
    "append_summary",
    "read_summary",
    "SUMMARY_NAME",
]

#: Campaign summary table: one row per processed session, appended as
#: sessions complete — the multi-day series the reference reassembles
#: from per-record ``.txt`` tables (``gofinal_ltfb.m:84-91``) and plots
#: in ``go_1s.m:356-429``; here a single machine-readable product.
SUMMARY_NAME = "go1s_summary.txt"

_SUMMARY_COLS = (
    "mjd", "res_mean_ns", "res_std_ns", "res25_mean_ns", "res25_std_ns",
    "filtered_std_ns", "n_flagged", "snr_op_db", "snr_lt_db", "n_codes",
    # carrier-phase-refined columns (rxcomplex.cpp:702-744 refinement
    # applied as carrier smoothing; nan when refinement is disabled)
    "res_refined_mean_ns", "res25_refined_std_ns",
    # per-site remote-series slope diagnostics (240527 go.m:78-84)
    "slope_op_ns_s", "slope_lt_ns_s",
)


def append_summary(out_dir: str, row: dict) -> str:
    """Append one session's summary row to ``go1s_summary.txt``.

    Tab-separated with a commented header; a session (keyed by mjd) that
    is already present is not duplicated — re-runs are idempotent like
    the ``.1s`` writer.
    """
    path = os.path.join(out_dir, SUMMARY_NAME)
    existing = {r["mjd"] for r in read_summary(path)}
    if round(float(row["mjd"]), 6) in existing:
        return path
    is_new = not os.path.exists(path)
    with open(path, "a") as f:
        if is_new:
            f.write("# " + "\t".join(_SUMMARY_COLS) + "\n")
        f.write(
            "\t".join(
                f"{int(row[c])}" if c in ("n_flagged", "n_codes")
                else f"{float(row.get(c, float('nan'))):.6f}"
                for c in _SUMMARY_COLS
            )
            + "\n"
        )
    return path


def read_summary(path: str) -> list[dict]:
    """Read a ``go1s_summary.txt`` back into summary dicts (the
    round-trip of :func:`append_summary`); missing file -> []."""
    if not os.path.exists(path):
        return []
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = line.split("\t")
            # accept pre-refinement rows (10 cols) as well
            if len(vals) not in (len(_SUMMARY_COLS), 12, 10):
                continue
            row = {c: float("nan") for c in _SUMMARY_COLS}
            for c, v in zip(_SUMMARY_COLS, vals):
                row[c] = int(v) if c in ("n_flagged", "n_codes") else float(v)
            row["mjd"] = round(row["mjd"], 6)
            rows.append(row)
    return rows


@dataclass(frozen=True)
class SessionFiles:
    """The four archives of one 5-minute session."""

    op_lo: str
    op_re: str
    lt_lo: str
    lt_re: str
    ts_op: int
    ts_lt: int


def _remote_name(local_name: str) -> str:
    """``strrep(strrep(name,'local','remote'),'_2','_1')`` (go_1s.m:101)."""
    return local_name.replace("local", "remote").replace("_2", "_1")


def find_sessions(op_dir: str, lt_dir: str) -> list[SessionFiles]:
    """Pair the four archives of every complete session.

    OP loopback archives drive the scan (``dl=dir('OP/lo*gz')``,
    ``go_1s.m:72``); LTFB is matched by timestamp decade — the reference
    matches on ``name(1:21)``, i.e. all but the last digit of the 10-digit
    unix timestamp (``go_1s.m:124``).
    """
    sessions: list[SessionFiles] = []
    lt_files = sorted(os.listdir(lt_dir)) if os.path.isdir(lt_dir) else []
    lt_by_decade: dict[int, list[str]] = {}
    for name in lt_files:
        if not name.startswith("local"):
            continue
        ts = timestamp_from_name(name)
        if ts is not None:
            lt_by_decade.setdefault(ts // 10, []).append(name)
    for name in sorted(os.listdir(op_dir)):
        if not name.startswith("local"):
            continue
        ts = timestamp_from_name(name)
        if ts is None:
            continue
        op_lo = os.path.join(op_dir, name)
        op_re = os.path.join(op_dir, _remote_name(name))
        if not os.path.exists(op_re):
            continue
        for lt_name in lt_by_decade.get(ts // 10, []):
            lt_lo = os.path.join(lt_dir, lt_name)
            lt_re = os.path.join(lt_dir, _remote_name(lt_name))
            if os.path.exists(lt_re):
                sessions.append(
                    SessionFiles(
                        op_lo=op_lo,
                        op_re=op_re,
                        lt_lo=lt_lo,
                        lt_re=lt_re,
                        ts_op=ts,
                        ts_lt=timestamp_from_name(lt_name) or ts,
                    )
                )
                break
    return sessions


def site_delays(
    lo_path: str,
    re_path: str,
    fs: float,
    nint: int = 1,
    policy: GatingPolicy = GatingPolicy(),
    tail_rule: bool = False,
    return_xval: bool = False,
):
    """One site's (loopback, remote) delay series in ns (``go_1s.m:78-175``).

    The loopback archive defines the epoch set ``k`` (amplitude gate +
    sample-loss trim); the remote archive is indexed at ``k`` and re-gated
    on its own amplitude, truncating ``k`` (and the loopback) at the first
    gap.  ``tail_rule=True`` adds the LTFB branch's extra truncation when
    the remote gate covers fewer epochs than the loopback series
    (``go_1s.m:164-169``).  Returns ``(lo_ns, re_ns, snr_med_db)`` or
    None when the session is unusable (< 102 usable codes, go_1s.m:100).
    ``return_xval=True`` appends the gated complex peaks
    ``(xval_lo, xval_re)`` for the carrier-phase refinement
    (``rxcomplex.cpp:702-744`` via
    :func:`amaranth_twstft_tpu_torch.models.twoway.carrier_smooth_delays`).
    """
    lo = matio.load_result(lo_path)
    if "xval1" not in lo["raw"]:
        return None
    xval_lo = lo["raw"]["xval1"].ravel()
    ind_lo = lo["raw"]["indice1"].ravel()
    cor_lo = lo["raw"]["correction1"].ravel()
    k = gate_epochs(xval_lo, policy)
    if len(k) == 0:
        return None
    lo_samp = ind_lo[k] + cor_lo[k] / (2 * nint + 1)
    lo_ns = lo_samp / fs * 1e9
    lo_ns = trim_sample_loss(lo_ns, policy)
    k = k[: len(lo_ns)]
    if len(lo_ns) <= 102:  # go_1s.m:100 usability gate
        return None

    re = matio.load_result(re_path)
    if "xval1" not in re["raw"]:
        return None  # other-producer format / empty remote archive
    xval_all = re["raw"]["xval1"].ravel()
    if len(xval_all) <= int(k.max(initial=0)):
        # remote archive shorter than the loopback's gated epoch set
        # (truncated capture): unusable, same path as the loopback gate
        return None
    xval_re = xval_all[k]
    kkk = np.flatnonzero(
        np.abs(xval_re) > np.abs(xval_re).max() * policy.amplitude_ratio
    )
    gaps = np.flatnonzero(np.diff(kkk) > 1)
    if len(gaps):
        # reference-faithful: go_1s.m:108-118 keeps the FIRST kkkk(1)
        # entries of k (count, not position — leading remote-gate
        # failures stay in; ``k=k(1:kkkk(1))``)
        cut = gaps[0] + 1
        k = k[:cut]
        lo_ns = lo_ns[: min(cut, len(lo_ns))]
    if tail_rule and len(kkk) < len(lo_ns):
        # go_1s.m:164-169 "truncated2": the remote gate's last epoch
        # bounds the series
        cut = kkk[-1] + 1 if len(kkk) else 0
        k = k[:cut]
        lo_ns = lo_ns[:cut]
    ind_re = re["raw"]["indice1"].ravel()
    cor_re = re["raw"]["correction1"].ravel()
    re_ns = (ind_re[k] + cor_re[k] / (2 * nint + 1)) / fs * 1e9
    re_ns = re_ns[: len(lo_ns)]
    lo_ns = lo_ns[: len(re_ns)]
    snr_med = float(
        np.median(
            10.0
            * np.log10(
                np.abs(
                    re["raw"]["SNR1r"].ravel()[k] + re["raw"]["SNR1i"].ravel()[k]
                )
                * fs
            )
        )
    )
    if return_xval:
        n = len(lo_ns)
        return lo_ns, re_ns, snr_med, xval_lo[k][:n], xval_re[: len(k)][:n]
    return lo_ns, re_ns, snr_med


def go1s_mjd(ts_unix: float) -> float:
    """Session date stamp (``go_1s.m:131-133``): the capture-name unix
    timestamp as a julian day, ``- 2400000.5 + 0.5 - 8.4e-2`` (the
    reference's empirical backdating of the name timestamp to the session
    midpoint)."""
    import datetime

    dt = datetime.datetime.fromtimestamp(ts_unix, datetime.timezone.utc)
    frac_day = (dt.hour + dt.minute / 60.0 + dt.second / 3600.0) / 24.0
    jd = julian_day(dt.year, dt.month, dt.day + frac_day)
    return jd - 2400000.5 + 0.5 - 8.4e-2


def _mjd_name(mjd0: float) -> str:
    """File stem for a session MJD, Octave ``num2str`` style (~9
    significant digits, trailing zeros trimmed).  A 6-digit ``%g`` would
    bucket MJDs at 0.1-day resolution and silently collide two
    same-day sessions 2 h apart (the reference names with
    ``num2str(ladate(p))``, ``go_1s.m:251``)."""
    return f"{mjd0:.10g}"


def write_1s_file(
    out_dir: str,
    mjd0: float,
    op_lo: np.ndarray,
    op_re: np.ndarray,
    lt_lo: np.ndarray,
    lt_re: np.ndarray,
    codes_per_second: int = 25,
    suffix: str = ".1s",
) -> str:
    """``<mjd>.1s`` per-second product file (``go_1s.m:251-268``).

    Header and row formats are byte-compatible with the reference,
    including its ``LTBBremote`` header typo; one row per full second,
    each column the per-second linear fit evaluated at the window
    midpoint.  ``suffix=".1sc"`` writes the carrier-smoothed variant
    (same format, different extension so the reference-compatible
    ``.1s`` remains untouched)."""
    from amaranth_twstft_tpu_torch.models.twoway import one_second_products

    rows = one_second_products(
        mjd0, op_lo, op_re, lt_lo, lt_re, codes_per_second
    )
    path = os.path.join(out_dir, _mjd_name(mjd0) + suffix)
    with open(path, "w") as f:
        f.write("# MJD\t\tOPlocal\tOPremote\tLTFBlocal\tLTBBremote\n")
        for r in rows:
            f.write(f"{r[0]:f}\t{r[1]:f}\t{r[2]:f}\t{r[3]:f}\t{r[4]:f}\n")
    return path


def process_sessions(
    op_dir: str,
    lt_dir: str,
    out_dir: str | None = None,
    fs: float = 5e6,
    nint: int = 1,
    policy: GatingPolicy = GatingPolicy(),
    gen_1s: bool = True,
    verbose: bool = False,
    write_summary: bool = True,
    f_carrier_hz: float | None = 70e6,
) -> list[dict]:
    """The full session loop (``go_1s.m:73-323``): scan, load four
    archives, gate, solve, write ``.1s`` products.  Idempotent: sessions
    whose ``.1s`` file already exists are skipped when ``gen_1s``.

    Returns one summary dict per processed session (mjd, res mean/std,
    25-point mean/std, notch-filtered std, SNR medians, file paths);
    ``write_summary`` also appends each row to ``go1s_summary.txt`` in
    ``out_dir`` (:func:`append_summary`) so a multi-day campaign series
    is reconstructable from outputs alone.

    ``f_carrier_hz`` (default: the system's 70 MHz IF) enables the
    carrier-phase refinement: each channel's gated ``xval`` peaks are
    run through the DLL/PLL receiver's unwrap + weighted-slope loop
    (``rxcomplex.cpp:702-744``) as carrier smoothing
    (:func:`amaranth_twstft_tpu_torch.models.twoway.carrier_smooth_delays`),
    the session is re-solved on the smoothed series, the summary gains
    ``res_refined_mean_ns`` / ``res25_refined_std_ns`` and a parallel
    ``<mjd>.1sc`` per-second file is written (same row format as the
    ``.1s``; the ``.1s`` itself stays byte-compatible with the
    reference).  ``None`` disables refinement (columns become nan).
    """
    from amaranth_twstft_tpu_torch.models.twoway import carrier_smooth_delays

    out_dir = out_dir or op_dir
    results = []
    for ses in find_sessions(op_dir, lt_dir):
        mjd0 = go1s_mjd(ses.ts_lt)
        out_path = os.path.join(out_dir, _mjd_name(mjd0) + ".1s")
        if gen_1s and os.path.exists(out_path):
            continue
        op = site_delays(ses.op_lo, ses.op_re, fs, nint, policy,
                         return_xval=True)
        lt = site_delays(
            ses.lt_lo, ses.lt_re, fs, nint, policy, tail_rule=True,
            return_xval=True,
        )
        if op is None or lt is None:
            if verbose:
                print(f"skipping unusable session {ses.ts_op}")
            continue
        op_lo, op_re, snr_op, op_xlo, op_xre = op
        lt_lo, lt_re, snr_lt, lt_xlo, lt_xre = lt
        # common-length truncation (go_1s.m:176-182)
        n = min(len(op_lo), len(lt_lo))
        op_lo, op_re, lt_lo, lt_re = (
            op_lo[:n], op_re[:n], lt_lo[:n], lt_re[:n]
        )
        sol: TwoWaySolution = solve_session(
            op_lo, op_re, lt_lo, lt_re, ses.ts_lt, policy
        )
        from amaranth_twstft_tpu_torch.models.twoway import session_slope

        slope_op, _ = session_slope(op_re, policy.codes_per_second)
        slope_lt, _ = session_slope(lt_re, policy.codes_per_second)
        sol_ref: TwoWaySolution | None = None
        if f_carrier_hz:
            cps = float(policy.codes_per_second)
            smoothed = [
                carrier_smooth_delays(d[:n], x[:n], f_carrier_hz, cps)
                for d, x in (
                    (op_lo, op_xlo), (op_re, op_xre),
                    (lt_lo, lt_xlo), (lt_re, lt_xre),
                )
            ]
            sol_ref = solve_session(*smoothed, ses.ts_lt, policy)
        path = None
        if gen_1s:
            path = write_1s_file(
                out_dir, mjd0, op_lo, op_re, lt_lo, lt_re,
                policy.codes_per_second,
            )
            if sol_ref is not None:
                write_1s_file(
                    out_dir, mjd0, *smoothed, policy.codes_per_second,
                    suffix=".1sc",
                )
        if verbose:
            print(
                f"{ses.ts_op}: mjd={mjd0:.4f} res={sol.res_mean:+.3f}"
                f"+-{sol.res_std:.3f} ns (1s: {sol.res25_std:.3f})"
            )
        row = dict(
            mjd=mjd0,
            res_mean_ns=sol.res_mean,
            res_std_ns=sol.res_std,
            res25_mean_ns=sol.res25_mean,
            res25_std_ns=sol.res25_std,
            filtered_std_ns=sol.filtered_std,
            n_flagged=sol.n_flagged,
            snr_op_db=snr_op,
            snr_lt_db=snr_lt,
            n_codes=n,
            res_refined_mean_ns=(
                sol_ref.res_mean if sol_ref else float("nan")
            ),
            res25_refined_std_ns=(
                sol_ref.res25_std if sol_ref else float("nan")
            ),
            slope_op_ns_s=slope_op,
            slope_lt_ns_s=slope_lt,
            one_s_path=path,
            files=ses,
        )
        if write_summary:
            row["summary_path"] = append_summary(out_dir, row)
        results.append(row)
    return results
