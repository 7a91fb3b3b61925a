"""Per-record -> text extraction (``processing/Octave/gofinal_ltfb.m``).

Turns one session's local + remote archives into the MJD-dated text table
consumed by the daily solver (``tw.m``):

- accepts either producer's field convention via
  :func:`amaranth_twstft_tpu_torch.utils.matio.load_result`
  (``gofinal_ltfb.m:35-45``),
- epochs are dated backwards from the capture-end timestamp
  (``gofinal_ltfb.m:49``: ``dateini = date_end - n_epochs``),
- rows are SNR-gated to max(SNR)-10 dB (``gofinal_ltfb.m:52``),
- when the detrended two-channel difference is noisy (> 1 us std), the
  5 ns/s drift disambiguation keeps the larger of two clusters anchored
  at epochs 30-40 vs 140-150 (``gofinal_ltfb.m:55-66``),
- output rows: ``datetime  delay  df1  SNR1  delay2  df2  SNR2
  delayrem  df1rem  SNR1rem`` (``gofinal_ltfb.m:84-91``),
- already-extracted sessions are skipped (``gofinal_ltfb.m:32,92-93``).

The port's NumPy copy of the JAX package's ``models/gofinal.py``: host
post-processing of the archives, with no device work.  The header row
keeps the reference's ``\\r\\n`` ending beside ``\\n`` data rows.
"""

from __future__ import annotations

import os

import numpy as np

from amaranth_twstft_tpu_torch.utils import matio
from amaranth_twstft_tpu_torch.utils.mjd import datestr_utc, timestamp_from_name

__all__ = ["drift_disambiguate", "extract_session", "write_rows", "read_rows"]


def drift_disambiguate(res: np.ndarray, indices: np.ndarray,
                       threshold_s: float = 1e-6,
                       window_s: float = 1e-5) -> np.ndarray:
    """The 5 ns/s cluster disambiguation (``gofinal_ltfb.m:55-66``).

    ``res`` is the per-epoch (measurement - loopback) delay in seconds at
    the gated ``indices``.  If its quadratic detrend leaves > 1 us of
    scatter, keep whichever of two 10-us clusters (anchored at positions
    30-40 and 140-150) is larger.
    """
    if len(res) < 3:
        return indices
    t = np.arange(len(res))
    coeff = np.polyfit(t, res, 2)
    detrended = res - np.polyval(coeff, t)
    if np.std(detrended) <= threshold_s:
        return indices
    if len(res) < 150:
        return indices
    k1 = np.flatnonzero(np.abs(res - np.mean(res[30:40])) < window_s)
    k2 = np.flatnonzero(np.abs(res - np.mean(res[140:150])) < window_s)
    if len(k1) == 0 or len(k2) == 0:
        return indices
    keep = k1 if len(k1) > len(k2) else k2
    return indices[keep]


def extract_session(
    local_mat: str,
    remote_mat: str,
    capture_end_unix: float | None = None,
    fs: float = 5e6,
    interp_factor: int = 3,
    epoch_seconds: float = 1.0,
    out_txt: str | None = None,
    snr_window_db: float = 10.0,
) -> dict | None:
    """One session -> gated, dated rows (and optionally the text file).

    Returns None if ``out_txt`` exists (idempotent resume).
    """
    if out_txt and os.path.exists(out_txt):
        return None
    if capture_end_unix is None:
        ts = timestamp_from_name(os.path.basename(local_mat))
        if ts is None:
            raise ValueError(f"no timestamp in {local_mat} and none given")
        capture_end_unix = float(ts)

    lo = matio.load_result(local_mat)
    re = matio.load_result(remote_mat)

    sol1 = lo["solution1"] / interp_factor / fs  # measurement (s)
    sol2 = lo.get("solution2")
    if sol2 is None:
        raise ValueError(f"{local_mat} is not a dual-channel archive")
    sol2 = sol2 / interp_factor / fs  # loopback (s)
    snr1 = lo["snr1_db"]
    snr2 = lo["snr2_db"]
    df1 = lo.get("df1", np.zeros_like(sol1))
    df2 = lo.get("df2", np.zeros_like(sol1))
    solr = re["solution1"] / interp_factor / fs
    snrr = re["snr1_db"]
    dfr = re.get("df1", np.zeros_like(solr))

    n = min(len(sol1), len(solr))
    date_ini = capture_end_unix - n * epoch_seconds  # gofinal_ltfb.m:49

    k = np.flatnonzero(snr1[:n] > snr1[:n].max() - snr_window_db)
    res = sol1[k] - sol2[k]
    k = drift_disambiguate(res, k)

    rows = []
    for p in k:
        rows.append(
            (
                datestr_utc(date_ini + p * epoch_seconds),
                sol1[p],
                float(df1[p]) if p < len(df1) else 0.0,
                float(snr1[p]),
                sol2[p],
                float(df2[p]) if p < len(df2) else 0.0,
                float(snr2[p]),
                solr[p],
                float(dfr[p]) if p < len(dfr) else 0.0,
                float(snrr[p]),
            )
        )
    if out_txt:
        write_rows(out_txt, rows)
    return {"rows": rows, "indices": k, "date_ini": date_ini}


def write_rows(path: str, rows: list[tuple]) -> None:
    """``gofinal_ltfb.m:86-91`` row format.

    The mixed line endings are the reference's own: its header fprintf
    literally ends ``\\r\\n`` while every data row ends ``\\n``
    (``gofinal_ltfb.m:86`` vs ``:88``) — byte compatibility requires
    reproducing that."""
    with open(path, "w") as f:
        f.write(
            "% y  m  d  h  m  s\tdelay\t\tdf1\tSNR1\tdelay2\tdf2\tSNR2"
            "\tdelayrem\t\tdf1rem\tSNR1rem\r\n"
        )
        for r in rows:
            f.write(
                f"{r[0]}\t{r[1]:.12f}\t{r[2]:.3f}\t{r[3]:.1f}"
                f"\t{r[4]:.12f}\t{r[5]:.3f}\t{r[6]:.1f}"
                f"\t{r[7]:.12f}\t{r[8]:.3f}\t{r[9]:.1f}\n"
            )


def read_rows(path: str) -> np.ndarray:
    """Load a gofinal text table into the (n, 15) numeric matrix the daily
    solver consumes (6 date columns + 9 data columns, ``tw.m:11-16``)."""
    rows = []
    with open(path) as f:
        for line in f:
            if line.startswith("%") or not line.strip():
                continue
            rows.append([float(x) for x in line.split()])
    return np.asarray(rows)
