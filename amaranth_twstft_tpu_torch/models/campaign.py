"""Campaign-level products: step corrections, text series, figures.

The reference's campaign tail (``acquisition/go_1s.m:356-429``) takes the
per-session summary arrays and

- folds the 25-point residual means into the half sample-ambiguity
  window (``s = mod(resmean25, 200/(2N+1)/2); s(s>10) -= ...``,
  ``go_1s.m:359-360``),
- applies **hard-coded per-MJD step corrections** (+6.5 ns after MJD
  60904, -5.5+1.29 ns after 60926.5 — operator-entered calibration
  steps after hardware interventions, ``go_1s.m:361-365``),
- saves the text series ``ladate`` / ``resmean25`` / ``resmean252``
  (``go_1s.m:390-393``),
- draws the campaign figures: residual-vs-MJD errorbars, C/N0 per site
  with a 44 dB·Hz display gate (``go_1s.m:420-429``).

Here the step corrections are an explicit, operator-supplied table
(:class:`StepCorrection`) instead of in-code patches, the series writer
is idempotent, and the figure is optional (matplotlib, Agg backend).

The port's NumPy copy of the JAX package's ``models/campaign.py``: host
post-processing with no device work; matplotlib is imported only inside
:func:`plot_campaign`.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

__all__ = [
    "StepCorrection",
    "load_corrections",
    "fold_half_window",
    "apply_step_corrections",
    "campaign_series",
    "write_campaign_series",
    "plot_campaign",
]


@dataclass(frozen=True)
class StepCorrection:
    """One operator-entered calibration step: sessions dated strictly
    after ``mjd_after`` get ``offset_ns`` added (``go_1s.m:361-365``
    behavior; steps accumulate in table order)."""

    mjd_after: float
    offset_ns: float


def load_corrections(path: str) -> list[StepCorrection]:
    """Read a correction table: JSON ``[[mjd, ns], ...]`` /
    ``[{"mjd_after": ..., "offset_ns": ...}, ...]``, or whitespace rows
    ``<mjd> <offset_ns>`` (``#`` comments allowed)."""
    with open(path) as f:
        text = f.read()
    stripped = text.lstrip()
    out: list[StepCorrection] = []
    if stripped.startswith("[") or stripped.startswith("{"):
        data = json.loads(text)
        if isinstance(data, dict):
            data = [data]  # a single bare correction object
        for item in data:
            if isinstance(item, dict):
                out.append(StepCorrection(float(item["mjd_after"]),
                                          float(item["offset_ns"])))
            else:
                out.append(StepCorrection(float(item[0]), float(item[1])))
        return out
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        mjd, ns = line.split()[:2]
        out.append(StepCorrection(float(mjd), float(ns)))
    return out


def fold_half_window(
    series_ns: np.ndarray,
    nint: int = 1,
    fold_above_ns: float = 10.0,
    ambiguity_ns: float = 200.0,
) -> np.ndarray:
    """The reference's display fold (``go_1s.m:359-360``):
    ``s = mod(series, half)`` with ``half = ambiguity/(2*nint+1)/2``,
    then values above ``fold_above_ns`` are shifted down one half-window
    (the mean rides near the ambiguity edge across sessions)."""
    half = ambiguity_ns / (2 * nint + 1) / 2.0
    s = np.mod(np.asarray(series_ns, float), half)
    s = np.where(s > fold_above_ns, s - half, s)
    return s


def apply_step_corrections(
    mjd: np.ndarray,
    series_ns: np.ndarray,
    corrections: list[StepCorrection] | tuple = (),
) -> np.ndarray:
    """Apply each correction: ``series[mjd > mjd_after] += offset_ns``
    in table order (steps accumulate, ``go_1s.m:361-365``)."""
    s = np.asarray(series_ns, float).copy()
    mjd = np.asarray(mjd, float)
    for c in corrections:
        s[mjd > c.mjd_after] += c.offset_ns
    return s


def campaign_series(
    rows: list[dict],
    nint: int = 1,
    corrections: list[StepCorrection] | tuple = (),
    fold: bool = True,
) -> dict:
    """Summary rows (``go1s.read_summary``) -> campaign series arrays.

    Returns ``ladate`` (MJD), ``resmean25`` (folded + step-corrected
    25-point mean, the reference's headline series), ``resmean25_raw``,
    ``resstd25``, ``resmean25_refined`` (carrier-refined variant, nan
    where refinement was off), ``snr_op`` / ``snr_lt`` (C/N0 medians).
    Rows are sorted by MJD; sessions flagged unusable by the reference's
    ``resmean == 0`` outlier rule are dropped (``go_1s.m:344``).
    """
    rows = sorted(rows, key=lambda r: r["mjd"])
    lad = np.array([r["mjd"] for r in rows])
    raw = np.array([r["res25_mean_ns"] for r in rows])
    keep = raw != 0.0  # go_1s.m:344 outlier convention
    lad, raw = lad[keep], raw[keep]
    std25 = np.array([r["res25_std_ns"] for r in rows])[keep]
    snr_op = np.array([r["snr_op_db"] for r in rows])[keep]
    snr_lt = np.array([r["snr_lt_db"] for r in rows])[keep]
    refined = np.array([
        r.get("res_refined_mean_ns", float("nan")) for r in rows
    ])[keep]
    slope_op = np.array([
        r.get("slope_op_ns_s", float("nan")) for r in rows
    ])[keep]
    slope_lt = np.array([
        r.get("slope_lt_ns_s", float("nan")) for r in rows
    ])[keep]
    s = fold_half_window(raw, nint) if fold else raw.copy()
    s = apply_step_corrections(lad, s, corrections)
    # refined overlay rides the SAME fold/step decisions as the code
    # series (refinement moves the mean by at most picoseconds; folding
    # the two independently could land a near-edge session in different
    # half-windows and fake a ~33 ns separation)
    sr = s + (refined - raw)
    return {
        "ladate": lad,
        "resmean25": s,
        "resmean25_raw": raw,
        "resstd25": std25,
        "resmean25_refined": sr,
        "snr_op": snr_op,
        "snr_lt": snr_lt,
        "slope_op": slope_op,
        "slope_lt": slope_lt,
    }


def write_campaign_series(out_dir: str, series: dict) -> list[str]:
    """The ``save -text ladate/resmean25`` products (``go_1s.m:390-393``)
    as one-value-per-line text files, plus a combined ``campaign.tsv``.
    Existing files are overwritten (the series grows as sessions land).
    """
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name in ("ladate", "resmean25", "resmean25_refined"):
        p = os.path.join(out_dir, f"{name}.txt")
        np.savetxt(p, np.asarray(series[name]), fmt="%.6f")
        paths.append(p)
    keys = ("ladate", "resmean25", "resmean25_raw", "resstd25",
            "resmean25_refined", "snr_op", "snr_lt", "slope_op",
            "slope_lt")
    p = os.path.join(out_dir, "campaign.tsv")
    with open(p, "w") as f:
        f.write("# " + "\t".join(keys) + "\n")
        for i in range(len(series["ladate"])):
            f.write("\t".join(f"{float(series[k][i]):.6f}" for k in keys)
                    + "\n")
    paths.append(p)
    return paths


def plot_campaign(series: dict, path: str, cn0_gate_db: float = 44.0) -> str:
    """The campaign figure (``go_1s.m:356-429`` panels that survive a
    file deliverable): residual-vs-MJD errorbars and per-site C/N0 with
    the reference's 44 dB·Hz display gate.  Requires matplotlib (Agg);
    one y-axis per panel, identity encoded by fixed hue + legend.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # fixed categorical order (slot1 blue = OP, slot2 orange = LTFB);
    # neutral ink for text, recessive grid
    c_op, c_lt = "#2a78d6", "#eb6834"
    ink, muted = "#0b0b0b", "#52514e"
    lad = series["ladate"] - 60000.0
    have_slopes = np.isfinite(
        series.get("slope_op", np.array([np.nan]))
    ).any()
    n_panels = 3 if have_slopes else 2
    fig, axes = plt.subplots(
        n_panels, 1, figsize=(8, 3 * n_panels), sharex=True,
        gridspec_kw={"hspace": 0.25},
    )
    ax1, ax2 = axes[0], axes[-1]
    ax1.errorbar(lad, series["resmean25"], yerr=series["resstd25"],
                 fmt="o", ms=4, lw=1.2, color=c_op, ecolor=muted,
                 capsize=2, label="two-way @ 1 s")
    if np.isfinite(series["resmean25_refined"]).any():
        ax1.plot(lad, series["resmean25_refined"], "s", ms=3.5,
                 color=c_lt, label="carrier-refined")
    ax1.set_ylabel("TWSTFT delay (ns) @ 1 s", color=ink)
    ax1.legend(frameon=False, fontsize=9)
    snr_op = np.where(series["snr_op"] >= cn0_gate_db,
                      series["snr_op"], np.nan)
    snr_lt = np.where(series["snr_lt"] >= cn0_gate_db,
                      series["snr_lt"], np.nan)
    ax2.plot(lad, snr_op, "-o", ms=4, lw=1.5, color=c_op, label="OP")
    ax2.plot(lad, snr_lt, "-o", ms=4, lw=1.5, color=c_lt, label="LTFB")
    ax2.set_ylim(40, 57)
    ax2.set_ylabel("C/N0 (dB·Hz)", color=ink)
    ax2.set_xlabel("MJD - 60000 (days)", color=ink)
    ax2.legend(frameon=False, fontsize=9, loc="lower left")
    if have_slopes:
        # the reference's slope panel (go.m:78-84 / go_1s.m figure 3:
        # per-site remote-series slope, +/-10 ns/s display window)
        axs = axes[1]
        axs.plot(lad, series["slope_op"], "-o", ms=4, lw=1.5,
                 color=c_op, label="OP")
        axs.plot(lad, series["slope_lt"], "-o", ms=4, lw=1.5,
                 color=c_lt, label="LTFB")
        axs.set_ylim(-10, 10)
        axs.set_ylabel("slope (ns/s)", color=ink)
        axs.legend(frameon=False, fontsize=9)
    for ax in axes:
        ax.grid(True, color="#e6e5e1", lw=0.6)
        ax.tick_params(colors=muted, labelsize=9)
        for s in ("top", "right"):
            ax.spines[s].set_visible(False)
    fig.savefig(path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return path
