"""MAT-file output matching both reference producers' field conventions.

(NumPy/SciPy; the port's copy of the JAX package's ``utils/matio.py``.)

The downstream two-way chain accepts either producer's files and detects
which by the presence of an ``indice1`` field (Octave producer: separate
``indice1`` + ``correction1``; C producer: ``correction1`` already holds
``indice + correction``) — institutionalized at
``processing/Octave/gofinal_ltfb.m:35-45``.  We can emit both so the
reference Octave downstream can consume our output directly (SURVEY.md
§7.1), plus gzipped variants (``goprocess.sh`` gzips archives; ``go_1s.m``
loads ``*.mat.gz``).
"""

from __future__ import annotations

import gzip
import os
import shutil
from typing import Any

import numpy as np
import scipy.io as sio

__all__ = [
    "save_octave_style",
    "save_c_style",
    "save_claudio_style",
    "load_result",
    "gzip_file",
]


def _col(x) -> np.ndarray:
    """Column vector like Octave's default orientation."""
    a = np.asarray(x)
    return a.reshape(-1, 1)


def save_octave_style(path: str, ch1: dict, ch2: dict | None, code=None) -> None:
    """Fields of ``godual_ranging.m:128``: ``corr* df1 df2 indic* SNR*
    code puissan*`` with 1-based ``indice``.

    ``ch*`` dicts carry 0-based ``indice`` plus ``correction``, ``snr_r``,
    ``snr_i``, ``df``, ``puissance``, ``puissance_code``, ``puissance_noise``.
    """
    md: dict[str, Any] = {
        "indice1": _col(np.asarray(ch1["indice"]) + 1.0),
        "correction1": _col(ch1["correction"]),
        "SNR1r": _col(ch1["snr_r"]),
        "SNR1i": _col(ch1["snr_i"]),
        "df1": _col(ch1["df"]),
        "puissance1": _col(ch1["puissance"]),
        "puissance1code": _col(ch1["puissance_code"]),
        "puissance1noise": _col(ch1["puissance_noise"]),
    }
    if ch2 is not None:
        md.update(
            indice2=_col(np.asarray(ch2["indice"]) + 1.0),
            correction2=_col(ch2["correction"]),
            SNR2r=_col(ch2["snr_r"]),
            SNR2i=_col(ch2["snr_i"]),
            df2=_col(ch2["df"]),
            puissance2=_col(ch2["puissance"]),
            puissance2code=_col(ch2["puissance_code"]),
            puissance2noise=_col(ch2["puissance_noise"]),
        )
    if code is not None:
        md["code"] = _col(np.asarray(code, dtype=np.float64))
    sio.savemat(path, md)


def save_c_style(path: str, ch1: dict, ch2: dict | None) -> None:
    """Fields of ``GoRanging::save`` (``processing/CPP/main.cpp:540-651``):
    ``correction1`` = 0-based indice + correction (``main.cpp:310``), scalar
    ``SNR1`` in dB, complex ``xval1``/``xval1m1``/``xval1p1``."""

    def chan(d: dict, i: int) -> dict:
        snr_db = 10.0 * np.log10(np.asarray(d["snr_r"]) + np.asarray(d["snr_i"]))
        return {
            f"correction{i}": _col(
                np.asarray(d["indice"], dtype=np.float64) + np.asarray(d["correction"])
            ),
            f"SNR{i}": _col(snr_db),
            f"df{i}": _col(d["df"]),
            f"puissance{i}": _col(d["puissance"]),
            f"puissance{i}code": _col(d["puissance_code"]),
            f"xval{i}": _col(np.asarray(d["xval"], dtype=np.complex128)),
            f"xval{i}m1": _col(np.asarray(d["xvalm1"], dtype=np.complex128)),
            f"xval{i}p1": _col(np.asarray(d["xvalp1"], dtype=np.complex128)),
        }

    md = chan(ch1, 1)
    if ch2 is not None:
        md.update(chan(ch2, 2))
    sio.savemat(path, md)


def save_claudio_style(path: str, ch: dict, code=None, moved=None,
                       carry_trimmed=None) -> None:
    """Fields of ``claudio_...separate.m:207``: ``corr* df indic* SNR*
    code puissan* xval* moved*`` — per-code arrays, ``indice`` on the
    non-interpolated (1-based) grid, ``xval1`` complex, ``moved`` the
    slip-epoch list.  ``carry_trimmed`` (the epochs at which the resident
    path trimmed a piled-up carry) is written only when non-empty, so an
    archive without a trim has exactly the reference's fields."""
    md: dict[str, Any] = {
        "indice1": _col(np.asarray(ch["indice"], dtype=np.float64)),
        "correction1": _col(ch["correction"]),
        "SNR1r": _col(ch["snr_r"]),
        "SNR1i": _col(ch["snr_i"]),
        "df": _col(ch["df"]),
        "puissance1": _col(ch["puissance"]),
        "xval1": _col(np.asarray(ch["xval"], dtype=np.complex128)),
        "moved": _col(np.asarray(moved if moved is not None else [], dtype=np.float64)),
    }
    if carry_trimmed:
        md["carry_trimmed"] = _col(np.asarray(carry_trimmed, dtype=np.float64))
    if code is not None:
        md["code"] = _col(np.asarray(code, dtype=np.float64))
    sio.savemat(path, md)


def load_result(path: str) -> dict:
    """Load either producer's file, normalizing to combined solutions.

    Mirrors the dual-format handling of ``gofinal_ltfb.m:35-45``: returns
    ``solution{1,2}`` = indice + correction on the interpolated grid
    (Octave files: ``(indice1-1) + correction1`` back to 0-based; C files:
    ``correction1`` as-is) and ``snr{1,2}_db``.
    """
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            md = sio.loadmat(f)
    else:
        md = sio.loadmat(path)
    out: dict[str, Any] = {"raw": md}
    has_indice = "indice1" in md

    def one(i: int):
        if f"correction{i}" not in md:
            return
        corr = md[f"correction{i}"].ravel()
        if has_indice:
            sol = (md[f"indice{i}"].ravel() - 1.0) + corr
            snr_db = 10.0 * np.log10(
                md[f"SNR{i}r"].ravel() + md[f"SNR{i}i"].ravel()
            )
        else:
            sol = corr
            snr_db = md[f"SNR{i}"].ravel()
        out[f"solution{i}"] = sol
        out[f"snr{i}_db"] = snr_db
        for key in (f"df{i}", f"xval{i}"):
            if key in md:
                out[key] = md[key].ravel()
        if "df" in md and i == 1:
            out["df1"] = md["df"].ravel()

    one(1)
    one(2)
    return out


def gzip_file(path: str, remove_original: bool = True) -> str:
    """gzip an output archive (``goprocess.sh`` behavior)."""
    gz = path + ".gz"
    with open(path, "rb") as fin, gzip.open(gz, "wb") as fout:
        shutil.copyfileobj(fin, fout)
    if remove_original:
        os.remove(path)
    return gz
