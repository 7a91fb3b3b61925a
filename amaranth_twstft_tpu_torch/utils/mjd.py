"""Time scales: Julian Day / MJD conversions and epoch dating.

Behavioral spec: the Gregorian/Julian-calendar JD algorithm of
``acquisition/go_1s.m:18-70`` (used to MJD-stamp every two-way product) and
the backwards epoch dating from the capture-end timestamp of
``processing/Octave/gofinal_ltfb.m:49`` (``dateini = date_end - n_epochs``,
one epoch per second there).  File names carry Unix timestamps
(``gosampling.sh:21-27``) recovered from file mtimes (``processing/C/stat.c``).

The port's copy of the JAX package's ``utils/mjd.py`` (stdlib only).
"""

from __future__ import annotations

import math
import re
from datetime import datetime, timezone

__all__ = [
    "julian_day",
    "mjd_from_unix",
    "unix_from_mjd",
    "epoch_start_unix",
    "timestamp_from_name",
]

_UNIX_EPOCH_MJD = 40587.0  # 1970-01-01 00:00 UTC


def julian_day(year: float, month: float, day: float) -> float:
    """Julian day number, valid across the 1582 Gregorian reform.

    Same piecewise formula as the reference (``go_1s.m:19-34``).
    """
    branch = year + (month - 1.0) / 12.0 + day / 365.25
    if month < 3:
        month += 12.0
        year -= 1.0
    if branch >= 1582.78:
        return (
            math.floor(year * 365.25)
            + math.floor(year / 400.0)
            - math.floor(year / 100.0)
            + math.floor(30.59 * (month - 2.0))
            + day
            + 1721088.5
        )
    if branch >= 0.0:
        return (
            math.floor(year * 365.25)
            + math.floor(30.59 * (month - 2.0))
            + day
            + 1721086.5
        )
    return (
        math.copysign(1.0, year) * math.floor(abs(year) * 365.25)
        + math.floor(30.59 * (month - 2.0))
        + day
        + 1721085.5
    )


def mjd_from_unix(unix_seconds: float) -> float:
    """MJD from a Unix timestamp: ``t/86400 + 40587`` (``tw.m:57``)."""
    return unix_seconds / 86400.0 + _UNIX_EPOCH_MJD


def unix_from_mjd(mjd: float) -> float:
    return (mjd - _UNIX_EPOCH_MJD) * 86400.0


def epoch_start_unix(capture_end_unix: float, n_epochs: int,
                     epoch_seconds: float = 1.0) -> float:
    """Date epochs backwards from the capture end.

    ``dateini = date_end - n_epochs`` with 1-s epochs
    (``gofinal_ltfb.m:49``: storage end = final date + 1 s).
    """
    return capture_end_unix - n_epochs * epoch_seconds


def timestamp_from_name(name: str) -> int | None:
    """Extract the leading Unix timestamp of a record file name.

    The acquisition chain names records ``<unix>....bin`` / ``...mat.gz``
    (``gosampling.sh:21-28``, parsed back with ``str2num(name(1:10))``,
    ``gofinal_ltfb.m:30-31``).
    """
    m = re.match(r"^\D*?(\d{10})", name)
    return int(m.group(1)) if m else None


def datestr_utc(unix_seconds: float) -> str:
    """``"%Y %m %d %H %M %S"`` row prefix (``gofinal_ltfb.m:89``)."""
    return datetime.fromtimestamp(int(unix_seconds), tz=timezone.utc).strftime(
        "%Y %m %d %H %M %S"
    )
