"""The program's own spans in a traced window, for the per-layer readers.

The port records spans while a ``torch.profiler`` records, as in a
``--trace 1`` run's window, and hands them out through
``amaranth_twstft_tpu_torch.utils.profiling.spans()``: each has a
``name``, ``start`` and ``end`` on ``time.perf_counter`` (the clock the
window's ``t0`` and ``t1`` are on), the ``second`` it belongs to and its
integer ``counts``.  A program without the recorder gives no spans, and
every reader then returns None.
"""

from __future__ import annotations


def window(data) -> list:
    """The program's spans that lie within the window ``[t0, t1]``."""
    try:
        from amaranth_twstft_tpu_torch.utils.profiling import spans
    except ImportError:
        return []
    t0, t1 = data["t0"], data["t1"]
    return [r for r in spans() if r.start >= t0 and r.end <= t1]


def by_second(data, name: str) -> dict:
    """The window's ``name`` spans by their second (the last where a
    second has several)."""
    return {r.second: r for r in window(data) if r.name == name}


def per_second_ms(data, name: str) -> float | None:
    """Mean over the window's seconds of the time in ``name`` spans, in
    ms; None where the window holds none."""
    by: dict = {}
    for r in window(data):
        if r.name == name:
            by[r.second] = by.get(r.second, 0.0) + (r.end - r.start)
    if not by:
        return None
    return 1e3 * sum(by.values()) / len(by)


def counts(data, name: str, key: str) -> list[int]:
    """The ``key`` count of each of the window's ``name`` spans."""
    return [r.counts[key] for r in window(data) if r.name == name and key in r.counts]


def queue_wait_ms(data) -> float | None:
    """Mean over the window's seconds of the wait between a second's
    ``bank.upload`` end and its ``bank.process`` start, in ms; None where
    the window holds no second with both."""
    up = by_second(data, "bank.upload")
    proc = by_second(data, "bank.process")
    waits = [proc[k].start - up[k].end for k in up if k is not None and k in proc]
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
