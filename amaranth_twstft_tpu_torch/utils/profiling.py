"""Profiling: the program's own spans, and ``torch.profiler`` traces.

The port's counterpart of the JAX package's ``utils/profiling.py``.  The
reference instruments the epoch loop with ``std::chrono`` and prints
``temps:`` in ms (``processing/CPP/main.cpp:462-516``).  Here:

- :func:`span` records a named host span while a ``torch.profiler``
  records, and nothing otherwise: its start and end on
  ``time.perf_counter``, the span open around it on the same thread, the
  id of the ``second`` it belongs to (given, else its parent's) and
  integer counts such as ``bytes``.  Each recorded span is also a range
  of the profiler's under its name, with its ``second`` as an argument,
  so it sits beside the kernels in the profiler's trace.  :func:`spans`
  returns the records, counts included.
- :func:`trace` is a ``torch.profiler`` trace context over the CPU and
  (where there is one) the CUDA device, written as a Chrome trace
  (``chrome://tracing`` or Perfetto) in place of ``jax.profiler``'s
  TensorBoard directory; the spans of the traced block are in it, with
  their ``second`` (where they have one) under ``args``.

While nothing records, :func:`span` reads one flag and returns a shared
no-op context: no clock is read and nothing is kept.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["Span", "span", "spans", "trace"]


class Span:
    """One recorded span: ``name``, ``start`` and ``end`` (seconds on
    ``time.perf_counter``), its ``id``, the ``parent`` span's id (None
    where no span of its thread was open), ``second`` and ``counts``."""

    __slots__ = ("id", "name", "parent", "second", "counts", "start", "end")

    def __init__(self, id: int, name: str, parent: int | None,
                 second: int | None, counts: dict[str, int]):
        self.id, self.name, self.parent = id, name, parent
        self.second, self.counts = second, counts
        self.start = self.end = None


class _Off:
    """The context :func:`span` returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_records: list[Span] = []
_ids = itertools.count()
_local = threading.local()


class _On:
    """The context :func:`span` returns while a profiler records."""

    __slots__ = ("span", "marker", "stack")

    def __init__(self, name: str, second: int | None, counts: dict[str, int]):
        self.span = Span(next(_ids), name, None, second, counts)

    def __enter__(self) -> Span:
        sp = self.span
        stack = self.stack = _local.__dict__.setdefault("stack", [])
        if stack:
            sp.parent = stack[-1].id
            if sp.second is None:
                sp.second = stack[-1].second
        # a function-scope range, not ``record_function``'s user
        # annotation: the profiler gives a user annotation a second range
        # on the device's timeline, over the kernels launched inside it,
        # which readers of the device events would count as device work.
        # The range's arguments hold the span's ``second``; a profiler
        # that records shapes (``trace``) writes them to its Chrome trace
        self.marker = torch._C._profiler._RecordFunctionFast(
            sp.name, (), {} if sp.second is None else {"second": sp.second})
        self.marker.__enter__()
        sp.start = time.perf_counter()
        stack.append(sp)
        return sp

    def __exit__(self, *exc):
        self.span.end = time.perf_counter()
        self.stack.pop()
        self.marker.__exit__(*exc)
        _records.append(self.span)
        return False


def span(name: str, second: int | None = None, **counts: int):
    """A span named ``name`` around the block, recorded while a
    ``torch.profiler`` records; ``second`` sets the id of the second the
    span and the spans inside it belong to.  The context gives the
    :class:`Span` (add counts known only at the end to its ``counts``),
    or None while nothing records."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _On(name, second, counts)


def spans() -> list[Span]:
    """The spans recorded in this process so far, each once it ended."""
    return list(_records)


@contextlib.contextmanager
def trace(logdir: str | None):
    """``torch.profiler`` trace of the block (no-op when ``logdir`` is
    None): CPU activity, and CUDA activity when a card is present; the
    Chrome trace is written to ``logdir/trace_<pid>_<ns>.json`` when the
    block ends, also when it raises.  It records the ops' shapes, and
    with them the ``second`` of each span."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=acts, record_shapes=True)
    prof.__enter__()
    try:
        yield
    finally:
        if ProfilerActivity.CUDA in acts:
            torch.cuda.synchronize()  # the block's device work, whole
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
