"""Profiling: per-stage wall-clock timers and ``torch.profiler`` traces.

The port's counterpart of the JAX package's ``utils/profiling.py``.  The
reference instruments the epoch loop with ``std::chrono`` and prints
``temps:`` in ms (``processing/CPP/main.cpp:462-516``).  Here: a stage
timer that can synchronise the card before it reads the clock, and a
``torch.profiler`` trace context over the CPU and (where there is one) the
CUDA device, written as a Chrome trace (``chrome://tracing`` or Perfetto)
in place of ``jax.profiler``'s TensorBoard directory.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import defaultdict

import torch

__all__ = ["StageTimer", "device_sync", "trace"]


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))


def device_sync(x) -> None:
    """Wait for every CUDA device that holds a tensor of ``x`` (a tensor,
    or a list, tuple, dict or dataclass of them); CPU tensors need no
    wait."""
    for dev in {t.device for t in _tensors(x) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulating per-stage wall-clock timer.

    >>> t = StageTimer()
    >>> with t.stage("fft"):
    ...     y = do_work()
    >>> t.report()
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                device_sync(sync)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f"{name}: {self.totals[name]*1e3:.1f} ms "
                f"({self.counts[name]}x)"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str | None):
    """``torch.profiler`` trace of the block (no-op when ``logdir`` is
    None): CPU activity, and CUDA activity when a card is present; the
    Chrome trace is written to ``logdir/trace_<pid>_<ns>.json`` when the
    block ends, also when it raises."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        yield
    finally:
        if ProfilerActivity.CUDA in acts:
            torch.cuda.synchronize()  # the block's device work, whole
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
