"""What every cell's run shares: finding its files by name, the guard
against the JAX package, spans around calls into the program, the
profiler's reduction, the card's description and the result line.

Nothing here knows a configuration, a traffic mix or a metric: those are
files under ``configs/``, ``workloads/``, ``drivers/`` and ``metrics/``,
found by the names in ``BENCHMARK.json``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: top-level module names the port's runs may never hold
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "amaranth_twstft_tpu")

#: the program under test: the PyTorch and CUDA port, never the JAX package
PROGRAM = "amaranth_twstft_tpu_torch"


def forbidden_modules(modules=None) -> list[str]:
    """Names in ``modules`` (default ``sys.modules``) whose top-level part,
    the text before the first dot, is one of :data:`FORBIDDEN_MODULES`
    compared whole (``amaranth_twstft_tpu_torch`` passes)."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN_MODULES)


def load_module(path: str, name: str):
    """A module from a file path (names such as ``claudio.read_ms`` hold
    dots, so the metrics are loaded by path, not imported)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of ``workloads`` in ``BENCHMARK.json`` with what it names:
    its configuration (the file the entry of ``configs`` gives), its
    traffic (``workloads/<cell>.json``), the configuration's driver
    (``drivers/<config>.py``) and the metrics it reports: the end-to-end
    metrics that list the cell or list no cells, and the per-layer
    metrics whose ``workloads`` list it."""

    def __init__(self, name: str, bench: dict | None = None,
                 root: str = ROOT, here: str = HERE,
                 workloads_dir: str | None = None):
        bench = bench or read_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        confs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = confs[self.entry["config"]]
        self.config = read_json(os.path.join(root, self.config_entry["file"]))
        self.traffic = read_json(os.path.join(
            workloads_dir or os.path.join(here, "workloads"), f"{name}.json"))
        self.driver_name = self.entry["config"]
        self.driver_path = os.path.join(here, "drivers", f"{self.driver_name}.py")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if "workloads" not in m or name in m["workloads"]]
        self.per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
        self.metrics_dir = os.path.join(here, "metrics")

    def metric_reader(self, name: str):
        return load_module(os.path.join(self.metrics_dir, f"{name}.py"),
                           f"port_bench_metric_{name.replace('.', '_')}")


class Spans:
    """Host spans ``(name, start, end)`` on ``time.perf_counter``, kept in
    memory; :meth:`wrap` times every call of an attribute of the program
    while the context is open."""

    def __init__(self):
        self.items: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def wrap(self, targets):
        """``targets``: ``(owner, attribute, span name)``; each original
        is restored on exit."""
        saved = []
        for owner, attr, name in targets:
            fn = getattr(owner, attr)

            def wrapped(*a, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    self.items.append((_name, t0, time.perf_counter()))

            saved.append((owner, attr, fn))
            setattr(owner, attr, wrapped)
        try:
            yield self
        finally:
            for owner, attr, fn in reversed(saved):
                setattr(owner, attr, fn)

    def durations(self, name: str, t0: float = -math.inf,
                  t1: float = math.inf) -> list[float]:
        return [e - s for n, s, e in self.items if n == name and s >= t0 and e <= t1]


# ----------------------------------------------------------------------
# the device
# ----------------------------------------------------------------------
def power_limit_w() -> float | None:
    """The card's power limit by ``nvidia-smi``, or None where it cannot
    be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_info(torch, count: int, peak_bytes: int) -> dict:
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": count,
        "memory_peak_bytes": int(peak_bytes),
        "power_limit_w": power_limit_w(),
    }


# ----------------------------------------------------------------------
# the profiler's trace
# ----------------------------------------------------------------------
MARK = "port_bench.window"


class Trace:
    """Device events of a traced window, as ``(name, start_s, end_s)`` on
    the host's ``perf_counter`` clock (aligned by a marker range that
    opens the window), and their reduction."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.t_mark = None
        self.events: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def record(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        card = self.torch.cuda.is_available()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
        with profile(activities=acts) as prof:
            with record_function(MARK):
                self.t_mark = time.perf_counter()
            yield self
            if card:
                self.torch.cuda.synchronize()
        self.prof = prof
        self._collect()

    def _collect(self) -> None:
        """Device events and the marker from the profiler's raw results
        (building its event tree for a long window takes minutes)."""
        cuda = self.torch.autograd.DeviceType.CUDA
        raw = getattr(self.prof.profiler, "kineto_results", None)
        if raw is not None:
            evs = [(e.name(), e.device_type(), e.start_ns() * 1e-9,
                    (e.start_ns() + e.duration_ns()) * 1e-9) for e in raw.events()]
        else:
            evs = [(e.name, e.device_type, e.time_range.start * 1e-6,
                    e.time_range.end * 1e-6) for e in self.prof.events()]
        mark = [s for n, _, s, _ in evs if n == MARK]
        if not mark:
            raise RuntimeError("the profiler's trace lost the window marker")
        off = self.t_mark - min(mark)
        self.events = [(n, s + off, e + off) for n, d, s, e in evs if d == cuda]

    def busy_s(self, t0: float, t1: float) -> float:
        """Union of the device events' ranges within [t0, t1] (events on
        two streams that overlap count once)."""
        total, end = 0.0, t0
        for _, s, e in sorted(self.events, key=lambda x: x[1]):
            s, e = max(s, end), min(e, t1)
            if e > s:
                total += e - s
                end = e
        return total

    def top_ops(self, t0: float, t1: float, n: int = 10) -> list[list]:
        """The device operations that took most time in [t0, t1], by name
        (a kernel's name cut to its first 160 characters)."""
        by: dict[str, float] = {}
        for name, s, e in self.events:
            if s >= t0 and e <= t1:
                name = name[:160]
                by[name] = by.get(name, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, spans: Spans, t0: float, t1: float,
                  n: int = 10) -> list[list]:
        """Idle device time in [t0, t1], each instant given to the
        innermost host span open then ("host" where none is), summed by
        name."""
        gaps, cur = [], t0
        for _, s, e in sorted(self.events, key=lambda x: x[1]) + [("", t1, t1)]:
            s = min(max(s, t0), t1)
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, min(e, t1))
        by: dict[str, float] = {}
        items = [(b - a, nm, a, b) for nm, a, b in spans.items if b > t0 and a < t1]
        for a, b in gaps:
            cuts = sorted({a, b, *(x for _, _, s, e in items for x in (s, e) if a < x < b)})
            for u, v in zip(cuts, cuts[1:]):
                mid = 0.5 * (u + v)
                cover = [(d, nm) for d, nm, s, e in items if s <= mid <= e]
                name = min(cover)[1] if cover else "host"
                by[name] = by.get(name, 0.0) + (v - u)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


# ----------------------------------------------------------------------
# the comparison's report
# ----------------------------------------------------------------------
class Compared:
    """Numbers compared with their limits; a number passes when it is at
    most its limit (every number here is a gap or a count)."""

    def __init__(self):
        self.items: list[tuple[str, float, float]] = []

    def add(self, name: str, value: float, limit: float) -> None:
        self.items.append((name, float(value), float(limit)))

    @property
    def ok(self) -> bool:
        return bool(self.items) and all(
            math.isfinite(v) and v <= lim for _, v, lim in self.items)

    def as_dict(self) -> dict:
        return {n: {"value": v, "limit": lim} for n, v, lim in self.items}

    def lines(self) -> list[str]:
        return [f"compared {n}: {v!r} (limit {lim!r}) "
                f"{'ok' if math.isfinite(v) and v <= lim else 'FAILED'}"
                for n, v, lim in self.items]
