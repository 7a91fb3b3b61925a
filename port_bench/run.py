#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository root, on a machine with a CUDA card.  The cell's
entry in ``BENCHMARK.json`` names its configuration and its driver; the
run builds the inputs from the seed, warms up (``setup_s``), measures for
``--seconds``, checks what the timed path produced against the plain
reference under ``reference/``, and prints one JSON line last on standard
output.  ``--trace 0`` reports the cell's end-to-end metrics, ``--trace
1`` its per-layer metrics from the benchmark's spans and the profiler.

It measures ``amaranth_twstft_tpu_torch`` (the PyTorch and CUDA port)
only: a run whose process holds ``jax``, ``jaxlib``, ``flax`` or the JAX
package exits non-zero with no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile
import time

_T_START = time.perf_counter()

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import harness  # noqa: E402

#: build and kernel caches of the program, at fixed paths in the checkout
CACHE_DIR = os.path.join(ROOT, ".port_bench_cache")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _fail(msg: str) -> int:
    print(f"port_bench: {msg}", file=sys.stderr, flush=True)
    return 2


def _guard(where: str) -> str | None:
    hit = harness.forbidden_modules()
    return f"{where}: the process holds {', '.join(hit)}" if hit else None


def main(argv=None, *, bench=None, here=HERE, workloads_dir=None,
         device=None, need_card=True) -> int:
    """One run; returns the exit code.  ``need_card=False`` and a CPU
    ``device`` are for the CPU tests, which drive a run at a tiny size."""
    args = parse(argv)
    cell = harness.Cell(args.workload, bench, root=ROOT, here=here,
                        workloads_dir=workloads_dir)
    if ROOT not in sys.path:
        sys.path.insert(1, ROOT)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ["TWSTFT_BANK_CACHE"] = os.path.join(CACHE_DIR, "banks")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE_DIR, "torch_extensions")

    import torch

    chips = int(cell.entry.get("chips", 1))
    if need_card:
        if not torch.cuda.is_available():
            return _fail("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < chips:
            return _fail(f"{torch.cuda.device_count()} cards, the cell asks for {chips}")
        device = "cuda"
    device = torch.device(device or "cuda")

    import importlib

    prog = importlib.import_module(harness.PROGRAM)
    if not os.path.abspath(prog.__file__).startswith(ROOT + os.sep):
        return _fail(f"{harness.PROGRAM} resolves outside the checkout: {prog.__file__}")

    work = tempfile.mkdtemp(prefix="port_bench_")
    try:
        mod = harness.load_module(cell.driver_path, f"port_bench_driver_{cell.driver_name}")
        drv = mod.Driver(cell, args.seed, device, work, bool(args.trace))
        drv.setup()
        if device.type == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - _T_START
        bad = _guard("after set-up")
        if bad:
            return _fail(bad)

        spans = harness.Spans()
        trace = None
        if args.trace:
            trace = harness.Trace(torch)
            with spans.wrap(drv.span_targets()), trace.record():
                drv.window(args.seconds, spans)
        else:
            drv.window(args.seconds, spans)
        bad = _guard("after the window")
        if bad:
            return _fail(bad)
        peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0

        metrics = {}
        data = drv.layer_data(spans, trace)
        if args.trace:
            for m in cell.per_layer:
                v = cell.metric_reader(m["name"]).read(data)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        else:
            e2e = dict(drv.end_to_end(), setup_s=setup_s)
            for m in cell.end_to_end:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}

        drv.release()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        compared, attempted, failed = drv.check()

        if device.type == "cuda":
            dev = harness.device_info(torch, chips, peak)
        else:
            dev = {"platform": "cpu", "kind": "cpu", "count": 1,
                   "memory_peak_bytes": 0, "power_limit_w": None}
        result = {"correct": compared.ok, "attempted": int(attempted),
                  "failed": int(failed), "metrics": metrics, "device": dev}
        if trace is not None:
            t0, t1 = drv.t0, drv.t1
            dev["busy_s"] = trace.busy_s(t0, t1)
            dev["window_s"] = t1 - t0
            result["breakdown"] = {"device_ops": trace.top_ops(t0, t1),
                                   "idle_gaps": trace.idle_gaps(spans, t0, t1)}
        result["compared"] = compared.as_dict()
        bad = _guard("at exit")
        if bad:
            return _fail(bad)
        for line in compared.lines():
            print(line, file=sys.stderr)
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
        return 0
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
