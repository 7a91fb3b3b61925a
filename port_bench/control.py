#!/usr/bin/env python3
"""Read a cell's control: the run's check with the step below the
configuration's precision in the program's place (see each driver's
``control``), on several seeds in one process.  The benchmark's own runs
never run it; it is how the limits' upper readings were taken.

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3 [--seconds 10]

Prints one JSON line per seed: the numbers compared, each with its limit,
and whether the control came out not correct, as it has to.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)

import harness  # noqa: E402


def main(argv=None, *, bench=None, workloads_dir=None, device=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    import torch

    cell = harness.Cell(args.workload, bench, workloads_dir=workloads_dir)
    mod = harness.load_module(cell.driver_path, f"port_bench_driver_{cell.driver_name}")
    dev = torch.device(device or "cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        work = tempfile.mkdtemp(prefix="port_bench_control_")
        try:
            cmp = mod.control(cell, seed, dev, work, args.seconds)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_fails": not cmp.ok, "compared": cmp.as_dict()}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
