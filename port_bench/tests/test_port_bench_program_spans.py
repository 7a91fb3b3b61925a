"""CPU tests of the per-layer metrics read from the program's own spans
(``program_spans.py`` and its readers under ``metrics/``)."""

from __future__ import annotations

import contextlib
import io
import json
import math
import shutil
import types

import pytest

import harness
import program_spans
import run

#: the per-layer metrics read from the program's spans
NEW = ("bank.read_to_f32_ms", "bank.read_complex_ms", "bank.pack_fill_ms", "bank.pack_stats_ms",
       "bank.pack_cast_ms", "bank.launch_ms", "bank.fetch_wait_ms", "bank.report_ms",
       "bank.queue_wait_ms", "bank.h2d_mb", "bank.rows_used_pct", "bank.queue_wait_ms.chan_s")

#: the prefetch queue's wait, split by the end-to-end metric it moves
WAITS = {"bank.f16_8ch": "bank.queue_wait_ms", "bank.f16_120ch": "bank.queue_wait_ms.chan_s"}


def _reader(name):
    return harness.load_module(f"{harness.HERE}/metrics/{name}.py", f"t_{name.replace('.', '_')}")


def test_each_cell_lists_the_program_span_metrics_and_one_queue_wait():
    """Every reader here is listed for both cells but the queue wait,
    whose two entries each list the cells that report what it moves."""
    with open(f"{harness.HERE}/../BENCHMARK.json") as f:
        bench = json.load(f)
    e2e = {m["name"]: m.get("workloads") for m in bench["end_to_end"]}
    entries = {m["name"]: m for m in bench["per_layer"] if m["name"] in NEW}
    assert set(entries) == set(NEW)
    for cell, wait in WAITS.items():
        mine = {n for n, m in entries.items() if cell in m["workloads"]}
        assert mine == set(NEW) - set(WAITS.values()) | {wait}, cell
        for n in mine:
            assert e2e[entries[n]["moves"]] is None or cell in e2e[entries[n]["moves"]], n


@pytest.mark.parametrize("cell", sorted(WAITS))
def test_a_tiny_traced_bank_run_reports_every_program_span_metric(tmp_path, cell):
    from tiny import tiny_bench

    bench, wdir = tiny_bench(str(tmp_path))
    if cell not in {w["name"] for w in bench["workloads"]}:
        # the tiny bank's traffic under this cell's name: the metrics a
        # cell reports are found by its name
        bench["workloads"].append({"name": cell, "config": "rx_bank", "chips": 1})
        shutil.copy(f"{wdir}/bank.f16_8ch.json", f"{wdir}/{cell}.json")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", "4294967311", "--seconds", "2",
                       "--trace", "1"], bench=bench, workloads_dir=wdir, device="cpu",
                      need_card=False)
    assert rc == 0, err.getvalue()
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True
    got = line["metrics"]
    mine = set(NEW) - set(WAITS.values()) | {WAITS[cell]}
    assert mine <= set(got)
    for name in mine:
        assert math.isfinite(got[name]["value"]) and got[name]["value"] >= 0, name
    # tiny geometry: 2 inputs, 4 buffer rows of fs + nobs = 102 000 f16 pairs
    assert got["bank.h2d_mb"]["value"] == 4 * 102_000 * 2 * 2 / 1e6
    assert got["bank.rows_used_pct"]["value"] == 50.0
    assert got[WAITS[cell]]["value"] > 0


def _span(name, second, start, end, **counts):
    return types.SimpleNamespace(name=name, second=second, start=start, end=end, counts=counts)


def test_readers_reduce_by_second_within_the_window(monkeypatch):
    recs = [
        _span("bank.upload", 0, 0.5, 0.9, bytes=10, rows=4, rows_used=2),  # before t0
        _span("bank.upload", 1, 1.0, 1.2, bytes=10, rows=4, rows_used=2),
        _span("bank.process", 1, 2.0, 2.1),
        _span("bank.upload", 2, 2.2, 2.4, bytes=30, rows=4, rows_used=4),
        _span("bank.process", 2, 2.9, 3.0),
        _span("io.read_sc16.to_f32", 2, 2.15, 2.17),
        _span("io.read_sc16.to_f32", 2, 2.17, 2.2),  # a second read twice
        _span("io.read_sc16.to_f32", 1, 0.95, 0.99),
        _span("bank.process", 3, 3.1, 3.3),  # after t1
    ]
    import amaranth_twstft_tpu_torch.utils.profiling as prof

    monkeypatch.setattr(prof, "spans", lambda: list(recs))
    data = {"t0": 0.95, "t1": 3.0}
    for wait in WAITS.values():
        assert abs(_reader(wait).read(data) - 1e3 * (0.8 + 0.5) / 2) < 1e-9
    assert _reader("bank.h2d_mb").read(data) == 20 / 1e6
    assert _reader("bank.rows_used_pct").read(data) == 75.0
    assert abs(_reader("bank.read_to_f32_ms").read(data) - 1e3 * (0.04 + 0.05) / 2) < 1e-9
    assert _reader("bank.report_ms").read(data) is None


def test_readers_give_nothing_for_a_program_without_the_recorder(monkeypatch):
    """The parent commit's program has no ``spans()``: every reader
    returns None, and none raises."""
    import amaranth_twstft_tpu_torch.utils.profiling as prof

    monkeypatch.delattr(prof, "spans")
    data = {"t0": 0.0, "t1": 1.0}
    assert program_spans.window(data) == []
    assert all(_reader(name).read(data) is None for name in NEW)
