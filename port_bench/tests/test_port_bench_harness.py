"""CPU tests of the benchmark's harness: finding cells by name, the guard
against the JAX package, the result line, the roofline's counts and the
traffic."""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

import harness
import roofline
import run
from traffic import generate
from traffic.lfsr import chips, is_mseq

ROOT = harness.ROOT


def test_guard_compares_whole_top_level_names():
    mods = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "amaranth_twstft_tpu",
            "amaranth_twstft_tpu.ops", "amaranth_twstft_tpu_torch", "amaranth_twstft_tpu_torch.ops",
            "jaxtyping", "numpy"]
    assert harness.forbidden_modules(mods) == [
        "amaranth_twstft_tpu", "amaranth_twstft_tpu.ops", "flax.linen", "jax", "jax.numpy",
        "jaxlib.xla_client"]
    assert harness.forbidden_modules(["amaranth_twstft_tpu_torch.models.claudio"]) == []


def test_no_card_exits_nonzero_without_a_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "bank.f16_8ch", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "cuda" in out.err.lower()


def test_benchmark_names_its_files():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        cell = harness.Cell(w["name"], bench)
        assert os.path.exists(cell.driver_path)
        assert "limits" in cell.traffic
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        for m in cell.per_layer:
            assert callable(cell.metric_reader(m["name"]).read)


STUB_DRIVER = '''
import time
from harness import Compared


class Driver:
    def __init__(self, cell, seed, device, work, trace):
        self.cell, self.seed = cell, seed

    def setup(self):
        self.n = self.cell.traffic["items"]

    def window(self, seconds, spans):
        self.t0 = time.perf_counter()
        self.t1 = self.t0 + 1.0

    def end_to_end(self):
        return {"items_per_s": float(self.n)}

    def span_targets(self):
        return []

    def layer_data(self, spans, trace):
        return {"n": self.n}

    def release(self):
        pass

    def check(self):
        c = Compared()
        c.add("gap", 0.0, self.cell.traffic["limit"])
        return c, self.n, 0
'''


def _run(argv, **kw):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(argv, **kw)
    return rc, out.getvalue(), err.getvalue()


def test_a_cell_configuration_and_metric_added_as_files_only(tmp_path):
    """A new configuration, its driver, a traffic mix and a per-layer
    metric, each a new file named in BENCHMARK.json, run with no edit of
    the harness."""
    here = tmp_path / "bench"
    shutil.copytree(os.path.join(harness.HERE, "metrics"), here / "metrics")
    (here / "drivers").mkdir()
    (here / "drivers" / "stub.py").write_text(STUB_DRIVER)
    (here / "workloads").mkdir()
    (here / "workloads" / "stub.small.json").write_text(json.dumps({"items": 7, "limit": 0.0}))
    (here / "metrics" / "stub.items.py").write_text("def read(data):\n    return data['n'] * 2\n")
    cfg = here / "stub.json"
    cfg.write_text(json.dumps({"name": "stub"}))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "stub", "source": "x", "file": str(cfg), "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "stub.small", "config": "stub", "traffic": "small",
                               "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "items_per_s", "unit": "1/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["stub.small"]})
    bench["per_layer"].append({"name": "stub.items", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "stub",
                               "moves": "items_per_s", "workloads": ["stub.small"]})
    for trace, want in ((0, {"setup_s", "items_per_s"}), (1, {"stub.items"})):
        rc, out, err = _run(["--workload", "stub.small", "--seed", "3", "--seconds", "1",
                             "--trace", str(trace)], bench=bench, here=str(here),
                            device="cpu", need_card=False)
        assert rc == 0, err
        line = json.loads(out.strip().splitlines()[-1])
        assert set(line["metrics"]) == want
        assert line["correct"] is True and line["attempted"] == 7
    assert line["metrics"]["stub.items"]["value"] == 14.0


def test_result_line_schema(tmp_path):
    from tiny import tiny_bench

    bench, wdir = tiny_bench(str(tmp_path))
    rc, out, err = _run(["--workload", "bank.f16_8ch", "--seed", "8589934593",
                         "--seconds", "1", "--trace", "0"], bench=bench, workloads_dir=wdir,
                        device="cpu", need_card=False)
    assert rc == 0, err
    last = out.strip().splitlines()[-1]
    line = json.loads(last)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "compared"
    assert set(line["metrics"]) == {"setup_s", "chan_s_per_s", "second_p90_ms"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    for v in line["compared"].values():
        assert set(v) == {"value", "limit"}
    # the compared numbers are also the last lines of standard error
    tail = err.strip().splitlines()[-len(line["compared"]):]
    assert all(t.startswith("compared ") for t in tail)


@pytest.mark.parametrize("shape, nbytes, flops", [
    # obs 8*2*24*200000 f32 + wav_ext 8*(200000+56) f32 + 4 outputs 8*24*57 f32
    ((8, 24, 200_000, 57), 4 * (76_800_000 + 1_600_448 + 43_776), 2 * 48 * 57 * 200_000 * 8),
    ((8, 9, 500_000, 57), 4 * (72_000_000 + 4_000_448 + 16_416), 2 * 18 * 57 * 500_000 * 8),
])
def test_roofline_counts_by_hand(shape, nbytes, flops):
    r = roofline.lagbank_window(*shape)
    assert r["bytes"] == nbytes and r["flops"] == flops
    assert r["bound"] == "bytes"
    assert r["t_min_s"] == pytest.approx(nbytes / 3.35e12)


def test_roofline_times_each_call_by_both_launches():
    """A window-form call is its window launch and the finalize launch
    after it; a finalize with no window before it, or a window cut off
    by the window's end, is no whole call."""
    from harness import load_module

    m = load_module(os.path.join(harness.HERE, "metrics", "lagbank.window_roofline_pct.py"),
                    "roofline_metric")
    ev = [("void lagbank_finalize_kernel<4>", 0.5, 0.6),
          ("void lagbank_window_kernel<8>", 1.0, 1.2), ("memcpy", 1.2, 1.3),
          ("void lagbank_finalize_kernel<4>", 1.3, 1.35),
          ("void lagbank_window_kernel<8>", 2.0, 2.1), ("lagbank_finalize_kernel", 2.1, 2.15),
          ("void lagbank_window_kernel<8>", 3.0, 3.1)]
    assert m.call_times(ev, 0.0, 5.0) == pytest.approx([0.25, 0.15])

    class Trace:
        events = ev

    t_min = roofline.lagbank_window(8, 24, 200_000, 57)["t_min_s"]
    got = m.read({"trace": Trace, "lag_bank_shapes": [(8, 2, 24, 200_000, 28)] * 2,
                  "t0": 0.0, "t1": 5.0})
    assert got == pytest.approx(100.0 * t_min / 0.2)


def test_lfsr_chips_are_m_sequences():
    assert is_mseq(10, 9) and is_mseq(10, 27) and not is_mseq(10, 10)
    c = chips(10, [9, 27], 3000, lanes=8)
    assert np.array_equal(c[:, :1023], c[:, 1023:2046])
    one = chips(10, [9], 1000, lanes=1)[0]
    assert np.array_equal(one, c[0, :1000])


def test_traffic_is_deterministic_for_a_seed(tmp_path):
    from tiny import CONFIGS, WORKLOADS

    sig = CONFIGS["rx_bank"]
    mix = dict(WORKLOADS["bank.f16_8ch"], ring_seconds=2)
    paths = [tmp_path / f"r{i}.sc16" for i in range(3)]
    truths = [generate.ring_capture(sig, sig["taps"], mix, seed, torch.device("cpu"), str(p))
              for seed, p in zip((7, 7, 8), paths)]
    a, b, c = (np.fromfile(p, np.int16) for p in paths)
    assert truths[0] == truths[1] and np.array_equal(a, b)
    assert truths[0] != truths[2] and not np.array_equal(a, c)


def test_ring_wraps_with_a_continuous_carrier(tmp_path):
    """The tail of the ring continues its head, and a second read across
    the wrap carries the same carrier and code as one read inside it."""
    from tiny import CONFIGS, WORKLOADS

    sig = CONFIGS["rx_bank"]
    mix = dict(WORKLOADS["bank.f16_8ch"], n_per_input=1, noise_sigma=0.0, amplitude=3000.0,
               ring_seconds=3)
    path = tmp_path / "ring.sc16"
    (truth, _) = generate.ring_capture(sig, sig["taps"], mix, 11, torch.device("cpu"), str(path))
    fs, L, N = int(sig["fs"]), 2000, 3
    x = np.fromfile(path, np.int16).reshape(-1, 4)
    assert x.shape[0] == N * fs + L
    assert np.array_equal(x[N * fs:], x[:L])
    # the Doppler on the 1/N grid: N*f is whole, so the carrier closes the ring
    assert abs(truth["doppler"] * N - round(truth["doppler"] * N)) < 1e-9
    z = x[:, 0].astype(np.float64) + 1j * x[:, 1]
    code = np.repeat(chips(10, [truth["taps"]], 1000)[0] * 2.0 - 1, 2)
    # one code period on each side of the wrap, despread with the code at
    # the truth's delay and mixed down by the truth's carrier: the same
    # complex amplitude on both sides
    n = np.arange(N * fs - L, N * fs + L)
    ref = np.roll(code, int(round(truth["delay"])))[n % L]
    seg = np.concatenate([z[N * fs - L:N * fs], z[N * fs:N * fs + L]])
    y = seg * ref * np.exp(-2j * np.pi * truth["doppler"] * n / fs)
    before, after = y[:L].mean(), y[L:].mean()
    assert abs(before) > 1000.0
    assert abs(after - before) < 1e-3 * abs(before)
