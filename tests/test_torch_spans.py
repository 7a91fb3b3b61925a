"""The port's span recorder (``utils/profiling.span`` and ``spans``) and
its spans on the banked receiver's per-second path, on the CPU at the
small_cfg geometry (L = 2000, 50 codes per second, 8 lags).

Recording is on exactly while a ``torch.profiler`` records: off, a span
is a shared no-op that reads no clock; on, spans nest by thread, inherit
the id of their second, keep their counts and sit at their own events
in the profiler's trace.  The receiver gives
the same reports, log lines and ``.dat`` rows either way.
"""

import dataclasses
import json
import os
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from amaranth_twstft_tpu_torch import native
from amaranth_twstft_tpu_torch.cli import main as torch_main
from amaranth_twstft_tpu_torch.models import dllpll as td
from amaranth_twstft_tpu_torch.models import tracker as tt
from amaranth_twstft_tpu_torch.models.emitter import ChannelSim, synthesize_capture
from amaranth_twstft_tpu_torch.utils import io, profiling
from amaranth_twstft_tpu_torch.utils.profiling import span

#: the bank's spans of every tracked second of a prefetching stream
BANK_SPANS = ("bank.pull", "io.read_sc16.to_f32", "io.read_sc16.to_complex", "bank.upload",
              "bank.pack", "bank.pack.fill", "bank.pack.stats", "bank.pack.cast",
              "bank.process", "bank.launch", "bank.fetch", "bank.report")


def _recording():
    return profile(activities=[ProfilerActivity.CPU])


def _since(n0: int) -> list:
    return profiling.spans()[n0:]


# ----------------------------------------------------------------------
# the recorder
# ----------------------------------------------------------------------
def test_off_span_is_the_shared_noop_and_records_nothing():
    n0 = len(profiling.spans())
    ctx = span("bank.upload", second=3, bytes=1)
    assert ctx is span("other")
    with ctx as sp:
        assert sp is None
    assert len(profiling.spans()) == n0


def test_off_span_allocates_nothing():
    def loop():
        for k in range(20000):
            with span("bank.pack", second=k):
                pass

    loop()
    tracemalloc.start()
    try:
        before, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        loop()
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # 20 000 spans: an allocation kept or made per span would show here
    assert after - before < 1024 and peak - before < 1024


def test_spans_nest_inherit_their_second_and_keep_counts():
    n0 = len(profiling.spans())
    with _recording():
        with span("a", second=7) as a:
            with span("b", rows=2) as b:
                with span("c") as c:
                    pass
            with span("d", second=8) as d:
                pass
            a.counts["bytes"] = 10
        with span("e") as e:
            pass
    got = {r.name: r for r in _since(n0)}
    assert set(got) == {"a", "b", "c", "d", "e"}
    assert got["a"] is a and got["e"] is e
    assert (a.parent, b.parent, c.parent, d.parent, e.parent) == (None, a.id, b.id, a.id, None)
    assert (a.second, b.second, c.second, d.second, e.second) == (7, 7, 7, 8, None)
    assert a.counts == {"bytes": 10} and b.counts == {"rows": 2} and c.counts == {}
    assert a.start <= b.start <= c.start <= c.end <= b.end <= d.start <= d.end <= a.end
    assert a.end <= e.start


def test_a_span_ends_when_its_block_raises():
    n0 = len(profiling.spans())
    with _recording():
        with pytest.raises(ValueError), span("bad", second=1):
            raise ValueError("the block's error propagates")
        with span("next") as nxt:
            pass
    bad, nxt_rec = _since(n0)
    assert bad.name == "bad" and bad.end >= bad.start
    assert nxt_rec is nxt and nxt.parent is None and nxt.second is None


def test_spans_of_another_thread_have_their_own_parents():
    n0 = len(profiling.spans())
    with _recording():
        with span("main", second=1) as main:
            def work():
                with span("worker"):
                    pass

            th = threading.Thread(target=work)
            th.start()
            th.join(timeout=10)
            assert not th.is_alive()
    worker = next(r for r in _since(n0) if r.name == "worker")
    assert main.second == 1 and worker.parent is None and worker.second is None


def test_span_starts_at_its_profiler_event():
    """A span's start lies at its event in the profiler's results, once
    the two clocks are aligned as ``port_bench/harness.Trace`` aligns
    them: a marker range opened first in the profile, with
    ``perf_counter`` read inside it, taken to be at the range's start.
    That alignment is exact to within the marker's own duration (about
    1 ms where it is a process's first range) and the span's range's (the
    clock is read inside it), and the test holds it to that sum."""
    mark = "test.window"
    n0 = len(profiling.spans())
    with _recording() as prof:
        with record_function(mark):
            t_mark = time.perf_counter()
        for k in range(3):
            with span("bank.upload", second=k):
                torch.ones(1000).sum()
                time.sleep(0.002)
    raw = prof.profiler.kineto_results
    evs = [(e.name(), e.start_ns() * 1e-9, e.duration_ns() * 1e-9) for e in raw.events()]
    ((m_start, m_dur),) = [(s, d) for n, s, d in evs if n == mark]
    off = t_mark - m_start
    ups = sorted((s + off, d) for n, s, d in evs if n == "bank.upload")
    rec = sorted(r.start for r in _since(n0))
    assert len(ups) == len(rec) == 3
    for (start, dur), r in zip(ups, rec):
        assert abs(start - r) <= m_dur + dur
        assert dur >= 0.002  # the event is the span's range, not another


# ----------------------------------------------------------------------
# the banked receiver's spans
# ----------------------------------------------------------------------
def _chan(taps, prn_id, **kw):
    return td.ChannelConfig(physical="A", prn_id=prn_id, bit_len=10, taps=taps,
                            chip_rate=5e4, code_len=1000, filter_hz=5e4,
                            acq_range_hz=500.0, acq_step_hz=50.0, snr_min_db=20.0,
                            nlag=8, **kw)


@pytest.fixture(scope="module")
def capture(small_cfg, tmp_path_factory):
    """Two PRNs on input A of a dual-input sc16 capture (B holds noise):
    PRN 9 at 137 samples and 120 Hz, PRN 27 at 555 samples and -210 Hz."""
    (stream,) = synthesize_capture(
        small_cfg,
        [ChannelSim(delay_samples=137.0, doppler_hz=120.0, amplitude=900, noise_sigma=120)],
        n_seconds=5, seed=17,
        extra_emissions=[(dataclasses.replace(small_cfg, taps=27),
                          ChannelSim(delay_samples=555.0, doppler_hz=-210.0,
                                     amplitude=900, noise_sigma=0.0))],
    )
    path = str(tmp_path_factory.mktemp("spans") / "cap.bin")
    io.write_sc16(path, stream, np.random.default_rng(3).normal(0, 100, len(stream)) + 0j)
    return path


def _seconds(path, small_cfg, n=4):
    """The ``dllpll`` verb's reads: second s from sample s*fs, fs + 2L long."""
    fs, L = int(small_cfg.fs), small_cfg.samples_per_code
    for s in range(n):
        d, _ = io.read_sc16_epochs(path, s * fs, 1, fs + 2 * L, channels=2)
        yield {"A": d[0, 0], "B": d[1, 0]}


def _run(capture, small_cfg, out_dir, *, transfer="f16", prefetch=True, sic=False):
    chans = [_chan(9, 100), _chan(27, 101, is_sic=sic)]
    os.makedirs(out_dir)
    rx = tt.BankedReceiver(chans, fs=small_cfg.fs, group=1, transfer=transfer,
                           out_dir=str(out_dir), device="cpu")
    reports = list(rx.run_stream(_seconds(capture, small_cfg), prefetch=prefetch))
    files = {f: open(os.path.join(out_dir, f)).read() for f in sorted(os.listdir(out_dir))}
    return reports, rx.log, files, rx


@pytest.mark.parametrize("transfer, prefetch", [("f16", True), ("int8", True), ("f16", False)])
def test_bank_gives_the_same_bits_recording_or_not(capture, small_cfg, tmp_path, transfer,
                                                   prefetch):
    rep_off, log_off, files_off, _ = _run(capture, small_cfg, tmp_path / "off",
                                          transfer=transfer, prefetch=prefetch)
    n0 = len(profiling.spans())
    with _recording():
        rep_on, log_on, files_on, _ = _run(capture, small_cfg, tmp_path / "on",
                                           transfer=transfer, prefetch=prefetch)
    assert len(_since(n0)) > 0
    assert rep_on == rep_off and log_on == log_off and files_on == files_off
    assert any(f.endswith(".dat") and text for f, text in files_on.items())
    assert all(r is not None and r.locked for r in rep_on[3])


def test_bank_path_reads_no_clock_while_off(capture, small_cfg, tmp_path, monkeypatch):
    calls = []
    real = time.perf_counter

    def counted():
        calls.append(1)
        return real()

    monkeypatch.setattr(time, "perf_counter", counted)
    with span("bank.pull", second=0):
        pass
    reports, *_ = _run(capture, small_cfg, tmp_path / "off")
    monkeypatch.undo()
    assert calls == [] and all(r is not None for r in reports[3])


def test_each_second_has_one_of_each_bank_span(capture, small_cfg, tmp_path):
    n0 = len(profiling.spans())
    with _recording():
        _run(capture, small_cfg, tmp_path / "on")
    rec = _since(n0)
    by_id = {r.id: r for r in rec}
    # the stream's last pull finds no second: a pull span of its own
    assert sorted(r.second for r in rec if r.name == "bank.pull") == [0, 1, 2, 3, 4]
    for k in range(4):
        mine = [r for r in rec if r.second == k]
        names = [r.name for r in mine]
        want = BANK_SPANS if k else BANK_SPANS[:-3] + ("bank.acquire",)
        assert sorted(names) == sorted(want), k
        one = {r.name: r for r in mine}
        pull, pack, up, proc = (one[n] for n in ("bank.pull", "bank.pack", "bank.upload",
                                                 "bank.process"))
        for n in ("io.read_sc16.to_f32", "io.read_sc16.to_complex"):
            assert by_id[one[n].parent] is pull
        frames = int(small_cfg.fs) + 2 * small_cfg.samples_per_code
        assert one["io.read_sc16.to_f32"].counts == {"frames": frames,
                                                     "threads": _pass_threads(capture, frames)}
        assert by_id[pack.parent] is up and up.parent is None and proc.parent is None
        for n in ("bank.pack.fill", "bank.pack.stats", "bank.pack.cast"):
            assert by_id[one[n].parent] is pack
            assert pack.start <= one[n].start <= one[n].end <= pack.end
        assert pull.end <= up.start <= up.end <= proc.start
        for n in ("bank.launch", "bank.fetch", "bank.report", "bank.acquire"):
            if n in one:
                assert by_id[one[n].parent] is proc
    acq = next(r for r in rec if r.name == "bank.acquire")
    assert acq.second == 0 and acq.counts == {}


def _pass_threads(path, frames):
    """The threads ``native.ingest_into`` reports for a two-input read of
    ``frames`` frames."""
    return native.ingest_into(path, 0, frames, [np.empty(2 * frames, np.float32) for _ in range(2)])


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_read_counts_its_native_pass(capture, small_cfg, dtype):
    """Any complex dtype is read by the native pass, and the read's
    ``to_f32`` span counts its frames and the threads it ran on."""
    fs, L = int(small_cfg.fs), small_cfg.samples_per_code
    frames = fs + 2 * L
    n0 = len(profiling.spans())
    with _recording():
        with span("bank.pull", second=7) as pull:
            d, n = io.read_sc16_epochs(capture, fs, 1, frames, channels=2, dtype=dtype)
    assert n == 1 and d.dtype == dtype
    one = {r.name: r for r in _since(n0)}
    f32, cplx = one["io.read_sc16.to_f32"], one["io.read_sc16.to_complex"]
    assert f32.parent == cplx.parent == pull.id and f32.second == cplx.second == 7
    assert f32.counts == {"frames": frames, "threads": _pass_threads(capture, frames)}
    assert cplx.counts == {}


@pytest.mark.parametrize("sic, used", [(False, 0.5), (True, 1.0)])
def test_upload_counts_bytes_and_rows(capture, small_cfg, tmp_path, sic, used):
    """``bytes`` is the packed array's size; ``rows_used`` / ``rows`` is a
    half with no SIC channel (the SIC rows ship unread) and 1 with one;
    the CPU packs on the host (``device_pack`` 0)."""
    n0 = len(profiling.spans())
    with _recording():
        *_, rx = _run(capture, small_cfg, tmp_path / "on", sic=sic)
    ups = [r for r in _since(n0) if r.name == "bank.upload"]
    assert [u.second for u in ups] == [0, 1, 2, 3]
    packed = rx._pack_second(next(_seconds(capture, small_cfg, 1)))[0]
    S = int(small_cfg.fs) + small_cfg.samples_per_code  # fs + nobs
    assert packed.shape == (2, S, 2) and packed.dtype == np.float16
    for u in ups:
        assert u.counts == {"bytes": packed.nbytes, "rows": 2, "rows_used": int(2 * used),
                            "device_pack": 0}
        assert u.counts["rows_used"] / u.counts["rows"] == used


def test_process_second_alone_has_no_second(capture, small_cfg):
    rx = tt.BankedReceiver([_chan(9, 100)], fs=small_cfg.fs, group=1, device="cpu")
    n0 = len(profiling.spans())
    with _recording():
        for sec in _seconds(capture, small_cfg, 2):
            rx.process_second(sec)
    rec = _since(n0)
    names = {r.name for r in rec}
    assert {"bank.upload", "bank.pack", "bank.process", "bank.launch"} <= names
    assert all(r.second is None for r in rec)
    # the upload runs before the second's process span opens
    up = next(r for r in rec if r.name == "bank.upload")
    proc = next(r for r in rec if r.name == "bank.process")
    assert up.parent is None and up.end <= proc.start


def test_dllpll_profile_writes_the_bank_spans(capture, tmp_path, capsys):
    param = tmp_path / "sdr.param"
    param.write_text("A N 100 0.0 50 50 500 50 20\nA N 101 0.0 50 50 500 50 20\n")
    logdir = tmp_path / "prof"
    assert torch_main(["dllpll", capture, "--param", str(param), "--fs", "1e5",
                       "--bitlen", "10", "--code-len", "1000", "--nlag", "8",
                       "--taps-map", "100=9,101=27", "--seconds", "3", "--device", "cpu",
                       "--profile", str(logdir)]) == 0
    out = capsys.readouterr().out
    assert out.startswith("2 A PRN100 ")
    (name,) = os.listdir(logdir)
    with open(logdir / name) as f:
        events = json.load(f)["traceEvents"]
    cats = {e.get("name"): e.get("cat") for e in events}
    assert {"bank.pack.cast", "bank.fetch", "bank.pull", "io.read_sc16.to_f32"} <= set(cats)
    # host ranges: a user annotation would also put a range on the device's
    # timeline, over the kernels launched inside it
    bank = [e for e in events if e.get("name", "").startswith(("bank.", "io.read_sc16."))]
    assert {e.get("cat") for e in bank} == {"cpu_op"}
    # each range carries its second, which links a second's read, upload
    # and process; the stream's last pull finds no second
    by_second: dict = {}
    for e in bank:
        by_second.setdefault(e["args"]["second"], []).append(e["name"])
    assert sorted(by_second) == [0, 1, 2, 3]
    assert by_second[3] == ["bank.pull"]
    for k in (0, 1, 2):
        assert set(BANK_SPANS) - {"bank.launch", "bank.fetch", "bank.report"} <= set(
            by_second[k]), k
    assert set(BANK_SPANS) <= set(by_second[1]) | set(by_second[2])
