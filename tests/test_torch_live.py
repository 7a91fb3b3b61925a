"""The port's live paths and small verbs against the JAX package's on the
CPU: the monitor stream protocol (``utils/stream``), ``dllpll --serve``,
the ``monitor`` verb and ``follow_capture``, the live plot, the schedule
helpers, ``utils/profiling``, the ``prn``/``emit``/``config``/``acquire``
verbs, and the banked receiver's prefetching ``run_stream``.

Tolerances: ``spectrum_summary``, ``prn``/``emit``/``acquire`` files and
``config`` JSON identical; ``monitor`` rows: epochs and channels
identical, delay within 1e-4 sample, df within 1e-2 Hz, snr and C/N0
within 1e-3 dB (float32 on both sides, pocketfft in torch and in XLA);
``run_stream`` with and without prefetch: the same bits.

Every socket test binds an ephemeral port, gives each connect and join a
timeout of its own, and closes its servers in ``finally``.
"""

import contextlib
import datetime as dt
import io
import json
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from amaranth_twstft_tpu import cli as jcli
from amaranth_twstft_tpu import pipeline as jpipe
from amaranth_twstft_tpu.utils import recorder as jrec
from amaranth_twstft_tpu.utils import stream as jstream
from amaranth_twstft_tpu_torch import cli as tcli
from amaranth_twstft_tpu_torch import pipeline as tpipe
from amaranth_twstft_tpu_torch.utils import profiling, recorder
from amaranth_twstft_tpu_torch.utils import stream as tstream

JOIN_S = 120.0  # every thread join's own limit


def _sig_args(cfg):
    return ["--fs", str(cfg.fs), "--chip-rate", str(cfg.chip_rate),
            "--code-len", str(cfg.code_len), "--bitlen", str(cfg.bit_len),
            "--taps", str(cfg.taps)]


def _free_port() -> int:
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def _subscribe(port, out, errors, timeout_s=30.0):
    """Collect one subscription's messages; connection refusals are
    retried for 10 s (the producer may not be up yet), anything else is
    kept in ``errors``."""
    deadline = time.monotonic() + 10.0
    while True:
        try:
            out.extend(tstream.connect_monitor("127.0.0.1", port, timeout_s=timeout_s))
            return
        except ConnectionRefusedError as e:
            if time.monotonic() > deadline:
                errors.append(e)
                return
            time.sleep(0.05)
        except BaseException as e:  # noqa: BLE001 — asserted by the test
            errors.append(e)
            return


def _join(*threads):
    for t in threads:
        t.join(timeout=JOIN_S)
        assert not t.is_alive(), t


@pytest.fixture(scope="module")
def capture(small_cfg, tmp_path_factory):
    """The JAX CLI's prn + emit pair of tests/test_monitor_cli.py."""
    d = tmp_path_factory.mktemp("live")
    cap, code = str(d / "cap.bin"), str(d / "code.bin")
    cfg = small_cfg
    assert jcli.main(["prn", "--bitlen", str(cfg.bit_len), "--noiselen",
                      str(cfg.code_len), "--taps", str(cfg.taps), "-o", code]) == 0
    assert jcli.main(["emit", cap, *_sig_args(cfg), "--seconds", "1",
                      "--delay", "437", "--doppler", "120", "--amplitude", "900",
                      "--noise", "150", "--delay2", "12", "--doppler2", "5"]) == 0
    return cap, code


def test_help_lists_all_fourteen_verbs(capsys):
    with pytest.raises(SystemExit):
        jcli.main(["--help"])
    out_j = capsys.readouterr().out
    with pytest.raises(SystemExit):
        tcli.main(["--help"])
    out_t = capsys.readouterr().out

    def verbs(text):
        return set(text[text.index("{") + 1 : text.index("}")].split(","))

    assert verbs(out_t) == verbs(out_j) and len(verbs(out_t)) == 14


# ----------------------------------------------------------------------
# the stream protocol
# ----------------------------------------------------------------------
@pytest.mark.parametrize("consumer", ["port", "jax"])
def test_server_broadcasts_identical_streams(consumer):
    """Two subscribers see the identical sequence; a third that leaves
    after 5 messages disturbs nobody; the JAX package's consumer reads the
    port's producer the same (the wire protocol is shared)."""
    connect = (tstream if consumer == "port" else jstream).connect_monitor
    outs = [[], [], []]
    errors = []

    def collect(out, n_stop=None):
        try:
            for msg in connect("127.0.0.1", srv.port, timeout_s=20.0):
                out.append(msg)
                if n_stop is not None and len(out) >= n_stop:
                    break
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    srv = tstream.MonitorServer(hello={"fs": 5e6})
    try:
        ths = [threading.Thread(target=collect, args=(outs[0],), daemon=True),
               threading.Thread(target=collect, args=(outs[1],), daemon=True),
               threading.Thread(target=collect, args=(outs[2], 5), daemon=True)]
        for t in ths:
            t.start()
        deadline = time.monotonic() + 10.0
        while srv.n_clients < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert srv.n_clients == 3
        for i in range(40):
            srv.publish({"type": "row", "epoch": i, "ch": i % 2,
                         "delay_samp": 431.4 + i})
    finally:
        srv.close()
    _join(*ths)
    assert not errors
    assert outs[0] == outs[1]
    assert outs[0][0] == {"type": "hello", "fs": 5e6}
    assert outs[0][-1] == {"type": "end"}
    assert [m["epoch"] for m in outs[0] if m["type"] == "row"] == list(range(40))
    assert len(outs[2]) == 5


def test_jax_producer_reaches_port_consumer():
    srv = jstream.MonitorServer(hello={"fs": 1e5, "channels": 2})
    got, errors = [], []
    th = threading.Thread(target=_subscribe, args=(srv.port, got, errors), daemon=True)
    try:
        th.start()
        deadline = time.monotonic() + 10.0
        while srv.n_clients < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        srv.publish({"type": "track", "second": 3, "gd_ns": 1.5})
    finally:
        srv.close()
    _join(th)
    assert not errors
    assert got == [{"type": "hello", "fs": 1e5, "channels": 2},
                   {"type": "track", "second": 3, "gd_ns": 1.5}, {"type": "end"}]


def test_slow_consumer_is_dropped_not_blocking():
    """A subscriber that never reads is dropped once its socket buffer
    fills; publish() never blocks past its send timeout."""
    srv = tstream.MonitorServer(send_timeout_s=0.2)
    dead = socket.socket()
    try:
        dead.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        dead.settimeout(10.0)
        dead.connect((srv.host, srv.port))
        deadline = time.monotonic() + 10.0
        while srv.n_clients < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert srv.n_clients == 1
        big = {"type": "row", "pad": "x" * 65536}
        t0 = time.monotonic()
        for i in range(64):
            srv.publish({**big, "epoch": i})
        assert srv.n_clients == 0
        assert time.monotonic() - t0 < 30.0
    finally:
        dead.close()
        srv.close()


def test_acceptor_failure_is_raised_not_silent():
    srv = tstream.MonitorServer()
    try:
        srv._error = OSError("accept failed")
        with pytest.raises(RuntimeError, match="accept thread failed"):
            srv.publish({"type": "row"})
    finally:
        srv._error = None
        srv.close()


def test_spectrum_summary_bit_identical():
    rng = np.random.default_rng(2)
    for shape, bins in (((4, 4096), 128), ((3000,), 64), ((2, 100), 128)):
        z = (rng.normal(0, 100, shape) + 1j * rng.normal(0, 100, shape)).astype(
            np.complex64)
        assert tstream.spectrum_summary(z, 1e5, bins) == jstream.spectrum_summary(
            z, 1e5, bins)


# ----------------------------------------------------------------------
# dllpll --serve
# ----------------------------------------------------------------------
@pytest.mark.parametrize("host", [False, True])
def test_dllpll_serve_messages_equal_printed_rows(small_cfg, tmp_path, capsys, host):
    """Every track message carries exactly a printed row (formatted as the
    JAX consumer prints it); hello first, end last."""
    from amaranth_twstft_tpu.models.emitter import ChannelSim, synthesize_capture

    (a,) = synthesize_capture(
        small_cfg, [ChannelSim(delay_samples=137.0, doppler_hz=100.0, amplitude=900,
                               noise_sigma=60)],
        n_seconds=4, seed=33)
    fs = int(small_cfg.fs)
    cap = str(tmp_path / "track.bin")
    frame = np.zeros((4 * fs, 4), np.int16)
    frame[:, 0] = np.clip(np.round(a.real), -32768, 32767)
    frame[:, 1] = np.clip(np.round(a.imag), -32768, 32767)
    frame.tofile(cap)
    param = tmp_path / "sdr.param"
    param.write_text("A N 100 100.0 50 50 400 50 18\n")
    port = _free_port()
    msgs, errors, rc = [], [], []

    def producer():
        try:
            rc.append(tcli.main(
                ["dllpll", cap, "--param", str(param), "--fs", str(small_cfg.fs),
                 "--serve", str(port), "--serve-min-clients", "1", "--bitlen", "10",
                 "--code-len", "1000", "--nlag", "8", "--taps-map", "100=9",
                 "--device", "cpu"] + (["--host"] if host else [])))
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    capsys.readouterr()
    tp = threading.Thread(target=producer, daemon=True)
    tc = threading.Thread(target=_subscribe, args=(port, msgs, errors), daemon=True)
    tp.start()
    tc.start()
    _join(tp, tc)
    assert not errors and rc == [0]
    printed = [ln for ln in capsys.readouterr().out.splitlines()
               if not ln.startswith("#")]
    assert msgs[0]["type"] == "hello" and msgs[0]["mode"] == "dllpll"
    assert msgs[-1] == {"type": "end"}
    tracks = [m for m in msgs if m["type"] == "track"]
    assert len(tracks) == len(printed) == 2
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        for m in tracks:
            tcli._print_track_msg(m)
    assert out.getvalue().splitlines() == printed
    gd = np.median([t["gd_ns"] for t in tracks])
    assert abs(gd - 137.0 / small_cfg.fs * 1e9) < 0.02 * 137.0 / small_cfg.fs * 1e9


# ----------------------------------------------------------------------
# monitor and follow_capture
# ----------------------------------------------------------------------
def _rows(text):
    return [ln.split() for ln in text.strip().splitlines()
            if ln and not ln.startswith("#") and ln.split()[0].lstrip("-").isdigit()]


def test_monitor_once_matches_jax(small_cfg, capture, capsys):
    cap, code = capture
    argv = ["monitor", cap, code, *_sig_args(small_cfg), "--channels", "2",
            "--epochs", "10", "--once"]
    capsys.readouterr()
    assert jcli.main(argv) == 0
    rows_j = _rows(capsys.readouterr().out)
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    rows_t = _rows(capsys.readouterr().out)
    assert len(rows_t) == len(rows_j) == 100  # 50 epochs x 2 channels
    # each bound plus the printed rounding (delay to 1e-4, the rest to 1e-2)
    for rj, rt in zip(rows_j, rows_t):
        assert rj[:2] == rt[:2]
        assert abs(float(rj[2]) - float(rt[2])) <= 1e-4 + 1e-4
        assert abs(float(rj[3]) - float(rt[3])) <= 1e-2 + 1e-2
        for k in (4, 5):
            assert abs(float(rj[k]) - float(rt[k])) <= 1e-3 + 1e-2
    ch0 = np.array([float(r[2]) for r in rows_t if r[1] == "0"])
    assert np.all(np.abs(ch0 - 437.0) < 0.5)


def test_monitor_step_matches_jax_unrounded(small_cfg, capture):
    """The step the verb binds, on complex64 epochs, against the JAX
    verb's step on pack_complex of the same epochs (unrounded values)."""
    import jax.numpy as jnp

    from amaranth_twstft_tpu.config import ProcessingConfig as JProc
    from amaranth_twstft_tpu.models.godual import build_replica as jbuild
    from amaranth_twstft_tpu.ops import boundary as jb
    from amaranth_twstft_tpu.ops import doppler as jdop
    from amaranth_twstft_tpu_torch.config import ProcessingConfig, SignalConfig
    from amaranth_twstft_tpu_torch.models.godual import build_replica
    from amaranth_twstft_tpu_torch.ops import boundary as tb
    from amaranth_twstft_tpu_torch.utils import io as tio

    cap, code = capture
    sig = SignalConfig(fs=small_cfg.fs, chip_rate=small_cfg.chip_rate,
                       code_len=small_cfg.code_len, bit_len=small_cfg.bit_len,
                       taps=small_cfg.taps)
    L = sig.samples_per_code
    d, n = tio.read_sc16_epochs(cap, 0, 10, L)
    rep_j = jbuild(code, small_cfg, JProc())
    mask = jdop.window_mask(L, sig.fs, -20e3, 20e3)
    step_j = jb.make_ranging_step(np.asarray(rep_j.fcode), np.asarray(rep_j.code_interp),
                                  mask, sig.fs)
    rep = build_replica(code, sig, ProcessingConfig())
    step_t = tb.make_ranging_step(rep.fcode, rep.code_interp, mask, sig.fs,
                                  packed=True, device="cpu")
    for ch in range(2):
        oj = step_j(jnp.asarray(jb.pack_complex(d[ch])))
        ot = tb.unpack_outputs(step_t(torch.from_numpy(d[ch])).numpy())
        np.testing.assert_array_equal(ot.indice, np.asarray(oj.indice))
        np.testing.assert_allclose(ot.delay_samples(), oj.delay_samples(), rtol=0, atol=1e-4)
        np.testing.assert_allclose(ot.df, np.asarray(oj.df), rtol=0, atol=1e-2)
        np.testing.assert_allclose(ot.snr_db(), oj.snr_db(), rtol=0, atol=1e-3)


def test_monitor_refuses_missing_inputs_and_bad_connect(capsys):
    assert tcli.main(["monitor", "--device", "cpu"]) == 2
    assert tcli.main(["monitor", "--connect", "localhost:http"]) == 2
    port = _free_port()  # nobody listens there
    assert tcli.main(["monitor", "--connect", f"127.0.0.1:{port}",
                      "--timeout", "1"]) == 1
    assert "is the producer" in capsys.readouterr().out


def _chunk(rng, n):
    z = rng.normal(0, 100, n) + 1j * rng.normal(0, 100, n)
    out = np.empty(2 * n, np.int16)
    out[0::2] = np.real(z).astype(np.int16)
    out[1::2] = np.imag(z).astype(np.int16)
    return out.tobytes()


@pytest.mark.parametrize("mod", ["port", "jax"])
def test_follow_capture_incremental(small_cfg, tmp_path, mod):
    """Tail semantics (tests/test_monitor_cli.py:47-74): a batch appears
    once the file has grown by it; the port yields what the JAX package
    yields, the same complex64 epochs."""
    follow = (tpipe if mod == "port" else jpipe).follow_capture
    L = small_cfg.samples_per_code
    path = str(tmp_path / "grow.bin")
    rng = np.random.default_rng(0)
    with open(path, "wb") as f:
        f.write(_chunk(rng, 3 * L))
        f.flush()
        gen = follow(path, small_cfg, channels=1, epochs_per_batch=2,
                     stop_when_idle=True)
        got = [next(gen)]
        f.write(_chunk(rng, 2 * L))
        f.flush()
        got.extend(list(gen))
    assert [(e, ch) for e, ch, _ in got] == [(0, 0), (2, 0)]
    assert all(d.shape == (2, L) and d.dtype == np.complex64 for _, _, d in got)
    ref = list(jpipe.follow_capture(path, small_cfg, channels=1, epochs_per_batch=2,
                                    stop_when_idle=True))
    for (e, c, d), (e2, c2, d2) in zip(got, ref, strict=True):
        assert (e, c) == (e2, c2) and np.array_equal(d, d2)


def test_follow_capture_waits_for_growth_then_times_out(small_cfg, tmp_path):
    """Without stop_when_idle the tail waits for the writer, and ends
    timeout_s after the last new batch."""
    L = small_cfg.samples_per_code
    path = str(tmp_path / "slow.bin")
    rng = np.random.default_rng(1)
    open(path, "wb").close()

    def writer():
        with open(path, "ab") as f:
            for _ in range(3):
                time.sleep(0.3)
                f.write(_chunk(rng, 2 * L))
                f.flush()

    th = threading.Thread(target=writer, daemon=True)
    th.start()
    t0 = time.monotonic()
    got = [(e, c) for e, c, _ in tpipe.follow_capture(
        path, small_cfg, channels=1, epochs_per_batch=2, poll_s=0.05, timeout_s=1.0)]
    _join(th)
    assert got == [(0, 0), (2, 0), (4, 0)]
    assert 1.0 <= time.monotonic() - t0 < 30.0


def test_monitor_serve_two_connected_consumers(small_cfg, capture, capsys):
    """monitor --serve broadcasts while printing; two --connect CLI
    consumers print the producer's rows, and a connect_monitor consumer
    sees them with one spectrum per batch per channel."""
    cap, code = capture
    port = _free_port()
    raw, errors, rcs = [], [], {}

    def producer():
        try:
            rcs["producer"] = tcli.main(
                ["monitor", cap, code, *_sig_args(small_cfg), "--channels", "2",
                 "--epochs", "10", "--once", "--serve", str(port),
                 "--serve-min-clients", "3", "--device", "cpu"])
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    def consumer_cli(name):
        rc = 1
        deadline = time.monotonic() + 10.0
        while rc != 0 and time.monotonic() < deadline:
            rc = tcli.main(["monitor", "--connect", f"127.0.0.1:{port}",
                            "--timeout", "10"])
            if rc != 0:
                time.sleep(0.05)
        rcs[name] = rc

    capsys.readouterr()
    ths = [threading.Thread(target=producer, daemon=True),
           threading.Thread(target=_subscribe, args=(port, raw, errors), daemon=True),
           threading.Thread(target=consumer_cli, args=("cli1",), daemon=True),
           threading.Thread(target=consumer_cli, args=("cli2",), daemon=True)]
    for t in ths:
        t.start()
    _join(*ths)
    assert not errors and rcs == {"producer": 0, "cli1": 0, "cli2": 0}
    assert raw[0]["type"] == "hello" and raw[0]["channels"] == 2
    assert raw[-1] == {"type": "end"}
    rows = [m for m in raw if m["type"] == "row"]
    specs = [m for m in raw if m["type"] == "spectrum"]
    assert len(rows) == 100
    assert len(specs) == 10 and all(len(s["bins_db"]) == 128 for s in specs)
    # the producer and the two --connect consumers print each row once each
    from collections import Counter

    printed = _rows(capsys.readouterr().out)
    cnt = Counter((int(r[0]), int(r[1]), float(r[2])) for r in printed)
    assert all(cnt[(m["epoch"], m["ch"], m["delay_samp"])] == 3 for m in rows)
    assert len(printed) == 3 * len(rows)


def test_monitor_connect_plot(tmp_path):
    """monitor --connect --plot renders the broadcast to a PNG snapshot."""
    pytest.importorskip("matplotlib")
    srv = tstream.MonitorServer(hello={"fs": 5e6, "channels": 1})
    out = tmp_path / "live.png"
    rc = []
    th = threading.Thread(target=lambda: rc.append(tcli.main(
        ["monitor", "--connect", f"127.0.0.1:{srv.port}", "--plot",
         "--plot-file", str(out), "--timeout", "10"])), daemon=True)
    try:
        th.start()
        deadline = time.monotonic() + 10.0
        while srv.n_clients < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert srv.n_clients == 1
        srv.publish({"type": "spectrum", "epoch": 0, "ch": 1,
                     "bins_db": [-60.0] * 128, "f_lo_hz": -2.5e6, "f_hi_hz": 2.5e6})
        for n in range(10):
            srv.publish({"type": "row", "epoch": n, "ch": 1, "delay_samp": 100.0 + n,
                         "df_hz": 0.0, "snr_db": 5.0, "cn0_dbhz": 48.0})
        srv.publish({"type": "track", "second": 1, "prn": 9, "gd_ns": 246800.0})
    finally:
        srv.close()
    _join(th)
    assert rc == [0] and out.exists() and out.stat().st_size > 10_000


def test_live_plot_consumer_matches_jax(tmp_path):
    pytest.importorskip("matplotlib")
    from amaranth_twstft_tpu.utils.plotview import LiveMonitorPlot as JPlot
    from amaranth_twstft_tpu_torch.utils.plotview import LiveMonitorPlot

    rng = np.random.default_rng(0)
    msgs = [{"type": "hello", "fs": 5e6, "channels": 2}]
    for ch in (1, 2):
        msgs.append({"type": "spectrum", "epoch": 0, "ch": ch,
                     "bins_db": rng.normal(-60, 5, 128).tolist(),
                     "f_lo_hz": -2.5e6, "f_hi_hz": 2.5e6})
    for n in range(30):
        for ch in (1, 2):
            msgs.append({"type": "row", "epoch": n, "ch": ch,
                         "delay_samp": 1234.0 + 0.01 * n, "df_hz": 130.0,
                         "snr_db": 6.0, "cn0_dbhz": 50.0})
    msgs += [{"type": "track", "second": 1, "prn": 9, "gd_ns": 246800.0},
             {"type": "end"}]
    views = []
    for cls, name in ((LiveMonitorPlot, "t.png"), (JPlot, "j.png")):
        v = cls(save_path=str(tmp_path / name), save_every_s=60.0)
        assert v.run(iter(msgs)) == str(tmp_path / name)
        views.append(v)
    t, j = views
    assert (t.n_msgs, t.delays, t.snrs, t.tracks, t.spectra) == (
        j.n_msgs, j.delays, j.snrs, j.tracks, j.spectra)


# ----------------------------------------------------------------------
# schedule helpers and the retry loop
# ----------------------------------------------------------------------
def test_schedule_helpers_match_jax():
    t = dt.datetime(2026, 3, 30, 22, 17, 5)
    for k in range(2 * 24 * 12 + 7):
        now = t + dt.timedelta(minutes=5 * k, seconds=k % 7)
        assert tpipe.next_sampling_window(now) == jpipe.next_sampling_window(now)
        assert tpipe.next_processing_time(now) == jpipe.next_processing_time(now)
    start, dur = tpipe.next_sampling_window(dt.datetime(2026, 1, 1, 1, 3))
    assert start == dt.datetime(2026, 1, 1, 1, 45) and dur == 330.0
    assert tpipe.next_processing_time(dt.datetime(2026, 1, 1, 23, 53)) == \
        dt.datetime(2026, 1, 2, 1, 53)


def test_retry_until_valid():
    calls, resets = [], []

    def action():
        calls.append(1)
        return "x" * len(calls)

    out = tpipe.retry_until_valid(action, lambda s: len(s) >= 3, attempts=5,
                                  delay_s=0.0, on_retry=lambda: resets.append(1))
    assert out == "xxx" and len(calls) == 3 and len(resets) == 2
    calls.clear()
    resets.clear()
    assert tpipe.retry_until_valid(action, lambda s: False, attempts=3, delay_s=0.0,
                                   on_retry=lambda: resets.append(1)) is None
    assert len(calls) == 3 and len(resets) == 2  # no reset after the last attempt


# ----------------------------------------------------------------------
# profiling
# ----------------------------------------------------------------------
def test_trace_writes_a_cpu_chrome_trace(tmp_path):
    logdir = tmp_path / "prof"
    with profiling.trace(str(logdir)):
        torch.fft.fft(torch.ones(4096, dtype=torch.complex64))
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(logdir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("fft" in str(e.get("name", "")) for e in events)
    with profiling.trace(None):
        pass
    with pytest.raises(ValueError), profiling.trace(str(tmp_path / "p2")):
        raise ValueError("the block's error still propagates")
    assert len(os.listdir(tmp_path / "p2")) == 1


def test_goranging_profile_writes_a_trace(small_cfg, capture, tmp_path, capsys):
    cap, code = capture
    logdir = tmp_path / "prof"
    assert tcli.main(["goranging", cap, code, *_sig_args(small_cfg), "--device", "cpu",
                      "--profile", str(logdir)]) == 0
    capsys.readouterr()
    (name,) = os.listdir(logdir)
    with open(logdir / name) as f:
        assert json.load(f)["traceEvents"]
    os.remove(os.path.splitext(cap)[0] + "C.mat")


# ----------------------------------------------------------------------
# prn, emit, config, acquire
# ----------------------------------------------------------------------
@pytest.mark.parametrize("extra", [[], ["--taps-b", "3"]])
def test_prn_files_identical(tmp_path, capsys, extra):
    common = ["prn", "--bitlen", "10", "--noiselen", "1000", "--taps", "9", *extra]
    assert jcli.main(common + ["-o", str(tmp_path / "j.bin")]) == 0
    assert tcli.main(common + ["-o", str(tmp_path / "t.bin")]) == 0
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    capsys.readouterr()
    assert jcli.main(["prn", "--bitlen", "10", "--search", "5"]) == 0
    out_j = capsys.readouterr().out
    assert tcli.main(["prn", "--bitlen", "10", "--search", "5"]) == 0
    assert capsys.readouterr().out == out_j
    assert tcli.main(["prn", "--bitlen", "10"]) == 2


def test_prn_default_filename(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert jcli.main(["prn", "--bitlen", "10", "--noiselen", "1000", "--taps", "9"]) == 0
    name_j = capsys.readouterr().out.strip()
    data_j = open(name_j, "rb").read()
    os.remove(name_j)
    assert tcli.main(["prn", "--bitlen", "10", "--noiselen", "1000", "--taps", "9"]) == 0
    name_t = capsys.readouterr().out.strip()
    assert name_t == name_j and open(name_t, "rb").read() == data_j


@pytest.mark.parametrize("extra", [
    [],
    ["--delay2", "12", "--doppler2", "5", "--timecode", "timecode"],
    ["--qpsk", "--taps-b", "3", "--timecode", "invert", "--seed", "7"],
])
def test_emit_files_identical(small_cfg, tmp_path, capsys, extra):
    common = ["emit", *_sig_args(small_cfg), "--seconds", "2", "--delay", "437.25",
              "--doppler", "120", "--amplitude", "900", "--noise", "150", *extra]
    assert jcli.main([common[0], str(tmp_path / "j.bin"), *common[1:]]) == 0
    assert tcli.main([common[0], str(tmp_path / "t.bin"), *common[1:]]) == 0
    capsys.readouterr()
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()


def test_config_json_and_hash_identical(tmp_path, capsys):
    assert jcli.main(["config"]) == 0
    out_j = capsys.readouterr().out
    assert tcli.main(["config"]) == 0
    assert capsys.readouterr().out == out_j
    path = tmp_path / "cfg.json"
    raw = json.loads(out_j)
    raw["signal"]["taps"] = 27
    raw["processing"]["nint"] = 4
    path.write_text(json.dumps(raw))
    assert jcli.main(["config", "--load", str(path)]) == 0
    j = capsys.readouterr()
    assert tcli.main(["config", "--load", str(path)]) == 0
    t = capsys.readouterr()
    assert (t.out, t.err) == (j.out, j.err) and t.err.startswith("ok hash=")
    path.write_text("{not json")
    assert tcli.main(["config", "--load", str(path)]) == 1
    assert "invalid config" in capsys.readouterr().err


def _fc32_stream(z_ch):
    inter = np.empty(z_ch.shape[1] * z_ch.shape[0], np.complex64)
    for c in range(z_ch.shape[0]):
        inter[c::z_ch.shape[0]] = z_ch[c]
    return inter.tobytes()


def test_recorder_bytes_identical(tmp_path):
    rng = np.random.default_rng(4)
    z = (rng.normal(0, 0.02, (2, 2500)) + 1j * rng.normal(0, 0.02, (2, 2500))
         ).astype(np.complex64)
    z[0, 5] = 1.5 + 1.5j  # saturates
    payload = _fc32_stream(z) + b"\x00" * 7  # a partial frame at the end
    for seconds, chunk in ((2.0, 300), (10.0, 1 << 18), (0.5, 7)):
        n_t = recorder.record_fc32_stream(io.BytesIO(payload), str(tmp_path / "t.bin"),
                                          1000.0, seconds, chunk_frames=chunk)
        n_j = jrec.record_fc32_stream(io.BytesIO(payload), str(tmp_path / "j.bin"),
                                      1000.0, seconds, chunk_frames=chunk)
        assert n_t == n_j == min(2500, int(1000.0 * seconds))
        assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()


def test_acquire_from_file_identical(tmp_path, capsys):
    rng = np.random.default_rng(5)
    z = (0.03 * rng.normal(size=(2, 1500)) + 0.03j * rng.normal(size=(2, 1500))
         ).astype(np.complex64)
    src = tmp_path / "src.fc32"
    src.write_bytes(_fc32_stream(z))
    for mod, name in ((jcli, "j.bin"), (tcli, "t.bin")):
        assert mod.main(["acquire", str(tmp_path / name), "--from", str(src),
                         "--fs", "1000", "--seconds", "1.2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[1])["frames"] == json.loads(lines[0])["frames"] == 1200
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    empty = tmp_path / "empty.fc32"
    empty.write_bytes(b"")
    assert tcli.main(["acquire", str(tmp_path / "e.bin"), "--from", str(empty)]) == 1


def test_acquire_over_tcp_identical(tmp_path, capsys):
    """acquire --from tcp:HOST:PORT (the 10GbE capture-link role): the
    port's recording of a socket stream equals the JAX CLI's."""
    rng = np.random.default_rng(6)
    z = (0.03 * rng.normal(size=(2, 1500)) + 0.03j * rng.normal(size=(2, 1500))
         ).astype(np.complex64)
    payload = _fc32_stream(z)
    for mod, name in ((jcli, "j.bin"), (tcli, "t.bin")):
        srv = socket.socket()
        srv.settimeout(30.0)
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        errors = []

        def feeder():
            try:
                conn, _ = srv.accept()
                with conn:
                    conn.sendall(payload)
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        th = threading.Thread(target=feeder, daemon=True)
        th.start()
        try:
            rc = mod.main(["acquire", str(tmp_path / name), "--from",
                           f"tcp:127.0.0.1:{srv.getsockname()[1]}", "--fs", "1000",
                           "--seconds", "1.2"])
        finally:
            _join(th)
            srv.close()
        assert rc == 0 and not errors
    capsys.readouterr()
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    assert os.path.getsize(tmp_path / "t.bin") == 1200 * 8


# ----------------------------------------------------------------------
# the banked receiver's prefetching run_stream
# ----------------------------------------------------------------------
@pytest.mark.parametrize("transfer", ["auto", "int8"])
def test_run_stream_prefetch_on_off_identical(small_cfg, transfer):
    import dataclasses

    from amaranth_twstft_tpu.models.emitter import ChannelSim, synthesize_capture
    from amaranth_twstft_tpu_torch.models import dllpll as td
    from amaranth_twstft_tpu_torch.models import tracker as tt

    (stream,) = synthesize_capture(
        small_cfg,
        [ChannelSim(delay_samples=137.0, doppler_hz=120.0, amplitude=900,
                    noise_sigma=120)],
        n_seconds=5, seed=17,
        extra_emissions=[(dataclasses.replace(small_cfg, taps=27),
                          ChannelSim(delay_samples=555.0, doppler_hz=-210.0,
                                     amplitude=900, noise_sigma=0.0))],
    )
    fs, L = int(small_cfg.fs), small_cfg.samples_per_code
    secs = [{"A": stream[s * fs : (s + 1) * fs + 2 * L]} for s in range(4)]
    chans = [td.ChannelConfig(physical="A", prn_id=100 + i, bit_len=10, taps=t,
                              chip_rate=5e4, code_len=1000, filter_hz=5e4,
                              acq_range_hz=500.0, acq_step_hz=50.0, snr_min_db=20.0,
                              nlag=8) for i, t in enumerate((9, 27))]
    out = []
    for prefetch in (True, False):
        rx = tt.BankedReceiver(chans, fs=small_cfg.fs, transfer=transfer, device="cpu")
        out.append((list(rx.run_stream(iter(secs), prefetch=prefetch)), rx.log,
                    [dataclasses.asdict(s) for s in rx.states]))
    (rep_a, log_a, st_a), (rep_b, log_b, st_b) = out
    assert log_a == log_b and st_a == st_b
    assert rep_a == rep_b
    assert all(r is not None and r.locked for r in rep_a[3])
