"""The GoRanging capture pipeline: host IO overlapped with device compute
(torch).

The port's counterpart of the JAX package's
``pipeline.process_capture_overlapped`` and its helpers
(``pipeline.py:24-387``).  On the card the two-deep software pipeline is:

- a reader thread fills **pinned** host batch buffers straight from the
  sc16 memmap in the run's transfer format (raw int16 by default, int8
  under a loose parity budget, float32 on request); a buffer is refilled
  only once the copy that read it has completed (its CUDA event);
- each batch's host-to-device copy runs ``non_blocking`` on a separate
  copy stream, and a CUDA event orders it before the batch's step;
- both channels of a batch run as one ranging step (the file's
  interleaved (B, L, 4) layout, deinterleaved on the device) with the
  per-epoch fixed-df vector uploaded once;
- each batch's outputs come back as one packed (2B, 14) float32 copy
  into pinned memory, waited on by an event while the next batch
  computes.

Reader failures come back through the queue, an empty capture raises
``ValueError``, and a final partial batch is zero-padded to the batch
shape and its padding rows dropped.

:func:`process_directory` is the directory batch runner of
``goprocess.sh`` (``pipeline.py:705-771``): every unprocessed capture of
a directory through one chain, with the idempotent-resume contract;
:func:`gzip_archives` is its gzip preamble.  :func:`follow_capture` tails
a growing capture for the ``monitor`` verb (``pipeline.py:774-824``), and
:func:`next_sampling_window`, :func:`next_processing_time` and
:func:`retry_until_valid` are the acquisition schedule and retry loop
(``pipeline.py:646-702``), host code copied as it is.
"""

from __future__ import annotations

import datetime as _dt
import glob
import os
import queue
import threading
import time
from collections.abc import Callable
from dataclasses import dataclass

import numpy as np
import torch

from amaranth_twstft_tpu_torch.config import (
    ProcessingConfig,
    SignalConfig,
    StationConfig,
)
from amaranth_twstft_tpu_torch.models import claudio, godual, goranging
from amaranth_twstft_tpu_torch.models.godual import ChannelArrays, build_replica
from amaranth_twstft_tpu_torch.models.goranging import default_mat_name
from amaranth_twstft_tpu_torch.ops import boundary
from amaranth_twstft_tpu_torch.ops.doppler import (
    PREPASS_MAX_SAMPLES,
    bound_prepass_window,
    per_file_df,
    per_file_df_ri,
)
from amaranth_twstft_tpu_torch.utils import io, matio
from amaranth_twstft_tpu_torch.utils.platform import resolve_device

__all__ = [
    "I8_PARITY_P99_NS",
    "process_capture_overlapped",
    "BatchReport",
    "process_directory",
    "gzip_archives",
    "follow_capture",
    "next_sampling_window",
    "next_processing_time",
    "retry_until_valid",
]

#: Measured p99 |delay error| of the int8 transfer format against the
#: float64 oracle at the -13 dB operating point (PARITY.md deviation 10);
#: a parity budget of at least twice this selects int8.
I8_PARITY_P99_NS = 0.040


def _pack_prepass(x: np.ndarray, in_dtype) -> np.ndarray:
    """Pack a decimated complex pre-pass array as (..., 2) in the run's
    transfer format.  int8 quantizes WITHOUT a scale (the squaring-
    spectrum argmax is scale-invariant); int16 packs the sc16 samples
    verbatim (they are int16-valued)."""
    if np.dtype(in_dtype) == np.int8:
        ri = boundary.pack_complex(x, dtype=np.float32)
        s = max(float(np.abs(ri).max()), 1.0) / 127.0
        return np.clip(np.round(ri / s), -127, 127).astype(np.int8)
    return boundary.pack_complex(x, dtype=in_dtype)


def _resolve_ingest_dtype(
    ingest_dtype: str | None, parity_ns: float | None, accel: bool
) -> str:
    """The ingest dtype from an explicit request or a parity budget.

    ``sc16`` is an alias of ``int16``.  Without a request: on the CPU
    ``float32`` (nothing is shipped); on the card ``int8`` when
    ``parity_ns >= 2 * I8_PARITY_P99_NS`` (half the bytes of sc16),
    else ``int16`` (the sc16 wire format, bit-identical to float32
    ingest at half its bytes)."""
    if ingest_dtype is not None:
        return "int16" if ingest_dtype == "sc16" else ingest_dtype
    if not accel:
        return "float32"
    if parity_ns is not None and parity_ns >= 2.0 * I8_PARITY_P99_NS:
        return "int8"
    return "int16"


def _prepass_df(capture_path, proc, signal, foffset_hz, in_dtype, dev, n_chan):
    """The per-file df pre-pass: decimate-by-N bounded-prefix read ->
    squaring-FFT argmax per channel (``main.cpp:363-450``; channel 2
    searches the whole spectrum, the ``main.cpp:442`` quirk).  On the
    card the decimated samples ship in the run's transfer format.
    Returns ([df...], wall_seconds)."""
    t0 = time.time()
    dec = bound_prepass_window(io.decimate_sc16(
        capture_path, proc.df_decimation, channels=2,
        max_out=PREPASS_MAX_SAMPLES,
    ))
    if dec.shape[-1] == 0:
        raise ValueError(
            f"capture {capture_path!r} is empty (no complete frames) — "
            "nothing to process"
        )

    def _pfd(x, windowed):
        kw = dict(foffset_hz=foffset_hz, windowed=windowed)
        if dev.type == "cuda":
            ri = torch.as_tensor(_pack_prepass(x, in_dtype)).to(dev)
            return per_file_df_ri(ri, signal.fs, proc.df_decimation, **kw)
        return per_file_df(torch.as_tensor(x), signal.fs, proc.df_decimation, **kw)

    dfs = [float(_pfd(dec[0], True))]
    if n_chan == 2:
        dfs.append(float(_pfd(dec[1], False)))  # main.cpp:442 quirk
    return dfs, time.time() - t0


def _make_reader(capture_path, n_chan, in_dtype, B, L, stats):
    """``read(start, out) -> (n, scale)``: fill ``out`` ((B, L, 4) for both
    channels, (B, L, 2) for channel 1 alone) with the epochs from sample
    ``start`` in the transfer format."""
    select = None if n_chan == 2 else 0

    def read(start, out):
        scale = None
        if in_dtype == np.int8:
            _, n, scale = io.read_sc16_epochs_q8(
                capture_path, start, B, L, channels=2, timers=stats,
                select=select, out=out)
        elif in_dtype == np.int16:
            _, n = io.read_sc16_epochs_raw16(
                capture_path, start, B, L, channels=2, timers=stats,
                select=select, out=out)
        elif n_chan == 2:
            _, n = io.read_sc16_epochs_packed(
                capture_path, start, B, L, channels=2, dtype=in_dtype,
                timers=stats, out=out)
        else:
            _, n = io.read_sc16_epochs_ri(
                capture_path, start, B, L, channels=2, dtype=in_dtype,
                timers=stats, select=0, out=out[None])
        return n, scale

    return read


def process_capture_overlapped(
    capture_path: str,
    code_path: str,
    signal: SignalConfig,
    proc: ProcessingConfig | None = None,
    remote: bool = False,
    foffset_hz: float = 0.0,
    batch_epochs: int = 50,
    out_mat: str | None = None,
    prefetch: int = 2,
    ingest_dtype: str | None = None,
    parity_ns: float | None = None,
    device=None,
) -> dict:
    """GoRanging semantics end to end, host IO overlapped with device
    compute, on ``device`` (default ``cuda``).

    Returns ``{"ch1", "ch2", "df", "mat_path", "timing"}`` like the JAX
    package's function, and writes the C-convention ``.mat``.  ``timing``
    holds the wall seconds of the pre-pass, the epoch loop, the ``.mat``
    write and the whole call, plus the reader's ``disk_s``/``convert_s``/
    ``bytes_read`` and the loop's ``h2d_call_s``/``dispatch_call_s``/
    ``fetch_s``/``bytes_shipped``/``n_batches``/``loop_effective_mbps``.
    """
    dev = resolve_device(device)
    accel = dev.type == "cuda"
    proc = proc or ProcessingConfig(hamming_window=True)
    t_all = time.time()
    rep = build_replica(code_path, signal, proc, conjugate=True)
    L = rep.samples_per_code
    B = batch_epochs
    n_chan = 1 if remote else 2
    in_dtype = np.dtype(_resolve_ingest_dtype(ingest_dtype, parity_ns, accel))

    stats: dict = {"disk_s": 0.0, "convert_s": 0.0, "bytes_read": 0,
                   "h2d_call_s": 0.0, "dispatch_call_s": 0.0,
                   "fetch_s": 0.0, "bytes_shipped": 0, "n_batches": 0}

    # --- host batch buffers and the reader thread ----------------------
    # A buffer goes back to `free` with the event of the copy that read
    # it; the reader waits on that event before refilling it.
    width = 2 * n_chan
    free: queue.Queue = queue.Queue()
    for _ in range(prefetch + 2):
        t = torch.zeros((B, L, width), dtype=getattr(torch, in_dtype.name),
                        pin_memory=accel)
        free.put((t, None))
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    read = _make_reader(capture_path, n_chan, in_dtype, B, L, stats)

    def reader():
        # any failure must surface on the queue: a dead reader with no
        # sentinel would hang the consumer
        try:
            start = 0
            while True:
                buf, ev = free.get()
                if ev is not None:
                    ev.synchronize()
                arr = buf.numpy()
                n, scale = read(start, arr)
                if n == 0:
                    break
                if n < B:
                    arr[n:] = 0  # zero-pad the final partial batch
                q.put((buf, n, scale))
                start += n * L
                if n < B:
                    break
        except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
            q.put(e)
            return
        q.put(None)

    th = threading.Thread(target=reader, daemon=True)
    th.start()

    # --- df pre-pass, overlapped with the reader filling its window ----
    dfs, t_df = _prepass_df(capture_path, proc, signal, foffset_hz, in_dtype,
                            dev, n_chan)

    t0 = time.time()
    step = boundary.make_ranging_step(
        rep.fcode, rep.code_interp, np.ones(L, bool), signal.fs,
        nint=proc.nint, packed=True, device=dev,
    )
    # (n_chan*B,) per-epoch fixed df, uploaded once
    dfv = torch.as_tensor(np.repeat(np.asarray(dfs[:n_chan], np.float32), B)).to(dev)
    if accel:
        copy_stream = torch.cuda.Stream(device=dev)
        compute_stream = torch.cuda.current_stream(dev)
        out_bufs = [torch.empty((n_chan * B, boundary.PACKED_WIDTH),
                                dtype=torch.float32, pin_memory=True)
                    for _ in range(2)]

    chans = [ChannelArrays() for _ in range(n_chan)]
    pending: list[tuple] = []  # (host rows, event, n) not yet drained

    def drain(entry):
        rows, done, n = entry
        tf = time.perf_counter()
        if done is not None:
            done.synchronize()
        # copy out of the (reused) pinned buffer before decoding
        fetched = rows.numpy().copy()
        stats["fetch_s"] += time.perf_counter() - tf
        res = boundary.to_epoch_result(boundary.unpack_outputs(fetched))
        for c in range(n_chan):
            sl = slice(c * B, c * B + n)
            sub = type(res)(**{f: getattr(res, f)[sl]
                               for f in res.__dataclass_fields__})
            chans[c].extend(sub, np.full((n,), dfs[c]))

    while True:
        item = q.get()
        if item is None:
            break
        if isinstance(item, BaseException):
            raise item  # the reader thread failed
        buf, n, scale = item
        stats["n_batches"] += 1
        th2 = time.perf_counter()
        if accel:
            with torch.cuda.stream(copy_stream):
                iq = buf.to(dev, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(copy_stream)
            compute_stream.wait_event(copied)
            iq.record_stream(compute_stream)
        else:
            iq = buf
        stats["h2d_call_s"] += time.perf_counter() - th2
        stats["bytes_shipped"] += buf.numel() * buf.element_size()
        td = time.perf_counter()
        outs = step(iq, df_fixed=dfv, scale=scale)
        if accel:
            rows = out_bufs[stats["n_batches"] % 2]
            rows.copy_(outs, non_blocking=True)
            done = torch.cuda.Event()
            done.record(compute_stream)
            free.put((buf, copied))
        else:
            rows, done = outs, None
            free.put((buf, None))  # the CPU step has already read it
        stats["dispatch_call_s"] += time.perf_counter() - td
        pending.append((rows, done, n))
        if len(pending) > 1:
            drain(pending.pop(0))
    for entry in pending:
        drain(entry)
    th.join()
    t_loop = time.time() - t0

    out = {
        "ch1": chans[0].asdict(),
        "ch2": chans[1].asdict() if n_chan == 2 else None,
        "df": dfs,
    }
    t0 = time.time()
    out_mat = out_mat or default_mat_name(capture_path, remote)
    matio.save_c_style(out_mat, out["ch1"], out["ch2"])
    out["mat_path"] = out_mat
    stats["loop_effective_mbps"] = (
        stats["bytes_shipped"] / t_loop / 1e6 if t_loop > 0 else 0.0
    )
    out["timing"] = {
        "df_prepass_s": t_df,
        "epoch_loop_s": t_loop,
        "mat_write_s": time.time() - t0,
        "total_s": time.time() - t_all,
        **{k: (round(v, 3) if isinstance(v, float) else v)
           for k, v in stats.items()},
    }
    return out


@dataclass
class BatchReport:
    processed: list[str]
    skipped: list[str]
    failed: list[tuple[str, str]]


def process_directory(
    datadir: str,
    code_path: str,
    signal: SignalConfig,
    proc: ProcessingConfig | None = None,
    station: StationConfig | None = None,
    chain: str = "claudio",
    remote: bool = False,
    device=None,
) -> BatchReport:
    """Process every unprocessed capture in ``datadir`` (goprocess.sh) on
    ``device`` (default ``cuda``; a missing card raises before any
    capture is touched).

    ``chain``: ``claudio`` (single-channel files ``*_{1,2}.bin``),
    ``godual`` or ``goranging`` (dual-channel ``1*.bin``).  A capture
    whose chain raises is recorded in ``failed`` and the batch goes on;
    nothing is retried on another device.  Outputs are gzipped and inputs
    moved to ``donetw/`` on success (``claudio_...separate.m:210-215``).
    """
    dev = resolve_device(device)
    proc = proc or ProcessingConfig()
    station = station or StationConfig()
    pattern = f"*_{station.remote_channel}.bin" if chain == "claudio" else "1*.bin"
    report = BatchReport([], [], [])
    for cap in sorted(glob.glob(os.path.join(datadir, pattern))):
        try:
            if chain == "claudio":
                out = claudio.process_file(
                    cap, code_path, signal, proc, station,
                    remote=remote, device=dev,
                )
            elif chain == "godual":
                out = godual.process_file(
                    cap, code_path, signal, proc, station,
                    remote=remote, device=dev,
                )
            elif chain == "goranging":
                out = goranging.process_file(
                    cap, code_path, signal, proc, remote=remote, device=dev,
                )
            else:
                raise ValueError(f"unknown chain {chain!r}")
        except Exception as e:  # noqa: BLE001 — keep the batch going
            report.failed.append((cap, repr(e)))
            continue
        if out is None:
            report.skipped.append(cap)
            continue
        if out.get("mat_path"):
            matio.gzip_file(out["mat_path"])
        io.move_to_done(cap)
        report.processed.append(cap)
    return report


def gzip_archives(directory: str) -> list[str]:
    """gzip the bare ``*.mat`` archives in a directory (``goprocess.sh``
    preamble)."""
    return [matio.gzip_file(p)
            for p in sorted(glob.glob(os.path.join(directory, "*.mat")))]


def next_sampling_window(now: _dt.datetime) -> tuple[_dt.datetime, float]:
    """Next acquisition window start + duration (s).

    Reference cron: ``3,45`` minutes past **odd** hours, 5.5-minute
    captures (``acquisition/crontab:1-2``, ``rx_multi_samples.cpp:38``).
    """
    cand = []
    for day_offset in (0, 1):
        base = (now + _dt.timedelta(days=day_offset)).replace(
            minute=0, second=0, microsecond=0
        )
        for h in range(24):
            if h % 2 == 0:  # crontab "1-23/2" = odd hours
                continue
            for m in (3, 45):
                t = base.replace(hour=h) + _dt.timedelta(minutes=m)
                if t > now:
                    cand.append(t)
    return min(cand), 330.0


def next_processing_time(now: _dt.datetime) -> _dt.datetime:
    """Processing fires at :53 of odd hours (``acquisition/crontab:3``)."""
    cand = []
    for day_offset in (0, 1):
        base = (now + _dt.timedelta(days=day_offset)).replace(
            minute=53, second=0, microsecond=0
        )
        for h in range(24):
            if h % 2 == 0:
                continue
            t = base.replace(hour=h)
            if t > now:
                cand.append(t)
    return min(cand)


def retry_until_valid(
    action: Callable[[], str],
    validate: Callable[[str], bool],
    attempts: int = 5,
    delay_s: float = 1.0,
    on_retry: Callable[[], None] | None = None,
) -> str | None:
    """Run ``action`` until ``validate(result)`` — the acquisition retry
    loop (``gosampling.sh:13-18``: loop until file2.bin > 10 blocks, with
    a device reset between attempts)."""
    for i in range(attempts):
        out = action()
        if validate(out):
            return out
        if i == attempts - 1:
            break  # no attempt follows: skip the reset + delay
        if on_retry:
            on_retry()
        time.sleep(delay_s)
    return None


def follow_capture(
    path: str,
    signal: SignalConfig,
    *,
    channels: int = 2,
    epochs_per_batch: int = 25,
    poll_s: float = 0.2,
    timeout_s: float = 10.0,
    stop_when_idle: bool = False,
):
    """Near-real-time monitor of a *growing* capture file.

    The reference streams X310 samples over ZMQ into a live Qt display
    (``experiments/2403/x310_twstft_gr.py``, ``zmq_rx.py:1-285``); the
    file-level equivalent tails the capture as the SDR writes it and
    yields ``(epoch_index, channel, iq_batch)`` tuples (complex64
    ``(epochs_per_batch, L)``) as soon as a full batch of code periods is
    available per channel.  Stops after ``timeout_s`` without a new batch
    (acquisition ended), or as soon as no new full batch is buffered when
    ``stop_when_idle``.
    """
    L = signal.samples_per_code
    consumed = 0  # complete batches yielded
    idle = 0.0
    while True:
        try:
            avail = io.n_samples_sc16(path, channels=channels)
        except OSError:
            avail = 0
        ready = int(avail // (epochs_per_batch * L))
        if ready > consumed:
            idle = 0.0
            for b in range(consumed, ready):
                d, n = io.read_sc16_epochs(
                    path, b * epochs_per_batch * L, epochs_per_batch, L,
                    channels=channels,
                )
                if n == 0:
                    break
                for ch in range(channels):
                    yield b * epochs_per_batch, ch, d[ch]
            consumed = ready
        else:
            if stop_when_idle:
                return
            idle += poll_s
            if idle >= timeout_s:
                return
            time.sleep(poll_s)
