"""Capture ingest: sc16 interleaved IQ files (NumPy, torch on the host).

The port's copy of the JAX package's ``utils/io.py`` readers.  The format
is the reference's interleaved 16-bit IQ (``acquisition/
rx_multi_samples.cpp:155``); the dual-channel layout has int16 frames
``[I1 Q1 I2 Q2]`` (``godual_ranging.m:76-80``, ``processing/CPP/
main.cpp:475-483``).

Every read of sample bytes is one call into the port's native library
(:mod:`amaranth_twstft_tpu_torch.native`), which maps the file, so a
long capture never materializes on the host; this module only sizes,
shapes and casts the arrays.  The batch readers of the GoRanging
pipeline take an optional ``out`` array (for example a NumPy view of a
pinned host buffer) and fill its first ``n`` epochs instead of
allocating; the values are the same either way.  ``open_sc16`` memmaps
a file for callers outside the readers.
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np
import torch

from amaranth_twstft_tpu_torch import native
from amaranth_twstft_tpu_torch.utils.profiling import span

__all__ = [
    "open_sc16",
    "n_samples_sc16",
    "read_sc16_epochs",
    "read_sc16_epochs_ri",
    "read_sc16_epochs_packed",
    "read_sc16_epochs_q8",
    "read_sc16_epochs_raw16",
    "read_raw16",
    "decimate_sc16",
    "write_sc16",
    "already_done",
    "move_to_done",
]


def open_sc16(path: str, channels: int = 2) -> np.ndarray:
    """Memmap an sc16 file as an int16 array of shape (n, 2*channels);
    empty or sub-frame files yield a (0, frame) array."""
    frame = 2 * channels
    size = os.path.getsize(path) // (2 * frame)
    if size == 0:
        return np.zeros((0, frame), dtype=np.int16)
    return np.memmap(path, dtype=np.int16, mode="r", shape=(size, frame))


def n_samples_sc16(path: str, channels: int = 2) -> int:
    return os.path.getsize(path) // (4 * channels)


def _n_epochs(path: str, channels: int, start_sample: int, n_epochs: int,
              L: int) -> int:
    total = n_samples_sc16(path, channels)
    return min(n_epochs, max(0, (total - start_sample) // L))


def _account(timers: dict | None, disk_s: float, convert_s: float,
             nbytes: int) -> None:
    """Accumulate the pipeline's per-stage attribution (``disk_s``: the
    native read, ``convert_s``: the cast to the transfer format,
    ``bytes_read``: the sc16 bytes read)."""
    if timers is None:
        return
    timers["disk_s"] = timers.get("disk_s", 0.0) + disk_s
    timers["convert_s"] = timers.get("convert_s", 0.0) + convert_s
    timers["bytes_read"] = timers.get("bytes_read", 0) + nbytes


def read_sc16_epochs(
    path: str,
    start_sample: int,
    n_epochs: int,
    samples_per_epoch: int,
    channels: int = 2,
    dtype=np.complex64,
):
    """Read ``n_epochs`` contiguous epochs -> (channels, n_epochs, L)
    complex; short tails are dropped.  Returns (array, n_read).

    One threaded native pass from the memory map fills a complex64
    array's float32 view (``native.ingest_into``); another ``dtype`` is
    cast from it.  Each part is ``(float)int16``, exact in any complex
    dtype."""
    n = _n_epochs(path, channels, start_sample, n_epochs, samples_per_epoch)
    if n == 0:
        return np.zeros((channels, 0, samples_per_epoch), dtype=dtype), 0
    n_frames = n * samples_per_epoch
    with span("io.read_sc16.to_complex"):
        out = np.empty((channels, n, samples_per_epoch), dtype=np.complex64)
        ri = [out[c].reshape(-1).view(np.float32) for c in range(channels)]
    with span("io.read_sc16.to_f32", frames=n_frames) as sp:
        threads = native.ingest_into(path, start_sample, n_frames, ri)
        if sp is not None:
            sp.counts["threads"] = threads
    return out.astype(dtype, copy=False), n


def read_sc16_epochs_ri(
    path: str,
    start_sample: int,
    n_epochs: int,
    samples_per_epoch: int,
    channels: int = 2,
    dtype=np.float32,
    timers: dict | None = None,
    select: int | None = None,
    out: np.ndarray | None = None,
):
    """Epochs as re/im pairs: (channels, n, L, 2) float, or (1, n, L, 2)
    of channel ``select`` only.  Returns (array, n_read); with ``out``
    (C-contiguous, shape (n_out, >= n, L, 2)) the array is ``out[:, :n]``.

    All channels: one threaded native pass (``native.ingest_into``)
    fills float32 rows, ``out``'s own or an array cast once.  One
    channel: the native int16 copy and one cast (:func:`_read_cast`)."""
    L = samples_per_epoch
    n = _n_epochs(path, channels, start_sample, n_epochs, L)
    n_out = 1 if select is not None else channels
    if n == 0:
        return np.zeros((n_out, 0, L, 2), dtype), 0
    if out is None:
        out = np.empty((n_out, n, L, 2), dtype=dtype)
    if select is not None:
        _read_cast(path, start_sample, n * L, channels, select,
                   _flat_out(out[0], n, L, 2), timers)
        return out[:, :n], n
    f32 = out if out.dtype == np.float32 else np.empty((n_out, n, L, 2), np.float32)
    t0 = time.perf_counter()
    native.ingest_into(path, start_sample, n * L,
                       [_flat_out(f32[c], n, L, 2) for c in range(n_out)])
    t1 = time.perf_counter()
    if f32 is not out:
        out[:, :n] = f32
    _account(timers, t1 - t0, time.perf_counter() - t1, 4 * channels * n * L)
    return out[:, :n], n


def read_sc16_epochs_packed(
    path: str,
    start_sample: int,
    n_epochs: int,
    samples_per_epoch: int,
    channels: int = 2,
    dtype=np.float16,
    timers: dict | None = None,
    out: np.ndarray | None = None,
):
    """Epochs in the file's interleaved order: (n, L, 2*channels) float.

    The native int16 copy and one contiguous torch cast
    (:func:`_read_cast`), zero strided copies; the ranging step
    deinterleaves (:func:`amaranth_twstft_tpu_torch.ops.boundary.ranging_step`)."""
    L = samples_per_epoch
    n = _n_epochs(path, channels, start_sample, n_epochs, L)
    width = 2 * channels
    if n == 0:
        return np.zeros((0, L, width), dtype), 0
    if out is None:
        out = np.empty((n, L, width), dtype=dtype)
    if out.dtype != np.dtype(dtype):
        raise ValueError(f"out is {out.dtype}, the reader was asked for {dtype}")
    _read_cast(path, start_sample, n * L, channels, None,
               _flat_out(out, n, L, width), timers)
    return out[:n], n


def _read_cast(path: str, start_frame: int, n_frames: int, channels: int,
               select: int | None, dst: np.ndarray, timers: dict | None) -> None:
    """Frames ``[start_frame, start_frame + n_frames)``, every channel's
    columns or channel ``select``'s, into the float (n_frames, width)
    ``dst``: the native int16 copy (``disk_s``), then one torch cast
    (``convert_s``)."""
    t0 = time.perf_counter()
    raw, got = native.read_raw16(path, start_frame, n_frames, channels=channels,
                                 select=-1 if select is None else select)
    if got != n_frames:
        raise OSError(f"{path}: {got} of {n_frames} frames read (the file "
                      "shrank during the read)")
    t1 = time.perf_counter()
    torch.from_numpy(dst).copy_(torch.from_numpy(raw))
    _account(timers, t1 - t0, time.perf_counter() - t1, raw.nbytes)


def _flat_out(out: np.ndarray, n: int, L: int, width: int) -> np.ndarray:
    """``out[:n]`` as the (n * L, width) view the native library writes
    into (a reshape that would copy is refused, not written to)."""
    if not out.flags.c_contiguous:
        raise ValueError("out must be C-contiguous")
    return out[:n].reshape(n * L, width)


def _pow2_shift(smax: float) -> int:
    """Smallest sh >= 0 with 127 << sh >= max|x| — integer-exact, the
    native quantizer's formula (``ingest.cpp`` ``twstft_quantize_q8``)."""
    sh = 0
    while (127 << sh) < smax:
        sh += 1
    return sh


def _quantize_q8_plain(raw: np.ndarray, pow2: bool, out: np.ndarray) -> float:
    """The plain chunked torch quantizer (the native one's reference):
    int16 ``raw`` -> int8 ``out`` (same size) in 2^21-element chunks, so
    the intermediate stays in cache.  Exact scale ``max|x|/127`` and
    ``q = round(x / scale)``, or with ``pow2`` the power-of-2 scale and
    the integer rounding shift.  Returns the scale."""
    chunk = 1 << 21
    t = torch.from_numpy(raw).view(-1)
    qt = torch.from_numpy(out).view(-1)
    # max|x| via min/max: abs() of int16 -32768 wraps
    smax = float(max(int(t.max()), -int(t.min())))
    if pow2:
        sh = _pow2_shift(smax)
        half = 1 << (sh - 1) if sh > 0 else 0
        for i in range(0, t.numel(), chunk):
            # int32 before the rounding add: on int16, x + half wraps for
            # near-full-scale samples and flips sign after the shift
            blk = (t[i : i + chunk].to(torch.int32) + half) >> sh
            qt[i : i + chunk] = blk.clamp_(-127, 127).to(torch.int8)
        return float(1 << sh)
    scale = max(smax, 1.0) / 127.0
    inv = 1.0 / scale
    for i in range(0, t.numel(), chunk):
        blk = t[i : i + chunk].to(torch.float32)
        blk.mul_(inv).round_().clamp_(-127, 127)
        qt[i : i + chunk] = blk.to(torch.int8)
    return scale


def read_sc16_epochs_q8(
    path: str,
    start_sample: int,
    n_epochs: int,
    samples_per_epoch: int,
    channels: int = 2,
    timers: dict | None = None,
    select: int | None = None,
    out: np.ndarray | None = None,
):
    """int8-quantized epochs: (n, L, 2*channels) int8 (or (n, L, 2) of
    channel ``select``) and the batch's scale.

    ``q = round(x / scale)`` with the exact ``scale = max|x| / 127``
    (PARITY.md deviation 10); ``TWSTFT_Q8_POW2=1`` takes the power-of-2
    scale with an integer rounding shift instead.  The native threaded
    quantizer does page-in, min/max and quantize in one call and books
    it under ``convert_s`` and ``native_q8_s`` (adding nothing to
    ``disk_s``), bit for bit :func:`_quantize_q8_plain`.  Returns (q,
    n_read, scale)."""
    L = samples_per_epoch
    n = _n_epochs(path, channels, start_sample, n_epochs, L)
    width = 2 if select is not None else 2 * channels
    if n == 0:
        return np.zeros((0, L, width), np.int8), 0, 1.0
    if out is None:
        out = np.empty((n, L, width), np.int8)
    flat = _flat_out(out, n, L, width)
    t0 = time.perf_counter()
    _, got, scale = native.quantize_q8(
        path, start_sample, n * L, channels=channels,
        select=-1 if select is None else select,
        pow2=os.environ.get("TWSTFT_Q8_POW2") == "1", out=flat)
    if got != n * L:
        raise OSError(f"{path}: {got} of {n * L} frames read (the file "
                      "shrank during the read)")
    if timers is not None:
        # one call spans page-in and quantize: no disk_s split
        dt = time.perf_counter() - t0
        for k in ("convert_s", "native_q8_s"):
            timers[k] = timers.get(k, 0.0) + dt
        timers["bytes_read"] = timers.get("bytes_read", 0) + 2 * flat.size
    return out[:n], n, scale


def read_sc16_epochs_raw16(
    path: str,
    start_sample: int,
    n_epochs: int,
    samples_per_epoch: int,
    channels: int = 2,
    timers: dict | None = None,
    select: int | None = None,
    out: np.ndarray | None = None,
):
    """Raw int16 epochs: (n, L, 2*channels) (or (n, L, 2) of channel
    ``select``) — the sc16 wire format shipped as is.  One threaded
    native copy out of the mmap and no conversion; the ranging step
    casts to float32, which is exact for every int16.  Returns (a,
    n_read)."""
    n = _n_epochs(path, channels, start_sample, n_epochs, samples_per_epoch)
    width = 2 if select is not None else 2 * channels
    if n == 0:
        return np.zeros((0, samples_per_epoch, width), np.int16), 0
    if out is None:
        out = np.empty((n, samples_per_epoch, width), np.int16)
    t0 = time.perf_counter()
    _, got = native.read_raw16(
        path, start_sample, n * samples_per_epoch, channels=channels,
        select=-1 if select is None else select,
        out=_flat_out(out, n, samples_per_epoch, width))
    n = got // samples_per_epoch
    _account(timers, time.perf_counter() - t0, 0.0, 2 * n * samples_per_epoch * width)
    return out[:n], n


def read_raw16(
    path: str,
    start_frame: int,
    n_frames: int,
    out: np.ndarray | None = None,
):
    """Raw int16 frame-range copy of a single-channel sc16 file: frames
    ``[start_frame, start_frame + n_frames)`` as (n, 2) int16, through
    the native library (``native.read_raw16``, as the JAX package's
    claudio reads).  With ``out`` (C-contiguous, shape (>= n_frames, 2),
    for example a NumPy view of a pinned buffer) the frames land there.
    Returns (a, n) with ``a`` the first ``n`` rows; a short read at the
    end of the file returns fewer rows."""
    return native.read_raw16(path, start_frame, n_frames, channels=1,
                             out=None if out is None else out[:n_frames])


def decimate_sc16(
    path: str,
    decim: int,
    channels: int = 2,
    dtype=np.complex64,
    max_out: int | None = None,
) -> np.ndarray:
    """Every ``decim``-th complex sample of each channel -> (channels, m)
    (``processing/CPP/main.cpp:371-395``).  ``max_out`` caps the output
    at the first ``max_out`` decimated samples and reads only that
    prefix of the file.  The native strided pass
    (``native.ingest_decimated``) writes float32 (re, im) pairs, viewed
    as complex64 and cast only for another ``dtype``."""
    ri = native.ingest_decimated(path, decim, channels=channels, max_out=max_out)
    return ri.view(np.complex64)[..., 0].astype(dtype, copy=False)


def write_sc16(path: str, *channels_iq: np.ndarray) -> None:
    """Write complex channels as an interleaved sc16 file, clipped to
    int16 like the SDR front end saturates."""
    n = len(channels_iq[0])
    frame = 2 * len(channels_iq)
    out = np.empty((n, frame), dtype=np.int16)
    for c, z in enumerate(channels_iq):
        out[:, 2 * c] = np.clip(np.round(np.real(z)), -32768, 32767)
        out[:, 2 * c + 1] = np.clip(np.round(np.imag(z)), -32768, 32767)
    out.tofile(path)


# Idempotent resume: the reference skips records whose output exists and
# moves processed inputs to ``donetw/`` (``claudio_...separate.m:119,
# 210-218``, ``gofinal_ltfb.m:32``).
def already_done(out_path: str) -> bool:
    return os.path.exists(out_path) or os.path.exists(out_path + ".gz")


def move_to_done(in_path: str, done_dir: str = "donetw") -> str:
    ddir = os.path.join(os.path.dirname(in_path) or ".", done_dir)
    os.makedirs(ddir, exist_ok=True)
    dest = os.path.join(ddir, os.path.basename(in_path))
    shutil.move(in_path, dest)
    return dest
