"""Capture ingest: sc16 interleaved IQ files (NumPy, torch on the host).

The port's copy of the JAX package's ``utils/io.py`` readers.  The format
is the reference's interleaved 16-bit IQ (``acquisition/
rx_multi_samples.cpp:155``); the dual-channel layout has int16 frames
``[I1 Q1 I2 Q2]`` (``godual_ranging.m:76-80``, ``processing/CPP/
main.cpp:475-483``).  Reads are memmap-based, so a long capture never
materializes on the host.

The batch readers of the GoRanging pipeline take an optional ``out``
array (for example a NumPy view of a pinned host buffer) and fill its
first ``n`` epochs instead of allocating; the values are the same either
way.  There is no native library here: ``read_sc16_epochs_q8`` is the
chunked torch quantizer with the exact scale ``max|x|/127`` (the JAX
package's native quantizer is bit-identical to that path) and
``read_sc16_epochs_raw16`` is one NumPy copy out of the memmap.
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np
import torch

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

_TORCH_FLOAT = {np.dtype(np.float16): torch.float16,
                np.dtype(np.float32): torch.float32}


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


def _n_epochs(total: int, start_sample: int, n_epochs: int, L: int) -> int:
    return min(n_epochs, max(0, (total - start_sample) // L))


def _account(timers: dict | None, disk_s: float, convert_s: float,
             nbytes: int) -> None:
    """Accumulate the pipeline's per-stage attribution (``disk_s``:
    memmap page-in + copy, ``convert_s``: int16 -> transfer format,
    ``bytes_read``)."""
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
    complex; short tails are dropped.  Returns (array, n_read)."""
    mm = open_sc16(path, channels)
    n = _n_epochs(mm.shape[0], start_sample, n_epochs, samples_per_epoch)
    if n == 0:
        return np.zeros((channels, 0, samples_per_epoch), dtype=dtype), 0
    raw = np.asarray(
        mm[start_sample : start_sample + n * samples_per_epoch]
    ).astype(np.float32)
    out = np.empty((channels, n, samples_per_epoch), dtype=dtype)
    for c in range(channels):
        z = raw[:, 2 * c] + 1j * raw[:, 2 * c + 1]
        out[c] = z.reshape(n, samples_per_epoch)
    return out, n


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
    (shape (n_out, >= n, L, 2)) the array is ``out[:, :n]``."""
    mm = open_sc16(path, channels)
    n = _n_epochs(mm.shape[0], start_sample, n_epochs, samples_per_epoch)
    n_out = 1 if select is not None else channels
    if n == 0:
        return np.zeros((n_out, 0, samples_per_epoch, 2), dtype), 0
    t0 = time.perf_counter()
    sl = mm[start_sample : start_sample + n * samples_per_epoch]
    if select is not None:
        sl = sl[:, 2 * select : 2 * select + 2]
    raw = np.asarray(sl)
    t1 = time.perf_counter()
    conv = raw.astype(dtype)
    if out is None:
        out = np.empty((n_out, n, samples_per_epoch, 2), dtype=dtype)
    for c in range(n_out):
        out[c, :n] = conv[:, 2 * c : 2 * c + 2].reshape(n, samples_per_epoch, 2)
    _account(timers, t1 - t0, time.perf_counter() - t1, raw.nbytes)
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

    One contiguous int16 -> float conversion (torch on the host), zero
    strided copies; the ranging step deinterleaves
    (:func:`amaranth_twstft_tpu_torch.ops.boundary.ranging_step`)."""
    mm = open_sc16(path, channels)
    n = _n_epochs(mm.shape[0], start_sample, n_epochs, samples_per_epoch)
    width = 2 * channels
    if n == 0:
        return np.zeros((0, samples_per_epoch, width), dtype), 0
    t0 = time.perf_counter()
    raw = np.array(mm[start_sample : start_sample + n * samples_per_epoch])
    t1 = time.perf_counter()
    if out is None:
        out = np.empty((n, samples_per_epoch, width), dtype=dtype)
    dst = torch.from_numpy(out[:n].reshape(n * samples_per_epoch, width))
    if dst.dtype != _TORCH_FLOAT[np.dtype(dtype)]:
        raise ValueError(f"out is {out.dtype}, the reader was asked for {dtype}")
    dst.copy_(torch.from_numpy(raw))
    _account(timers, t1 - t0, time.perf_counter() - t1, raw.nbytes)
    return out[:n], n


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
    (PARITY.md deviation 10), in 2^21-element float32 chunks so the
    intermediate stays in cache.  Returns (q, n_read, scale)."""
    mm = open_sc16(path, channels)
    n = _n_epochs(mm.shape[0], start_sample, n_epochs, samples_per_epoch)
    width = 2 if select is not None else 2 * channels
    if n == 0:
        return np.zeros((0, samples_per_epoch, width), np.int8), 0, 1.0
    t0 = time.perf_counter()
    sl = mm[start_sample : start_sample + n * samples_per_epoch]
    if select is not None:
        sl = sl[:, 2 * select : 2 * select + 2]
    raw = np.array(sl)  # a writable copy out of the read-only memmap
    t1 = time.perf_counter()
    chunk = 1 << 21
    t = torch.from_numpy(raw).view(-1)
    # max|x| via min/max: abs() of int16 -32768 wraps
    smax = float(max(int(t.max()), -int(t.min())))
    scale = max(smax, 1.0) / 127.0
    inv = 1.0 / scale
    if out is None:
        out = np.empty((n, samples_per_epoch, width), np.int8)
    qt = torch.from_numpy(out[:n].reshape(-1))
    for i in range(0, t.numel(), chunk):
        blk = t[i : i + chunk].to(torch.float32)
        blk.mul_(inv).round_().clamp_(-127, 127)
        qt[i : i + chunk] = blk.to(torch.int8)
    _account(timers, t1 - t0, time.perf_counter() - t1, raw.nbytes)
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
    ``select``) — the sc16 wire format shipped as is.  One copy out of
    the memmap and no conversion; the ranging step casts to float32,
    which is exact for every int16.  Returns (a, n_read)."""
    mm = open_sc16(path, channels)
    n = _n_epochs(mm.shape[0], start_sample, n_epochs, samples_per_epoch)
    width = 2 if select is not None else 2 * channels
    if n == 0:
        return np.zeros((0, samples_per_epoch, width), np.int16), 0
    t0 = time.perf_counter()
    sl = mm[start_sample : start_sample + n * samples_per_epoch]
    if select is not None:
        sl = sl[:, 2 * select : 2 * select + 2]
    if out is None:
        out = np.empty((n, samples_per_epoch, width), np.int16)
    np.copyto(out[:n].reshape(n * samples_per_epoch, width), sl)
    _account(timers, time.perf_counter() - t0, 0.0, out[:n].nbytes)
    return out[:n], n


def read_raw16(
    path: str,
    start_frame: int,
    n_frames: int,
    out: np.ndarray | None = None,
):
    """Raw int16 frame-range copy of a single-channel sc16 file: frames
    ``[start_frame, start_frame + n_frames)`` as (n, 2) int16 (the JAX
    package's ``native.read_raw16`` memmap branch,
    ``native/__init__.py:293-330``).  With ``out`` (shape (>= n_frames,
    2), for example a NumPy view of a pinned buffer) the frames land
    there.  Returns (a, n) with ``a`` the first ``n`` rows; a short read
    at the end of the file returns fewer rows."""
    mm = open_sc16(path, 1)
    n = min(n_frames, max(0, mm.shape[0] - start_frame))
    if out is None:
        out = np.empty((n, 2), np.int16)
    np.copyto(out[:n], mm[start_frame : start_frame + n])
    return out[:n], n


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
    prefix of the file."""
    mm = open_sc16(path, channels)
    stop = None if max_out is None else max_out * decim
    sub = np.asarray(mm[:stop:decim]).astype(np.float32)
    out = np.empty((channels, sub.shape[0]), dtype=dtype)
    for c in range(channels):
        out[c] = sub[:, 2 * c] + 1j * sub[:, 2 * c + 1]
    return out


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
