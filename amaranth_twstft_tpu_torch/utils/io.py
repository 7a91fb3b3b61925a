"""Capture ingest: sc16 interleaved IQ files (NumPy).

The port's copy of the readers the DLL/PLL path uses from the JAX
package's ``utils/io.py``.  The format is the reference's interleaved
16-bit IQ (``acquisition/rx_multi_samples.cpp:155``); the dual-channel
layout has int16 frames ``[I1 Q1 I2 Q2]``.  Reads are memmap-based.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["open_sc16", "n_samples_sc16", "read_sc16_epochs", "write_sc16"]


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
    total = mm.shape[0]
    n_avail = max(0, (total - start_sample) // samples_per_epoch)
    n = min(n_epochs, n_avail)
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
