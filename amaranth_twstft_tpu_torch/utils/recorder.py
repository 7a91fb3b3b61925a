"""Acquisition recorder: fc32 sample stream -> sc16 capture file.

The port's copy of the JAX package's ``utils/recorder.py`` (stdlib and
NumPy, no device).  The GRC acquisition flowgraph
(``processing/Python/b210_file.py:38-78``) is: USRP 2-channel fc32
source -> per-sample channel interleave ->
``multiply_const_cc(32767)`` -> ``complex_to_interleaved_short`` ->
``head(samp_rate*duree*2*2)`` -> file sink.  No SDR vendor library runs in
this deployment, so the recorder keeps every software stage of that
graph and accepts the fc32 stream from any byte source — a pipe from an
SDR process, a TCP socket (the X310's 10GbE role), or a file — and
writes the canonical interleaved sc16 capture the processing chains
ingest (``rx_multi_samples.cpp:155`` wire format).
"""

from __future__ import annotations

import socket
import sys

import numpy as np

__all__ = ["record_fc32_stream", "open_source"]


def open_source(spec: str):
    """Open a byte source: ``-`` = stdin, ``tcp:HOST:PORT`` = connect
    and stream (the 10GbE capture-link role), else a file/FIFO path."""
    if spec == "-":
        return sys.stdin.buffer
    if spec.startswith("tcp:"):
        _, host, port = spec.split(":", 2)
        s = socket.create_connection((host or "127.0.0.1", int(port)))
        return s.makefile("rb")
    return open(spec, "rb")


def record_fc32_stream(
    src,
    out_path: str,
    fs: float,
    seconds: float,
    channels: int = 2,
    scale: float = 32767.0,
    chunk_frames: int = 1 << 18,
) -> int:
    """Record an interleaved-fc32 stream to an sc16 file.

    ``src`` is a binary file-like yielding complex64 samples interleaved
    per frame (``[ch0, ch1, ch0, ch1, ...]`` — the ``blocks.interleave``
    order); frames are scaled by ``scale`` (``multiply_const_cc``),
    saturated to int16 (``complex_to_interleaved_short``) and written
    until ``fs*seconds`` frames (the ``head`` block bound:
    ``samp_rate*duree*2*2`` shorts) or EOF.  Short tails that do not
    fill a whole frame are dropped.  Returns frames written.
    """
    head_frames = int(fs * seconds)
    frame_bytes = 8 * channels  # complex64 per channel
    written = 0
    with open(out_path, "wb") as out:
        carry = b""
        while written < head_frames:
            want = min(chunk_frames, head_frames - written)
            data = src.read(want * frame_bytes - len(carry))
            if not data:
                break
            buf = carry + data
            n = len(buf) // frame_bytes
            carry = buf[n * frame_bytes:]
            if n == 0:
                continue
            z = np.frombuffer(
                buf[: n * frame_bytes], dtype=np.complex64
            ).reshape(n, channels)
            frame = np.empty((n, 2 * channels), np.int16)
            for c in range(channels):
                frame[:, 2 * c] = np.clip(
                    np.rint(z[:, c].real * scale), -32768, 32767
                )
                frame[:, 2 * c + 1] = np.clip(
                    np.rint(z[:, c].imag * scale), -32768, 32767
                )
            out.write(frame.tobytes())
            written += n
    return written
