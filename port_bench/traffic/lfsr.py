"""Fibonacci LFSR chips in NumPy, frozen for the benchmark.

The register shifts right and takes ``parity(state & taps)`` into its top
bit each chip; chip i is the low bit before the i-th shift, from the
state 1 (the TWSTFT gateware's m-sequence generator).  Both the traffic
and the references make their codes here, never from the program.

A whole code is made by many short runs side by side: the states at the
starts of ``lanes`` segments come from powers of the step's matrix over
GF(2), so the slow sequential walk is ``n / lanes`` steps long.
"""

from __future__ import annotations

import numpy as np

__all__ = ["chips", "is_mseq"]


def _parity(x: np.ndarray) -> np.ndarray:
    for s in (32, 16, 8, 4, 2, 1):
        x = x ^ (x >> np.uint64(s))
    return x & np.uint64(1)


def _step(state: np.ndarray, taps: np.ndarray, bit_len: int) -> np.ndarray:
    top = np.uint64(bit_len - 1)
    return (state >> np.uint64(1)) | (_parity(state & taps) << top)


def _step_matrix(taps: np.ndarray, bit_len: int) -> np.ndarray:
    """(T, bit_len, bit_len) 0/1 matrices of one step: column b is the
    image of the state with only bit b set."""
    basis = np.uint64(1) << np.arange(bit_len, dtype=np.uint64)
    img = _step(basis[None, :], taps[:, None], bit_len)  # (T, b)
    bits = (img[:, None, :] >> np.arange(bit_len, dtype=np.uint64)[None, :, None])
    return (bits & np.uint64(1)).astype(np.int64)


def _mat_pow(m: np.ndarray, e: int) -> np.ndarray:
    out = np.broadcast_to(np.eye(m.shape[-1], dtype=np.int64), m.shape).copy()
    while e:
        if e & 1:
            out = (out @ m) & 1
        m = (m @ m) & 1
        e >>= 1
    return out


def chips(bit_len: int, taps, n: int, lanes: int = 512) -> np.ndarray:
    """The first ``n`` chips (0/1 int8) of each tap mask -> (len(taps), n)."""
    taps = np.atleast_1d(np.asarray(taps, dtype=np.uint64))
    seg = -(-n // lanes)
    jump = _mat_pow(_step_matrix(taps, bit_len), seg)  # (T, b, b)
    vec = np.zeros((len(taps), bit_len), np.int64)
    vec[:, 0] = 1  # the state 1
    weights = np.uint64(1) << np.arange(bit_len, dtype=np.uint64)
    starts = np.empty((len(taps), lanes), np.uint64)
    for j in range(lanes):
        starts[:, j] = (vec.astype(np.uint64) * weights).sum(axis=1)
        vec = np.einsum("tij,tj->ti", jump, vec) & 1
    state = starts
    out = np.empty((len(taps), lanes, seg), np.int8)
    tcol = taps[:, None]
    for i in range(seg):
        out[:, :, i] = (state & np.uint64(1)).astype(np.int8)
        state = _step(state, tcol, bit_len)
    return out.reshape(len(taps), lanes * seg)[:, :n]


def is_mseq(bit_len: int, taps: int) -> bool:
    """Whether ``taps`` gives the full period ``2**bit_len - 1`` from 1."""
    period = (1 << bit_len) - 1
    c = chips(bit_len, [taps], 2 * period + 1, lanes=64)[0]
    first_back = np.flatnonzero(
        np.all(np.lib.stride_tricks.sliding_window_view(c, bit_len)
               == c[:bit_len], axis=1))
    return len(first_back) > 1 and int(first_back[1]) == period
