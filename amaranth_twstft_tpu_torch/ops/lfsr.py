"""Fibonacci LFSR / m-sequence PRN mathematics (NumPy).

The port's copy of the JAX package's ``ops/lfsr.py`` numpy paths: the
reference gateware shifts the register right and inserts
``xor(reg & taps)`` at the MSB each chip, with the LSB as the chip output
(``amaranth_twstft/prn.py:43-47``); the m-sequence taps search
brute-forces the full period (``amaranth_twstft/common.py:32-57``,
``tools/mseq_calculator.c:9-38``).

There is no native engine here: :func:`find_mseq_taps` is the NumPy
lockstep search (about 9 s for 120 17-bit taps on one core).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "lfsr_next",
    "prn_chips",
    "prn_chips_batch",
    "is_mseq",
    "find_mseq_taps",
    "prn_default_filename",
    "write_prn_file",
    "read_prn_file",
]


def lfsr_next(state: int, taps: int, bit_len: int) -> int:
    """One LFSR step: right shift, parity(state & taps) into the MSB."""
    bit = bin(state & taps).count("1") & 1
    return (state >> 1) | (bit << (bit_len - 1))


def prn_chips(bit_len: int, taps: int, n: int, seed: int = 1) -> np.ndarray:
    """First ``n`` chips (0/1 int8) of the PRN stream.

    Chip i is ``state & 1`` *before* the i-th shift (the byte stream of
    ``write_prn_seq``, ``amaranth_twstft/common.py:66-71``); sequences
    longer than the LFSR period repeat.
    """
    period = (1 << bit_len) - 1
    m = min(n, period)
    out = np.empty(m, dtype=np.int8)
    state = seed
    for i in range(m):
        out[i] = state & 1
        state = lfsr_next(state, taps, bit_len)
    if n <= period:
        return out
    reps = -(-n // period)
    return np.tile(out, reps)[:n]


def prn_chips_batch(
    bit_len: int, taps: np.ndarray, n: int, seed: int = 1
) -> np.ndarray:
    """First ``n`` chips for a BATCH of tap masks -> (len(taps), n) int8:
    every LFSR stepped in lockstep by one NumPy pass."""
    taps = np.asarray(taps, dtype=np.uint64)
    period = (1 << bit_len) - 1
    m = min(n, period)
    state = np.full(taps.shape, seed, dtype=np.uint64)
    msb = np.uint64(1) << np.uint64(bit_len - 1)
    one = np.uint64(1)
    out = np.empty((len(taps), m), dtype=np.int8)
    for i in range(m):
        out[:, i] = (state & one).astype(np.int8)
        bits = _parity64(state & taps)
        state = (state >> one) | (bits * msb)
    if n <= period:
        return out
    reps = -(-n // period)
    return np.tile(out, (1, reps))[:, :n]


def _parity64(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> np.uint64(32))
    x = x ^ (x >> np.uint64(16))
    x = x ^ (x >> np.uint64(8))
    x = x ^ (x >> np.uint64(4))
    x = x ^ (x >> np.uint64(2))
    x = x ^ (x >> np.uint64(1))
    return x & np.uint64(1)


def is_mseq(bit_len: int, taps: int, seed: int = 1) -> bool:
    """True iff ``taps`` generates a maximal-length sequence: after
    2**bit_len - 2 steps the state has revisited neither the seed nor 0
    (``amaranth_twstft/common.py:44-51``)."""
    period = (1 << bit_len) - 1
    s = int(seed)
    for _ in range(period - 1):
        bit = bin(s & taps).count("1") & 1
        s = (s >> 1) | (bit << (bit_len - 1))
        if s == seed or s == 0:
            return False
    return True


def find_mseq_taps(
    bit_len: int, limit: int = 10, seed: int = 1, chunk: int = 4096
) -> list[int]:
    """First ``limit`` odd tap masks generating m-sequences, ascending
    (``m_seq_codes``, ``amaranth_twstft/common.py:32-57``).

    NumPy-batched search: ``chunk`` candidates step in lockstep; any whose
    state revisits the seed or reaches zero before the full period is
    dropped, and survivors are compacted as they die.
    """
    period = (1 << bit_len) - 1
    msb = np.uint64(1) << np.uint64(bit_len - 1)
    seed64 = np.uint64(seed)
    found: list[int] = []
    for start in range(1, 1 << bit_len, 2 * chunk):
        stop = min(start + 2 * chunk, 1 << bit_len)
        cands = np.arange(start, stop, 2, dtype=np.uint64)
        state = np.full(cands.shape, seed, dtype=np.uint64)
        steps_done = 0
        while steps_done < period - 1 and len(cands):
            block = min(1024, period - 1 - steps_done)
            dead = np.zeros(cands.shape, dtype=bool)
            for _ in range(block):
                bits = _parity64(state & cands)
                state = (state >> np.uint64(1)) | (bits * msb)
                dead |= (state == seed64) | (state == 0)
            if dead.any():
                keep = ~dead
                cands, state = cands[keep], state[keep]
            steps_done += block
        found.extend(int(t) for t in cands)
        if len(found) >= limit:
            break
    return found[:limit]


# ----------------------------------------------------------------------
# PRN file IO, byte-compatible with ``write_prn_seq``
# (``amaranth_twstft/common.py:59-73``): 1 byte per chip, value 0 or 1;
# QPSK interleaves the A and B streams.
# ----------------------------------------------------------------------
def prn_default_filename(bit_len: int, noiselen: int, taps_a: int,
                         taps_b: int | None = None) -> str:
    """Reference naming scheme (``amaranth_twstft/common.py:61``)."""
    suffix = f".{taps_b}q" if taps_b else "b"
    return f"prn{taps_a}{suffix}psk{bit_len}bits.bin"


def write_prn_file(
    path: str,
    bit_len: int,
    noiselen: int,
    taps_a: int,
    taps_b: int | None = None,
    seed: int = 1,
) -> None:
    a = prn_chips(bit_len, taps_a, noiselen, seed)
    if taps_b is None:
        data = a.astype(np.uint8)
    else:
        b = prn_chips(bit_len, taps_b, noiselen, seed)
        data = np.empty(2 * noiselen, dtype=np.uint8)
        data[0::2] = a
        data[1::2] = b
    with open(path, "wb") as f:
        f.write(data.tobytes())


def read_prn_file(path: str, qpsk: bool = False):
    """Read a PRN chip file (0/1 bytes) -> int8 array(s), as the chains
    do (``godual_ranging.m:63``, ``processing/CPP/main.cpp:673``)."""
    raw = np.fromfile(path, dtype=np.uint8)
    if not qpsk:
        return raw.astype(np.int8)
    return raw[0::2].astype(np.int8), raw[1::2].astype(np.int8)
