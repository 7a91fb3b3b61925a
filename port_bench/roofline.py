"""The card's peaks and the least time of a kernel's work, frozen for the
benchmark so that every implementation of a kernel is held to the same
amount of work.

Peaks: NVIDIA H100 SXM data sheet, dense: 3.35 TB/s of HBM3 and
495 TFLOP/s in TF32 (the rate of a float32 contraction on the tensor
cores), at the 700 W power limit.  A kernel's least time is the larger of
its bytes over the bandwidth (each input read once, each output written
once) and its operations over the peak (the contraction's 2*M*N*K flops,
counted once, whatever precision tricks a kernel plays).
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_TF32_FLOPS = 495e12
F32 = 4


def lagbank_window(G: int, P: int, K: int, NL: int) -> dict:
    """The lag bank's window form: ``obs`` (G, 2, P, K) float32 against the
    circular replica extension (G, K + NL - 1) float32, read as NL windows
    of K; out: power, phase, re and im, each (G, P, NL) float32.  The
    contraction is (2P x K) by (K x NL) per channel."""
    nbytes = F32 * (G * 2 * P * K + G * (K + NL - 1) + 4 * G * P * NL)
    flops = 2 * (2 * P) * NL * K * G
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_flops = flops / PEAK_TF32_FLOPS
    return {"bytes": nbytes, "flops": flops, "t_bytes_s": t_bytes, "t_flops_s": t_flops,
            "t_min_s": max(t_bytes, t_flops), "bound": "bytes" if t_bytes >= t_flops else "flops"}
