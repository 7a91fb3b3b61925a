#!/usr/bin/env python3
"""How far the claudio df hunt lands from a Doppler line, by SNR.

For each amplitude and trial, synthesizes one production 2-s block
(:func:`trial_block`: 5 MS/s, the 100 000-chip 17-bit code on taps 9 at 2
samples per chip, an integer delay, noise 300 per I/Q component) at a
Doppler drawn inside the LTFB claudio window (46.5-53.5 kHz, between FFT
bins), quantizes it to int8 as the resident path does, runs the port's
``search_df_candidates_ri`` and ``refresh_df_ri``, and prints the hunt's
bin offset from the true line and the refreshed df error.  At high SNR
the line's leakage passes the 20x-median gate over many bins; the hunt
keeps the highest-bin candidate that passes the trial correlation, which
the +-3-bin refresh cannot walk back from.  ``tests/test_torch_claudio.py``
runs the JAX package's hunt on the same blocks and requires the same bins
and df.

    python3 tools/claudio_hunt_leakage.py 1000 200 110 [--trials 2] [--device cpu]

A block is 10^7 complex samples: expect a few seconds and ~1 GB per trial
on a CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from amaranth_twstft_tpu_torch.models.claudio import _quantize_q8  # noqa: E402
from amaranth_twstft_tpu_torch.ops import boundary, doppler  # noqa: E402
from amaranth_twstft_tpu_torch.ops.lfsr import prn_chips  # noqa: E402

FS = 5e6
L = 200_000
BLOCK = 10_000_000
NOISE = 300.0
DF_LO, DF_HI = 46.5e3, 53.5e3  # the LTFB window (92-108 kHz) halved
MASK_HZ = (92e3, 108e3)
BIN_HZ = FS / (BLOCK - 1) / 2  # one bin of the doubled axis, in df


def code_samples() -> np.ndarray:
    """The production code, +-1 at 2 samples per chip (L samples)."""
    return np.repeat(prn_chips(17, 9, 100_000).astype(np.float64) * 2 - 1, 2)


def trial_block(code: np.ndarray, amp: float, seed: int, trial: int):
    """Trial ``trial``'s block at amplitude ``amp`` (int16 units) as
    ((BLOCK, 2) int16, true df in Hz), built one code period at a time
    from its own seed."""
    rng = np.random.default_rng([seed, trial, int(round(amp * 1000))])
    df = rng.uniform(DF_LO, DF_HI)
    sig = amp * np.roll(code, 12345)
    raw = np.empty((BLOCK, 2), np.int16)
    for i in range(0, BLOCK, L):
        t = np.arange(i, i + L)
        x = sig * np.exp(2j * np.pi * (df * t / FS + 0.3))
        x += rng.normal(0, NOISE, L) + 1j * rng.normal(0, NOISE, L)
        raw[i : i + L, 0] = np.round(x.real)
        raw[i : i + L, 1] = np.round(x.imag)
    return raw, df


def hunt_inputs(raw: np.ndarray):
    """The resident hunt's inputs: the int8 block and the unquantized
    first code period minus its mean (float32 pairs)."""
    q8, _ = _quantize_q8(raw)
    dc = raw[:L].astype(np.float32)
    dc -= dc.mean(axis=0, keepdims=True)
    return q8, dc


def bins_from_line(kbon: int, df: float) -> float:
    """Distance of shifted-spectrum bin ``kbon`` (halved) from ``df``,
    in bins of the doubled axis."""
    return ((-FS / 2 + kbon * FS / (BLOCK - 1)) / 2 - df) / BIN_HZ


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("amplitudes", type=float, nargs="+", help="int16 units")
    ap.add_argument("--trials", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    dev = torch.device(args.device)
    code = code_samples()
    fcode = torch.from_numpy(boundary.pack_complex(np.fft.fft(code))).to(dev)
    mask = torch.from_numpy(doppler.window_mask(BLOCK, FS, *MASK_HZ)).to(dev)
    for amp in args.amplitudes:
        for trial in range(args.trials):
            raw, df = trial_block(code, amp, args.seed, trial)
            q8, dc = hunt_inputs(raw)
            q8_d = torch.from_numpy(q8).to(dev)
            kbon, n_above = doppler.search_df_candidates_ri(
                q8_d, torch.from_numpy(dc).to(dev), fcode, FS, mask)
            kbon = int(kbon)
            if kbon < 0:
                print(f"amplitude {amp:g} trial {trial}: df {df:.3f} Hz, no line "
                      f"validated ({int(n_above)} bins above the gate)")
                continue
            got, _ = doppler.refresh_df_ri(q8_d, FS, kbon)
            print(f"amplitude {amp:g} (SNR {10 * np.log10(amp**2 / 2 / NOISE**2):+.1f} "
                  f"dB per sample) trial {trial}: df {df:.3f} Hz, {int(n_above)} bins "
                  f"above the gate, hunt {bins_from_line(kbon, df):+.2f} bins "
                  f"from the line, refreshed df error {float(got) - df:+.4f} Hz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
