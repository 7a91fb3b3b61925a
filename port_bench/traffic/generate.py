"""The one traffic generator: sc16 captures from a seed and the parameters
of a mix (``workloads/<cell>.json``), made on the device in a few large
calls and written once.

- :func:`single_channel_files`: a station's single-channel session files,
  each one code delayed by an FFT phase ramp, at its Doppler and
  amplitude, plus Gaussian noise (the two-way session's captures);
- :func:`ring_capture`: a two-input capture of many emissions that wraps:
  ``ring_seconds`` seconds plus one code period, the tail a copy of the
  head.  Dopplers lie on a ``1/ring_seconds``-Hz grid and the code
  periods divide a second, so carrier and code run on without a break
  across the wrap, and second s of a long stream is the ring's second
  ``s mod ring_seconds``.

Plain NumPy and PyTorch; nothing of the program.  Each function returns
the truths it injected, which the checks read.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from traffic.lfsr import chips as lfsr_chips

__all__ = ["write_code_file", "code_waves", "single_channel_files", "ring_capture"]


def write_code_file(path: str, chips: np.ndarray) -> None:
    """A PRN chip file as the chains read it: one 0/1 byte per chip."""
    with open(path, "wb") as f:
        f.write(np.asarray(chips, np.uint8).tobytes())


def code_waves(chips: np.ndarray, sps: int, delays: np.ndarray, dev) -> torch.Tensor:
    """(n, L) complex128 one-period waveforms: each row's +/-1 code (held
    ``sps`` samples a chip), delayed circularly by ``delays`` samples."""
    code = torch.from_numpy(np.repeat(chips.astype(np.float64) * 2 - 1, sps, axis=-1)).to(dev)
    L = code.shape[-1]
    k = torch.fft.fftfreq(L, device=dev, dtype=torch.float64)
    ramp = torch.exp(-2j * math.pi * k[None, :]
                     * torch.as_tensor(delays, dtype=torch.float64, device=dev)[:, None])
    return torch.fft.ifft(torch.fft.fft(code, dim=-1) * ramp, dim=-1)


def _flush(f) -> None:
    """Write the file back to the disk now, in set-up, so that the page
    cache's write-back does not run beside the measured window."""
    f.flush()
    os.fsync(f.fileno())


def _to_sc16(z: torch.Tensor) -> np.ndarray:
    iq = torch.stack([z.real, z.imag], dim=-1)
    return torch.clamp(torch.round(iq), -32768, 32767).to(torch.int16).cpu().numpy()


def single_channel_files(sig: dict, files: list[dict], codes: dict, mix: dict,
                         seed: int, dev, paths: list[str]) -> list[dict]:
    """Write one sc16 file per entry of ``files`` (``code``: a key of
    ``codes``, the tap masks; ``amplitude``), ``mix["seconds"]`` long.

    Each file's Doppler is drawn within ``mix["doppler_hz"]`` times
    ``mix["doppler_sign"]``.  Each delay is a whole number of
    samples at least ``delay_margin`` of a period from either end, plus a
    fraction of size within ``delay_frac``, away from one half so that the
    re-seek's rounding is unambiguous."""
    fs = float(sig["fs"])
    sps = int(round(fs / sig["chip_rate"]))
    L = int(sig["code_len"]) * sps
    n = int(fs)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t = torch.arange(n, device=dev, dtype=torch.float64)
    out = []
    for spec, path in zip(files, paths):
        chips = lfsr_chips(sig["bit_len"], [codes[spec["code"]]], sig["code_len"])
        lo, hi = mix["delay_frac"]
        frac = rng.uniform(lo, hi) * rng.choice([-1.0, 1.0])
        m = int(mix["delay_margin"] * L)
        delay = float(rng.integers(m, L - m)) + frac
        dop = mix["doppler_sign"] * rng.uniform(*mix["doppler_hz"])
        phase = rng.uniform()
        wave = code_waves(chips, sps, np.array([delay]), dev)[0]
        with open(path, "wb") as f:
            for s0 in range(0, int(mix["seconds"]) * n, n):
                tt = t + s0
                ph = torch.remainder(dop * tt / fs + phase, 1.0)
                z = spec["amplitude"] * wave[torch.remainder(tt.long(), L)] \
                    * torch.exp(2j * math.pi * ph)
                z = z + torch.complex(*torch.randn(2, n, generator=gen, device=dev,
                                                   dtype=torch.float64)) * mix["noise_sigma"]
                f.write(_to_sc16(z).tobytes())
            _flush(f)
        out.append({"path": path, "code": spec["code"], "delay": delay,
                    "doppler": dop, "amplitude": spec["amplitude"]})
    return out


def ring_capture(sig: dict, taps: list[int], mix: dict, seed: int, dev,
                 path: str) -> list[dict]:
    """Write the two-input ring (``mix["n_per_input"]`` emissions per
    input, the first ``2 * n_per_input`` of ``taps``, input A's first).

    Dopplers are distinct per input on a ``dop_grid_hz`` grid within
    +-``dop_span_hz`` (the squaring lines at 2f stay apart), plus an offset
    within +-``dop_offset_hz`` on the ``1/ring_seconds`` grid; delays are
    whole samples plus a fraction within +-``max_frac``; phases uniform.
    Returns one truth per emission, in ``taps`` order."""
    fs = int(sig["fs"])
    sps = int(round(fs / sig["chip_rate"]))
    L = int(sig["code_len"]) * sps
    N = int(mix["ring_seconds"])
    if fs % L:
        raise ValueError("the ring needs code periods that divide a second")
    n_in = int(mix["n_per_input"])
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    chips = lfsr_chips(sig["bit_len"], taps[: 2 * n_in], sig["code_len"])
    grid = np.arange(-mix["dop_span_hz"], mix["dop_span_hz"] + 1.0, mix["dop_grid_hz"])
    k_off = int(round(mix["dop_offset_hz"] * N))
    frame = np.empty((N * fs + L, 4), np.int16)
    t = torch.arange(fs, device=dev, dtype=torch.float64)
    truths = []
    for inp in range(2):
        dops = rng.choice(grid, n_in, replace=False) + rng.integers(-k_off, k_off + 1, n_in) / N
        delays = (rng.integers(0, L, n_in) + rng.uniform(-mix["max_frac"], mix["max_frac"], n_in)) % L
        phases = rng.uniform(0.0, 1.0, n_in)
        rows = slice(inp * n_in, (inp + 1) * n_in)
        wave = code_waves(chips[rows], sps, delays, dev) * mix["amplitude"]
        f = torch.as_tensor(dops, device=dev)[:, None]
        ph0 = torch.as_tensor(phases, device=dev)[:, None]
        for s in range(N):
            tt = t + s * fs
            idx = torch.remainder(tt.long(), L)
            # one second of every emission at once, summed in chunks that fit
            z = torch.zeros(fs, dtype=torch.complex128, device=dev)
            for j0 in range(0, n_in, 8):
                j1 = min(n_in, j0 + 8)
                ph = torch.remainder(f[j0:j1] * tt[None, :] / fs + ph0[j0:j1], 1.0)
                z += (wave[j0:j1][:, idx] * torch.exp(2j * math.pi * ph)).sum(dim=0)
            z += torch.complex(*torch.randn(2, fs, generator=gen, device=dev,
                                            dtype=torch.float64)) * mix["noise_sigma"]
            frame[s * fs:(s + 1) * fs, 2 * inp:2 * inp + 2] = _to_sc16(z)
        for j in range(n_in):
            truths.append({"input": "AB"[inp], "taps": int(taps[inp * n_in + j]),
                           "doppler": float(dops[j]), "delay": float(delays[j])})
        del wave
    frame[N * fs:] = frame[:L]
    with open(path, "wb") as f:
        frame.tofile(f)
        _flush(f)
    return truths
