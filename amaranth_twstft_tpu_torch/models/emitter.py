"""Baseband simulation of the FPGA transmit chain — the fixture generator.

(NumPy; the port's copy of the JAX package's ``models/emitter.py``.)

The reference's test fixtures are recorded IQ captures ("recorded IQ files
*are* the fixtures", SURVEY.md §4.6); to test without a satellite we
simulate the emission chain at baseband:

- PRN restarts exactly at each code boundary and on PPS
  (``amaranth_twstft/synchronizer.py:61-101``),
- BPSK maps chip c (0/1) to phase 0/pi — carrier XOR data
  (``amaranth_twstft/mixer.py:26-27``),
- QPSK Gray-maps two chips (a, b) onto 0/90/180/270 degrees: the axis is
  ``carrier`` when ``a ^ b`` else ``carrier90``, inverted by ``a``
  (``mixer.py:28-34``): (a,b)=(0,1)->0, (0,0)->90, (1,0)->180, (1,1)->270,
- the time coder optionally inverts the first code of each second and
  shifts out a 6-bit seconds counter, one bit per code, minute wrap at 60
  (``amaranth_twstft/time_coder.py:25-44``),
- the channel adds delay, Doppler, carrier phase and AWGN; the SDR
  quantizes to int16 (``rx_multi_samples.cpp:155``).

A synthesized two-station scenario exercises the full two-way solve with a
*known* clock offset — the ground truth the reference can never have.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from amaranth_twstft_tpu_torch.config import SignalConfig, Modulation, TimeCoderMode
from amaranth_twstft_tpu_torch.config import TIMECODE_SIZE
from amaranth_twstft_tpu_torch.ops.lfsr import prn_chips
from amaranth_twstft_tpu_torch.ops.prn import chips_to_pm1, upsample_zoh

__all__ = ["ChannelSim", "timecode_bits", "baseband_second", "synthesize_capture"]


def timecode_bits(mode: TimeCoderMode, second: int, codes_per_second: int) -> np.ndarray:
    """Per-code time-coder bit within one second.

    ``shift_time`` is loaded with ``[1, seconds_counter]`` on PPS and
    shifted right once per code (``time_coder.py:25-41``): code 0 is always
    inverted (bit 1); codes 1..6 carry the 6-bit counter LSB-first in
    TIMECODE mode; all further codes are 0.
    """
    bits = np.zeros(codes_per_second, dtype=np.int8)
    if mode == TimeCoderMode.OFF:
        return bits
    bits[0] = 1
    if mode == TimeCoderMode.TIMECODE:
        t = second % 60
        for i in range(TIMECODE_SIZE):
            if 1 + i < codes_per_second:
                bits[1 + i] = (t >> i) & 1
    return bits


def baseband_second(cfg: SignalConfig, second: int = 0) -> np.ndarray:
    """One second of ideal baseband emission at fs (complex128, unit power).

    BPSK: ``(-1)**(chip ^ tc)`` real; QPSK: Gray-mapped unit phasors.
    """
    n_codes = int(round(cfg.codes_per_second))
    tc = timecode_bits(cfg.timecoder, second, n_codes)
    chips_a = prn_chips(cfg.bit_len, cfg.taps, cfg.code_len, cfg.seed)
    if cfg.modulation == Modulation.QPSK:
        if cfg.taps_b is None:
            raise ValueError("QPSK requires taps_b")
        chips_b = prn_chips(cfg.bit_len, cfg.taps_b, cfg.code_len, cfg.seed)
        # Gray map (mixer.py:28-34): phase index such that
        # (a,b)=(0,1)->0 deg, (0,0)->90, (1,0)->180, (1,1)->270.
        idx = np.where(
            chips_a == 0, np.where(chips_b == 1, 0, 1), np.where(chips_b == 0, 2, 3)
        )
        symbols = np.exp(1j * np.pi / 2 * idx)
    else:
        symbols = chips_to_pm1(chips_a).astype(np.complex128)
    wave_code = upsample_zoh(symbols, cfg.samples_per_chip)
    out = np.empty(n_codes * cfg.samples_per_code, dtype=np.complex128)
    L = cfg.samples_per_code
    for c in range(n_codes):
        sign = -1.0 if tc[c] else 1.0
        out[c * L : (c + 1) * L] = sign * wave_code
    return out


@dataclass
class ChannelSim:
    """One received channel: delayed, Doppler-shifted, noisy emission."""

    delay_samples: float = 0.0  # may be fractional
    doppler_hz: float = 0.0
    phase_cycles: float = 0.0
    amplitude: float = 1000.0  # int16 scale
    noise_sigma: float = 100.0  # per I/Q component
    drift_samples_per_s: float = 0.0  # linear delay drift


def _fractional_delay_circular(x: np.ndarray, delay: float) -> np.ndarray:
    """Circular fractional delay via FFT phase ramp (emission is periodic)."""
    n = len(x)
    k = np.fft.fftfreq(n)
    return np.fft.ifft(np.fft.fft(x) * np.exp(-2j * np.pi * k * delay))


def synthesize_capture(
    cfg: SignalConfig,
    channels: list[ChannelSim],
    n_seconds: int = 1,
    seed: int = 0,
    extra_emissions: list[tuple[SignalConfig, ChannelSim]] | None = None,
) -> list[np.ndarray]:
    """Synthesize per-channel complex IQ streams (float, pre-quantization).

    Each channel carries the ``cfg`` emission with its own channel
    parameters; ``extra_emissions`` adds co-channel signals (other PRNs —
    the multi-PRN DLL/PLL scenario, ``rxcomplex.cpp`` sdr.param channels).
    Delay drift is applied per second (piecewise-constant Doppler-free
    code drift, like a clock-rate offset would produce).
    """
    rng = np.random.default_rng(seed)
    outs = []
    base = [baseband_second(cfg, s) for s in range(n_seconds)]
    # extra emissions' basebands are channel-independent: build once
    # (a per-channel rebuild re-walks the 100k-chip LFSR per second)
    extra_bases = [
        [baseband_second(ecfg, s) for s in range(n_seconds)]
        for ecfg, _ in (extra_emissions or [])
    ]
    n = len(base[0])
    for ch in channels:
        stream = np.empty(n_seconds * n, dtype=np.complex128)
        for s in range(n_seconds):
            d = ch.delay_samples + ch.drift_samples_per_s * s
            sig = _fractional_delay_circular(base[s], d)
            t = (np.arange(n) + s * n) / cfg.fs
            lo = np.exp(2j * np.pi * (ch.doppler_hz * t + ch.phase_cycles))
            stream[s * n : (s + 1) * n] = ch.amplitude * sig * lo
        if extra_emissions:
            for (ecfg, ech), ebase in zip(extra_emissions, extra_bases):
                for s in range(n_seconds):
                    d = ech.delay_samples + ech.drift_samples_per_s * s
                    sig = _fractional_delay_circular(ebase[s], d)
                    t = (np.arange(n) + s * n) / cfg.fs
                    lo = np.exp(
                        2j * np.pi * (ech.doppler_hz * t + ech.phase_cycles)
                    )
                    stream[s * n : (s + 1) * n] += ech.amplitude * sig * lo
        noise = rng.normal(0, ch.noise_sigma, 2 * len(stream))
        stream = stream + noise[0::2] + 1j * noise[1::2]
        outs.append(stream)
    return outs
