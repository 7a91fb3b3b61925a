#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``amaranth_twstft_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It drives every slice of the port at production geometry and fails
(non-zero exit, no result line) on any error.  The DLL/PLL slice,
``twstft-torch dllpll`` through the banked receiver:

1. builds every kernel of the slice from ``amaranth_twstft_tpu_torch/csrc``
   with ``nvcc`` for ``sm_90a`` (one compiler per source, all together);
2. synthesizes, on the card, a two-input capture of 120 emissions (60 PRNs
   per input, 17-bit m-sequence taps, 5 MS/s, 100 000-chip codes) with
   delays, Dopplers and phases drawn from ``--seed``, plus noise; each
   emission's one-code waveform is built once, delayed fractionally by FFT
   and tiled, since the code is periodic within a second;
3. writes 6 s of it as sc16 and runs the ``dllpll`` CLI in-process on it
   with an ``sdr.param`` of all 120 channels, with the kernels' launch
   counts set to 0 just before and read just after;
4. asserts that >= 100 channels are locked at second 4, that the locked
   channels recover the injected Doppler within 0.5 Hz and code delay
   within a quarter sample, and that the lag-bank kernel launched;
5. holds the kernel against its plain PyTorch version at the production
   group shape (power within 1e-4 of each row's maximum; phase within
   1e-4 cycles wherever power >= 1e-3 x the row maximum), in both input
   forms; holds the window form against the plain version in float64
   (its power and phase errors may each be at most 4x those of the
   float32 plain version against the same float64 result); and checks
   that two launches give the same bits;
6. times the kernel, its plain version and ``torch.matmul`` of the same
   contraction with CUDA events, and the kernel at K = 257 and 2000 as
   well, and works out the card's bounds (bytes, 3xTF32 and fp32
   operations).

The GoRanging slice, ``twstft-torch goranging --fast`` (no hand-written
kernel: cuFFT, one IEEE-fp32 ``torch.matmul`` and elementwise torch):

7. synthesizes, on the card one second at a time, a 20 s dual-channel
   capture at 5 MS/s (500 epochs of the 100 000-chip 17-bit code per
   channel, L = 200 000, 800 MB of sc16) with delays with fractional parts, Dopplers
   within +-3 kHz and noise drawn from ``--seed``, and writes the code
   with the port's ``write_prn_file``;
8. runs the CLI in-process twice (``ProcessingConfig(hamming_window=True)``,
   nint = 1, 50 epochs per channel per batch, raw int16 ingest) and checks
   each channel's median delay within 0.01 sample and its df within 1 Hz
   of the truth;
9. holds the overlapped pipeline against ``goranging.process_file`` on the
   card (indice identical, correction within 1e-4 sample), float32 ingest
   against int16 (the same bits), and the card's first batch against the
   port on the CPU (indice identical, correction within 1e-4 sample,
   snr within 1e-3 relative); runs the int8 ladder once and prints its
   largest delay difference from int16 in ps;
10. prints the end-to-end IQ MS/s over both channels, the pipeline's
    ``timing``, the card's busy share over a traced run, the per-file
    set-up, the ranging step's time per batch of 2 x 50 epochs (CUDA
    events), a ``torch.profiler`` table of its device ops, and the device
    time and ops per call of the functions a later PR will write as
    kernels.

The claudio chain and the two-way products, ``twstft-torch claudio``
then ``twstft-torch go1s`` and ``campaign`` (no hand-written kernel
either: the resident int8 block step is cuFFT, the packed ranging step
and elementwise torch):

11. writes, on the card one second at a time, the four single-channel
    34-s captures of one two-way session at production geometry (5 MS/s,
    L = 200 000, 2-s blocks; OP on taps 9, LTFB on another maximal tap
    set; 680 MB each): OP ``<ts>_2`` (loopback, OP code) and ``<ts>_1``
    (remote, LTFB code), LTFB ``<ts+4>_2`` and ``<ts+4>_1``, with
    Dopplers in each site's claudio window, fractional delays and noise
    from ``--seed``; runs the ``claudio`` verb in-process on each
    (production ``ProcessingConfig(conjugate_data=True)``: the 30-s hunt
    skip, then 17 blocks) and checks every block's df within 0.5 Hz of
    the truth, a non-empty ``moved`` and the median tracked delay within
    0.01 sample of the truth folded by the re-seek;
12. holds the card against the port on the CPU on a 4-s prefix of the
    first capture (no hunt skip, the resident path on both): df and
    ``moved`` identical, delays within 1e-4 sample;
13. prints each file's end-to-end claudio IQ MS/s (cold or warm cache),
    its layer times and, over one traced warm file, the card's busy
    share;
14. times the block step's functions at production shapes;
15. runs ``go1s`` on the two directories and checks one solved session,
    the ``.1s``/``.1sc`` products and ``res_mean_ns`` within 1 ns of the
    folded truths, then ``campaign`` on its summary.

The live paths (after the bank, and after the GoRanging slice on its
capture):

16. synthesizes a two-input production-geometry capture of 8 emissions
    (4 per input, 5 s plus one code, amplitude 100, noise 300, delay
    fractions within +-0.3 sample, Dopplers within +-3 kHz and at least
    560 Hz apart on each input, so that no other emission's squaring line
    falls in a channel's fine-frequency mask) and runs ``dllpll --host
    --serve PORT --serve-min-clients 1`` in-process with a subscriber
    thread, the explicit-form launch count set to 0 just before;
17. checks that all 8 channels report at the last second within 0.5 Hz
    and a quarter sample of the truths, that the subscriber received
    exactly the printed rows, and that the explicit form of the lag-bank
    kernel launched once per tracked channel-second;
18. holds the card against the port's Receiver on the CPU over the first
    3 s (cnt identical, fc within 1e-3 Hz, gd within 0.01 ns);
19. runs the banked ``dllpll`` on the same capture and ``sdr.param``
    (within 0.5 Hz and a quarter sample of the host receiver);
20. holds the explicit form against its plain version and float64 on the
    host path's last-launch inputs, (2, 24, 200 000) x (200 000, 57) (its
    power and phase errors against float64 may each be at most 4x the
    float32 plain version's), checks that two launches give the same bits,
    and times it (CUDA events, the host's wall of calls that do not wait
    for the card, and device time from ``torch.profiler``), its plain
    version and ``torch.matmul`` of the same product, and the form at
    K = 257;
21. grows a new file from the GoRanging capture in 1-s appends, one per
    second as a receiver writes (a writer thread), while ``monitor --serve PORT --timeout 3`` tails it on the
    card, with a subscriber thread;
22. checks a row for every epoch of both channels, each channel's median
    delay within 0.01 sample of the truth, the rows equal to direct calls
    of the verb's bound step on the same epochs, the first batch equal to
    the port on the CPU (indice identical, delay within 1e-4 sample), and
    that the subscriber got every row and a spectrum per batch and channel;
23. prints rows per second and the lag from a batch's last appended byte
    to its last row;
24. runs ``goranging --fast --profile DIR`` once and checks that the
    Chrome trace holds CUDA kernel events.

It prints the card's name and power limit (``nvidia-smi``), one
``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Scratch files go to the git-ignored ``amaranth_twstft_tpu_torch/build/``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch

FS = 5e6
CHIP_RATE = 2.5e6
CODE_LEN = 100_000
BIT_LEN = 17
N_PER_INPUT = 60
N_SECONDS = 6
CHECK_SECOND = 4
AMPLITUDE = 100.0  # per emission, int16 units
NOISE_SIGMA = 300.0  # per I/Q component
MAX_FRAC = 0.3  # largest fractional part of an injected delay, samples
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12  # dense tensor cores
PEAK_BYTES_PER_S = 3.35e12
F64_GATE = 4.0  # kernel error vs float64 at most this x the fp32 plain's
GR_SECONDS = 20  # GoRanging capture length (depth is the only cut)
GR_BATCH = 50  # epochs per channel per batch
GR_AMPLITUDE = 1000.0  # int16 units
GR_NOISE = 300.0  # per I/Q component
GR_DELAY_TOL = 0.01  # samples
GR_DF_TOL = 1.0  # Hz
TW_SECONDS = 34  # per claudio capture: the 30-s hunt skip + 17 blocks
TW_PREFIX_SECONDS = 4  # the card-vs-CPU prefix
# int16 units; noise per I/Q component.  The loopbacks are strong (their
# delay noise must stay well under go_1s's 2 ns sample-loss gate); the
# remotes sit at -11.7 dB per sample, C/N0 = 55.3 dB-Hz, the campaign's
# operating range (go_1s.m:420-429)
TW_LOOPBACK_AMPLITUDE = 1000.0
TW_REMOTE_AMPLITUDE = 110.0
TW_NOISE = 300.0
TW_DELAY_TOL = 0.01  # samples, median tracked delay vs folded truth
TW_DF_TOL = 0.5  # Hz, every block's df
TW_CPU_DELAY_TOL = 1e-4  # samples, card vs CPU on the resident path
TW_RES_TOL_NS = 1.0  # go1s res_mean vs the folded truths
# the host receiver's capture: production geometry, 4 emissions per input
# (8 channels) over 5 s; Dopplers on a 600-Hz grid, so that on each input
# they lie at least 560 Hz apart and no other emission's squaring line
# falls in a channel's +-200 Hz fine-frequency mask (dllpll.py:736-744)
HOST_PER_INPUT = 4
HOST_SECONDS = 5
HOST_DOP_GRID = 600.0
HOST_CPU_SECONDS = 3  # the card-vs-CPU prefix
HOST_CPU_FC_HZ = 1e-3
HOST_CPU_GD_NS = 0.01
MON_SECONDS = 10  # appended to the tailed file, one second per second


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def synthesize(dev, seed: int, taps: list[int], path: str,
               n_per_input: int = N_PER_INPUT, n_seconds: int = N_SECONDS,
               dop_grid: float = 100.0) -> dict:
    """Write the two-input capture (``n_per_input`` emissions per input,
    ``n_seconds`` plus one code, Dopplers on a ``dop_grid``-Hz grid within
    +-3 kHz, distinct per input, plus a fractional offset within +-20 Hz);
    return the injected truths."""
    from amaranth_twstft_tpu_torch.ops.lfsr import prn_chips_batch

    nobs = CODE_LEN * int(FS // CHIP_RATE)
    rng = np.random.default_rng(seed)
    chips = prn_chips_batch(BIT_LEN, np.asarray(taps, np.uint64), CODE_LEN)
    fs = int(FS)
    n_total = n_seconds * fs + nobs
    truths = {}
    gen = torch.Generator(device=dev).manual_seed(seed)
    k = torch.fft.fftfreq(nobs, device=dev, dtype=torch.float64)
    t = torch.arange(fs, device=dev, dtype=torch.float64)
    frame = np.empty((n_total, 4), np.int16)
    for inp, phys in enumerate("AB"):
        rows = list(range(inp * n_per_input, (inp + 1) * n_per_input))
        # Dopplers on a grid (distinct per input, so the squaring lines at
        # 2f stay apart) plus a fractional offset
        dops = (rng.choice(np.arange(-3000.0, 3001.0, dop_grid), n_per_input,
                           replace=False)
                + rng.uniform(-20.0, 20.0, n_per_input))
        # whole-sample delays plus a fraction within +-MAX_FRAC: at 2
        # samples per chip the HRC discriminator (rxcomplex.cpp:649-659,
        # kept as the JAX package has it) overshoots the fraction more and
        # more as it nears one half: within a quarter sample at 0.3,
        # beyond it at 0.45
        # (tests/test_torch_tracker.py::test_fractional_delay_matches_jax)
        delays = (rng.integers(0, nobs, n_per_input)
                  + rng.uniform(-MAX_FRAC, MAX_FRAC, n_per_input)) % nobs
        phases = rng.uniform(0.0, 1.0, n_per_input)
        code = torch.from_numpy(
            np.repeat(chips[rows].astype(np.float64) * 2 - 1, 2, axis=1)
        ).to(dev)
        ramp = torch.exp(-2j * math.pi * k[None, :]
                         * torch.from_numpy(delays).to(dev)[:, None])
        wave = torch.fft.ifft(torch.fft.fft(code, dim=-1) * ramp, dim=-1)
        sig = torch.zeros(n_total, dtype=torch.complex128, device=dev)
        for s0 in range(0, n_total, fs):
            n = min(fs, n_total - s0)
            tt = t[:n] + s0
            idx = torch.remainder(tt.long(), nobs)
            for j in range(n_per_input):
                ph = torch.remainder(dops[j] * tt / FS + phases[j], 1.0)
                sig[s0 : s0 + n] += (AMPLITUDE * wave[j, idx]
                                     * torch.exp(2j * math.pi * ph))
        noise = torch.randn(2, n_total, generator=gen, device=dev,
                            dtype=torch.float64) * NOISE_SIGMA
        iq = torch.stack([sig.real + noise[0], sig.imag + noise[1]], dim=-1)
        iq = torch.clamp(torch.round(iq), -32768, 32767).to(torch.int16)
        frame[:, 2 * inp : 2 * inp + 2] = iq.cpu().numpy()
        for j, r in enumerate(rows):
            truths[(phys, 100 + r)] = (float(dops[j]), float(delays[j]), taps[r])
        del sig, wave, code, ramp, noise, iq
    frame.tofile(path)
    return truths


def write_param(param: str, truths: dict) -> tuple[str, str]:
    """The ``sdr.param`` of every emission of ``truths`` (acquisition over
    +-4 kHz from 0 Hz in 100 Hz steps, 7 dB gate) and the ``--taps-map``
    that gives each PRN its code."""
    kcps = CHIP_RATE / 1e3
    chans = sorted(truths, key=lambda k: k[1])
    with open(param, "w") as f:
        f.write("# ch sic prn fc kcps flt frange fstep snr\n")
        for phys, prn in chans:
            f.write(f"{phys} N {prn} 0 {kcps:g} {kcps:g} 4000 100 7\n")
    return param, ",".join(f"{prn}={truths[(phys, prn)][2]}" for phys, prn in chans)


@contextlib.contextmanager
def timing_hooks(targets):
    """Wrap each ``(owner, attribute, sink, sync)`` callable so that every
    call appends its wall time to ``sink``; with ``sync`` the device is
    synchronised before and after, so the time covers the call's device
    work.  The originals are restored on exit."""
    saved = []
    for owner, attr, sink, sync in targets:
        fn = getattr(owner, attr)

        def wrapped(*a, _fn=fn, _sink=sink, _sync=sync, **kw):
            if _sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                if _sync:
                    torch.cuda.synchronize()
                _sink.append(time.perf_counter() - t0)

        saved.append((owner, attr, fn))
        setattr(owner, attr, wrapped)
    try:
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


def run_dllpll(work: str, truths: dict, cap: str, dev):
    """The main path: the dllpll CLI, in-process.  Records, per second,
    the wall time between two seconds' reports of ``run_stream`` (end to
    end: read, pack, upload, bank, report rows) and the wall times of the
    layers under it (``times``: sc16 read, host pack, pack + upload start,
    the bank's ``process_second``, and its device steps)."""
    from amaranth_twstft_tpu_torch import cli
    from amaranth_twstft_tpu_torch.models import tracker
    from amaranth_twstft_tpu_torch.utils import io as sc16

    param, taps_map = write_param(os.path.join(work, "sdr.param"), truths)
    out_dir = os.path.join(work, "out")
    times = {k: [] for k in ("read", "pack", "upload", "bank", "track_step",
                             "acquire_step")}
    e2e_walls: list[float] = []
    orig_stream = tracker.BankedReceiver.run_stream

    def timed_stream(self, *a, **kw):
        t_prev = time.perf_counter()
        for reports in orig_stream(self, *a, **kw):
            t = time.perf_counter()
            e2e_walls.append(t - t_prev)
            t_prev = t
            yield reports

    # the lag bank's inputs of the main path's last launch, for the
    # kernel-vs-plain comparison and the timings
    last_lag_bank: dict = {}
    orig_lag_bank = tracker.lag_bank_windows

    def keep_inputs(obs, wav_ext, nlag, power_scale=0.5):
        last_lag_bank.update(obs=obs, wav_ext=wav_ext, nlag=nlag,
                             power_scale=power_scale)
        return orig_lag_bank(obs, wav_ext, nlag, power_scale)

    rx_cls = tracker.BankedReceiver
    hooks = [
        (sc16, "read_sc16_epochs", times["read"], False),
        (rx_cls, "_pack_second", times["pack"], False),
        (rx_cls, "upload_second", times["upload"], False),
        (rx_cls, "process_second", times["bank"], False),
        (tracker, "banked_track_step", times["track_step"], True),
        (tracker, "banked_acquire_step", times["acquire_step"], True),
    ]
    stdout = io.StringIO()
    rx_cls.run_stream = timed_stream
    tracker.lag_bank_windows = keep_inputs
    try:
        with timing_hooks(hooks), contextlib.redirect_stdout(stdout), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main(["dllpll", cap, "--param", param, "--out-dir", out_dir,
                           "--fs", repr(FS), "--bitlen", str(BIT_LEN),
                           "--code-len", str(CODE_LEN), "--taps-map", taps_map,
                           "--device", str(dev)])
    finally:
        rx_cls.run_stream = orig_stream
        tracker.lag_bank_windows = orig_lag_bank
    if rc != 0:
        raise RuntimeError(f"dllpll exited {rc}")
    reports = parse_rows(stdout.getvalue())
    with open(os.path.join(out_dir, "rxcomplex.log")) as f:
        rxlog = f.read()
    return reports, times, e2e_walls, rxlog, last_lag_bank


def parse_rows(text: str) -> dict:
    """The dllpll verb's printed rows -> {(second, physical, prn): (fc_hz,
    cnt, gd_ns)}; comment lines (``# serving on ...``) are skipped."""
    reports: dict = {}
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        f = line.split()
        reports[(int(f[0]), f[1], int(f[2][3:]))] = (float(f[3]), int(f[5]), float(f[6]))
    return reports


def compare_lag_banks(what: str, kernel_out, plain_out):
    """Power within 1e-4 of each row's maximum; phase within 1e-4 cycles
    wherever power >= 1e-3 x the row maximum.  Returns the largest
    power error, that error over its row's maximum, and the largest
    phase error (cycles)."""
    pk, phk = kernel_out[:2]
    pp, php = plain_out[:2]
    rowmax = pp.amax(-1, keepdim=True)
    abs_err = float((pk - pp).abs().max())
    rel_err = float(((pk - pp).abs() / rowmax).max())
    dph = (torch.remainder(phk - php + 0.5, 1.0) - 0.5).abs()
    ph_err = float(dph[pp >= 1e-3 * rowmax].max())
    log(f"kernel vs plain, {what}: max power err {abs_err:.3e} (largest "
        f"power {float(rowmax.max()):.3e}), max power err / row max "
        f"{rel_err:.3e}, max phase err {ph_err:.3e} cycles")
    if not (rel_err < 1e-4 and ph_err < 1e-4):
        raise RuntimeError(f"lag-bank kernel disagrees with its plain version ({what})")
    return abs_err, rel_err, ph_err


def check_kernel(lb_inputs: dict):
    """The lag-bank kernel against its plain version on the main path's
    last launch inputs — (G, 2, P, K) downconverted codes and the group's
    replica extensions, the production group shape — in the bank's window
    form (in float32, in float64, and launch against launch for the same
    bits), then in the explicit (K, NL) form of ``lag_bank_correlate``
    (the kernel's other path) on the group's first channel.  Returns the
    window form's errors, its float64 errors and the plain version's, and
    the explicit lag matrices."""
    from amaranth_twstft_tpu_torch.ops import lagbank

    obs, wav_ext = lb_inputs["obs"], lb_inputs["wav_ext"]
    nlag, scale = lb_inputs["nlag"], lb_inputs["power_scale"]
    G, _, P, nobs = obs.shape
    nl = 2 * nlag + 1
    kern = lagbank.lag_bank_windows(obs, wav_ext, nlag, scale)
    again = lagbank.lag_bank_windows(obs, wav_ext, nlag, scale)
    if not all(torch.equal(a, b) for a, b in zip(kern, again)):
        raise RuntimeError("two launches of the lag-bank kernel differ")
    log("kernel determinism: two launches give the same bits")
    plain = lagbank.lag_bank_windows_plain(obs, wav_ext, nlag, scale)
    errs = compare_lag_banks(
        f"window form at (G, P, K, NL) = ({G}, {P}, {nobs}, {nl})", kern, plain)
    ref64 = lagbank.lag_bank_windows_plain(obs.double(), wav_ext.double(),
                                           nlag, scale)
    kern64 = lagbank.lag_bank_errors(kern, ref64)
    plain64 = lagbank.lag_bank_errors(plain, ref64)
    log(f"against float64: kernel power err / row max {kern64[0]:.3e}, phase "
        f"err {kern64[1]:.3e} cycles; fp32 plain {plain64[0]:.3e}, "
        f"{plain64[1]:.3e} cycles (gate: kernel <= {F64_GATE:g} x plain)")
    if kern64[0] > F64_GATE * plain64[0] or kern64[1] > F64_GATE * plain64[1]:
        raise RuntimeError("lag-bank kernel fails the float64 gate")
    del ref64, again
    w_mat = wav_ext.unfold(-1, nobs, 1).flip(-2).transpose(-1, -2).contiguous()
    compare_lag_banks(
        f"explicit form at (C, K, NL) = ({P}, {nobs}, {nl})",
        lagbank.lag_bank_correlate(obs[0], w_mat[0]),
        lagbank.lag_bank_plain(obs[0], w_mat[0]),
    )
    return errs, kern64, plain64, w_mat


def check_truths(reports: dict, truths: dict,
                 second: int = CHECK_SECOND) -> tuple[int, int, float, float]:
    nobs = CODE_LEN * int(FS // CHIP_RATE)
    ns_per_sample = 1e9 / FS
    period_ns = nobs * ns_per_sample
    locked = ok = 0
    worst_df = worst_gd = 0.0
    for (phys, prn), (dop, delay, _) in truths.items():
        rep = reports.get((second, phys, prn))
        if rep is None:
            continue
        locked += 1
        fc, _, gd = rep
        err = (gd - delay * ns_per_sample) % period_ns
        err = min(err, period_ns - err)
        worst_df = max(worst_df, abs(fc - dop))
        worst_gd = max(worst_gd, err / ns_per_sample)
        if abs(fc - dop) < 0.5 and err < 0.25 * ns_per_sample:
            ok += 1
    return locked, ok, worst_df, worst_gd


def synthesize_ranging(dev, seed: int, code_path: str, path: str) -> dict:
    """Write the GoRanging capture: channel c carries the code delayed by
    ``delays[c]`` samples (circularly, by an FFT phase ramp, as
    ``models/emitter`` does), at ``dopplers[c]`` Hz, plus noise; built on
    the card one second at a time.  Returns the truths."""
    from amaranth_twstft_tpu_torch.ops.lfsr import read_prn_file

    L = CODE_LEN * int(FS // CHIP_RATE)
    rng = np.random.default_rng(seed)
    delays = rng.integers(1000, L - 1000, 2) + rng.uniform(0.05, 0.95, 2)
    dops = rng.uniform(-3000.0, 3000.0, 2)
    phases = rng.uniform(0.0, 1.0, 2)
    code = torch.from_numpy(
        np.repeat(read_prn_file(code_path).astype(np.float64) * 2 - 1, 2)).to(dev)
    k = torch.fft.fftfreq(L, device=dev, dtype=torch.float64)
    ramp = torch.exp(-2j * math.pi * k[None] * torch.from_numpy(delays).to(dev)[:, None])
    waves = torch.fft.ifft(torch.fft.fft(code)[None] * ramp, dim=-1)
    gen = torch.Generator(device=dev).manual_seed(seed)
    fs = int(FS)
    t = torch.arange(fs, device=dev, dtype=torch.float64)
    frame = torch.empty((fs, 4), dtype=torch.int16, device=dev)
    with open(path, "wb") as f:
        for s0 in range(0, GR_SECONDS * fs, fs):
            tt = t + s0
            idx = torch.remainder(tt.long(), L)
            for c in range(2):
                ph = torch.remainder(dops[c] * tt / FS + phases[c], 1.0)
                sig = GR_AMPLITUDE * waves[c, idx] * torch.exp(2j * math.pi * ph)
                noise = torch.randn(2, fs, generator=gen, device=dev,
                                    dtype=torch.float64) * GR_NOISE
                iq = torch.stack([sig.real + noise[0], sig.imag + noise[1]], dim=-1)
                frame[:, 2 * c : 2 * c + 2] = torch.clamp(
                    torch.round(iq), -32768, 32767).to(torch.int16)
            f.write(frame.cpu().numpy().tobytes())
    return {"delay": delays, "doppler": dops}


def run_goranging_cli(cap: str, code: str, out_mat: str, dev):
    """The main path: ``twstft-torch goranging --fast`` in-process.
    Returns the pipeline's output dict and the call's wall time."""
    from amaranth_twstft_tpu_torch import cli, pipeline

    kept = {}
    orig = pipeline.process_capture_overlapped

    def keep(*a, **kw):
        kw["out_mat"] = out_mat
        kept["out"] = orig(*a, **kw)
        return kept["out"]

    pipeline.process_capture_overlapped = keep
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main(["goranging", cap, code, "--fast", "--device", str(dev),
                           "--batch-epochs", str(GR_BATCH)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        pipeline.process_capture_overlapped = orig
    if rc != 0:
        raise RuntimeError(f"goranging exited {rc}")
    return kept["out"], wall


def delays_samples(ch: dict) -> np.ndarray:
    return (ch["indice"].astype(np.float64) + ch["correction"]) / 3.0


def traced(fn, reps: int):
    """Run ``fn`` ``reps`` times under ``torch.profiler``; returns the
    profile, its device events and the wall seconds of the runs."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    return prof, dev_events, wall


def busy_ms(dev_events) -> float:
    """Union of the device events' time ranges, ms (events on two streams
    that overlap count once)."""
    total = 0.0
    end = -math.inf
    for e in sorted(dev_events, key=lambda e: e.time_range.start):
        s0, s1 = e.time_range.start, e.time_range.end
        if s1 > end:
            total += s1 - max(s0, end)
            end = s1
    return total / 1e3


def profile_device(fn, reps: int = 5):
    """Device time (ms) and device ops per call of ``fn`` from
    ``torch.profiler`` over ``reps`` calls, and the key_averages table;
    (None, None, table) when the trace holds no device events."""
    fn()
    torch.cuda.synchronize()
    prof, dev_events, _ = traced(fn, reps)
    if not dev_events:
        # the first trace after a long traced run came back without its
        # device events once on the H100; one more trace gets them
        prof, dev_events, _ = traced(fn, reps)
    try:
        table = prof.key_averages().table(sort_by="device_time_total", row_limit=14)
    except (AttributeError, KeyError, ValueError):
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=14)
    if not dev_events:
        return None, None, table
    total_us = sum(e.time_range.elapsed_us() for e in dev_events)
    return total_us / 1e3 / reps, len(dev_events) / reps, table


def goranging_phase(work: str, dev, seed: int) -> tuple[tuple, dict]:
    """Steps 7-10; returns the capture, code and truths (for the monitor
    and profile phases, which delete them) and the numbers of the
    ``{"goranging": ...}`` line."""
    from amaranth_twstft_tpu_torch import pipeline
    from amaranth_twstft_tpu_torch.config import ProcessingConfig, SignalConfig
    from amaranth_twstft_tpu_torch.models import goranging
    from amaranth_twstft_tpu_torch.models.godual import build_replica
    from amaranth_twstft_tpu_torch.ops import boundary, doppler, fftutils, zoomdft
    from amaranth_twstft_tpu_torch.ops.correlator import DEFAULT_FINE_WIDTH
    from amaranth_twstft_tpu_torch.ops.lfsr import write_prn_file
    from amaranth_twstft_tpu_torch.utils import io as sc16

    cfg = SignalConfig()  # 5 MS/s, 2.5 Mchip/s, 100 000-chip 17-bit code
    proc = ProcessingConfig(hamming_window=True)
    L = cfg.samples_per_code
    code = os.path.join(work, "code.bin")
    cap = os.path.join(work, "ranging.bin")
    t0 = time.perf_counter()
    write_prn_file(code, cfg.bit_len, cfg.code_len, cfg.taps)
    truth = synthesize_ranging(dev, seed, code, cap)
    log(f"goranging capture: {GR_SECONDS} s x 2 channels, "
        f"{os.path.getsize(cap) / 1e6:.0f} MB in {time.perf_counter() - t0:.1f} s; "
        f"truth delays {truth['delay']} samples, Dopplers {truth['doppler']} Hz")

    # -- 8. the main path, cold then warm ---------------------------------
    runs = [run_goranging_cli(cap, code, os.path.join(work, f"fast{i}C.mat"), dev)
            for i in range(2)]
    out, wall = runs[1]
    iq_samples = GR_SECONDS * cfg.fs * 2  # both channels (bench.py:424)
    msps = iq_samples / wall / 1e6
    log(f"goranging --fast: wall {runs[0][1]:.3f} s cold, {wall:.3f} s warm -> "
        f"{msps:.2f} IQ MS/s end to end over both channels "
        f"({runs[0][0]['timing']['n_batches']} batches of 2 x {GR_BATCH} epochs)")
    log(f"  timing (warm): {json.dumps(out['timing'])}")
    log(f"  timing (cold): {json.dumps(runs[0][0]['timing'])}")
    errs = []
    for c, ch in enumerate(("ch1", "ch2")):
        dl = delays_samples(out[ch])
        if len(dl) != GR_SECONDS * round(cfg.codes_per_second):
            raise RuntimeError(f"{ch}: {len(dl)} epochs")
        d_err = float(np.median(dl) - truth["delay"][c])
        f_err = float(out["df"][c] - truth["doppler"][c])
        errs.append((d_err, f_err))
        log(f"  {ch}: median delay err {d_err:+.5f} sample (p-p over epochs "
            f"{np.ptp(dl):.4f}), df {out['df'][c]:.4f} Hz (err {f_err:+.4f} Hz)")
        if abs(d_err) > GR_DELAY_TOL or abs(f_err) > GR_DF_TOL:
            raise RuntimeError(f"goranging truth check failed on {ch}")
    for ch in ("ch1", "ch2"):
        for k in out[ch]:
            if not np.array_equal(out[ch][k], runs[0][0][ch][k]):
                raise RuntimeError(f"two goranging runs differ ({ch} {k})")
    # the card's busy share over a third, traced run (the union of its
    # device events over the traced wall; the trace itself slows the host)
    _, dev_events, traced_wall = traced(
        lambda: run_goranging_cli(cap, code, os.path.join(work, "tracedC.mat"), dev), 1)
    busy = busy_ms(dev_events) if dev_events else None
    log(f"  traced run: wall {traced_wall:.3f} s, device busy "
        f"{busy} ms ({len(dev_events)} device ops)"
        + (f" -> busy share {busy / 1e3 / traced_wall:.4f}, of the untraced warm "
           f"wall {busy / 1e3 / wall:.4f}" if busy else ""))

    # -- 9. against process_file, float32 ingest and the CPU --------------
    t0 = time.perf_counter()
    base = goranging.process_file(cap, code, cfg, proc, batch_epochs=GR_BATCH,
                                  out_mat=os.path.join(work, "baseC.mat"), device=dev)
    t_base = time.perf_counter() - t0
    worst_pf = 0.0
    for ch in ("ch1", "ch2"):
        if not np.array_equal(out[ch]["indice"], base[ch]["indice"]):
            raise RuntimeError(f"pipeline vs process_file: indice differs ({ch})")
        worst_pf = max(worst_pf, float(np.abs(out[ch]["correction"]
                                              - base[ch]["correction"]).max()))
    if worst_pf > 1e-4 or out["df"] != base["df"]:
        raise RuntimeError(f"pipeline vs process_file: correction {worst_pf}")
    log(f"pipeline vs goranging.process_file on the card ({t_base:.2f} s): indice "
        f"identical, max correction diff {worst_pf:.2e} sample, df equal")
    kw = dict(batch_epochs=GR_BATCH, device=dev)
    o32 = pipeline.process_capture_overlapped(
        cap, code, cfg, proc, ingest_dtype="float32",
        out_mat=os.path.join(work, "f32C.mat"), **kw)
    for ch in ("ch1", "ch2"):
        for k in out[ch]:
            if not np.array_equal(out[ch][k], o32[ch][k]):
                raise RuntimeError(f"int16 vs float32 ingest differ ({ch} {k})")
    log(f"int16 ingest vs float32 ingest: the same bits "
        f"(float32 run {o32['timing']['total_s']:.3f} s)")
    o8 = pipeline.process_capture_overlapped(
        cap, code, cfg, proc, parity_ns=0.1,
        out_mat=os.path.join(work, "q8C.mat"), **kw)
    ps = max(float(np.abs(delays_samples(o8[ch]) - delays_samples(out[ch])).max())
             for ch in ("ch1", "ch2")) / cfg.fs * 1e12
    log(f"int8 ladder (parity_ns=0.1): max |delay - int16 delay| {ps:.2f} ps "
        f"(run {o8['timing']['total_s']:.3f} s)")

    t0 = time.perf_counter()
    rep = build_replica(code, cfg, proc)
    t_rep = time.perf_counter() - t0
    iq, n = sc16.read_sc16_epochs_raw16(cap, 0, GR_BATCH, L)
    dfv = np.repeat(np.asarray(out["df"], np.float32), GR_BATCH)
    cpu_step = boundary.make_ranging_step(rep.fcode, rep.code_interp, np.ones(L, bool),
                                          cfg.fs, packed=True, device="cpu")
    t0 = time.perf_counter()
    cpu_rows = boundary.to_epoch_result(boundary.unpack_outputs(
        cpu_step(torch.from_numpy(iq), df_fixed=torch.from_numpy(dfv)).numpy()))
    t_cpu = time.perf_counter() - t0
    worst_cpu = 0.0
    for c, ch in enumerate(("ch1", "ch2")):
        sl = slice(c * GR_BATCH, (c + 1) * GR_BATCH)
        card = {k: v[:GR_BATCH] for k, v in out[ch].items()}
        if not np.array_equal(card["indice"], cpu_rows.indice[sl]):
            raise RuntimeError(f"card vs CPU first batch: indice differs ({ch})")
        worst_cpu = max(worst_cpu, float(np.abs(card["correction"]
                                                - cpu_rows.correction[sl]).max()))
        for f in ("snr_r", "snr_i"):
            rel = np.abs(card[f] - getattr(cpu_rows, f)[sl]) / (
                cpu_rows.snr_r[sl] + cpu_rows.snr_i[sl])
            if rel.max() > 1e-3:
                raise RuntimeError(f"card vs CPU first batch: {f} {rel.max()}")
    if worst_cpu > 1e-4:
        raise RuntimeError(f"card vs CPU first batch: correction {worst_cpu}")
    log(f"card vs the port on the CPU, first batch (CPU step {t_cpu:.2f} s): indice "
        f"identical, max correction diff {worst_cpu:.2e} sample")

    # -- 10. the resident step and its device functions -------------------
    t0 = time.perf_counter()
    step = boundary.make_ranging_step(rep.fcode, rep.code_interp, np.ones(L, bool),
                                      cfg.fs, packed=True, device=dev)
    torch.cuda.synchronize()
    t_bind = time.perf_counter() - t0
    log(f"set-up per file: build_replica {t_rep:.4f} s, make_ranging_step "
        f"{t_bind:.4f} s (host wall)")
    iq_d = torch.from_numpy(iq).to(dev)
    dfv_d = torch.from_numpy(dfv).to(dev)
    step_ms = cuda_ms(lambda: step(iq_d, df_fixed=dfv_d), 20)
    step_dev_ms, step_ops, table = profile_device(lambda: step(iq_d, df_fixed=dfv_d))
    log(f"ranging_step per batch of 2 x {GR_BATCH} epochs: {step_ms:.3f} ms (CUDA "
        f"events), device {step_dev_ms} ms in {step_ops} device ops (profiler)")
    log(table)

    # the step's parts at the batch's own shapes (B = 2 x 50 rows of L)
    fcode = torch.as_tensor(rep.fcode.astype(np.complex64), device=dev)
    fine = torch.as_tensor(zoomdft.fine_window_matrix(L, 1, DEFAULT_FINE_WIDTH)
                           .astype(np.complex64), device=dev)
    g = torch.as_tensor(zoomdft.zoom_gather(np.conj(np.fft.fft(
        rep.code_interp.astype(np.float64))), L, 1).astype(np.complex64), device=dev)

    def prologue():
        x = iq_d.to(torch.float32)
        x = torch.cat([x[..., 0:2], x[..., 2:4]], dim=0)
        d = torch.complex(x[..., 0], x[..., 1])
        d = d - torch.mean(d, dim=-1, keepdim=True)
        return d * fftutils.mix_phasor(L, dfv_d, cfg.fs)

    y = prologue()
    ffty = torch.fft.fft(y, dim=-1)
    prod = ffty * fcode
    ci = torch.argmax(torch.abs(torch.fft.ifft(prod, dim=-1)), dim=-1)
    s_idx = torch.remainder(ci * 3 - 1, 3 * L)
    d_raw = torch.complex(*torch.cat([iq_d[..., 0:2], iq_d[..., 2:4]], 0)
                          .to(torch.float32).unbind(-1))
    dec = doppler.bound_prepass_window(sc16.decimate_sc16(
        cap, proc.df_decimation, max_out=doppler.PREPASS_MAX_SAMPLES))
    dec0 = torch.as_tensor(dec[0]).to(dev)
    funcs = {
        "fine_window": lambda: zoomdft.fine_window(prod, ci, fine, 1),
        "zoom_point": lambda: zoomdft.zoom_point(ffty, g, s_idx, 1),
        "mix_prologue": prologue,
        "squaring_df": lambda: doppler.squaring_df(d_raw, cfg.fs, np.ones(L, bool)),
        "per_file_df": lambda: doppler.per_file_df(dec0, cfg.fs, proc.df_decimation),
    }
    parts = {}
    for name, fn in funcs.items():
        ms = cuda_ms(fn, 20)
        dev_ms, ops, _ = profile_device(fn)
        parts[name] = {"ms": ms, "device_ms": dev_ms, "device_ops": ops}
        log(f"  {name}: {ms:.4f} ms per call (CUDA events), device {dev_ms} ms in "
            f"{ops} device ops (profiler)")
    return (cap, code, truth), {
        "seconds": GR_SECONDS, "batch_epochs": GR_BATCH, "L": L,
        "iq_msps": msps, "wall_s": wall, "cold_wall_s": runs[0][1],
        "timing": out["timing"], "delay_err_samples": [e[0] for e in errs],
        "df_err_hz": [e[1] for e in errs], "int8_max_delay_diff_ps": ps,
        "vs_process_file_max_corr": worst_pf, "vs_cpu_max_corr": worst_cpu,
        "busy_ms": busy, "traced_wall_s": traced_wall,
        "replica_s": t_rep, "bind_s": t_bind,
        "step_ms": step_ms, "step_device_ms": step_dev_ms,
        "step_device_ops": step_ops, "parts": parts,
    }


def synthesize_single(dev, seed: int, code_path: str, delay: float,
                      doppler: float, amplitude: float, path: str, seconds: int,
                      fs: float) -> None:
    """Write a single-channel sc16 capture: the code of ``code_path``
    delayed by ``delay`` samples (circularly, by an FFT phase ramp), at
    ``doppler`` Hz with a random phase and ``amplitude``, plus noise;
    built on the card one second at a time."""
    from amaranth_twstft_tpu_torch.ops.lfsr import read_prn_file

    chips = read_prn_file(code_path).astype(np.float64) * 2 - 1
    code = torch.from_numpy(np.repeat(chips, int(fs // CHIP_RATE))).to(dev)
    L = code.numel()
    k = torch.fft.fftfreq(L, device=dev, dtype=torch.float64)
    wave = torch.fft.ifft(torch.fft.fft(code) * torch.exp(-2j * math.pi * k * delay))
    gen = torch.Generator(device=dev).manual_seed(seed)
    phase = float(np.random.default_rng(seed).uniform())
    n = int(fs)
    t = torch.arange(n, device=dev, dtype=torch.float64)
    with open(path, "wb") as f:
        for s0 in range(0, seconds * n, n):
            tt = t + s0
            ph = torch.remainder(doppler * tt / fs + phase, 1.0)
            sig = amplitude * wave[torch.remainder(tt.long(), L)] * torch.exp(
                2j * math.pi * ph)
            noise = torch.randn(2, n, generator=gen, device=dev,
                                dtype=torch.float64) * TW_NOISE
            iq = torch.stack([sig.real + noise[0], sig.imag + noise[1]], dim=-1)
            f.write(torch.clamp(torch.round(iq), -32768, 32767).to(torch.int16)
                    .cpu().numpy().tobytes())


def session_truths(seed: int, lt_taps: int, L: int, block: int, fs: float) -> dict:
    """The four captures of one session: (site, channel) -> (code taps,
    delay, Doppler, amplitude).  Each site's loopback ``_2`` carries its
    own code, its remote ``_1`` the other site's; the Dopplers lie in each
    site's claudio window (OP negative, ``claudio.py:50-58``); the delays
    have fractional parts away from one half, so the re-seek's rounding is
    unambiguous.

    The loopbacks' doubled Doppler sits on a centre of the 2-s block's
    FFT bins.  Off a centre, the squaring line of a channel this strong
    leaks above the hunt's 20x-median gate for up to +-16 bins, the
    reference's hunt keeps the highest-bin candidate that passes the
    trial correlation (``claudio_...separate.m:33-44``), and the +-3-bin
    refresh cannot walk back to the line: df would be off by up to 4 Hz.
    The JAX package does the same: ``tests/test_torch_claudio.py::
    test_production_hunt_matches_jax`` holds both packages to the same
    bins and df on a production block with its line between bins.  The
    weak remotes' lines leak past no more than 3 bins, so their Dopplers
    are drawn freely."""
    rng = np.random.default_rng(seed + 4)
    taps = {"OP": 9, "LTFB": lt_taps}
    truths = {}
    for site, ch in (("OP", "_2"), ("OP", "_1"), ("LTFB", "_2"), ("LTFB", "_1")):
        own = site if ch == "_2" else ("LTFB" if site == "OP" else "OP")
        frac = rng.uniform(0.1, 0.4) * rng.choice([-1.0, 1.0])
        delay = float(rng.integers(L // 20, L - L // 20)) + frac
        dop = (-1.0 if site == "OP" else 1.0) * rng.uniform(46.5e3, 53.5e3)
        if ch == "_2":
            half_bin = fs / block / 2  # the doubled axis' bin, halved
            dop = round(dop / half_bin) * half_bin
            amp = TW_LOOPBACK_AMPLITUDE
        else:
            amp = TW_REMOTE_AMPLITUDE
        truths[(site, ch)] = (taps[own], delay, dop, amp)
    return truths


def folded_delay(delay: float) -> float:
    """Where the claudio chain tracks a code delayed by ``delay`` samples:
    its data-conjugated correlation peaks at ``-delay`` mod L, and the
    re-seek (``claudio.py:524-529``) parks the peak at 21 + that peak's
    fractional part, i.e. at ``21 - (delay - round(delay))``."""
    return 21.0 - (delay - round(delay))


def run_claudio_cli(cap: str, code: str, site: str, ch: str, dev):
    """The main path: ``twstft-torch claudio`` in-process (production
    ``ProcessingConfig(conjugate_data=True)``).  Returns the chain's
    result dict and the call's wall time."""
    from amaranth_twstft_tpu_torch import cli
    from amaranth_twstft_tpu_torch.models import claudio

    kept = {}
    orig = claudio.process_file

    def keep(*a, **kw):
        kept["out"] = orig(*a, **kw)
        return kept["out"]

    argv = ["claudio", cap, code, "--remote" if ch == "_1" else "--local",
            "--device", str(dev)] + (["--op"] if site == "OP" else [])
    claudio.process_file = keep
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        claudio.process_file = orig
    if rc != 0 or kept.get("out") is None:
        raise RuntimeError(f"claudio {cap} exited {rc}")
    return kept["out"], wall


def tracked_delays(out: dict) -> np.ndarray:
    return out["indice"].astype(np.float64) + out["correction"] / 3.0


def twoway_phase(work: str, dev, seed: int, lt_taps: int) -> dict:
    """Steps 11-15; returns the numbers of the ``{"twoway": ...}`` line."""
    from amaranth_twstft_tpu_torch import cli
    from amaranth_twstft_tpu_torch.config import (
        ProcessingConfig,
        SignalConfig,
        StationConfig,
    )
    from amaranth_twstft_tpu_torch.models import claudio
    from amaranth_twstft_tpu_torch.models.godual import build_replica
    from amaranth_twstft_tpu_torch.ops import boundary, doppler
    from amaranth_twstft_tpu_torch.ops.lfsr import write_prn_file
    from amaranth_twstft_tpu_torch.utils import io as sc16

    cfg = SignalConfig()
    proc = ProcessingConfig(conjugate_data=True)  # production: 2-s blocks, 30-s skip
    L, fs = cfg.samples_per_code, cfg.fs
    root = os.path.join(work, "twoway")
    truths = session_truths(seed, lt_taps, L, int(fs * proc.block_seconds), fs)
    codes = {}
    for taps in sorted({v[0] for v in truths.values()}):
        codes[taps] = os.path.join(root, f"code_{taps}.bin")
        os.makedirs(root, exist_ok=True)
        write_prn_file(codes[taps], cfg.bit_len, cfg.code_len, taps)
    ts = {"OP": 1755400000, "LTFB": 1755400004}  # one decade: one session
    claudio._RESIDENT_CACHE.clear()
    files = {}
    prefix = None
    for (site, ch), (taps, delay, dop, amp) in truths.items():
        os.makedirs(os.path.join(root, site), exist_ok=True)
        cap = os.path.join(root, site, f"{ts[site]}{ch}.bin")
        t0 = time.perf_counter()
        synthesize_single(dev, seed + len(files), codes[taps], delay, dop, amp,
                          cap, TW_SECONDS, fs)
        t_syn = time.perf_counter() - t0
        out, wall = run_claudio_cli(cap, codes[taps], site, ch, dev)
        tm = out["timing"]
        n_iq = sc16.n_samples_sc16(cap, channels=1)
        msps = n_iq / tm["total_s"] / 1e6
        dl = tracked_delays(out)
        d_err = float(np.median(dl) - folded_delay(delay))
        df_err = float(np.abs(out["df"] - dop).max())
        blocks = len(tm["block_step_ms"])
        warm = "warm" if tm["cache_hit"] else "cold"
        log(f"claudio {site}{ch} ({warm}, taps {taps}): {os.path.getsize(cap) / 1e6:.0f} MB "
            f"written in {t_syn:.1f} s; process_file {tm['total_s']:.3f} s "
            f"(verb wall {wall:.3f} s) -> {msps:.2f} IQ MS/s; {len(dl)} codes in "
            f"{blocks} blocks; median delay err {d_err:+.5f} sample (truth "
            f"{folded_delay(delay):.4f}); max |df - truth| {df_err:.4f} Hz; "
            f"moved {out['moved']}")
        log(f"  layers: setup {tm['setup_s']:.4f} s, hunt {tm['hunt_s']:.4f} s, "
            f"raw read {tm['read_s']:.4f} s, quantize {tm['quantize_s']:.4f} s, "
            f"H2D enqueue {tm['h2d_enqueue_s']:.4f} s, block step "
            f"{np.mean(tm['block_step_ms']):.3f} ms per block (CUDA events; "
            f"{[round(x, 3) for x in tm['block_step_ms']]}), fetch wait "
            f"{tm['fetch_wait_s']:.4f} s, {len(tm['slip_ms'])} slip passes "
            f"{[round(x, 3) for x in tm['slip_ms']]} ms, .mat write "
            f"{tm['mat_write_s']:.4f} s")
        if not out["found"] or not out["moved"] or out["carry_trimmed"]:
            raise RuntimeError(f"claudio {site}{ch}: found {out['found']}, moved "
                               f"{out['moved']}, trims {out['carry_trimmed']}")
        if abs(d_err) > TW_DELAY_TOL or df_err > TW_DF_TOL:
            raise RuntimeError(f"claudio {site}{ch}: truth check failed")
        # the re-seek drops at most the session's last partial code
        if blocks != TW_SECONDS // 2 or not (
                0 <= TW_SECONDS * round(cfg.codes_per_second) - len(dl) <= 1):
            raise RuntimeError(f"claudio {site}{ch}: {blocks} blocks, {len(dl)} codes")
        files[f"{site}{ch}"] = {
            "cache": warm, "iq_msps": msps, "total_s": tm["total_s"],
            "verb_wall_s": wall, "delay_err_samples": d_err, "df_err_hz": df_err,
            "moved": out["moved"], "timing": tm,
        }
        if prefix is None:
            # a 4-s prefix of the first capture, for the CPU comparison
            prefix = (os.path.join(root, f"{ts[site]}{ch}_prefix.bin"), codes[taps])
            with open(cap, "rb") as src, open(prefix[0], "wb") as dst:
                dst.write(src.read(TW_PREFIX_SECONDS * int(fs) * 4))
        if site == "LTFB" and ch == "_1":
            # -- 13. the busy share over one traced warm file ----------------
            os.makedirs(os.path.join(root, "traced"), exist_ok=True)
            kw = dict(remote=True, ranging=False, out_dir=os.path.join(root, "traced"),
                      device=dev)
            _, dev_events, traced_wall = traced(lambda: claudio.process_file(
                cap, codes[taps], cfg, proc, StationConfig(op=False), **kw), 1)
            busy = busy_ms(dev_events) if dev_events else None
            log(f"  traced warm run: wall {traced_wall:.3f} s, device busy {busy} ms "
                f"({len(dev_events)} device ops)"
                + (f" -> busy share {busy / 1e3 / traced_wall:.4f}" if busy else ""))
            files[f"{site}{ch}"].update(busy_ms=busy, traced_wall_s=traced_wall)
            last = (cap, codes[taps])
        else:
            os.remove(cap)

    # -- 14. the block step's functions at production shapes -----------------
    cap, code = last
    res = next(iter(v for k, v in claudio._RESIDENT_CACHE.items()
                    if k[0] == os.path.abspath(code)))
    block = int(fs * proc.block_seconds)
    raw, _ = sc16.read_raw16(cap, 0, block)
    q8_np, scale = claudio._quantize_q8(raw)
    q8 = torch.from_numpy(q8_np).to(dev)
    scale = float(np.float32(scale))
    x, prev = res.new_buffer(), res.new_buffer()
    dold = L // 3  # a carry as after a slip
    offsets = np.arange(0, dold + block - L + 1, L, dtype=np.int64)
    res.assemble(x, prev, 0, dold, q8, scale)
    rep = build_replica(code, cfg, proc, conjugate=False)
    mask_d = torch.from_numpy(doppler.window_mask(
        block, fs, *claudio.claudio_df_window(StationConfig(op=False), False))).to(dev)
    dc_np = raw[:L].astype(np.float32)
    dc = torch.from_numpy(dc_np - dc_np.mean(axis=0, keepdims=True)).to(dev)
    fcode_ri = torch.from_numpy(boundary.pack_complex(rep.fcode)).to(dev)
    kbon = int(doppler.search_df_candidates_ri(q8, dc, fcode_ri, fs, mask_d)[0])
    raw_d = x[dold : dold + block]
    wins = res.windows(x, offsets, dold + block)
    df_d = doppler.refresh_df_ri(raw_d, fs, kbon)[0].to(torch.float32)
    funcs = {
        "claudio_assemble": lambda: res.assemble(x, prev, 0, dold, q8, scale),
        "claudio_refresh_df": lambda: doppler.refresh_df_ri(raw_d, fs, kbon),
        "claudio_window_gather": lambda: res.windows(x, offsets, dold + block),
        "claudio_packed_step": lambda: res.step_packed(wins, df_fixed=df_d),
        "claudio_block_step": lambda: res.block_step(x, prev, 0, dold, q8, scale,
                                                     kbon, offsets),
        "search_df_candidates_ri": lambda: doppler.search_df_candidates_ri(
            q8, dc, fcode_ri, fs, mask_d),
    }
    parts = {}
    for name, fn in funcs.items():
        ms = cuda_ms(fn, 10)
        dev_ms, ops, _ = profile_device(fn)
        parts[name] = {"ms": ms, "device_ms": dev_ms, "device_ops": ops}
        log(f"  {name}: {ms:.4f} ms per call (CUDA events), device {dev_ms} ms in "
            f"{ops} device ops (profiler)")
    log(f"  block step shapes: block {block} samples, {len(offsets)} windows "
        f"padded to {res.pad_to} x L = {L}")
    del x, prev, q8, wins, dc, fcode_ri, mask_d, raw_d
    os.remove(cap)

    # -- 12. the card against the CPU on a 4-s prefix ------------------------
    pre_proc = ProcessingConfig(conjugate_data=True, skip_seconds=0.0)
    runs = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        od = os.path.join(root, f"prefix_{name}")
        os.makedirs(od, exist_ok=True)
        t0 = time.perf_counter()
        runs[name] = claudio.process_file(
            prefix[0], prefix[1], cfg, pre_proc, StationConfig(op=True),
            ranging=False, out_dir=od, device=d, transfer="int8")
        log(f"4-s prefix on the {name}: {time.perf_counter() - t0:.2f} s")
    card, cpu = runs["card"], runs["cpu"]
    pre_err = float(np.abs(tracked_delays(card) - tracked_delays(cpu)).max())
    if not np.array_equal(card["df"], cpu["df"]) or card["moved"] != cpu["moved"] \
            or pre_err > TW_CPU_DELAY_TOL:
        raise RuntimeError(f"claudio card vs CPU: df {card['df'][:1]} / "
                           f"{cpu['df'][:1]}, moved {card['moved']} / {cpu['moved']}, "
                           f"delay {pre_err}")
    log(f"claudio card vs the port on the CPU (4-s prefix, resident int8 path): "
        f"df identical, moved identical, max delay diff {pre_err:.2e} sample "
        f"(tolerance {TW_CPU_DELAY_TOL:g})")
    os.remove(prefix[0])

    # -- 15. go1s and campaign ----------------------------------------------
    out_dir = os.path.join(root, "products")
    os.makedirs(out_dir, exist_ok=True)
    stdout = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        rc = cli.main(["go1s", os.path.join(root, "OP"), os.path.join(root, "LTFB"),
                       "-o", out_dir])
    go1s_wall = time.perf_counter() - t0
    rows = json.loads(stdout.getvalue().splitlines()[-1])
    fold = {k: folded_delay(v[1]) for k, v in truths.items()}
    truth_ns = 0.5 * ((fold["OP", "_1"] - fold["OP", "_2"])
                      - (fold["LTFB", "_1"] - fold["LTFB", "_2"])) * 1e9 / fs
    if rc != 0 or len(rows) != 1:
        raise RuntimeError(f"go1s exited {rc} with {len(rows)} sessions")
    res_err = rows[0]["res_mean_ns"] - truth_ns
    products = sorted(os.listdir(out_dir))
    log(f"go1s: wall {go1s_wall:.3f} s, {rows[0]['n_codes']} codes, res_mean "
        f"{rows[0]['res_mean_ns']:.4f} ns (folded truth {truth_ns:.4f} ns, err "
        f"{res_err:+.4f} ns), res std {rows[0]['res_std_ns']:.4f} ns, refined "
        f"mean {rows[0]['res_refined_mean_ns']:.4f} ns; products {products}")
    if abs(res_err) > TW_RES_TOL_NS or not any(p.endswith(".1s") for p in products) \
            or not any(p.endswith(".1sc") for p in products):
        raise RuntimeError("go1s check failed")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["campaign", out_dir])
    if rc != 0 or not os.path.exists(os.path.join(out_dir, "resmean25.txt")):
        raise RuntimeError(f"campaign exited {rc}")
    log(f"campaign: products {sorted(os.listdir(out_dir))}")
    return {
        "seconds": TW_SECONDS, "files": files, "parts": parts,
        "prefix_max_delay_diff_samples": pre_err, "go1s_wall_s": go1s_wall,
        "res_mean_ns": rows[0]["res_mean_ns"], "truth_ns": truth_ns,
        "res_err_ns": res_err,
    }


def free_port() -> int:
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


class Subscriber(threading.Thread):
    """A monitor-stream subscriber in a thread: retries refused connects
    for 60 s (the producer may not be up yet), keeps every message with
    its arrival time, and keeps any other error for :meth:`result`."""

    def __init__(self, port: int, timeout_s: float = 120.0):
        super().__init__(daemon=True)
        self.port, self.timeout_s = port, timeout_s
        self.msgs: list[tuple[float, dict]] = []
        self.connected = threading.Event()
        self.error: BaseException | None = None

    def run(self):
        from amaranth_twstft_tpu_torch.utils.stream import connect_monitor

        deadline = time.monotonic() + 60.0
        try:
            while True:
                try:
                    for msg in connect_monitor("127.0.0.1", self.port,
                                               timeout_s=self.timeout_s):
                        self.msgs.append((time.monotonic(), msg))
                        self.connected.set()
                    return
                except ConnectionRefusedError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.05)
        except BaseException as e:  # noqa: BLE001 — raised by result()
            self.error = e

    def result(self) -> list[tuple[float, dict]]:
        self.join(timeout=self.timeout_s)
        if self.is_alive():
            raise RuntimeError("the subscriber never saw the end of the stream")
        if self.error is not None:
            raise RuntimeError("the subscriber failed") from self.error
        if not self.msgs or self.msgs[-1][1] != {"type": "end"}:
            raise RuntimeError("the stream ended without its end message")
        return self.msgs


def sc16_seconds(cap: str, n: int, nobs: int):
    """The dllpll verb's per-second sample dicts (complex64, fs + one code
    per second, the tail shortened), for the first ``n`` seconds."""
    from amaranth_twstft_tpu_torch.utils import io as sc16

    fs = int(FS)
    total = sc16.n_samples_sc16(cap, channels=2)
    for s in range(n):
        d, _ = sc16.read_sc16_epochs(cap, s * fs, 1, min(fs + nobs, total - s * fs),
                                     channels=2)
        yield {"A": d[0, 0], "B": d[1, 0]}


def host_phase(work: str, dev, seed: int, taps: list[int]) -> dict:
    """Steps 16-20: ``dllpll --host --serve`` on a production-geometry
    capture of 8 emissions; returns the numbers of the ``{"host": ...}``
    line and the explicit-form entries of the kernels line."""
    from amaranth_twstft_tpu_torch import cli
    from amaranth_twstft_tpu_torch.models import dllpll
    from amaranth_twstft_tpu_torch.ops import lagbank

    nobs = CODE_LEN * int(FS // CHIP_RATE)
    cap = os.path.join(work, "host.sc16")
    t0 = time.perf_counter()
    truths = synthesize(dev, seed + 1, taps[: 2 * HOST_PER_INPUT], cap,
                        n_per_input=HOST_PER_INPUT, n_seconds=HOST_SECONDS,
                        dop_grid=HOST_DOP_GRID)
    log(f"host capture: {len(truths)} emissions, {HOST_SECONDS} s + one code, "
        f"{os.path.getsize(cap) / 1e6:.0f} MB in {time.perf_counter() - t0:.1f} s; "
        f"Dopplers {sorted(round(v[0], 1) for v in truths.values())} Hz")
    param, taps_map = write_param(os.path.join(work, "host.param"), truths)
    common = [cap, "--param", param, "--fs", repr(FS), "--bitlen", str(BIT_LEN),
              "--code-len", str(CODE_LEN), "--taps-map", taps_map]

    # -- 16. the main path: dllpll --host --serve, an in-process subscriber
    walls: list[float] = []
    caf_ms: list[float] = []
    last: dict = {}
    orig_caf, orig_lb = dllpll.caf_search, dllpll.lag_bank_correlate

    def timed_caf(*a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = orig_caf(*a, **kw)
        e1.record()
        e1.synchronize()
        caf_ms.append(e0.elapsed_time(e1))
        return out

    def keep_inputs(obs_ri, wav_lags):
        last.update(obs=obs_ri, w=wav_lags)
        return orig_lb(obs_ri, wav_lags)

    port = free_port()
    sub = Subscriber(port)
    sub.start()
    out_dir = os.path.join(work, "host_out")
    shutil.rmtree(out_dir, ignore_errors=True)  # the verb appends
    stdout = io.StringIO()
    lagbank.lag_bank_correlate.launches = 0
    lagbank.lag_bank_kernel.launches = 0
    dllpll.caf_search, dllpll.lag_bank_correlate = timed_caf, keep_inputs
    try:
        t0 = time.perf_counter()
        with timing_hooks([(dllpll.Receiver, "process_second", walls, True)]), \
                contextlib.redirect_stdout(stdout), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main(["dllpll", *common, "--host", "--serve", str(port),
                           "--serve-min-clients", "1", "--out-dir", out_dir,
                           "--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        dllpll.caf_search, dllpll.lag_bank_correlate = orig_caf, orig_lb
    launches = lagbank.lag_bank_correlate.launches
    if rc != 0:
        raise RuntimeError(f"dllpll --host exited {rc}")
    msgs = sub.result()
    rows = [ln for ln in stdout.getvalue().splitlines() if not ln.startswith("#")]
    reps = parse_rows(stdout.getvalue())
    with open(os.path.join(out_dir, "rxcomplex.log")) as f:
        rxlog = f.read()
    log(f"dllpll --host: {HOST_SECONDS} s of {len(truths)} channels in {wall:.3f} s "
        f"wall; Receiver.process_second wall per second {[round(w, 4) for w in walls]} s; "
        f"caf_search per acquisition {[round(m, 3) for m in caf_ms]} ms (CUDA events)")

    # -- 17. truths, the subscriber, the launches -------------------------
    last_second = HOST_SECONDS - 1
    locked, ok, worst_df, worst_gd = check_truths(reps, truths, last_second)
    log(f"second {last_second}: {locked} of {len(truths)} channels report, {ok} within "
        f"0.5 Hz and 0.25 sample (worst |df| {worst_df:.4f} Hz, worst |gd| "
        f"{worst_gd:.4f} sample)")
    if locked != len(truths) or ok != locked:
        raise RuntimeError(f"host truth check failed: {locked} report, {ok} ok")
    track = io.StringIO()
    with contextlib.redirect_stdout(track):
        for _, m in msgs:
            if m["type"] == "track":
                cli._print_track_msg(m)
    if msgs[0][1].get("mode") != "dllpll" or track.getvalue().splitlines() != rows:
        raise RuntimeError("the subscriber's track messages differ from the printed rows")
    log(f"subscriber: hello, {len(rows)} track messages equal to the printed rows, end")
    tracked = len(rows) + rxlog.count("code lock") + rxlog.count("lock lost")
    if launches != tracked or launches != len(truths) * (HOST_SECONDS - 1):
        raise RuntimeError(f"explicit-form launches {launches}, tracked "
                           f"channel-seconds {tracked}")
    log(f"explicit-form lag-bank launches on the --host path: {launches} "
        f"(= tracked channel-seconds; {lagbank.lag_bank_kernel.launches} kernel "
        f"launches of either form)")

    # -- 18. the card against the port on the CPU, first seconds ----------
    with open(param) as f:
        chans = [dataclasses.replace(c, bit_len=BIT_LEN, code_len=CODE_LEN,
                                     taps=truths[(c.physical, c.prn_id)][2])
                 for c in dllpll.parse_sdr_param(f.read())]
    t0 = time.perf_counter()
    rx_cpu = dllpll.Receiver(chans, fs=FS, device="cpu")
    cpu_reps = [rx_cpu.process_second(sec)
                for sec in sc16_seconds(cap, HOST_CPU_SECONDS, nobs)]
    t_cpu = time.perf_counter() - t0
    worst_fc = worst_gd_ns = 0.0
    n_cmp = 0
    for s, reports in enumerate(cpu_reps):
        for ch, r in zip(rx_cpu.channels, reports):
            card = reps.get((s, ch.cfg.physical, ch.cfg.prn_id))
            if (r is None) != (card is None):
                raise RuntimeError(f"card vs CPU: second {s} {ch.cfg.prn_id} reports differ")
            if r is None:
                continue
            n_cmp += 1
            worst_fc = max(worst_fc, abs(card[0] - r.fc_hz))
            worst_gd_ns = max(worst_gd_ns, abs(card[2] - r.gd_ns))
            if card[1] != r.cnt:
                raise RuntimeError(f"card vs CPU: cnt {card[1]} / {r.cnt}")
    if n_cmp == 0 or worst_fc > HOST_CPU_FC_HZ or worst_gd_ns > HOST_CPU_GD_NS:
        raise RuntimeError(f"card vs CPU: {n_cmp} rows, fc {worst_fc}, gd {worst_gd_ns}")
    log(f"card vs the port on the CPU, first {HOST_CPU_SECONDS} s ({t_cpu:.1f} s on the "
        f"CPU): {n_cmp} rows, cnt identical, max |fc| diff {worst_fc:.2e} Hz, max |gd| "
        f"diff {worst_gd_ns:.2e} ns")

    # -- 19. the banked receiver on the same capture -----------------------
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(["dllpll", *common, "--device", str(dev)])
    bank = parse_rows(stdout.getvalue())
    worst_bank_df = worst_bank_gd = 0.0
    for (phys, prn) in truths:
        h, b = reps[(last_second, phys, prn)], bank.get((last_second, phys, prn))
        if rc != 0 or b is None:
            raise RuntimeError(f"banked dllpll: rc {rc}, no row for {prn}")
        worst_bank_df = max(worst_bank_df, abs(h[0] - b[0]))
        worst_bank_gd = max(worst_bank_gd, abs(h[2] - b[2]) * FS / 1e9)
    if worst_bank_df > 0.5 or worst_bank_gd > 0.25:
        raise RuntimeError(f"host vs bank: df {worst_bank_df}, gd {worst_bank_gd}")
    log(f"host vs banked dllpll at second {last_second}: max |fc| diff "
        f"{worst_bank_df:.2e} Hz, max |gd| diff {worst_bank_gd:.2e} sample")

    # -- 20. the explicit form on the path's last-launch inputs ------------
    obs, w = last["obs"], last["w"]
    _, C, K = obs.shape
    nl = w.shape[1]
    kern = lagbank.lag_bank_correlate(obs, w)
    again = lagbank.lag_bank_correlate(obs, w)
    if not all(torch.equal(a, b) for a, b in zip(kern, again)):
        raise RuntimeError("two launches of the explicit form differ")
    log("explicit-form determinism: two launches give the same bits")
    plain = lagbank.lag_bank_plain(obs, w)
    abs_err, rel_err, ph_err = compare_lag_banks(
        f"explicit form on the --host path's last launch, (2, C, K) x (K, NL) = "
        f"(2, {C}, {K}) x ({K}, {nl})", kern, plain)
    ref64 = lagbank.lag_bank_plain(obs.double(), w.double())
    kern64 = lagbank.lag_bank_errors(kern, ref64)
    plain64 = lagbank.lag_bank_errors(plain, ref64)
    del ref64, again
    log(f"explicit form against float64: kernel power err / row max {kern64[0]:.3e}, "
        f"phase {kern64[1]:.3e} cycles; fp32 plain {plain64[0]:.3e}, {plain64[1]:.3e} "
        f"cycles (gate: kernel <= {F64_GATE:g} x plain)")
    if kern64[0] > F64_GATE * plain64[0] or kern64[1] > F64_GATE * plain64[1]:
        raise RuntimeError("the explicit form fails the float64 gate")
    ms = cuda_ms(lambda: lagbank.lag_bank_correlate(obs, w), 20)
    plain_ms = cuda_ms(lambda: lagbank.lag_bank_plain(obs, w), 10)
    obs2 = obs.reshape(2 * C, K)
    library_ms = cuda_ms(lambda: torch.matmul(obs2, w), 10)
    ms2 = cuda_ms(lambda: lagbank.lag_bank_correlate(obs, w), 20)
    # host time alone: the wall of 20 calls that do not wait for the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        lagbank.lag_bank_correlate(obs, w)
    host_ms = 1e3 * (time.perf_counter() - t0) / 20
    torch.cuda.synchronize()
    # device time alone: a call's host time (checks, two allocations, the
    # ctypes call) can exceed the kernels' ~0.04 ms on the card's host
    device_ms, device_ops, _ = profile_device(lambda: lagbank.lag_bank_correlate(obs, w), 10)
    plain_device_ms, _, _ = profile_device(lambda: lagbank.lag_bank_plain(obs, w), 10)
    library_device_ms, _, _ = profile_device(lambda: torch.matmul(obs2, w), 10)
    o257, w257 = obs[..., :257].contiguous(), w[:257].contiguous()
    ms_k257 = cuda_ms(lambda: lagbank.lag_bank_correlate(o257, w257), 50)
    flops = 2.0 * 2 * C * nl * K
    nbytes = 4.0 * (obs.numel() + w.numel() + 2 * C * nl)  # + power, phase
    bound_bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    bound_tf32x3_ms = 1e3 * 3 * flops / PEAK_TF32_FLOPS
    bound_fp32_ms = 1e3 * flops / PEAK_FP32_FLOPS
    kernel_ms = min(ms, ms2)
    log(f"explicit form per launch: kernel {ms:.4f} / {ms2:.4f} ms, plain {plain_ms:.4f} "
        f"ms, torch.matmul {library_ms:.4f} ms (CUDA events); host time of a call "
        f"{host_ms:.4f} ms; device time (profiler): "
        f"kernel {device_ms} ms in {device_ops} kernels, plain {plain_device_ms} ms, "
        f"torch.matmul {library_device_ms} ms; at K = 257: {ms_k257:.4f} "
        f"ms; bounds: bytes {bound_bytes_ms:.4f} ms ({nbytes:.3e} B), 3xTF32 "
        f"{bound_tf32x3_ms:.4f} ms, fp32 FMA {bound_fp32_ms:.4f} ms ({flops:.3e} FLOP); "
        f"{nbytes / kernel_ms / 1e6:.1f} GB/s")
    # the dense CAF at the acquisition's shape: one production epoch,
    # 81 hypotheses of +-4 kHz in 100 Hz steps (the Queue 2 row)
    from amaranth_twstft_tpu_torch.ops import caf

    ch0 = rx_cpu.channels[0]
    epoch = next(sc16_seconds(cap, 1, nobs))["A"][12 * nobs : 13 * nobs]
    d = torch.from_numpy(np.ascontiguousarray(epoch[None])).to(dev)
    fcode = torch.from_numpy(ch0.fcode).to(dev, d.dtype)
    code3 = torch.from_numpy(ch0.code_interp).to(dev)
    shifts, _ = caf.doppler_bins(FS, nobs, -4000.0, 4000.0, 100.0)
    caf_parts = {}
    for name, fn in (
        ("caf_peaks", lambda: caf.caf_peaks(d, fcode, shifts)),
        ("caf_search", lambda: caf.caf_search(d, fcode, code3, FS, -4000.0, 4000.0,
                                              100.0)),
    ):
        ms_f = cuda_ms(fn, 10)
        dev_ms, ops, _ = profile_device(fn)
        caf_parts[name] = {"ms": ms_f, "device_ms": dev_ms, "device_ops": ops}
        log(f"  {name} (1 x {nobs} complex64, {len(shifts)} hypotheses): {ms_f:.4f} ms "
            f"per call (CUDA events), device {dev_ms} ms in {ops} device ops (profiler)")
    os.remove(cap)
    del obs, obs2, w, o257, w257, kern, plain, last, d, fcode, code3
    return {
        "host": {
            "seconds": HOST_SECONDS, "channels": len(truths), "wall_s": wall,
            "process_second_wall_s": walls, "caf_search_ms": caf_ms,
            "worst_df_hz": worst_df, "worst_gd_samples": worst_gd,
            "cpu_max_fc_diff_hz": worst_fc, "cpu_max_gd_diff_ns": worst_gd_ns,
            "bank_max_fc_diff_hz": worst_bank_df,
            "bank_max_gd_diff_samples": worst_bank_gd, "track_messages": len(rows),
            "caf": caf_parts,
        },
        "kernel": {
            "launches_explicit": launches,
            "ms_explicit": kernel_ms,
            "plain_ms_explicit": plain_ms,
            "library_ms_explicit": library_ms,
            "device_ms_explicit": device_ms,
            "host_ms_explicit": host_ms,
            "plain_device_ms_explicit": plain_device_ms,
            "library_device_ms_explicit": library_device_ms,
            "ms_explicit_k257": ms_k257,
            "bound_explicit_ms": max(bound_bytes_ms, bound_tf32x3_ms),
            "bound_explicit_by": "bytes" if bound_bytes_ms >= bound_tf32x3_ms else "operations",
            "bound_explicit_tf32x3_ms": bound_tf32x3_ms,
            "explicit_max_abs_err": abs_err,
            "explicit_err_over_row_max": rel_err,
            "explicit_phase_err_cycles": ph_err,
            "explicit_f64_err": kern64[0],
            "explicit_f64_phase_err_cycles": kern64[1],
            "explicit_plain_f64_err": plain64[0],
            "explicit_plain_f64_phase_err_cycles": plain64[1],
            "explicit_deterministic": True,
        },
    }


def monitor_phase(work: str, cap: str, code: str, truth: dict, dev) -> dict:
    """Steps 21-23: ``monitor --serve`` tails a file that a writer thread
    grows from the GoRanging capture in 1-s appends; returns the numbers
    of the ``{"monitor": ...}`` line."""
    from amaranth_twstft_tpu_torch import cli
    from amaranth_twstft_tpu_torch.config import ProcessingConfig, SignalConfig
    from amaranth_twstft_tpu_torch.models.godual import build_replica
    from amaranth_twstft_tpu_torch.ops import boundary, doppler
    from amaranth_twstft_tpu_torch.utils import io as sc16

    cfg = SignalConfig(fs=FS, chip_rate=CHIP_RATE, code_len=CODE_LEN, bit_len=BIT_LEN)
    L, fs = cfg.samples_per_code, int(cfg.fs)
    epochs = round(cfg.codes_per_second)  # the verb's batch: one second
    grow = os.path.join(work, "grow.sc16")
    open(grow, "wb").close()
    port = free_port()
    sub = Subscriber(port)
    appended: list[float] = []
    writer_error: list[BaseException] = []

    def writer():
        try:
            if not sub.connected.wait(60.0):
                raise RuntimeError("the monitor never started serving")
            with open(cap, "rb") as src, open(grow, "ab") as dst:
                t_start = time.monotonic()
                for k in range(MON_SECONDS):
                    # one second of capture per second, as a receiver writes
                    time.sleep(max(0.0, t_start + k - time.monotonic()))
                    dst.write(src.read(fs * 8))
                    dst.flush()
                    appended.append(time.monotonic())
        except BaseException as e:  # noqa: BLE001 — raised below
            writer_error.append(e)

    steps: list = []
    orig_make = boundary.make_ranging_step

    def keep_step(*a, **kw):
        steps.append(orig_make(*a, **kw))
        return steps[-1]

    wt = threading.Thread(target=writer, daemon=True)
    sub.start()
    wt.start()
    stdout = io.StringIO()
    boundary.make_ranging_step = keep_step
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main(["monitor", grow, code, "--serve", str(port),
                           "--serve-min-clients", "1", "--timeout", "3",
                           "--device", str(dev), *signal_args(cfg)])
        wall = time.perf_counter() - t0
    finally:
        boundary.make_ranging_step = orig_make
    wt.join(timeout=120.0)
    if wt.is_alive() or writer_error:
        raise RuntimeError(f"the writer failed: {writer_error}")
    msgs = sub.result()
    if rc != 0 or len(steps) != 1:
        raise RuntimeError(f"monitor exited {rc} with {len(steps)} bound steps")
    printed = [ln for ln in stdout.getvalue().splitlines() if not ln.startswith("#")]
    rows = [(t, m) for t, m in msgs if m["type"] == "row"]
    specs = [m for _, m in msgs if m["type"] == "spectrum"]

    # -- 22. checks ------------------------------------------------------
    want = {(e, c) for e in range(MON_SECONDS * epochs) for c in range(2)}
    got = [(int(r.split()[0]), int(r.split()[1])) for r in printed]
    if set(got) != want or len(got) != len(want):
        raise RuntimeError(f"monitor printed {len(got)} rows, want "
                           f"{2 * MON_SECONDS * epochs}")
    sent = [f"{m['epoch']:6d} {m['ch']} {m['delay_samp']:12.4f} {m['df_hz']:9.2f} "
            f"{m['snr_db']:7.2f} {m['cn0_dbhz']:6.2f}" for _, m in rows]
    if sent != printed:
        raise RuntimeError("the subscriber's rows differ from the printed rows")
    if len({(m["epoch"], m["ch"]) for m in specs}) < MON_SECONDS * 2:
        raise RuntimeError(f"{len(specs)} spectra for {MON_SECONDS} batches x 2 channels")
    med_err = []
    for c in range(2):
        dl = np.array([float(r.split()[2]) for r in printed if int(r.split()[1]) == c])
        med_err.append(float(np.median(dl) - truth["delay"][c]))
    if max(abs(e) for e in med_err) > GR_DELAY_TOL:
        raise RuntimeError(f"monitor median delay errors {med_err}")
    # the rows against direct calls of the verb's bound step on the same epochs
    step = steps[0]
    direct = []
    first = {}
    for b in range(MON_SECONDS):
        d, n = sc16.read_sc16_epochs(grow, b * epochs * L, epochs, L)
        for c in range(2):
            out = boundary.unpack_outputs(step(torch.from_numpy(d[c]).to(dev)).cpu().numpy())
            dl, snr = out.delay_samples(), out.snr_db()
            cn0 = _cn0(out)
            direct += [f"{b * epochs + i:6d} {c} {dl[i]:12.4f} {out.df[i]:9.2f} "
                       f"{snr[i]:7.2f} {cn0:6.2f}" for i in range(n)]
            if b == 0:
                first[c] = (d[c], out)
    if direct != printed:
        raise RuntimeError("the monitor's rows differ from direct calls of its step")
    # the first batch against the port on the CPU
    rep = build_replica(code, cfg, ProcessingConfig())
    mask = doppler.window_mask(L, cfg.fs, -20e3, 20e3)
    cpu_step = boundary.make_ranging_step(rep.fcode, rep.code_interp, mask, cfg.fs,
                                          packed=True, device="cpu")
    worst_cpu = 0.0
    for c, (d, card) in first.items():
        cpu = boundary.unpack_outputs(cpu_step(torch.from_numpy(d)).numpy())
        if not np.array_equal(cpu.indice, card.indice):
            raise RuntimeError(f"monitor card vs CPU: indice differs (channel {c})")
        worst_cpu = max(worst_cpu, float(np.abs(cpu.delay_samples()
                                                - card.delay_samples()).max()))
    if worst_cpu > 1e-4:
        raise RuntimeError(f"monitor card vs CPU: delay {worst_cpu}")

    # -- 23. rate and lag -------------------------------------------------
    last_row = {}
    for t, m in rows:
        last_row[m["epoch"] // epochs] = t
    lags = [last_row[b] - appended[b] for b in range(MON_SECONDS)]
    span = rows[-1][0] - appended[0]
    log(f"monitor --serve: {len(printed)} rows of {MON_SECONDS} batches x 2 channels, "
        f"{len(specs)} spectra; verb wall {wall:.3f} s (with the 3 s idle timeout); "
        f"{len(printed) / span:.1f} rows per second from the first append to the last "
        f"row; lag from a batch's last appended byte to its last row "
        f"{[round(x, 3) for x in lags]} s (median {float(np.median(lags)):.3f} s)")
    log(f"  median delay err {[round(e, 5) for e in med_err]} sample; rows equal to "
        f"direct calls of the bound step; first batch vs the CPU: indice identical, "
        f"max delay diff {worst_cpu:.2e} sample")
    os.remove(grow)
    return {"rows": len(printed), "spectra": len(specs), "wall_s": wall,
            "rows_per_s": len(printed) / span, "lag_s": lags,
            "delay_err_samples": med_err, "vs_cpu_max_delay_diff": worst_cpu}


def signal_args(cfg) -> list[str]:
    return ["--fs", repr(cfg.fs), "--chip-rate", repr(cfg.chip_rate),
            "--code-len", str(cfg.code_len), "--bitlen", str(cfg.bit_len),
            "--taps", str(cfg.taps)]


def _cn0(out) -> float:
    from amaranth_twstft_tpu_torch.models.twoway import cn0_dbhz

    return cn0_dbhz(out.snr_r, out.snr_i, FS)


def profile_phase(work: str, cap: str, code: str, dev) -> dict:
    """Step 24: ``goranging --fast --profile LOGDIR``; the Chrome trace
    must hold CUDA kernel events."""
    from amaranth_twstft_tpu_torch import cli

    logdir = os.path.join(work, "profile")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(["goranging", cap, code, "--fast", "--device", str(dev),
                       "--batch-epochs", str(GR_BATCH), "--profile", logdir])
    wall = time.perf_counter() - t0
    traces = os.listdir(logdir) if os.path.isdir(logdir) else []
    if rc != 0 or len(traces) != 1:
        raise RuntimeError(f"goranging --profile exited {rc} with traces {traces}")
    path = os.path.join(logdir, traces[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        raise RuntimeError("the profile's trace holds no CUDA kernel events")
    log(f"goranging --profile: wall {wall:.3f} s, trace {os.path.getsize(path) / 1e6:.1f} "
        f"MB, {len(events)} events, {len(kernels)} CUDA kernel events")
    os.remove(path)
    return {"wall_s": wall, "events": len(events), "kernel_events": len(kernels)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=2026)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    os.environ.setdefault("TWSTFT_BANK_CACHE", "")  # no ~300 MB cache entry

    from amaranth_twstft_tpu_torch.ops import lagbank
    from amaranth_twstft_tpu_torch.ops.lfsr import find_mseq_taps
    from amaranth_twstft_tpu_torch.utils import cuda_build

    t_start = time.perf_counter()
    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    reports = cuda_build.build_all(force=True)
    log(f"build: {len(reports)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # -- 2. capture -------------------------------------------------------
    work = os.path.join(cuda_build.BUILD_DIR, "smoke")
    os.makedirs(work, exist_ok=True)
    cap = os.path.join(work, "capture.sc16")
    t0 = time.perf_counter()
    taps = find_mseq_taps(BIT_LEN, 2 * N_PER_INPUT)
    if len(taps) != 2 * N_PER_INPUT:
        raise RuntimeError(f"found {len(taps)} taps")
    log(f"taps: {len(taps)} 17-bit m-sequences in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    truths = synthesize(dev, args.seed, taps, cap)
    log(f"capture: {len(truths)} emissions, {N_SECONDS} s + one code, "
        f"{os.path.getsize(cap) / 1e6:.0f} MB in {time.perf_counter() - t0:.1f} s")

    # -- 3. the main path -------------------------------------------------
    lagbank.lag_bank_kernel.launches = 0
    t0 = time.perf_counter()
    reps, times, e2e_walls, rxlog, lb_inputs = run_dllpll(work, truths, cap, dev)
    torch.cuda.synchronize()
    wall_total = time.perf_counter() - t0
    launches = lagbank.lag_bank_kernel.launches
    tracked_seconds = N_SECONDS - 1  # second 0 acquires, seconds 1.. track
    n_chan = 2 * N_PER_INPUT
    walls = times["bank"]
    # steady tracking: seconds 2.. (second 1 is every channel's code lock)
    e2e_steady = float(np.median(e2e_walls[2:]))
    log(f"dllpll: {N_SECONDS} s of {n_chan} channels in {wall_total:.3f} s wall; "
        f"end-to-end wall per second (read, pack, upload, bank, rows) {e2e_walls}")
    for name, ts in times.items():
        log(f"  layer {name}: wall per call {ts}")
    log(f"end to end: {n_chan / e2e_steady:.1f} tracked channel-seconds per "
        f"wall second (median of seconds 2-{N_SECONDS - 1}: {e2e_steady:.4f} s "
        f"per second; real time is {n_chan})")

    # -- 4. truths --------------------------------------------------------
    locked, ok, worst_df, worst_gd = check_truths(reps, truths)
    log(f"second {CHECK_SECOND}: {locked} channels locked, {ok} within 0.5 Hz "
        f"and 0.25 sample (worst |df| {worst_df:.4f} Hz, worst |gd| "
        f"{worst_gd:.4f} sample)")
    if locked < 100 or ok < locked:
        raise RuntimeError(f"truth check failed: locked {locked}, ok {ok}")
    if launches <= 0:
        raise RuntimeError("the lag-bank kernel never launched on the main path")
    per_sec = launches / tracked_seconds
    if "code lock" not in rxlog:
        raise RuntimeError("no channel reached code lock")
    log(f"lag-bank launches on the main path: {launches} "
        f"({per_sec:g} per tracked second)")

    # -- 5. kernel vs plain on the main path's inputs ----------------------
    lagbank.lag_bank_kernel.launches = 0  # the checks below are not the main path
    (abs_err, pow_err, ph_err), kern64, plain64, w_mat = check_kernel(lb_inputs)
    obs, wav_ext = lb_inputs["obs"], lb_inputs["wav_ext"]
    nlag, scale = lb_inputs["nlag"], lb_inputs["power_scale"]
    G, _, P, nobs = obs.shape
    nl = 2 * nlag + 1

    # -- 6. timing and bound ------------------------------------------------
    obs2 = obs.reshape(G, 2 * P, nobs)
    ms = cuda_ms(lambda: lagbank.lag_bank_windows(obs, wav_ext, nlag, scale), 20)
    plain_ms = cuda_ms(lambda: lagbank.lag_bank_windows_plain(obs, wav_ext, nlag, scale), 5)
    library_ms = cuda_ms(lambda: torch.matmul(obs2, w_mat), 10)
    ms2 = cuda_ms(lambda: lagbank.lag_bank_windows(obs, wav_ext, nlag, scale), 20)
    # the function's operations (57 lags, not the kernel's 64) and bytes:
    # obs and the replica read once, four outputs written once
    flops = 2.0 * 2 * G * P * nl * nobs
    nbytes = 4.0 * (obs.numel() + wav_ext.numel() + 4 * G * P * nl)
    bound_bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    bound_tf32x3_ms = 1e3 * 3 * flops / PEAK_TF32_FLOPS
    bound_fp32_ms = 1e3 * flops / PEAK_FP32_FLOPS
    bound_ms = max(bound_bytes_ms, bound_tf32x3_ms)
    bound_by = "operations" if bound_tf32x3_ms >= bound_bytes_ms else "bytes"
    kernel_ms = min(ms, ms2)
    log(f"lagbank per group of {G}: kernel {ms:.4f} / {ms2:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul "
        f"{library_ms:.4f} ms; bounds: bytes {bound_bytes_ms:.4f} ms "
        f"({nbytes:.3e} B), 3xTF32 {bound_tf32x3_ms:.4f} ms, fp32 FMA "
        f"{bound_fp32_ms:.4f} ms ({flops:.3e} FLOP); "
        f"{flops / kernel_ms / 1e9:.2f} TFLOP/s of the function, "
        f"{nbytes / kernel_ms / 1e6:.1f} GB/s")
    short_ms = {}
    for k in (257, 2000):
        o = obs[..., :k].contiguous()
        w = wav_ext[:, : k + 2 * nlag].contiguous()
        short_ms[k] = cuda_ms(lambda: lagbank.lag_bank_windows(o, w, nlag, scale), 50)
    log(f"lagbank per group of {G} at K = 257: {short_ms[257]:.4f} ms, "
        f"K = 2000: {short_ms[2000]:.4f} ms")
    groups = math.ceil(n_chan / G)
    log(f"per tracked second of {n_chan} channels: {groups} launches, kernel "
        f"{groups * kernel_ms:.3f} ms, bound {groups * bound_ms:.3f} ms; bank "
        f"wall per tracked second (median of seconds 2-{N_SECONDS - 1}) "
        f"{float(np.median(walls[2:])):.4f} s")
    del obs, obs2, w_mat, wav_ext, lb_inputs
    os.remove(cap)

    # -- 16-20. the host-sequential receiver (dllpll --host --serve) -------
    t0 = time.perf_counter()
    host = host_phase(work, dev, args.seed, taps)
    log(f"host phase: {time.perf_counter() - t0:.1f} s")

    # -- 7-10. the GoRanging slice -----------------------------------------
    t0 = time.perf_counter()
    (gr_cap, gr_code, gr_truth), gr = goranging_phase(work, dev, args.seed)
    log(f"goranging phase: {time.perf_counter() - t0:.1f} s")

    # -- 21-24. monitor --serve on a growing copy, goranging --profile ------
    t0 = time.perf_counter()
    mon = monitor_phase(work, gr_cap, gr_code, gr_truth, dev)
    prof = profile_phase(work, gr_cap, gr_code, dev)
    for f in (gr_cap, gr_code):
        os.remove(f)
    log(f"monitor and profile phases: {time.perf_counter() - t0:.1f} s")

    # -- 11-15. the claudio chain and the two-way products ------------------
    t0 = time.perf_counter()
    tw = twoway_phase(work, dev, args.seed, next(t for t in taps if t != 9))
    log(f"two-way phase: {time.perf_counter() - t0:.1f} s")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"goranging": gr}))
    log(json.dumps({"twoway": tw}))
    log(json.dumps({"host": host["host"]}))
    log(json.dumps({"monitor": mon, "profile": prof}))
    log(json.dumps({"kernels": [{
        "name": "lagbank",
        "route": "cuda",
        "source": "amaranth_twstft_tpu_torch/csrc/lagbank.cu",
        "replaces": "amaranth_twstft_tpu/ops/lagbank.py:96",
        "launches": launches,
        "max_abs_err": abs_err,
        "max_err_over_row_max": pow_err,
        "max_phase_err_cycles": ph_err,
        "f64_err": kern64[0],
        "f64_phase_err_cycles": kern64[1],
        "plain_f64_err": plain64[0],
        "plain_f64_phase_err_cycles": plain64[1],
        "deterministic": True,
        "ms": kernel_ms,
        "ms_k257": short_ms[257],
        "ms_k2000": short_ms[2000],
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        **host["kernel"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
