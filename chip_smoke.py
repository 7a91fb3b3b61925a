#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``amaranth_twstft_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It drives the port's DLL/PLL slice — ``twstft-torch dllpll`` through the
banked receiver — at production geometry and fails (non-zero exit, no
result line) on any error:

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

It prints the card's name and power limit (``nvidia-smi``), one
``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Scratch files go to the git-ignored ``amaranth_twstft_tpu_torch/build/``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import subprocess
import sys
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


def synthesize(dev, seed: int, taps: list[int], path: str) -> dict:
    """Write the two-input capture; return the injected truths."""
    from amaranth_twstft_tpu_torch.ops.lfsr import prn_chips_batch

    nobs = CODE_LEN * int(FS // CHIP_RATE)
    rng = np.random.default_rng(seed)
    chips = prn_chips_batch(BIT_LEN, np.asarray(taps, np.uint64), CODE_LEN)
    fs = int(FS)
    n_total = N_SECONDS * fs + nobs
    truths = {}
    gen = torch.Generator(device=dev).manual_seed(seed)
    k = torch.fft.fftfreq(nobs, device=dev, dtype=torch.float64)
    t = torch.arange(fs, device=dev, dtype=torch.float64)
    frame = np.empty((n_total, 4), np.int16)
    for inp, phys in enumerate("AB"):
        rows = list(range(inp * N_PER_INPUT, (inp + 1) * N_PER_INPUT))
        # Dopplers on a 100 Hz grid (distinct per input, so the squaring
        # lines at 2f stay apart) plus a common fractional offset
        dops = (rng.choice(np.arange(-3000.0, 3001.0, 100.0), N_PER_INPUT,
                           replace=False)
                + rng.uniform(-20.0, 20.0, N_PER_INPUT))
        # whole-sample delays plus a fraction within +-MAX_FRAC: at 2
        # samples per chip the HRC discriminator (rxcomplex.cpp:649-659,
        # kept as the JAX package has it) overshoots the fraction more and
        # more as it nears one half: within a quarter sample at 0.3,
        # beyond it at 0.45
        # (tests/test_torch_tracker.py::test_fractional_delay_matches_jax)
        delays = (rng.integers(0, nobs, N_PER_INPUT)
                  + rng.uniform(-MAX_FRAC, MAX_FRAC, N_PER_INPUT)) % nobs
        phases = rng.uniform(0.0, 1.0, N_PER_INPUT)
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
            for j in range(N_PER_INPUT):
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

    param = os.path.join(work, "sdr.param")
    kcps = CHIP_RATE / 1e3
    chans = sorted(truths, key=lambda k: k[1])
    with open(param, "w") as f:
        f.write("# ch sic prn fc kcps flt frange fstep snr\n")
        for phys, prn in chans:
            f.write(f"{phys} N {prn} 0 {kcps:g} {kcps:g} 4000 100 7\n")
    taps_map = ",".join(f"{prn}={truths[(phys, prn)][2]}" for phys, prn in chans)
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
    reports: dict = {}
    for line in stdout.getvalue().splitlines():
        f = line.split()
        reports[(int(f[0]), f[1], int(f[2][3:]))] = (float(f[3]), int(f[5]), float(f[6]))
    with open(os.path.join(out_dir, "rxcomplex.log")) as f:
        rxlog = f.read()
    return reports, times, e2e_walls, rxlog, last_lag_bank


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


def check_truths(reports: dict, truths: dict) -> tuple[int, int, float, float]:
    nobs = CODE_LEN * int(FS // CHIP_RATE)
    ns_per_sample = 1e9 / FS
    period_ns = nobs * ns_per_sample
    locked = ok = 0
    worst_df = worst_gd = 0.0
    for (phys, prn), (dop, delay, _) in truths.items():
        rep = reports.get((CHECK_SECOND, phys, prn))
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

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
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
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
