#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``amaranth_twstft_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py
    python3 chip_smoke.py --explicit-times TREE   # only the explicit lag-bank form's times

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
    first capture (no hunt skip), on the resident path and on the
    per-call ``transfer="f32"`` path: df and ``moved`` identical, delays
    within 1e-4 sample;
13. prints each file's end-to-end claudio IQ MS/s (cold or warm cache),
    its layer times and, over one traced warm file, the card's busy
    share;
14. times the block step's functions at production shapes, then runs the
    per-call ``transfer="f32"`` path on the last capture (LTFB's remote):
    every block's df within 0.5 Hz, a non-empty ``moved``, the median
    delay within 0.01 sample of the folded truth, and against the
    resident int8 run of the verb df and ``moved`` identical and delays
    within 1e-3 sample (the resident path reads int8 samples: the CPU
    tests' resident-vs-float bound; the f32 path against the CPU is held
    to 1e-4 in step 12); prints its IQ MS/s beside the resident run's;
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
    for the card, and device time and CUDA kernels per call from
    ``torch.profiler``, a device time only when the trace holds a whole
    number of kernels per call), its plain version and ``torch.matmul`` of
    the same product (CUDA events and device time), and the form at
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

The native host library and the last modules (after the bank's build,
and after the GoRanging slice on its capture):

N1. builds ``native/*.cpp`` with ``g++`` ahead of every timed phase
    (printing its seconds and flags); on the GoRanging capture (800 MB)
    holds ``native.quantize_q8`` (exact and power-of-2 scale) against the
    plain torch quantizer (bytes and scale equal) and ``native.read_raw16``
    against the memmap copy (bytes equal), and prints each path's MB/s,
    the thread count and ``os.cpu_count()``;
N2. runs ``goranging --fast --parity-ns 0.1`` (the native int8 reader,
    which N1 holds to the plain quantizer): each channel's median delay
    within 0.01 sample of the truth; prints its and the int16 runs'
    reader times and, after the two-way phase, claudio's ``read_s`` (its raw
    blocks come through the native library); ``prn --search 120`` at 17
    bits equals the plain NumPy search (both timed);
M.  holds ``ops/mxufft`` ``fft_factored`` and ``ifft_factored`` at
    (50, 200 000) and (1, 10^7) complex64 within 5e-5 of the maximum of
    the float64 ``torch.fft`` truth, and times them and ``torch.fft`` at
    the same shape with CUDA events;
S.  runs the correlator studies at production geometry on the card
    (``f16_ingest_error_study()`` with its percentile table,
    ``timing_interpolation_study`` on the 100 000-chip 17-bit code,
    ``qpsk_vs_bpsk_study(SignalConfig())``, ``code_length_study`` over
    the seven campaign codes up to 2.5 Mchip, ``gotracking_slope_study()``),
    prints each one's wall time and peak device memory and asserts the
    conclusion its JAX test asserts.

The paths no earlier phase ran on the card (after the sharded phase, on
the GoRanging capture; after the two-way phase, on its OP captures):

R1. runs ``ranging`` in-process on the GoRanging capture (godual's card
    branch: the bound step with the per-epoch masked df, its calls
    counted by a wrapper of ``boundary.make_ranging_step``), checks each
    channel's median delay within 0.01 sample of the truth, every epoch's
    df within 1 Hz of the squaring bin's label nearest twice the truth
    (the coarse estimate's resolution is 12.5 Hz), the Octave-convention
    ``.mat`` fields, and prints the wall and IQ MS/s;
R2. runs ``ranging --remote`` on a copy of the capture's first 4 s whose
    channel 1 is moved by 50 kHz into LTFB's remote window: one channel,
    the ``remote`` prefix, the same truth checks;
R3. runs ``godual.process_file`` with ``fine_freq=True``: every epoch's
    df within 1 Hz of the truth;
R4. holds each run's first 25 epochs per channel against the same bound
    step on the CPU (indice identical, correction within 1e-4 sample, snr
    within 1e-3 of the total, df within 0.05 Hz) and against the CPU's
    host branch on a prefix (delays within 0.01 sample);
B1. runs ``batch --chain goranging`` and ``--chain godual`` over a
    directory each holding a 4-s ``1*.bin`` copy of the GoRanging capture
    and a ``2*.bin`` one the glob does not pick: one capture processed,
    none skipped or failed, its gunzipped ``.mat`` equal field for field
    to the single-file verb's (``goranging``, ``ranging``) on a copy, the
    input moved to ``donetw/``, and a second run with nothing to do;
B2. the same with ``--chain claudio`` over OP's two 34-s captures, the
    loopback moved by 50 kHz into claudio's ranging window (the archive
    against the truth as in step 11); the capture put back is skipped;
B3. calls ``pipeline.process_directory`` on OP's remote capture with
    ``pattern``, ``ranging=False``, ``gzip_outputs=False``,
    ``move_done=False`` and ``transfer="int8"``: nothing gzipped or
    moved, the archive equal to the ``claudio`` verb's from step 11;
P1. writes the JAX package's on-chip parity capture (50 fractional-delay
    epochs at production geometry, ``tests_tpu/test_device_parity.py``'s
    arithmetic) and runs ``process_capture_overlapped`` with float16,
    int8, int8 under ``TWSTFT_Q8_POW2=1`` and sc16 ingest: each run's
    delays against a float64 oracle (the port's complex128 correlator on
    the CPU) at p99 under 8 / 36 / 54 / 8 ps, printing p50, p99 and max;
P2. runs ``make_ranging_step(nint=4, packed=True)`` at the fractions
    0.1-0.83 with df 0: the largest error under 60 ps;
P3. runs the df pre-pass (``per_file_df_ri``) on the parity capture's
    decimated channel 1 packed as float32, int8 and int16
    (``pipeline._pack_prepass``): int8 within two squaring bins + 1e-6 Hz
    of float32, int16 within 1e-6 Hz.

The DLL/PLL receiver's modes (after the bank on the mesh, on the main
capture and on captures of their own; 4 s each, checked at second 3
within 0.5 Hz and a quarter sample of the truths; "against the CPU" is
step 18's check over the CPU's first 3 s, the first with reports: the
same rows, ``cnt`` identical, fc within 1e-3 Hz, gd within 0.01 ns, the
CPU's ``rxcomplex.log`` lines the card's first lines):

D1. runs the main path's 120 channels through ``run_stream`` with
    ``transfer`` int8, int4, int2 and f32: every channel on its truth;
    int4 and int2 also with the prefetch off (the same bits: reports,
    log, states); prints each format's bytes uploaded per second, tracked
    channel-s/s and worst errors;
D2. writes an ``sdr.param`` with ``S`` rows over a capture of 8
    channels (per input two at amplitude 1000 and, on the ``S`` rows, two
    at 110; noise 300): ``dllpll`` with every channel on its truth and each
    SIC channel's code lock (PRN id + 50) in ``rxcomplex.log``, against the
    CPU; then the same rows marked ``N`` (recorded, not gated);
D3. ``dllpll --real`` on 8 channels whose real samples sit on the I
    columns, on a carrier at fs/5: the truths, against the CPU;
D4. an ``sdr.param`` with 2500 and 1000 kcps rows (L = 200 000 and
    500 000; 8 channels each): two geometry groups, rows in ``sdr.param``'s
    order, the truths, against the CPU; the window-form kernel at the
    1000-kcps launch shape against its plain version (``check_kernel``)
    and timed beside its bytes floor;
D5. ``dllpll --follow --idle-timeout 2`` on a file a writer thread grows
    from the main capture one second per second: the printed rows and
    log equal those of a run on the finished file; prints each second's
    lag from its append to its reports;
D6. ``reload_params`` after second 2 on a fresh int8 receiver, changing
    one row's fc and another's SNR gate: it returns those rows, the other
    channels' states after second 3 equal D1's int8 run bit for bit, and
    the changed rows re-acquire and report on their truths at second 5.

The modes walk, phase W: the device options no earlier phase passed, at
production widths (5 MS/s, 100 000-chip codes, 120 bank channels), cut
in depth to W_SECONDS = 4 s unless stated; each run's kernel launch
counts set to 0 just before it and checked just after:

W1. ``dllpll --nlag 32`` and ``--nlag 100`` on the main capture (NL 65
    and 201: two and four 64-lag blocks of the window form), every
    channel on its truth at second 3 and its rows against the main path's
    nlag-28 rows within step 18's tolerance (equality recorded);
    ``dllpll --host --nlag 32, 100, 201`` on the host capture, 3 s each
    (NL 403: the explicit form stages each span's lag windows): one
    explicit-form launch per tracked channel-second, the truths at second
    2, the NL-403 run against the CPU over 3 s (the first second with
    reports).  Both forms at NL 65, 201 and 403 against their plain
    versions and float64 (within 1e-5 of the row maximum), timed beside
    their bounds and ``torch.matmul``; the explicit form's two launches
    the same bits, with step 20's numbers (device, call and host times,
    kernels per call, ``torch.matmul`` device and call times) measured by
    ``explicit_times`` in a fresh process (``--explicit-times``: a trace
    in this long-lived process can come back short of its device events)
    on seeded inputs of the same shapes;
    ``lag_bank_correlate_channels`` at NL 403 one launch with each
    channel's bits, timed there beside its per-channel calls, their plain
    versions and one batched ``torch.matmul``;
W2. ``dllpll --group 1, 7, 120``: 120, 18 and 1 window-form launches per
    tracked second, the truths, the rows against the main path's;
W3. ``goranging --f64`` (the plain chain in complex128 on the card) and
    ``ranging --f64 --op -v`` on the GoRanging capture's first 4 s: each
    channel's median delay within 0.01 sample and df within 1 Hz of its
    truth (godual's coarse df of its bin label), and on a 1-s prefix card
    and CPU within 1e-6 sample; ``goranging --fast --f64`` prints its
    float32-ingest warning and meets the truths;
W4. ``goranging --remote --foffset 20000 --nint 2``, plain and ``--fast``,
    on a copy whose channel 1 is moved 20 kHz: on the moved truth, plain
    and ``--fast`` epoch for epoch (indice identical, delays within 1e-4
    sample), plain card against CPU on a 1-s prefix; ``goranging --nint 2
    --fast`` on the truths and against the CPU;
W5. ``batch --remote`` over phase B's moved OP loopback and OP's remote
    capture: the default station picks ``*_2.bin``, its ``remoteclaudio``
    archive equals ``claudio.process_file(remote=True, ranging=True)`` (the
    chain ``batch`` runs; the ``claudio --remote`` verb searches the remote
    window instead, recorded) and lies on the truth;
W6. ``monitor --channels 1 --epochs 50 --serve --serve-host 127.0.0.1`` on
    that loopback grown one second per second (4 s), with ``monitor
    --connect`` consumers in subprocesses (rows; ``--plot --plot-file``
    when matplotlib imports): a row per epoch, the consumer's rows equal,
    the median delay within 0.01 sample, ``monitor --once`` on the
    finished file the same rows;
W7. 1000 kcps (L = 500 000): a 4-s dual-channel capture through
    ``goranging --fast`` and ``ranging`` (truths; card against CPU on a
    1-s prefix) and a 34-s single-channel one through ``claudio`` and
    ``batch`` (the verb's production 30-s hunt skip: an 8-s file would be
    "not found"; truths, the batch archive equal to the verb's, card
    against CPU on a 4-s prefix); ``claudio --fs 1e7`` (L = 400 000, a
    2e7-bin hunt past ``torch.nanquantile``'s 2^24 limit) on a 34-s
    capture (truths; the hunt's first block card against CPU); an 18-bit
    code through ``goranging --fast``.

It prints the card's name and power limit (``nvidia-smi``), a line of
numbers per slice (``{"ranging": ...}``, ``{"batch": ...}``,
``{"parity": ...}``, ``{"dllpll_modes": ...}`` and ``{"walk": ...}``
among them), one ``{"kernels": [...]}`` line (the window form's entry,
with phase D's launches and phase W's launches and shapes among them, and
the explicit form's entry, ``lagbank_explicit``, with step 20's numbers
and, under ``shapes``, those of every explicit-form launch shape, and the
device pack's entry, ``pack``: its launches on the main path, one a second,
and ``--pack-times``' check and times), and as its last line
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
from typing import NamedTuple

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
TW_CPU_DELAY_TOL = 1e-4  # samples, card vs CPU on the same path
# samples: the resident int8 path against a float path on the same capture
# (tests/test_torch_claudio.py's bound for resident int8 vs complex128): the
# two read other samples, since int8 adds ~1.4e-4 of the noise power
TW_RESIDENT_DELAY_TOL = 1e-3
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
# phase R: the ranging verb (godual's card branch) on the GoRanging capture
RG_CPU_EPOCHS = 25  # each channel's first epochs: the card against the CPU
RG_REMOTE_SECONDS = 4  # the remote run's copy of the capture
RG_REMOTE_SHIFT_HZ = 50e3  # channel 1 into LTFB's remote window, 40-60 kHz
# phase B: the batch verb over its three chains
B_PREFIX_SECONDS = 4  # the dual-channel directories' copy of the capture
B_RANGING_SHIFT_HZ = 50e3  # OP's loopback into claudio's ranging window
# phase P: the JAX package's on-chip parity checks
# (tests_tpu/test_device_parity.py): 50 epochs of a fractional-delay
# capture, each ingest form's delays against a float64 oracle (p99, ps),
# and the nint = 4 step at adversarial fractions (largest error, ps)
P_EPOCHS = 50
P_BATCH = 125  # the JAX suite's batch: one zero-padded batch
P99_BOUND_PS = {"float16": 8.0, "int8": 36.0, "int8-pow2": 54.0, "sc16": 8.0}
NINT4_FRACS = (0.1, 0.25, 0.37, 0.5, 0.62, 0.83)
NINT4_BOUND_PS = 60.0
# the staged matmul FFT's shapes (a GoRanging batch of 50 codes, one 2-s
# claudio block) and the CUDA-event repetitions of each
MX_SHAPES = (((50, 200_000), 10), ((1, 10**7), 5))
# phase D: the DLL/PLL receiver's modes at production geometry
D_SECONDS = 4  # each mode's run (second 3 checked against the truths)
D_CPU_SECONDS = 3  # the CPU's run: second 2 is the first with reports
D_TRANSFERS = ("int8", "int4", "int2", "f32")  # the main path gives f16's
D_RELOAD_ROWS = (5, 77)  # D6: fc changed, SNR gate changed
# D2-D4 synthesize 8 or 16 channels with Dopplers within +-620 Hz and
# acquire over +-800 Hz (fewer CAF hypotheses for the CPU's run)
D_DOP_SPAN = 600.0
D_FRANGE = 800.0
D_CARRIER_HZ = FS / 5  # D3's real-sample carrier
D_SLOW_CHIP_RATE = 1e6  # D4's second geometry: L = 500 000, 10 codes per second
# phase W: the device options no earlier phase passed (ROADMAP's modes walk)
W_SECONDS = 4  # each run's depth (the truths at second 3), unless stated
W_NLAGS = (32, 100)  # dllpll --nlag on the bank: NL 65 and 201
W_GROUPS = (1, 7, 120)  # dllpll --group: 120, 18 and 1 launches per second
W_KERNEL_NLAG = 201  # the window form also at NL 403, on the NL-201 run's obs
W_HOST_NLAGS = (32, 100, 201)  # dllpll --host --nlag: NL 65, 201 and 403
W_HOST_SECONDS = 3  # the host receiver reports first at second 2
W_F64_TOL = 1e-5  # lag-bank kernel against float64, of the row maximum
W_F64_DELAY_TOL = 1e-6  # samples: the complex128 chains, card against CPU
W_FOFFSET_HZ = 20e3  # W4: channel 1 moved into the pre-pass window at --foffset
W_NINT = 2  # W4: a grid of 5 points per sample
W_MON_SECONDS = 4  # W6: seconds appended to the tailed file, one per second
W_MON_EPOCHS = 50  # W6: two 1-s appends per batch
W_SLOW_CHIP_RATE = 1e6  # W7: L = 500 000, 10 codes per second
W_FAST_FS = 1e7  # W7: 4 samples per chip, L = 400 000, a 2e7-bin claudio hunt
W_OTHER_BITLEN = 18  # W7: an 18-bit m-sequence (period 262 143 > 100 000 chips)


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


def host_ms(fn, reps: int = 20) -> float:
    """Host time of a call, ms: the wall of ``reps`` calls that do not
    wait for the card (it stops measuring the host once the launch queue
    fills, which takes far more calls than this)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * wall / reps


class Truth(NamedTuple):
    """One injected emission: Doppler (Hz, a real-mode carrier included),
    code delay (samples), its m-sequence taps, chip rate, and whether its
    ``sdr.param`` row is a SIC row."""

    dop: float
    delay: float
    taps: int
    chip_rate: float = CHIP_RATE
    sic: bool = False


class Emissions(NamedTuple):
    """A group of emissions per input: count, chip rate, amplitude (int16
    units) and whether their rows are SIC rows."""

    n_per_input: int
    chip_rate: float = CHIP_RATE
    amplitude: float = AMPLITUDE
    sic: bool = False


def code_samples(chip_rate: float) -> int:
    return CODE_LEN * int(FS // chip_rate)


def synthesize(dev, seed: int, taps: list[int], path: str,
               n_per_input: int = N_PER_INPUT, n_seconds: int = N_SECONDS,
               dop_grid: float = 100.0, groups: list[Emissions] | None = None,
               dop_span: float = 3000.0, carrier_hz: float = 0.0,
               real: bool = False) -> dict:
    """Write the two-input capture (``n_per_input`` emissions per input, or
    ``groups`` of them, ``n_seconds`` plus one code, Dopplers on a
    ``dop_grid``-Hz grid within +-``dop_span``, distinct per input, plus a
    fractional offset within +-20 Hz, and ``carrier_hz`` above it); with
    ``real`` the I columns carry the real signal plus noise and the Q
    columns zeros.  Returns the injected truths."""
    from amaranth_twstft_tpu_torch.ops.lfsr import prn_chips_batch

    groups = groups or [Emissions(n_per_input)]
    n_in = sum(g.n_per_input for g in groups)
    rng = np.random.default_rng(seed)
    chips = prn_chips_batch(BIT_LEN, np.asarray(taps[: 2 * n_in], np.uint64), CODE_LEN)
    fs = int(FS)
    n_total = n_seconds * fs + max(code_samples(g.chip_rate) for g in groups)
    truths = {}
    gen = torch.Generator(device=dev).manual_seed(seed)
    t = torch.arange(fs, device=dev, dtype=torch.float64)
    frame = np.empty((n_total, 4), np.int16)
    for inp, phys in enumerate("AB"):
        em = [g for g in groups for _ in range(g.n_per_input)]
        nobs = np.array([code_samples(g.chip_rate) for g in em])
        # Dopplers on a grid (distinct per input, so the squaring lines at
        # 2f stay apart) plus a fractional offset
        dops = (rng.choice(np.arange(-dop_span, dop_span + 1.0, dop_grid), n_in,
                           replace=False)
                + rng.uniform(-20.0, 20.0, n_in))
        # whole-sample delays plus a fraction within +-MAX_FRAC: at 2
        # samples per chip the HRC discriminator (rxcomplex.cpp:649-659,
        # kept as the JAX package has it) overshoots the fraction more and
        # more as it nears one half: within a quarter sample at 0.3,
        # beyond it at 0.45
        # (tests/test_torch_tracker.py::test_fractional_delay_matches_jax)
        whole = (rng.integers(0, nobs[0], n_in) if (nobs == nobs[0]).all()
                 else rng.integers(0, nobs))
        delays = (whole + rng.uniform(-MAX_FRAC, MAX_FRAC, n_in)) % nobs
        phases = rng.uniform(0.0, 1.0, n_in)
        sig = torch.zeros(n_total, dtype=torch.complex128, device=dev)
        j0 = 0
        for g in groups:
            js = range(j0, j0 + g.n_per_input)
            rows = [inp * n_in + j for j in js]
            L = code_samples(g.chip_rate)
            k = torch.fft.fftfreq(L, device=dev, dtype=torch.float64)
            code = torch.from_numpy(
                np.repeat(chips[rows].astype(np.float64) * 2 - 1, L // CODE_LEN, axis=1)
            ).to(dev)
            ramp = torch.exp(-2j * math.pi * k[None, :]
                             * torch.from_numpy(delays[list(js)]).to(dev)[:, None])
            wave = torch.fft.ifft(torch.fft.fft(code, dim=-1) * ramp, dim=-1)
            for s0 in range(0, n_total, fs):
                n = min(fs, n_total - s0)
                tt = t[:n] + s0
                idx = torch.remainder(tt.long(), L)
                for w, j in enumerate(js):
                    ph = torch.remainder((carrier_hz + dops[j]) * tt / FS + phases[j], 1.0)
                    sig[s0 : s0 + n] += (g.amplitude * wave[w, idx]
                                         * torch.exp(2j * math.pi * ph))
            for j, r in zip(js, rows):
                truths[(phys, 100 + r)] = Truth(float(carrier_hz + dops[j]),
                                                float(delays[j]), taps[r],
                                                g.chip_rate, g.sic)
            j0 += g.n_per_input
            del wave, code, ramp
        noise = torch.randn(2, n_total, generator=gen, device=dev,
                            dtype=torch.float64) * NOISE_SIGMA
        iq = torch.stack([sig.real + noise[0],
                          torch.zeros_like(sig.real) if real else sig.imag + noise[1]],
                         dim=-1)
        iq = torch.clamp(torch.round(iq), -32768, 32767).to(torch.int16)
        frame[:, 2 * inp : 2 * inp + 2] = iq.cpu().numpy()
        del sig, noise, iq
    frame.tofile(path)
    return truths


def write_param(param: str, truths: dict, fc_hz: float = 0.0, frange: float = 4000.0,
                sic: bool = True) -> tuple[str, str]:
    """The ``sdr.param`` of every emission of ``truths`` (acquisition over
    +-``frange`` Hz from ``fc_hz`` in 100 Hz steps, 7 dB gate; with
    ``sic``, the truths' SIC rows as ``S``) and the ``--taps-map`` that
    gives each PRN its code."""
    chans = sorted(truths, key=lambda k: k[1])
    with open(param, "w") as f:
        f.write("# ch sic prn fc kcps flt frange fstep snr\n")
        for phys, prn in chans:
            t = truths[(phys, prn)]
            kcps = t.chip_rate / 1e3
            f.write(f"{phys} {'S' if sic and t.sic else 'N'} {prn} {fc_hz:.1f} "
                    f"{kcps:g} {kcps:g} {frange:g} 100 7\n")
    return param, ",".join(f"{prn}={truths[(phys, prn)].taps}" for phys, prn in chans)


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


@contextlib.contextmanager
def counted_steps(sink: list):
    """Wrap ``boundary.make_ranging_step`` so that every step it binds
    appends each call's host wall time to ``sink`` (its length is the
    step's call count), as ``timing_hooks`` wraps a callable; the
    original is restored on exit."""
    from amaranth_twstft_tpu_torch.ops import boundary

    orig = boundary.make_ranging_step

    def make(*a, **kw):
        step = orig(*a, **kw)

        def counted(*sa, **skw):
            t0 = time.perf_counter()
            try:
                return step(*sa, **skw)
            finally:
                sink.append(time.perf_counter() - t0)

        return counted

    boundary.make_ranging_step = make
    try:
        yield
    finally:
        boundary.make_ranging_step = orig


def run_verb(argv: list[str], err: list | None = None) -> tuple[str, float]:
    """A ``twstft-torch`` verb in-process; raises unless it exits 0.
    Returns its standard output and wall time; appends its standard
    error to ``err`` when given."""
    from amaranth_twstft_tpu_torch import cli

    stdout, stderr = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{' '.join(argv)} exited {rc}")
    if err is not None:
        err.append(stderr.getvalue())
    return stdout.getvalue(), wall


def kept_verb(module, name: str, argv: list[str], err: list | None = None):
    """:func:`run_verb` with ``module.name`` wrapped to keep what the
    verb's call of it returns.  Returns that result, the verb's standard
    output and its wall time."""
    kept: dict = {}
    orig = getattr(module, name)

    def keep(*a, **kw):
        kept["out"] = orig(*a, **kw)
        return kept["out"]

    setattr(module, name, keep)
    try:
        text, wall = run_verb(argv, err)
    finally:
        setattr(module, name, orig)
    return kept["out"], text, wall


def run_dllpll(work: str, truths: dict, cap: str, dev, kept_reports=None):
    """The main path: the dllpll CLI, in-process.  Records, per second,
    the wall time between two seconds' reports of ``run_stream`` (end to
    end: read, pack, upload, bank, report rows) and the wall times of the
    layers under it (``times``: sc16 read, host pack, pack + upload start,
    the bank's ``process_second``, and its device steps); appends each
    second's reports as tuples to ``kept_reports`` when given."""
    from amaranth_twstft_tpu_torch.models import tracker
    from amaranth_twstft_tpu_torch.utils import io as sc16

    times = {k: [] for k in ("read", "pack", "upload", "bank", "track_step",
                             "acquire_step")}
    e2e_walls: list[float] = []
    orig_stream = tracker.BankedReceiver.run_stream

    def timed_stream(self, *a, **kw):
        t_prev = time.perf_counter()
        for reports in orig_stream(self, *a, **kw):
            t = time.perf_counter()
            e2e_walls.append(t - t_prev)
            if kept_reports is not None:
                kept_reports.append([r and dataclasses.astuple(r) for r in reports])
            t_prev = time.perf_counter()
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
    rx_cls.run_stream = timed_stream
    tracker.lag_bank_windows = keep_inputs
    try:
        with timing_hooks(hooks):
            run = dllpll_verb(work, "sdr", cap, truths, dev)
    finally:
        rx_cls.run_stream = orig_stream
        tracker.lag_bank_windows = orig_lag_bank
    return run["rows"], times, e2e_walls, "\n".join(run["log"]), last_lag_bank


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
    """At ``second``: how many channels report, how many of them within 0.5
    Hz and a quarter sample of their truths, and the worst errors (Hz,
    samples)."""
    ns_per_sample = 1e9 / FS
    locked = ok = 0
    worst_df = worst_gd = 0.0
    for (phys, prn), truth in truths.items():
        rep = reports.get((second, phys, prn))
        if rep is None:
            continue
        locked += 1
        fc, _, gd = rep
        dop = truth.dop
        period_ns = code_samples(truth.chip_rate) * ns_per_sample
        err = (gd - truth.delay * ns_per_sample) % period_ns
        err = min(err, period_ns - err)
        worst_df = max(worst_df, abs(fc - dop))
        worst_gd = max(worst_gd, err / ns_per_sample)
        if abs(fc - dop) < 0.5 and err < 0.25 * ns_per_sample:
            ok += 1
    return locked, ok, worst_df, worst_gd


def synthesize_ranging(dev, seed: int, code_path: str, path: str,
                       seconds: int = GR_SECONDS, chip_rate: float = CHIP_RATE) -> dict:
    """Write the GoRanging capture: channel c carries the code delayed by
    ``delays[c]`` samples (circularly, by an FFT phase ramp, as
    ``models/emitter`` does), at ``dopplers[c]`` Hz, plus noise; built on
    the card one second at a time.  Returns the truths."""
    from amaranth_twstft_tpu_torch.ops.lfsr import read_prn_file

    spc = int(FS // chip_rate)
    L = read_prn_file(code_path).size * spc
    rng = np.random.default_rng(seed)
    delays = rng.integers(1000, L - 1000, 2) + rng.uniform(0.05, 0.95, 2)
    dops = rng.uniform(-3000.0, 3000.0, 2)
    phases = rng.uniform(0.0, 1.0, 2)
    code = torch.from_numpy(
        np.repeat(read_prn_file(code_path).astype(np.float64) * 2 - 1, spc)).to(dev)
    k = torch.fft.fftfreq(L, device=dev, dtype=torch.float64)
    ramp = torch.exp(-2j * math.pi * k[None] * torch.from_numpy(delays).to(dev)[:, None])
    waves = torch.fft.ifft(torch.fft.fft(code)[None] * ramp, dim=-1)
    gen = torch.Generator(device=dev).manual_seed(seed)
    fs = int(FS)
    t = torch.arange(fs, device=dev, dtype=torch.float64)
    frame = torch.empty((fs, 4), dtype=torch.int16, device=dev)
    with open(path, "wb") as f:
        for s0 in range(0, seconds * fs, fs):
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


def run_goranging_cli(cap: str, code: str, out_mat: str, dev, mode: str = "--fast",
                      extra: tuple = ()):
    """The main path: ``twstft-torch goranging --fast`` (or ``mode``
    ``--sharded``) in-process, with ``extra`` arguments.  Returns the
    pipeline's output dict and the call's wall time."""
    from amaranth_twstft_tpu_torch import pipeline

    kept = {}
    name = {"--fast": "process_capture_overlapped",
            "--sharded": "process_capture_sharded"}[mode]
    orig = getattr(pipeline, name)

    def keep(*a, **kw):
        kw["out_mat"] = out_mat
        kept["out"] = orig(*a, **kw)
        return kept["out"]

    setattr(pipeline, name, keep)
    try:
        _, wall = run_verb(["goranging", cap, code, mode, "--device", str(dev),
                            "--batch-epochs", str(GR_BATCH), *extra])
    finally:
        setattr(pipeline, name, orig)
    return kept["out"], wall


def delays_samples(ch: dict, grid: int = 3) -> np.ndarray:
    """Delays in samples of a ranging result on a grid of ``grid`` = 2 nint
    + 1 points per sample."""
    return (ch["indice"].astype(np.float64) + ch["correction"]) / grid


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
        "n_epochs": len(out["ch1"]["indice"]),
        "vs_process_file_max_corr": worst_pf, "vs_cpu_max_corr": worst_cpu,
        "busy_ms": busy, "traced_wall_s": traced_wall,
        "replica_s": t_rep, "bind_s": t_bind,
        "step_ms": step_ms, "step_device_ms": step_dev_ms,
        "step_device_ops": step_ops, "parts": parts,
    }


def synthesize_single(dev, seed: int, code_path: str, delay: float,
                      doppler: float, amplitude: float, path: str, seconds: int,
                      fs: float, chip_rate: float = CHIP_RATE) -> None:
    """Write a single-channel sc16 capture: the code of ``code_path``
    delayed by ``delay`` samples (circularly, by an FFT phase ramp), at
    ``doppler`` Hz with a random phase and ``amplitude``, plus noise;
    built on the card one second at a time."""
    from amaranth_twstft_tpu_torch.ops.lfsr import read_prn_file

    chips = read_prn_file(code_path).astype(np.float64) * 2 - 1
    code = torch.from_numpy(np.repeat(chips, int(fs // chip_rate))).to(dev)
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
    from amaranth_twstft_tpu_torch.models import claudio

    argv = ["claudio", cap, code, "--remote" if ch == "_1" else "--local",
            "--device", str(dev)] + (["--op"] if site == "OP" else [])
    out, _, wall = kept_verb(claudio, "process_file", argv)
    if out is None:
        raise RuntimeError(f"claudio {cap}: already done")
    return out, wall


def tracked_delays(out: dict) -> np.ndarray:
    return out["indice"].astype(np.float64) + out["correction"] / 3.0


def twoway_phase(work: str, dev, seed: int, lt_taps: int, keep: dict | None = None) -> dict:
    """Steps 11-15; returns the numbers of the ``{"twoway": ...}`` line.
    With ``keep`` (phase B's), OP's two captures are linked into
    ``keep["dirs"][channel]`` before they are deleted, and ``keep`` gets
    their paths, the codes, the truths and the claudio verb's OP_1
    archive."""
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
            copy_prefix(cap, prefix[0], TW_PREFIX_SECONDS * int(fs), channels=1)
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
            resident = (out, delay, dop, msps)
        else:
            if keep is not None and site == "OP":
                kept = os.path.join(keep["dirs"][ch], os.path.basename(cap))
                os.link(cap, kept)
                keep[f"OP{ch}"] = kept
                if ch == "_1":
                    keep["OP_1_mat"] = out["mat_path"]
            os.remove(cap)
    if keep is not None:
        keep.update(codes={"OP": codes[9], "LTFB": codes[lt_taps]}, truths=truths)

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

    # -- 14b. the per-call transfer="f32" path on the same capture -----------
    out_f32 = os.path.join(root, "f32")
    os.makedirs(out_f32, exist_ok=True)
    res_out, delay, dop, res_msps = resident
    t0 = time.perf_counter()
    f32 = claudio.process_file(cap, code, cfg, proc, StationConfig(op=False), remote=True,
                               ranging=False, out_dir=out_f32, device=dev, transfer="f32")
    torch.cuda.synchronize()
    f32_wall = time.perf_counter() - t0
    f32_msps = sc16.n_samples_sc16(cap, channels=1) / f32_wall / 1e6
    dl = tracked_delays(f32)
    f32_d_err = float(np.median(dl) - folded_delay(delay))
    f32_df_err = float(np.abs(f32["df"] - dop).max())
    if len(dl) != len(tracked_delays(res_out)):
        raise RuntimeError(f"claudio transfer='f32': {len(dl)} codes, resident "
                           f"{len(tracked_delays(res_out))}")
    diff = dl - tracked_delays(res_out)
    f32_vs, f32_rms = float(np.abs(diff).max()), float(np.sqrt(np.mean(diff ** 2)))
    log(f"claudio transfer='f32' on LTFB_1: process_file {f32_wall:.3f} s -> "
        f"{f32_msps:.2f} IQ MS/s (the resident int8 verb run: {res_msps:.2f}); median "
        f"delay err {f32_d_err:+.5f} sample; max |df - truth| {f32_df_err:.4f} Hz; moved "
        f"{f32['moved']}; against the resident run: df identical "
        f"{np.array_equal(f32['df'], res_out['df'])}, moved identical "
        f"{f32['moved'] == res_out['moved']}, delay diff max {f32_vs:.2e} rms "
        f"{f32_rms:.2e} sample over {len(dl)} codes (bound {TW_RESIDENT_DELAY_TOL:g}: "
        f"int8 against float samples; the f32 path against the CPU is step 12's)")
    if not f32["found"] or not f32["moved"] or abs(f32_d_err) > TW_DELAY_TOL \
            or f32_df_err > TW_DF_TOL:
        raise RuntimeError("claudio transfer='f32': truth check failed")
    if not np.array_equal(f32["df"], res_out["df"]) or f32["moved"] != res_out["moved"] \
            or f32_vs > TW_RESIDENT_DELAY_TOL:
        raise RuntimeError("claudio transfer='f32' differs from the resident run")
    os.remove(cap)

    # -- 12. the card against the CPU on a 4-s prefix, both paths ------------
    pre_proc = ProcessingConfig(conjugate_data=True, skip_seconds=0.0)
    pre_err = {}
    for transfer in ("int8", "f32"):
        runs = {}
        for name, d in (("card", dev), ("cpu", "cpu")):
            od = os.path.join(root, f"prefix_{transfer}_{name}")
            os.makedirs(od, exist_ok=True)
            t0 = time.perf_counter()
            runs[name] = claudio.process_file(
                prefix[0], prefix[1], cfg, pre_proc, StationConfig(op=True),
                ranging=False, out_dir=od, device=d, transfer=transfer)
            log(f"4-s prefix, transfer={transfer!r}, on the {name}: "
                f"{time.perf_counter() - t0:.2f} s")
        card, cpu = runs["card"], runs["cpu"]
        pre_err[transfer] = float(np.abs(tracked_delays(card) - tracked_delays(cpu)).max())
        if not np.array_equal(card["df"], cpu["df"]) or card["moved"] != cpu["moved"] \
                or pre_err[transfer] > TW_CPU_DELAY_TOL:
            raise RuntimeError(f"claudio {transfer} card vs CPU: df {card['df'][:1]} / "
                               f"{cpu['df'][:1]}, moved {card['moved']} / {cpu['moved']}, "
                               f"delay {pre_err[transfer]}")
        log(f"claudio card vs the port on the CPU (4-s prefix, transfer={transfer!r}): "
            f"df identical, moved identical, max delay diff {pre_err[transfer]:.2e} "
            f"sample (tolerance {TW_CPU_DELAY_TOL:g})")
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
        "prefix_max_delay_diff_samples": pre_err["int8"], "go1s_wall_s": go1s_wall,
        "f32": {"wall_s": f32_wall, "iq_msps": f32_msps, "resident_iq_msps": res_msps,
                "delay_err_samples": f32_d_err, "df_err_hz": f32_df_err,
                "vs_resident_max_delay_diff": f32_vs,
                "vs_resident_rms_delay_diff": f32_rms,
                "prefix_vs_cpu_max_delay_diff": pre_err["f32"]},
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
    line, the explicit-form entries of the kernels line and the capture
    with its truths (phase W runs on it, then deletes it)."""
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
    gate = truth_gate("dllpll --host", reps, truths, last_second)
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
    t0 = time.perf_counter()
    rx_cpu = dllpll.Receiver(param_channels(param, truths), fs=FS, device="cpu")
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
    bank = dllpll_verb(work, "host_bank", cap, truths, dev)["rows"]
    worst_bank_df = worst_bank_gd = 0.0
    for (phys, prn) in truths:
        h, b = reps[(last_second, phys, prn)], bank.get((last_second, phys, prn))
        if b is None:
            raise RuntimeError(f"banked dllpll: no row for {prn}")
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
    h_ms = host_ms(lambda: lagbank.lag_bank_correlate(obs, w))
    # device time alone: a call's host time (checks, the output's
    # allocation, the ctypes call) can exceed the kernel's ~0.04 ms on the
    # card's host
    device_ms, device_ops = per_call_device(lambda: lagbank.lag_bank_correlate(obs, w))
    plain_device_ms, _ = per_call_device(lambda: lagbank.lag_bank_plain(obs, w))
    library_device_ms, _ = per_call_device(lambda: torch.matmul(obs2, w))
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
        f"{h_ms:.4f} ms; device time (profiler): "
        f"kernel {device_ms} ms in {device_ops} kernels per call, plain {plain_device_ms} ms, "
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
    del obs, obs2, w, o257, w257, kern, plain, last, d, fcode, code3
    return {
        "capture": (cap, truths),
        "host": {
            "seconds": HOST_SECONDS, "channels": len(truths), "wall_s": wall,
            "process_second_wall_s": walls, "caf_search_ms": caf_ms,
            **gate, "cpu_max_fc_diff_hz": worst_fc, "cpu_max_gd_diff_ns": worst_gd_ns,
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
            "host_ms_explicit": h_ms,
            "kernels_per_call_explicit": device_ops,
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


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def bank_on_mesh(work: str, truths: dict, cap: str, dev, mesh, ref_reports: list,
                 ref_launches: int, ref_log: str) -> dict:
    """M2: the dllpll verb's banked receiver on the 1x1 NCCL mesh (every
    BankedReceiver the verb builds gets ``mesh=``), the window-form launch
    count set to 0 just before: its reports must equal the unsharded main
    path's bit for bit, with the same log and the same launches."""
    from amaranth_twstft_tpu_torch.models import tracker
    from amaranth_twstft_tpu_torch.ops import lagbank

    mwork = os.path.join(work, "mesh")
    os.makedirs(mwork, exist_ok=True)
    kept: list = []
    orig_init = tracker.BankedReceiver.__init__

    def init_on_mesh(self, *a, **kw):
        orig_init(self, *a, mesh=mesh, **kw)

    tracker.BankedReceiver.__init__ = init_on_mesh
    lagbank.lag_bank_kernel.launches = 0
    try:
        t0 = time.perf_counter()
        _, _, e2e_walls, rxlog, lb = run_dllpll(mwork, truths, cap, dev, kept)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        tracker.BankedReceiver.__init__ = orig_init
    launches = lagbank.lag_bank_kernel.launches
    del lb
    if len(kept) != len(ref_reports):
        raise RuntimeError(f"mesh bank: {len(kept)} seconds, unsharded {len(ref_reports)}")
    for s_idx, (a, b) in enumerate(zip(kept, ref_reports)):
        if a != b:
            i = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            raise RuntimeError(f"mesh bank second {s_idx} channel {i}: {a[i]} != {b[i]}")
    if rxlog != ref_log:
        raise RuntimeError("mesh bank: rxcomplex.log differs from the unsharded bank's")
    if launches != ref_launches:
        raise RuntimeError(f"mesh bank: {launches} window-form launches, "
                           f"unsharded {ref_launches}")
    n_chan = 2 * N_PER_INPUT
    steady = float(np.median(e2e_walls[2:]))
    log(f"bank on a 1x1 NCCL mesh: {len(kept)} s of {n_chan} channels equal to the "
        f"unsharded bank bit for bit, {launches} window-form launches (the same); "
        f"wall {wall:.3f} s, {n_chan / steady:.1f} tracked channel-s/s")
    return {"bank_bit_identical": True, "bank_launches": launches,
            "bank_wall_s": wall, "bank_channel_s_per_s": n_chan / steady}


def mat_fields_equal(a: str, b: str) -> int:
    """Raise unless two .mat files hold the same arrays, field for field
    and bit for bit; return how many were compared."""
    import scipy.io as sio

    ma, mb = sio.loadmat(a), sio.loadmat(b)
    keys = sorted(k for k in mb if not k.startswith("__"))
    if keys != sorted(k for k in ma if not k.startswith("__")):
        raise RuntimeError(f"{a} and {b} hold different fields")
    for k in keys:
        if ma[k].dtype != mb[k].dtype or not np.array_equal(ma[k], mb[k]):
            raise RuntimeError(f"{a} and {b} differ in {k}")
    return len(keys)


def sharded_phase(work: str, cap: str, code: str, truth: dict, dev, mesh) -> dict:
    """M3-M6 on the GoRanging capture; returns the numbers of the
    ``{"sharded": ...}`` line."""
    from amaranth_twstft_tpu_torch.config import ProcessingConfig, SignalConfig
    from amaranth_twstft_tpu_torch.models.godual import build_replica
    from amaranth_twstft_tpu_torch.ops import lagbank
    from amaranth_twstft_tpu_torch.ops.caf import caf_peaks, doppler_bins
    from amaranth_twstft_tpu_torch.ops.correlator import correlate_epochs
    from amaranth_twstft_tpu_torch.parallel import sharded
    from amaranth_twstft_tpu_torch.utils import io as sc16

    out: dict = {"card": smi_line()}
    cfg = SignalConfig()
    L = cfg.samples_per_code
    # -- M3. goranging --sharded against --fast, in process ----------------
    runs = [run_goranging_cli(cap, code, os.path.join(work, f"sharded{i}C.mat"), dev,
                              "--sharded") for i in range(2)]
    fast, fast_wall = run_goranging_cli(cap, code, os.path.join(work, "fastmC.mat"), dev)
    got, wall = runs[1]
    if got["df"] != fast["df"]:
        raise RuntimeError(f"sharded df {got['df']} != fast {fast['df']}")
    for ch in ("ch1", "ch2"):
        for k in fast[ch]:
            if not np.array_equal(got[ch][k], fast[ch][k]):
                raise RuntimeError(f"goranging --sharded differs from --fast ({ch} {k})")
    n_fields = mat_fields_equal(got["mat_path"], fast["mat_path"])
    t = got["timing"]
    if (t["n_devices"], t["n_processes"]) != (1, 1):
        raise RuntimeError(f"sharded timing {t}")
    iq = GR_SECONDS * cfg.fs * 2
    keys = ("df_prepass_s", "epoch_loop_s", "fetch_s", "total_s")
    layers = {name: {k: r["timing"][k] for k in keys} | {"verb_wall_s": w}
              for name, (r, w) in (("sharded", (got, wall)), ("fast", (fast, fast_wall)))}
    out.update(goranging_identical=True, mat_fields_compared=n_fields,
               sharded_msps_warm=iq / wall / 1e6, sharded_msps_cold=iq / runs[0][1] / 1e6,
               fast_msps_warm=iq / fast_wall / 1e6, goranging_layers=layers)
    log(f"goranging --sharded (world 1, NCCL) = --fast: every epoch, df and "
        f"{n_fields} .mat fields identical; warm IQ MS/s sharded "
        f"{out['sharded_msps_warm']:.2f} (cold {out['sharded_msps_cold']:.2f}), fast "
        f"{out['fast_msps_warm']:.2f}; layers (s) {json.dumps(layers)} [{out['card']}]")

    # -- M4. the sharded CAF step against the direct chain ------------------
    rep = build_replica(code, cfg, ProcessingConfig(hamming_window=True), conjugate=True)
    fcode = np.asarray(rep.fcode).astype(np.complex64)
    code3 = np.asarray(rep.code_interp).astype(np.float32)
    epb, halo = 8, L // 2
    f0 = float(np.round(truth["doppler"][0] / 25.0) * 25.0)
    shifts, _ = doppler_bins(cfg.fs, L, f0 - 1000.0, f0 + 1000.0, 25.0)
    if len(shifts) != 81:
        raise RuntimeError(f"{len(shifts)} hypotheses")
    d, _ = sc16.read_sc16_epochs(cap, 0, 1, epb * L + halo, channels=2)
    blocks = d[0, :1]  # channel 1, (1, 8 L + L/2)
    step = sharded.make_sharded_caf_step(mesh, cfg.fs, L, epb, halo, caf_chunk=4)
    args = sharded.shard_blocks(mesh, blocks, np.zeros(1, np.int32), fcode, code3, shifts)
    res = step(*args)
    fc_t, c3_t = args[2], args[3]

    def direct():
        x = args[0][0, : epb * L].reshape(epb, L)
        pk = caf_peaks(x, fc_t, shifts, chunk=4)
        h = torch.argmax(pk.power, dim=-1)
        p = torch.gather(pk.power, -1, h[:, None])[:, 0]
        f = torch.as_tensor(shifts, device=x.device)[h].to(p.dtype) * (cfg.fs / L)
        r = correlate_epochs(x, fc_t, f, c3_t, cfg.fs)
        return ((r.indice + r.correction) / 3, f, p,
                10.0 * torch.log10(r.snr_r + r.snr_i), r.xval)

    ref = direct()
    for name, a, b in zip(("delay", "df", "peak", "snr", "xval"), res, ref):
        if not torch.equal(a[0], b):
            raise RuntimeError(f"sharded CAF step {name} differs from the direct chain")
    d_err = float(torch.median(res[0][0]).item() - truth["delay"][0])
    if abs(d_err) > 0.05:
        raise RuntimeError(f"sharded CAF step: median delay err {d_err} sample")
    out.update(caf_identical=True, caf_delay_err=d_err,
               caf_ms=cuda_ms(lambda: step(*args), 5), caf_direct_ms=cuda_ms(direct, 5))
    log(f"sharded CAF step (L = {L}, 8 epochs, halo L/2, 81 hypotheses) = caf_peaks "
        f"-> argmax -> correlate_epochs bit for bit; median delay err {d_err:+.4f} "
        f"sample; {out['caf_ms']:.3f} ms vs direct {out['caf_direct_ms']:.3f} ms "
        f"[{out['card']}]")

    # -- M5. the sharded lag-bank step at the host receiver's shape ---------
    gen = torch.Generator(device=dev).manual_seed(7)
    C, P, K, NL = 8, 24, 200_000, 57
    obs = torch.randn(C, 2, P, K, generator=gen, device=dev)
    wav = torch.randn(C, K, NL, generator=gen, device=dev)
    lstep = sharded.make_sharded_lagbank_step(mesh)
    lagbank.lag_bank_correlate.launches = 0
    pw, ph = lstep(obs, wav)
    torch.cuda.synchronize()
    launches = lagbank.lag_bank_correlate.launches
    if launches != 1:
        raise RuntimeError(f"sharded lag-bank step: {launches} explicit launches")
    for c in range(C):
        p1, h1 = lagbank.lag_bank_correlate(obs[c], wav[c])
        if not (torch.equal(pw[c], p1) and torch.equal(ph[c], h1)):
            raise RuntimeError(f"sharded lag-bank step channel {c} differs")
    # every channel against the plain version on the same inputs, with
    # step 20's limits: 1e-4 of the row maximum / 1e-4 cycles against the
    # float32 plain, and at most F64_GATE x its error against float64
    errs = np.zeros((C, 3, 2))  # (kernel vs fp32 plain, kernel vs f64, plain vs f64)
    for c in range(C):
        plain = lagbank.lag_bank_plain(obs[c], wav[c])
        ref64 = lagbank.lag_bank_plain(obs[c].double(), wav[c].double())
        errs[c] = (lagbank.lag_bank_errors((pw[c], ph[c]), plain),
                   lagbank.lag_bank_errors((pw[c], ph[c]), ref64),
                   lagbank.lag_bank_errors(plain, ref64))
        del plain, ref64
    if (errs[:, 0] >= 1e-4).any():
        raise RuntimeError(f"sharded lag-bank step disagrees with its plain version: "
                           f"{errs[:, 0].max(0)}")
    if (errs[:, 1] > F64_GATE * errs[:, 2]).any():
        raise RuntimeError("sharded lag-bank step fails the float64 gate")
    worst = errs.max(0)
    log(f"sharded lag-bank step against the plain version, {C} channels: power err / "
        f"row max {worst[0, 0]:.3e}, phase {worst[0, 1]:.3e} cycles; against float64 "
        f"{worst[1, 0]:.3e}, {worst[1, 1]:.3e} cycles; fp32 plain against float64 "
        f"{worst[2, 0]:.3e}, {worst[2, 1]:.3e} cycles (gate: kernel <= {F64_GATE:g} x "
        f"plain per channel)")
    out.update(lagbank_err_over_row_max=worst[0, 0], lagbank_phase_err_cycles=worst[0, 1],
               lagbank_f64_err_over_row_max=worst[1, 0],
               lagbank_f64_phase_err_cycles=worst[1, 1],
               lagbank_plain_f64_err_over_row_max=worst[2, 0],
               lagbank_plain_f64_phase_err_cycles=worst[2, 1])
    ms = cuda_ms(lambda: lstep(obs, wav), 10)
    per_ch_ms = cuda_ms(lambda: [lagbank.lag_bank_correlate(obs[c], wav[c])
                                 for c in range(C)], 10)
    nbytes = 4.0 * (obs.numel() + wav.numel() + 2 * C * P * NL)
    flops = 2.0 * 2 * C * P * NL * K
    bound_bytes, bound_ops = 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * 3 * flops / PEAK_TF32_FLOPS
    out.update(lagbank_identical=True, lagbank_step_launches=launches,
               lagbank_step_ms=ms, lagbank_per_channel_ms=per_ch_ms,
               lagbank_step_bound_ms=max(bound_bytes, bound_ops),
               lagbank_step_bound_by="bytes" if bound_bytes >= bound_ops else "operations")
    log(f"sharded lag-bank step, {C} x (2, {P}, {K}) x ({K}, {NL}): 1 explicit launch, "
        f"every channel bit for bit its own lag_bank_correlate; {ms:.4f} ms vs "
        f"{per_ch_ms:.4f} ms for {C} single-channel calls; bound "
        f"{out['lagbank_step_bound_ms']:.4f} ms ({out['lagbank_step_bound_by']}) "
        f"[{out['card']}]")
    del obs, wav, pw, ph
    torch.cuda.empty_cache()

    # -- M6. goranging --sharded under torchrun ------------------------------
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", "-m", "amaranth_twstft_tpu_torch", "goranging",
           cap, code, "--sharded", "--batch-epochs", str(GR_BATCH)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=root, env=env, start_new_session=True)
    try:
        so, se = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        raise RuntimeError("torchrun goranging --sharded timed out") from None
    run_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"torchrun goranging --sharded exited {proc.returncode}: "
                           f"{se[-3000:]}")
    mat = so.strip().splitlines()[-1]
    n_fields = mat_fields_equal(mat, got["mat_path"])
    os.remove(mat)
    out.update(torchrun_identical=True, torchrun_wall_s=run_wall)
    log(f"torchrun --standalone --nproc-per-node 1 goranging --sharded: the .mat "
        f"equals the in-process run's ({n_fields} fields); {run_wall:.1f} s with "
        f"start-up [{out['card']}]")
    return out


def native_phase(work: str, cap: str, code: str, truth: dict, dev, gr: dict) -> dict:
    """Steps N1-N2 on the GoRanging capture (``gr``: the numbers of the
    int16 runs); returns the numbers of the ``{"native": ...}`` line."""
    from amaranth_twstft_tpu_torch import cli, native
    from amaranth_twstft_tpu_torch.ops import lfsr
    from amaranth_twstft_tpu_torch.utils import io as sc16

    # -- N1. the library against the plain versions, whole capture ---------
    n_frames = sc16.n_samples_sc16(cap, channels=2)
    mb = os.path.getsize(cap) / 1e6
    threads = min(os.cpu_count() or 2, 8)
    t0 = time.perf_counter()
    raw = np.array(sc16.open_sc16(cap, 2))
    t_mm = time.perf_counter() - t0
    t0 = time.perf_counter()
    a, n = native.read_raw16(cap, 0, n_frames, channels=2)
    t_raw = time.perf_counter() - t0
    if n != n_frames or not np.array_equal(a, raw):
        raise RuntimeError("native read_raw16 differs from the memmap copy")
    del a
    rates = {"read_raw16_mbps": mb / t_raw, "memmap_copy_mbps": mb / t_mm}
    for pow2 in (False, True):
        tag = "pow2" if pow2 else "exact"
        t0 = time.perf_counter()
        q, n, scale = native.quantize_q8(cap, 0, n_frames, channels=2, pow2=pow2)
        t_nat = time.perf_counter() - t0
        plain = np.empty_like(q)
        t0 = time.perf_counter()
        s_plain = sc16._quantize_q8_plain(raw, pow2, plain)
        t_plain = time.perf_counter() - t0
        if n != n_frames or scale != s_plain or not np.array_equal(q, plain):
            raise RuntimeError(f"native quantize_q8 ({tag}) differs from the plain "
                               f"quantizer (scale {scale} vs {s_plain})")
        rates[f"quantize_q8_{tag}_mbps"] = mb / t_nat
        rates[f"plain_q8_{tag}_mbps"] = mb / (t_plain + t_mm)
        log(f"N1 quantize_q8 {tag}: scale {scale!r}, bytes and scale equal to the plain "
            f"torch quantizer; native {mb / t_nat:.0f} MB/s ({t_nat:.3f} s), plain "
            f"{mb / (t_plain + t_mm):.0f} MB/s (memmap copy {t_mm:.3f} s + quantize "
            f"{t_plain:.3f} s)")
        del q, plain
    del raw
    log(f"N1 read_raw16: equal to the memmap copy; native {rates['read_raw16_mbps']:.0f} "
        f"MB/s ({t_raw:.3f} s), memmap copy {rates['memmap_copy_mbps']:.0f} MB/s, over "
        f"{mb:.0f} MB; {threads} threads, os.cpu_count() {os.cpu_count()}")

    # -- N2. goranging --fast --parity-ns 0.1 through the native quantizer ---
    o_nat, w_nat = run_goranging_cli(cap, code, os.path.join(work, "q8nativeC.mat"),
                                     dev, extra=("--parity-ns", "0.1"))
    if "native_q8_s" not in o_nat["timing"]:
        raise RuntimeError("the int8 run did not take the native quantizer")
    errs = []
    for c, ch in enumerate(("ch1", "ch2")):
        dl = delays_samples(o_nat[ch])
        errs.append(float(np.median(dl) - truth["delay"][c]))
        if len(dl) != gr["n_epochs"] or abs(errs[-1]) > GR_DELAY_TOL:
            raise RuntimeError(f"int8 run: {ch} {len(dl)} epochs, delay err {errs[-1]}")
    tn, t16 = o_nat["timing"], gr["timing"]
    log(f"N2 goranging --fast --parity-ns 0.1 (native int8 reader): median delay "
        f"err {errs} sample; wall {w_nat:.3f} s")
    log(f"  int8 timing: convert_s {tn['convert_s']}, native_q8_s {tn['native_q8_s']}, "
        f"epoch_loop_s {tn['epoch_loop_s']}; int16 run (native read_raw16): disk_s "
        f"{t16['disk_s']}, convert_s {t16['convert_s']}, epoch_loop_s {t16['epoch_loop_s']}")

    # prn --search at the production 17-bit length, engine vs plain search
    stdout = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        rc = cli.main(["prn", "--bitlen", str(BIT_LEN), "--search", str(2 * N_PER_INPUT)])
    t_search = time.perf_counter() - t0
    found = [int(x) for x in stdout.getvalue().split()]
    t0 = time.perf_counter()
    plain_taps = lfsr._find_mseq_taps_np(BIT_LEN, 2 * N_PER_INPUT)
    t_plain_search = time.perf_counter() - t0
    if rc != 0 or found != plain_taps:
        raise RuntimeError("prn --search differs from the plain search")
    log(f"N2 prn --search {2 * N_PER_INPUT} at {BIT_LEN} bits: the plain search's taps; "
        f"{t_search:.3f} s (native engine), plain {t_plain_search:.3f} s")
    return {
        **rates, "threads": threads, "cpu_count": os.cpu_count(), "capture_mb": mb,
        "q8_native_wall_s": w_nat, "q8_delay_err_samples": errs,
        "q8_timing_native": tn,
        "int16_disk_s": t16["disk_s"], "int16_convert_s": t16["convert_s"],
        "prn_search_s": t_search, "prn_search_plain_s": t_plain_search,
    }


def mxufft_phase(dev, seed: int) -> dict:
    """Step M: the staged matmul FFT against the float64 truth and cuFFT."""
    from amaranth_twstft_tpu_torch.ops import mxufft

    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for shape, reps in MX_SHAPES:
        x = torch.randn(shape, dtype=torch.complex64, generator=gen, device=dev)
        x64 = x.to(torch.complex128)
        row = {"factors": list(mxufft.good_factors(shape[-1]))}
        for name, fn, lib in (("fft", mxufft.fft_factored, torch.fft.fft),
                              ("ifft", mxufft.ifft_factored, torch.fft.ifft)):
            y = fn(x)
            truth = lib(x64, dim=-1)
            peak = truth.abs().max()
            err = float((y.to(torch.complex128) - truth).abs().max() / peak)
            lib_err = float((lib(x, dim=-1).to(torch.complex128) - truth).abs().max() / peak)
            ms = cuda_ms(lambda: fn(x), reps)
            lib_ms = cuda_ms(lambda: lib(x, dim=-1), reps)
            log(f"M {name}_factored {tuple(shape)} complex64 (stages {row['factors']}): "
                f"max err / max {err:.3e} (cuFFT {lib_err:.3e}); {ms:.4f} ms, "
                f"torch.fft.{name} {lib_ms:.4f} ms ({ms / lib_ms:.1f}x)")
            if y.dtype != torch.complex64 or not err < 5e-5:
                raise RuntimeError(f"{name}_factored {shape}: {y.dtype}, err {err}")
            row[name] = {"max_err": err, "cufft_max_err": lib_err, "ms": ms,
                         "cufft_ms": lib_ms}
        out["x".join(map(str, shape))] = row
        del x, x64, y, truth
    return out


def studies_phase(dev) -> dict:
    """Step S: the correlator studies at production geometry on the card,
    each with the conclusion its JAX test asserts."""
    from amaranth_twstft_tpu_torch import studies
    from amaranth_twstft_tpu_torch.config import SignalConfig

    torch.cuda.empty_cache()
    walls, peaks = {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        peaks[name] = torch.cuda.max_memory_allocated(dev) / 1e9
        return r

    f16 = timed("f16_ingest_error_study", lambda: studies.f16_ingest_error_study(device=dev))
    for chain in ("quant", "f32", "int8"):
        log(f"S f16_ingest_error_study {chain}: " + ", ".join(
            f"{k} {v!r}" for k, v in f16[chain].items()))
    if not (f16["quant"]["max_ns"] < 0.01 and f16["f32"]["max_ns"] < 0.01
            and f16["int8"]["max_ns"] < 0.1 and f16["f32"]["n"] == 1024):
        raise RuntimeError(f"f16_ingest_error_study: {f16}")
    ti = timed("timing_interpolation_study", lambda: studies.timing_interpolation_study(
        code_len=CODE_LEN, bit_len=BIT_LEN, taps=9, device=dev))
    s0, s1, s2 = ti["std_samples"]
    log(f"S timing_interpolation_study (100 000 chips): std {ti['std_samples']} sample "
        f"at nint 0/1/2, mean err {ti['mean_err_samples']}")
    if not (s0 > 5.0 * s1 and s2 < 2.0 * s1 and s1 < 0.05):
        raise RuntimeError(f"timing_interpolation_study: {ti}")
    qp = timed("qpsk_vs_bpsk_study", lambda: studies.qpsk_vs_bpsk_study(
        SignalConfig(), device=dev))
    log(f"S qpsk_vs_bpsk_study (production signal): {qp}")
    if not (abs(qp["bpsk_mean"] - 137.25) < 0.1 and abs(qp["qpsk_mean"] - 137.25) < 0.2
            and qp["qpsk_std_samples"] > 0.8 * qp["bpsk_std_samples"]):
        raise RuntimeError(f"qpsk_vs_bpsk_study: {qp}")
    cl = timed("code_length_study", lambda: studies.code_length_study(
        configs=studies.CODE_LENGTH_CAMPAIGN, device=dev))
    std = cl["std_samples"]
    # the matched-filter law: std[0]/std[i] within 2x of sqrt(len_i/len_0)
    # (tests/test_studies.py's 2 < ratio < 8 at 16x length)
    law = (std[0] / std) / np.sqrt(cl["code_len"] / cl["code_len"][0])
    log(f"S code_length_study (the seven campaign codes, 5 kchip to 2.5 Mchip): "
        f"std {std} sample, mean {cl['mean_samples']}; std ratio over sqrt(length "
        f"ratio) {law}")
    if not (np.all(np.abs(cl["mean_samples"] - 123.0) < 0.5)
            and np.all(np.diff(std) < 0) and np.all((law > 0.5) & (law < 2.0))):
        raise RuntimeError(f"code_length_study: {cl}")
    gt = timed("gotracking_slope_study", lambda: studies.gotracking_slope_study(device=dev))
    floor = gt["noise_floor_s_per_s"]
    log(f"S gotracking_slope_study: slope mean {gt['slope_mean']!r} s/s (true "
        f"{gt['slope_true']!r}), 1-s floor {floor!r}, production extrapolation "
        f"{gt['floor_production_extrapolated']!r}")
    if not (floor < 1e-12 and gt["floor_production_extrapolated"] < 3e-13
            and abs(gt["slope_mean"] - gt["slope_true"])
            < 3 * floor / np.sqrt(len(gt["slopes_s_per_s"]))):
        raise RuntimeError(f"gotracking_slope_study: {gt}")
    for k in walls:
        log(f"S {k}: wall {walls[k]:.3f} s, peak device memory {peaks[k]:.2f} GB")
    return {
        "wall_s": walls, "peak_gb": peaks, "f16": f16,
        "timing_std_samples": ti["std_samples"].tolist(), "qpsk": qp,
        "code_length_std_samples": std.tolist(),
        "gotracking_floor_s_per_s": floor,
    }


def run_ranging_cli(cap: str, code: str, dev, extra: tuple = ()):
    """The ``ranging`` verb in-process, its step calls counted.  Returns
    ``godual.process_file``'s dict, the step's call times and the wall."""
    from amaranth_twstft_tpu_torch.models import godual

    calls: list = []
    with counted_steps(calls):
        out, _, wall = kept_verb(godual, "process_file",
                                 ["ranging", cap, code, "--device", str(dev), *extra])
    return out, calls, wall


def copy_prefix(src: str, dst: str, n_frames: int, channels: int = 2) -> None:
    """The first ``n_frames`` sample frames of an sc16 capture."""
    with open(src, "rb") as f, open(dst, "wb") as g:
        g.write(f.read(n_frames * 4 * channels))


def shifted_copy(src: str, dst: str, seconds: int, shift_hz: float, channels: int,
                 dev) -> None:
    """The first ``seconds`` of an sc16 capture with its first channel moved
    by ``shift_hz`` (on the card one second at a time, rounded back to
    int16; the other channel as it is).  The delay is unchanged."""
    fs = int(FS)
    t = torch.arange(fs, device=dev, dtype=torch.float64)
    with open(src, "rb") as f, open(dst, "wb") as g:
        for s0 in range(0, seconds * fs, fs):
            raw = np.frombuffer(f.read(fs * 4 * channels), np.int16).reshape(-1, 2 * channels)
            x = torch.from_numpy(raw.copy()).to(dev)
            n = x.shape[0]
            z = torch.complex(x[:, 0].double(), x[:, 1].double())
            ph = torch.remainder(shift_hz * (t[:n] + s0) / FS, 1.0)
            z = z * torch.exp(2j * math.pi * ph)
            x[:, 0] = torch.clamp(torch.round(z.real), -32768, 32767).to(torch.int16)
            x[:, 1] = torch.clamp(torch.round(z.imag), -32768, 32767).to(torch.int16)
            g.write(x.cpu().numpy().tobytes())


def check_ranging(what: str, out: dict, truths: list, fine: bool,
                  L: int = CODE_LEN * int(FS // CHIP_RATE)) -> dict:
    """Each channel's median delay within ``GR_DELAY_TOL`` of its truth and
    every epoch's df within ``GR_DF_TOL``: of the truth when the fine
    frequency refined it; else of the coarse estimate's target.  The
    per-epoch squaring spectrum peaks at the FFT bin nearest twice the
    Doppler (bins fs / L = 25 Hz apart at L = 200 000), and the chain reads
    df off the reference's inclusive linspace (``godual_ranging.m:73``),
    whose label for bin i lies i fs / (L (L - 1)) above the bin's
    frequency: the target is that label, halved.  ``truths``: (delay,
    Doppler) per channel; ``L`` the code's samples."""
    from amaranth_twstft_tpu_torch.ops.fftutils import fftfreq_shifted

    bins = np.fft.fftshift(np.fft.fftfreq(L, 1.0 / FS))
    labels = fftfreq_shifted(L, FS)
    errs = {}
    for c, (delay, dop) in enumerate(truths):
        ch = f"ch{c + 1}"
        dl = delays_samples(out[ch])
        df = np.asarray(out[ch]["df"], np.float64)
        target = float(dop) if fine else float(labels[np.argmin(np.abs(bins - 2.0 * dop))] / 2.0)
        d_err = float(np.median(dl) - delay)
        df_err = float(np.abs(df - target).max())
        truth_err = float(np.abs(df - dop).max())
        errs[ch] = {"delay_err_samples": d_err, "delay_pp_samples": float(np.ptp(dl)),
                    "df_err_hz": df_err, "df_err_vs_truth_hz": truth_err,
                    "df_target_hz": target}
        log(f"  {what} {ch}: {len(dl)} epochs, median delay err {d_err:+.5f} sample "
            f"(p-p {np.ptp(dl):.4f}); max |df - {'truth' if fine else 'bin label'} "
            f"{target:.4f}| {df_err:.4f} Hz, max |df - truth {dop:.4f}| {truth_err:.4f} Hz")
        if abs(d_err) > GR_DELAY_TOL or df_err > GR_DF_TOL:
            raise RuntimeError(f"{what} {ch}: truth check failed")
    return errs


def ranging_vs_cpu(what: str, out: dict, cap: str, code: str, proc, station,
                   remote: bool, work: str) -> dict:
    """The card branch's first ``RG_CPU_EPOCHS`` epochs of each channel
    against (a) the same bound step on the CPU (indice identical,
    correction within 1e-4 sample, snr within 1e-3 of the total, df within
    0.05 Hz: ``tests/test_torch_cuda.py::_close_ranging``) and (b) the
    host branch, ``godual.process_file(device="cpu")``, on a prefix of the
    capture (delays within ``GR_DELAY_TOL``)."""
    from amaranth_twstft_tpu_torch.config import SignalConfig
    from amaranth_twstft_tpu_torch.models import godual
    from amaranth_twstft_tpu_torch.ops import boundary, doppler
    from amaranth_twstft_tpu_torch.utils import io as sc16

    cfg = SignalConfig()
    L = cfg.samples_per_code
    rep = godual.build_replica(code, cfg, proc)
    mask = doppler.window_mask(L, cfg.fs, *godual.df_window(station, remote))
    step = boundary.make_ranging_step(rep.fcode, rep.code_interp, mask, cfg.fs,
                                      nint=proc.nint, fine_freq=proc.fine_freq,
                                      device="cpu")
    d, n = sc16.read_sc16_epochs(cap, 0, RG_CPU_EPOCHS, L)
    prefix = os.path.join(work, "ranging_prefix.bin")
    copy_prefix(cap, prefix, n * L)
    t0 = time.perf_counter()
    host = godual.process_file(prefix, code, cfg, proc, station, remote=remote,
                               out_mat=os.path.join(work, "ranging_prefix.mat"),
                               device="cpu")
    t_host = time.perf_counter() - t0
    os.remove(prefix)
    worst = {"correction": 0.0, "snr_rel": 0.0, "df_hz": 0.0, "host_delay": 0.0}
    for c in range(1 if remote else 2):
        ch = f"ch{c + 1}"
        card = {k: np.asarray(v)[:n] for k, v in out[ch].items()}
        rows = step(torch.from_numpy(d[c]))
        cpu, cpu_df = boundary.to_epoch_result(rows), rows.df.numpy()
        if not np.array_equal(card["indice"], cpu.indice):
            raise RuntimeError(f"{what} {ch}: card vs CPU step, indice differs")
        worst["correction"] = max(worst["correction"], float(
            np.abs(card["correction"] - cpu.correction).max()))
        tot = cpu.snr_r + cpu.snr_i
        worst["snr_rel"] = max(worst["snr_rel"], *(
            float((np.abs(card[f] - getattr(cpu, f)) / tot).max())
            for f in ("snr_r", "snr_i")))
        worst["df_hz"] = max(worst["df_hz"], float(np.abs(card["df"] - cpu_df).max()))
        worst["host_delay"] = max(worst["host_delay"], float(np.abs(
            delays_samples(card) - delays_samples(host[ch])).max()))
    log(f"  {what} card vs the same step on the CPU ({n} epochs per channel): indice "
        f"identical, max correction diff {worst['correction']:.2e} sample, snr "
        f"{worst['snr_rel']:.2e} of the total, df {worst['df_hz']:.2e} Hz; vs the CPU's "
        f"host branch ({t_host:.2f} s): max delay diff {worst['host_delay']:.2e} sample")
    if worst["correction"] > 1e-4 or worst["snr_rel"] > 1e-3 or worst["df_hz"] > 0.05 \
            or worst["host_delay"] > GR_DELAY_TOL:
        raise RuntimeError(f"{what}: card vs CPU {worst}")
    return worst


def ranging_phase(work: str, cap: str, code: str, truth: dict, dev) -> dict:
    """Steps R1-R4 on the GoRanging capture; returns the numbers of the
    ``{"ranging": ...}`` line."""
    import scipy.io as sio

    from amaranth_twstft_tpu_torch.config import (
        ProcessingConfig,
        SignalConfig,
        StationConfig,
    )
    from amaranth_twstft_tpu_torch.models import godual

    cfg = SignalConfig()
    n_epochs = GR_SECONDS * round(cfg.codes_per_second)
    steps = -(-n_epochs // 25)  # godual's 25-epoch batches per channel
    truths = list(zip(truth["delay"], truth["doppler"]))
    out: dict = {}

    # -- R1. ranging, both channels: the card branch of godual.process_file
    local, calls, wall = run_ranging_cli(cap, code, dev)
    msps = GR_SECONDS * cfg.fs * 2 / wall / 1e6
    log(f"R1 ranging (local, both channels): wall {wall:.3f} s -> {msps:.2f} IQ MS/s "
        f"over both channels; {len(calls)} step calls (host {sum(calls):.3f} s)")
    if len(calls) != 2 * steps:
        raise RuntimeError(f"ranging: {len(calls)} step calls, expected {2 * steps}")
    mat = sio.loadmat(local["mat_path"])
    if os.path.basename(local["mat_path"]) != "ranging.mat":
        raise RuntimeError(f"ranging wrote {local['mat_path']}")
    for c in (1, 2):
        h = local[f"ch{c}"]
        pairs = {f"indice{c}": h["indice"] + 1.0, f"correction{c}": h["correction"],
                 f"SNR{c}r": h["snr_r"], f"SNR{c}i": h["snr_i"], f"df{c}": h["df"],
                 f"puissance{c}": h["puissance"]}
        for k, v in pairs.items():
            if not np.array_equal(mat[k].ravel(), np.asarray(v, np.float64).ravel()):
                raise RuntimeError(f"ranging .mat field {k} differs from the result")
    if "code" not in mat:
        raise RuntimeError("ranging .mat has no code field")
    out["local"] = {"wall_s": wall, "iq_msps": msps, "step_calls": len(calls),
                    "step_host_s": sum(calls),
                    "errors": check_ranging("R1 ranging", local, truths, fine=False),
                    "mat_fields": sorted(k for k in mat if not k.startswith("__"))}

    # -- R2. ranging --remote: channel 1 of a copy moved into the window ---
    rdir = os.path.join(work, "remote")
    os.makedirs(rdir, exist_ok=True)
    rcap = os.path.join(rdir, "ranging.bin")
    t0 = time.perf_counter()
    shifted_copy(cap, rcap, RG_REMOTE_SECONDS, RG_REMOTE_SHIFT_HZ, 2, dev)
    t_copy = time.perf_counter() - t0
    remote, rcalls, rwall = run_ranging_cli(rcap, code, dev, ("--remote",))
    rmat = sio.loadmat(remote["mat_path"])
    log(f"R2 ranging --remote on {RG_REMOTE_SECONDS} s with channel 1 moved by "
        f"{RG_REMOTE_SHIFT_HZ:g} Hz (copy {t_copy:.2f} s): wall {rwall:.3f} s, "
        f"{len(rcalls)} step calls, wrote {os.path.basename(remote['mat_path'])}")
    r_epochs = RG_REMOTE_SECONDS * round(cfg.codes_per_second)
    if remote["ch2"] is not None or len(rcalls) != -(-r_epochs // 25) \
            or os.path.basename(remote["mat_path"]) != "remoteranging.mat" \
            or "indice2" in rmat or "indice1" not in rmat:
        raise RuntimeError("ranging --remote: channels, step calls or .mat name wrong")
    r_truth = [(truth["delay"][0], truth["doppler"][0] + RG_REMOTE_SHIFT_HZ)]
    out["remote"] = {"wall_s": rwall, "step_calls": len(rcalls), "seconds": RG_REMOTE_SECONDS,
                     "errors": check_ranging("R2 ranging --remote", remote, r_truth,
                                             fine=False)}

    # -- R3. godual.process_file with the fine frequency -------------------
    fproc = ProcessingConfig(fine_freq=True)
    fcalls: list = []
    with counted_steps(fcalls):
        t0 = time.perf_counter()
        fine = godual.process_file(cap, code, cfg, fproc, StationConfig(),
                                   out_mat=os.path.join(work, "ranging_fine.mat"),
                                   device=dev)
        torch.cuda.synchronize()
        fwall = time.perf_counter() - t0
    log(f"R3 godual.process_file(fine_freq=True): wall {fwall:.3f} s -> "
        f"{GR_SECONDS * cfg.fs * 2 / fwall / 1e6:.2f} IQ MS/s, {len(fcalls)} step calls")
    if len(fcalls) != 2 * steps:
        raise RuntimeError(f"fine_freq: {len(fcalls)} step calls")
    out["fine"] = {"wall_s": fwall, "step_calls": len(fcalls),
                   "errors": check_ranging("R3 fine_freq", fine, truths, fine=True)}

    # -- R4. the card branch against the CPU --------------------------------
    out["local"]["vs_cpu"] = ranging_vs_cpu("R4 ranging", local, cap, code,
                                            ProcessingConfig(), StationConfig(), False, work)
    out["remote"]["vs_cpu"] = ranging_vs_cpu("R4 ranging --remote", remote, rcap, code,
                                             ProcessingConfig(), StationConfig(op=False),
                                             True, work)
    out["fine"]["vs_cpu"] = ranging_vs_cpu("R4 fine_freq", fine, cap, code, fproc,
                                           StationConfig(), False, work)
    os.remove(rcap)
    return out


def batch_sources(work: str, cap: str, code: str) -> tuple[str, str]:
    """Phase B's dual-channel directories (before the GoRanging capture is
    deleted): for each of ``goranging`` and ``godual`` a ``1*.bin`` copy of
    the capture's first ``B_PREFIX_SECONDS``, a ``2*.bin`` one the chain's
    glob does not pick, and the copy the single-file verb runs on; and the
    directories the two-way phase links OP's captures into.  Returns the
    phase's root and its copy of the code."""
    root = os.path.join(work, "batch")
    src = os.path.join(root, "dual_prefix.bin")
    for d in ("src", "claudio"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    copy_prefix(cap, src, B_PREFIX_SECONDS * int(FS))
    for chain in ("goranging", "godual"):
        for d, names in ((chain, ("1755400000.bin", "2755400000.bin")),
                         (chain + "_ref", ("1755400000.bin",))):
            os.makedirs(os.path.join(root, d), exist_ok=True)
            for name in names:
                shutil.copyfile(src, os.path.join(root, d, name))
    os.remove(src)
    shutil.copyfile(code, os.path.join(root, "code.bin"))
    return root, os.path.join(root, "code.bin")


def gunzipped(path: str) -> str:
    """Unpack ``path`` (``.mat.gz``) beside it; returns the bare path."""
    import gzip

    bare = path[: -len(".gz")] + ".unpacked.mat"
    with gzip.open(path, "rb") as f, open(bare, "wb") as g:
        shutil.copyfileobj(f, g)
    return bare


def batch_dir(root: str, chain: str, name: str, code: str, ref_argv: list[str],
              dev, other: str) -> dict:
    """B1-B3 for one chain: the single-file verb on the reference copy,
    then ``batch`` over the directory: ``name`` processed, nothing skipped
    or failed, its gunzipped ``.mat`` equal to the verb's field for field,
    the input in ``donetw/`` and ``other`` (not picked) in place; then a
    second run that finds nothing to do and leaves the archive as it was."""
    d, ref = os.path.join(root, chain), os.path.join(root, chain + "_ref")
    ref_out, ref_wall = run_verb([*ref_argv[:1], os.path.join(ref, name), code,
                                  *ref_argv[1:], "--device", str(dev)])
    ref_mat = ref_out.strip().splitlines()[-1]
    argv = ["batch", d, code, "--chain", chain, "--device", str(dev)]
    rep_out, wall = run_verb(argv)
    rep = json.loads(rep_out.strip().splitlines()[-1])
    cap = os.path.join(d, name)
    if rep != {"processed": [cap], "skipped": [], "failed": []}:
        raise RuntimeError(f"batch --chain {chain}: {rep}")
    gz = os.path.join(d, os.path.basename(ref_mat) + ".gz")
    bare = gunzipped(gz)
    n_fields = mat_fields_equal(bare, ref_mat)
    os.remove(bare)
    if os.path.exists(cap) or not os.path.exists(os.path.join(d, "donetw", name)) \
            or not os.path.exists(os.path.join(d, other)) \
            or os.path.exists(os.path.join(d, os.path.basename(ref_mat))):
        raise RuntimeError(f"batch --chain {chain}: files not where expected: "
                           f"{sorted(os.listdir(d))}")
    stamp = os.stat(gz).st_mtime_ns
    again_out, again_wall = run_verb(argv)
    again = json.loads(again_out.strip().splitlines()[-1])
    if again != {"processed": [], "skipped": [], "failed": []} \
            or os.stat(gz).st_mtime_ns != stamp:
        raise RuntimeError(f"batch --chain {chain}, second run: {again}")
    log(f"B {chain}: batch wall {wall:.3f} s (the single-file verb {ref_wall:.3f} s), "
        f"processed {name}; gunzipped .mat equal to the verb's in {n_fields} fields; "
        f"input in donetw/, {other} left in place; second run ({again_wall:.3f} s) "
        f"found nothing to do")
    return {"wall_s": wall, "verb_wall_s": ref_wall, "second_wall_s": again_wall,
            "mat_fields": n_fields, "processed": [name]}


def batch_phase(root: str, dev, gr_code: str, kept: dict) -> dict:
    """Steps B1-B4; ``kept`` holds what the two-way phase kept for it (OP's
    captures, codes, truths and the claudio verb's OP_1 archive).  Returns
    the numbers of the ``{"batch": ...}`` line."""
    import gzip

    import scipy.io as sio

    from amaranth_twstft_tpu_torch import pipeline
    from amaranth_twstft_tpu_torch.config import SignalConfig, StationConfig

    cfg = SignalConfig()
    out: dict = {"prefix_seconds": B_PREFIX_SECONDS}
    # -- B1-B2. goranging and godual over a dual-channel directory each ------
    out["goranging"] = batch_dir(root, "goranging", "1755400000.bin", gr_code,
                                 ["goranging"], dev, "2755400000.bin")
    out["godual"] = batch_dir(root, "godual", "1755400000.bin", gr_code,
                              ["ranging"], dev, "2755400000.bin")

    # -- B3. claudio: OP's loopback moved into the ranging window, OP's remote
    cdir = os.path.join(root, "claudio")
    os.makedirs(os.path.join(root, "claudio_ref"), exist_ok=True)
    name = os.path.basename(kept["OP_2"])
    t0 = time.perf_counter()
    shifted_copy(kept["OP_2"], os.path.join(cdir, name), TW_SECONDS, B_RANGING_SHIFT_HZ,
                 1, dev)
    t_copy = time.perf_counter() - t0
    os.remove(kept["OP_2"])
    shutil.copyfile(os.path.join(cdir, name), os.path.join(root, "claudio_ref", name))
    remote_name = os.path.basename(kept["OP_1"])
    log(f"B claudio: {name} moved by {B_RANGING_SHIFT_HZ:g} Hz ({t_copy:.2f} s), "
        f"{remote_name} as the two-way phase wrote it")
    code9 = kept["codes"]["OP"]
    out["claudio"] = batch_dir(root, "claudio", name, code9, ["claudio"], dev,
                               remote_name)
    # the archive against the truth: OP's loopback, moved
    with gzip.open(os.path.join(cdir, "rangingclaudio" + name.replace(".bin", ".mat.gz"))) as f:
        m = sio.loadmat(f)
    _, delay, dop, _ = kept["truths"][("OP", "_2")]
    # the archive holds the result's indice and correction as they are
    tracked = m["indice1"].ravel() + m["correction1"].ravel() / 3.0
    d_err = float(np.median(tracked) - folded_delay(delay))
    df_err = float(np.abs(m["df"].ravel() - (dop + B_RANGING_SHIFT_HZ)).max())
    log(f"  claudio batch archive: median delay err {d_err:+.5f} sample (folded truth "
        f"{folded_delay(delay):.4f}), max |df - truth| {df_err:.4f} Hz over "
        f"{m['df'].size} codes")
    if abs(d_err) > TW_DELAY_TOL or df_err > TW_DF_TOL:
        raise RuntimeError("batch --chain claudio: truth check failed")
    out["claudio"].update(delay_err_samples=d_err, df_err_hz=df_err)
    # the input put back: the archive is there, so the capture is skipped
    cap = os.path.join(cdir, name)
    os.replace(os.path.join(cdir, "donetw", name), cap)
    rep_out, _ = run_verb(["batch", cdir, code9, "--device", str(dev)])
    rep = json.loads(rep_out.strip().splitlines()[-1])
    if rep != {"processed": [], "skipped": [cap], "failed": []} or not os.path.exists(cap):
        raise RuntimeError(f"batch --chain claudio over a done capture: {rep}")
    log(f"  claudio: {name} put back is skipped (its archive exists) and stays in place")
    out["claudio"]["resume_skipped"] = [name]
    os.makedirs(os.path.join(root, "walk"), exist_ok=True)
    os.replace(cap, os.path.join(root, "walk", name))  # for W5 and W6

    # -- B4. process_directory: pattern, ranging, no gzip, no move, a keyword
    t0 = time.perf_counter()
    rep = pipeline.process_directory(
        cdir, kept["codes"]["LTFB"], cfg, station=StationConfig(op=True), chain="claudio",
        pattern="*_1.bin", remote=True, ranging=False, gzip_outputs=False,
        move_done=False, device=dev, transfer="int8")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rcap = os.path.join(cdir, remote_name)
    mat = os.path.join(cdir, "remoteclaudio" + remote_name.replace(".bin", ".mat"))
    if rep.processed != [rcap] or rep.skipped or rep.failed or not os.path.exists(rcap) \
            or not os.path.exists(mat) or os.path.exists(mat + ".gz") \
            or os.listdir(os.path.join(cdir, "donetw")) != []:
        raise RuntimeError(f"process_directory without gzip and move: {rep}, "
                           f"{sorted(os.listdir(cdir))}")
    n_fields = mat_fields_equal(mat, kept["OP_1_mat"])
    log(f"B4 process_directory(pattern='*_1.bin', remote=True, ranging=False, "
        f"gzip_outputs=False, move_done=False, transfer='int8'): wall {wall:.3f} s, "
        f"processed {remote_name}, bare .mat equal to the two-way phase's claudio "
        f"verb archive in {n_fields} fields, nothing gzipped or moved")
    out["process_directory"] = {"wall_s": wall, "mat_fields": n_fields,
                                "processed": [os.path.basename(p) for p in rep.processed]}
    os.replace(rcap, os.path.join(root, "walk", remote_name))  # for W5
    return out


class StampedOut(io.StringIO):
    """A stdout that keeps the monotonic time at which each line ended."""

    def __init__(self):
        super().__init__()
        self.times: list[float] = []

    def write(self, text):
        n = super().write(text)
        self.times.extend([time.monotonic()] * text.count("\n"))
        return n


def dllpll_verb(work: str, name: str, cap: str, truths: dict, dev, *extra: str,
                fc_hz: float = 0.0, frange: float = 4000.0, sic: bool = True,
                stream_times: list | None = None) -> dict:
    """``twstft-torch dllpll`` in-process on ``cap`` with ``truths``'
    ``sdr.param`` and a fresh ``--out-dir``; raises unless it exits 0.
    With ``stream_times``, the monotonic time at which ``run_stream``
    yields each second is appended to it.  Returns the printed rows
    (:func:`parse_rows`), the printed lines with their times, the
    ``rxcomplex.log`` lines, the standard error and the wall time."""
    from amaranth_twstft_tpu_torch import cli
    from amaranth_twstft_tpu_torch.models import tracker

    param, taps_map = write_param(os.path.join(work, f"{name}.param"), truths, fc_hz,
                                  frange, sic)
    out_dir = os.path.join(work, f"{name}_out")
    shutil.rmtree(out_dir, ignore_errors=True)
    stdout, stderr = StampedOut(), io.StringIO()
    orig_stream = tracker.BankedReceiver.run_stream

    def stamped(self, *a, **kw):
        for reports in orig_stream(self, *a, **kw):
            stream_times.append(time.monotonic())
            yield reports

    if stream_times is not None:
        tracker.BankedReceiver.run_stream = stamped
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
            rc = cli.main(["dllpll", cap, "--param", param, "--out-dir", out_dir,
                           "--fs", repr(FS), "--bitlen", str(BIT_LEN), "--code-len",
                           str(CODE_LEN), "--taps-map", taps_map, "--device", str(dev),
                           *extra])
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        tracker.BankedReceiver.run_stream = orig_stream
    if rc != 0:
        raise RuntimeError(f"dllpll {name} exited {rc}")
    with open(os.path.join(out_dir, "rxcomplex.log")) as f:
        rxlog = f.read().splitlines()
    shutil.rmtree(out_dir)
    lines = stdout.getvalue().splitlines()
    printed = [(t, ln) for t, ln in zip(stdout.times, lines) if not ln.startswith("#")]
    return {"rows": parse_rows(stdout.getvalue()), "printed": printed, "log": rxlog,
            "stderr": stderr.getvalue(), "wall": wall}


def rows_vs(what: str, rows: dict, ref: dict, seconds: int) -> dict:
    """A dllpll run's printed rows against another run's over the first
    ``seconds``: the same rows, ``cnt`` identical, fc within HOST_CPU_FC_HZ
    and gd within HOST_CPU_GD_NS (step 18's tolerance); records whether the
    printed values are equal."""
    want = {k: v for k, v in ref.items() if k[0] < seconds}
    if not want or set(rows) != set(want):
        raise RuntimeError(f"{what}: rows differ ({len(rows)} / {len(want)})")
    worst_fc = worst_gd = 0.0
    for k, (fc, cnt, gd) in want.items():
        got = rows[k]
        if got[1] != cnt:
            raise RuntimeError(f"{what}: cnt {got[1]} / {cnt} at {k}")
        worst_fc = max(worst_fc, abs(got[0] - fc))
        worst_gd = max(worst_gd, abs(got[2] - gd))
    if worst_fc > HOST_CPU_FC_HZ or worst_gd > HOST_CPU_GD_NS:
        raise RuntimeError(f"{what}: fc {worst_fc} Hz, gd {worst_gd} ns")
    same = all(rows[k] == v for k, v in want.items())
    log(f"  {what}: {len(want)} rows, cnt identical, max |fc| diff {worst_fc:.2e} Hz, "
        f"max |gd| diff {worst_gd:.2e} ns; printed values equal: {same}")
    return {"rows": len(want), "max_fc_diff_hz": worst_fc, "max_gd_diff_ns": worst_gd,
            "identical": same}


def card_vs_cpu(what: str, card: dict, cpu: dict) -> dict:
    """Step 18's comparison for a dllpll run on the card against the same
    verb on the CPU over its first seconds: :func:`rows_vs` (the same
    reports, ``cnt`` identical, fc within HOST_CPU_FC_HZ and gd within
    HOST_CPU_GD_NS) and the CPU's ``rxcomplex.log`` lines the card's first
    lines."""
    seconds = 1 + max(k[0] for k in cpu["rows"]) if cpu["rows"] else 0
    vs = rows_vs(f"{what} card vs the port on the CPU over the first {seconds} s "
                 f"({cpu['wall']:.1f} s on the CPU)", cpu["rows"], card["rows"], seconds)
    if card["log"][: len(cpu["log"])] != cpu["log"]:
        raise RuntimeError(f"{what} card vs CPU: rxcomplex.log lines differ")
    log(f"  {what} card vs CPU: the same {len(cpu['log'])} rxcomplex.log lines")
    return {**vs, "log_lines": len(cpu["log"]), "cpu_wall_s": cpu["wall"]}


def truth_gate(what: str, rows: dict, truths: dict, second: int) -> dict:
    """Every channel of ``truths`` reports at ``second`` within 0.5 Hz and
    a quarter sample of its truth."""
    locked, ok, worst_df, worst_gd = check_truths(rows, truths, second)
    log(f"  {what}: second {second}: {locked} of {len(truths)} channels report, {ok} "
        f"within 0.5 Hz and 0.25 sample (worst |df| {worst_df:.4f} Hz, worst |gd| "
        f"{worst_gd:.4f} sample)")
    if locked != len(truths) or ok != locked:
        bad = {k: (truths[k], rows.get((second, *k))) for k in truths
               if check_truths(rows, {k: truths[k]}, second)[1] != 1}
        raise RuntimeError(f"{what}: {locked} of {len(truths)} report, {ok} on truth; "
                           f"off truth (truth, report): {bad}")
    return {"worst_df_hz": worst_df, "worst_gd_samples": worst_gd}


def param_channels(param: str, truths: dict) -> list:
    """The channels the dllpll verb builds from ``param`` (each PRN's taps
    from ``truths``)."""
    from amaranth_twstft_tpu_torch.models import dllpll

    with open(param) as f:
        return [dataclasses.replace(c, bit_len=BIT_LEN, code_len=CODE_LEN,
                                    taps=truths[(c.physical, c.prn_id)].taps)
                for c in dllpll.parse_sdr_param(f.read())]


def run_bank(rx, secs: list, prefetch: bool = True, between=None) -> dict:
    """Drive ``rx.run_stream`` over ``secs`` with the window-form launch
    count set to 0 just before; ``between(s, rx)`` runs after second s's
    reports.  Returns the reports as tuples, the rows (as
    :func:`parse_rows` gives them), the wall between two seconds' reports,
    the bytes of each upload and the launches."""
    from amaranth_twstft_tpu_torch.ops import lagbank

    sizes: list[int] = []
    dtypes: set = set()
    upload = rx.upload_second

    def counted_upload(sec, **kw):
        pending = upload(sec, **kw)
        sizes.append(pending.dev.numel() * pending.dev.element_size())
        dtypes.add(str(pending.dev.dtype))
        return pending

    rx.upload_second = counted_upload
    kept, rows, walls = [], {}, []
    lagbank.lag_bank_kernel.launches = 0
    try:
        t_prev = time.perf_counter()
        for s, reports in enumerate(rx.run_stream(iter(secs), prefetch=prefetch)):
            walls.append(time.perf_counter() - t_prev)
            kept.append([r and dataclasses.astuple(r) for r in reports])
            for ch, r in zip(rx.channels, reports):
                if r is not None:
                    rows[(s, ch.cfg.physical, ch.cfg.prn_id)] = (r.fc_hz, r.cnt, r.gd_ns)
            if between is not None:
                between(s, rx)
            t_prev = time.perf_counter()
    finally:
        del rx.upload_second
    return {"kept": kept, "rows": rows, "walls": walls, "sizes": sizes,
            "dtypes": sorted(dtypes), "launches": lagbank.lag_bank_kernel.launches}


def d1_transfers(work: str, truths: dict, dev, secs: list) -> dict:
    """D1 and D6: every transfer format through ``run_stream`` on the main
    path's capture and channels, then ``reload_params`` mid-stream on the
    int8 receiver."""
    from amaranth_twstft_tpu_torch.models import tracker
    from amaranth_twstft_tpu_torch.models.dllpll import TrackState

    param, _ = write_param(os.path.join(work, "d1.param"), truths)
    chans = param_channels(param, truths)
    n_chan = len(chans)
    t0 = time.perf_counter()
    base = tracker.BankedReceiver(chans, fs=FS, group=8, device=dev)
    arrays = {"wav_ext": base.bank.wav_ext, "psbb": base.bank.psbb,
              "fcode_ri": base.bank.fcode_ri, "_buf_idx": base._buf_idx}
    fresh_states = [dataclasses.asdict(TrackState(fc=c.fc_init_hz)) for c in chans]
    log(f"D1 bank of {n_chan} channels built in {time.perf_counter() - t0:.1f} s")
    del base

    def fresh(transfer):
        return tracker.BankedReceiver.from_reference(
            chans, arrays, fresh_states, fs=FS, group=8, transfer=transfer, device=dev)

    out: dict = {"formats": {}, "launches": {}}
    last = D_SECONDS - 1
    for transfer in D_TRANSFERS:
        rx = fresh(transfer)
        run = run_bank(rx, secs[:D_SECONDS])
        steady = float(np.median(run["walls"][2:]))
        per_s = run["sizes"][0]
        log(f"D1 {transfer}: {per_s / 1e6:.2f} MB uploaded per second of samples "
            f"({per_s} B, {run['dtypes']}); "
            f"{n_chan / steady:.1f} tracked channel-s/s (median wall of seconds "
            f"2-{last}: {steady:.4f} s; walls {[round(w, 4) for w in run['walls']]}); "
            f"{run['launches']} window-form launches")
        gate = truth_gate(f"D1 {transfer}", run["rows"], truths, last)
        entry = {"bytes_per_s": per_s, "dtypes": run["dtypes"],
                 "channel_s_per_s": n_chan / steady,
                 "walls_s": run["walls"], **gate}
        out["launches"][f"d1_{transfer}"] = run["launches"]
        if transfer in ("int4", "int2"):
            rx_np = fresh(transfer)
            run_np = run_bank(rx_np, secs[:D_SECONDS], prefetch=False)
            same = (run_np["kept"] == run["kept"] and rx_np.log == rx.log
                    and [dataclasses.asdict(s) for s in rx_np.states]
                    == [dataclasses.asdict(s) for s in rx.states])
            if not same:
                raise RuntimeError(f"D1 {transfer}: prefetch on and off differ")
            log(f"  D1 {transfer}: prefetch on and off give the same bits (reports, "
                f"log, states)")
            entry["prefetch_identical"] = True
            out["launches"][f"d1_{transfer}_no_prefetch"] = run_np["launches"]
        if transfer == "int8":
            int8_states = [dataclasses.asdict(s) for s in rx.states]
        out["formats"][transfer] = entry

    # -- D6. reload_params mid-stream on the int8 receiver ---------------------
    rows_txt = [ln for ln in open(param).read().splitlines() if not ln.startswith("#")]
    f = rows_txt[D_RELOAD_ROWS[0]].split()
    f[3] = "500.0"  # the row's fc
    rows_txt[D_RELOAD_ROWS[0]] = " ".join(f)
    f = rows_txt[D_RELOAD_ROWS[1]].split()
    f[8] = "5"  # the row's SNR gate, dB
    rows_txt[D_RELOAD_ROWS[1]] = " ".join(f)
    text = "\n".join(rows_txt) + "\n"
    got: dict = {}

    def reload_after_two(s, rx):
        if s == 2:
            t = time.perf_counter()
            got["changed"] = rx.reload_params(text)
            got["reload_s"] = time.perf_counter() - t
        elif s == 3:
            got["states"] = [dataclasses.asdict(st) for st in rx.states]

    rx = fresh("int8")
    run = run_bank(rx, secs[:N_SECONDS], between=reload_after_two)
    out["launches"]["d6_reload"] = run["launches"]
    if got["changed"] != list(D_RELOAD_ROWS):
        raise RuntimeError(f"D6: reload_params returned {got['changed']}")
    kept = [i for i in range(n_chan) if i not in D_RELOAD_ROWS]
    diff = [i for i in kept if got["states"][i] != int8_states[i]]
    if diff:
        raise RuntimeError(f"D6: unchanged channels {diff[:5]} differ after second 3")
    for i in D_RELOAD_ROWS:
        if not (got["states"][i]["is_trk"] and got["states"][i]["is_first"]):
            raise RuntimeError(f"D6: changed row {i} did not re-acquire at second 3")
    changed_truths = {(c.physical, c.prn_id): truths[(c.physical, c.prn_id)]
                      for c in (chans[i] for i in D_RELOAD_ROWS)}
    gate = truth_gate("D6 changed rows after the reload", run["rows"], changed_truths,
                      N_SECONDS - 1)
    gate_all = truth_gate("D6 every row", run["rows"], truths, N_SECONDS - 1)
    log(f"D6 reload_params after second 2: returned {got['changed']} in "
        f"{got['reload_s']:.2f} s (rows {D_RELOAD_ROWS[0]}: fc 0 -> 500 Hz, "
        f"{D_RELOAD_ROWS[1]}: SNR gate 7 -> 5 dB); the {len(kept)} unchanged channels' "
        f"states after second 3 equal the D1 int8 run's bit for bit; the changed rows "
        f"re-acquired and report on their truths at second {N_SECONDS - 1}")
    out["reload"] = {"changed": got["changed"], "reload_s": got["reload_s"],
                     "kept_states_identical": len(kept), "changed_rows": gate,
                     "every_row": gate_all}
    return out


def d2_sic(work: str, dev, seed: int, taps: list[int], launches: dict) -> dict:
    """D2: SIC rows.  Strong emissions (the two-way loopbacks' amplitude)
    and weak ones on ``S`` rows (the remotes' amplitude) on each input."""
    cap = os.path.join(work, "sic.sc16")
    truths = synthesize(dev, seed + 2, taps, cap, n_seconds=D_SECONDS, groups=[
        Emissions(2, amplitude=TW_LOOPBACK_AMPLITUDE),
        Emissions(2, amplitude=TW_REMOTE_AMPLITUDE, sic=True)], dop_span=D_DOP_SPAN)
    kw = dict(frange=D_FRANGE)
    from amaranth_twstft_tpu_torch.ops import lagbank

    lagbank.lag_bank_kernel.launches = 0
    card = dllpll_verb(work, "sic", cap, truths, dev, **kw)
    launches["d2_sic"] = lagbank.lag_bank_kernel.launches
    gate = truth_gate("D2 SIC", card["rows"], truths, D_SECONDS - 1)
    weak = {k: v for k, v in truths.items() if v.sic}
    for phys, prn in weak:
        line = f"code lock   : Ch. {phys}, PRN#{prn + 50}, count ="
        if not any(ln.startswith(line) for ln in card["log"]):
            raise RuntimeError(f"D2: no code lock line for SIC channel {prn} (#{prn + 50})")
    log(f"D2 dllpll with {len(weak)} SIC rows of {len(truths)}: wall {card['wall']:.3f} s "
        f"for {D_SECONDS} s; rxcomplex.log has each SIC channel's code lock (PRN id + "
        f"50); {launches['d2_sic']} window-form launches")
    cpu = dllpll_verb(work, "sic_cpu", cap, truths, "cpu", "--seconds",
                      str(D_CPU_SECONDS), **kw)
    vs = card_vs_cpu("D2 SIC", card, cpu)
    lagbank.lag_bank_kernel.launches = 0
    as_n = dllpll_verb(work, "sic_as_n", cap, truths, dev, sic=False, **kw)
    launches["d2_rows_as_n"] = lagbank.lag_bank_kernel.launches
    locked_n, ok_n, df_n, gd_n = check_truths(as_n["rows"], weak, D_SECONDS - 1)
    log(f"  D2 the same rows marked N: {locked_n} of {len(weak)} weak channels report "
        f"at second {D_SECONDS - 1}, {ok_n} on their truths (worst |df| {df_n:.4f} Hz, "
        f"|gd| {gd_n:.4f} sample); wall {as_n['wall']:.3f} s")
    os.remove(cap)
    return {"channels": len(truths), "sic_rows": len(weak), "wall_s": card["wall"],
            **gate, "vs_cpu": vs, "weak_as_n": {"report": locked_n, "on_truth": ok_n,
                                                "worst_df_hz": df_n,
                                                "worst_gd_samples": gd_n}}


def d3_real(work: str, dev, seed: int, taps: list[int], launches: dict) -> dict:
    """D3: ``--real``: real samples on the I columns, the emissions on a
    carrier at fs/5."""
    from amaranth_twstft_tpu_torch.ops import lagbank

    cap = os.path.join(work, "real.sc16")
    truths = synthesize(dev, seed + 3, taps, cap, n_seconds=D_SECONDS,
                        groups=[Emissions(4)], dop_span=D_DOP_SPAN,
                        carrier_hz=D_CARRIER_HZ, real=True)
    kw = dict(fc_hz=D_CARRIER_HZ, frange=D_FRANGE)
    lagbank.lag_bank_kernel.launches = 0
    card = dllpll_verb(work, "real", cap, truths, dev, "--real", **kw)
    launches["d3_real"] = lagbank.lag_bank_kernel.launches
    log(f"D3 dllpll --real, {len(truths)} channels on a {D_CARRIER_HZ / 1e6:g} MHz "
        f"carrier: wall {card['wall']:.3f} s for {D_SECONDS} s; "
        f"{launches['d3_real']} window-form launches")
    gate = truth_gate("D3 --real", card["rows"], truths, D_SECONDS - 1)
    cpu = dllpll_verb(work, "real_cpu", cap, truths, "cpu", "--real", "--seconds",
                      str(D_CPU_SECONDS), **kw)
    vs = card_vs_cpu("D3 --real", card, cpu)
    os.remove(cap)
    return {"channels": len(truths), "wall_s": card["wall"], **gate, "vs_cpu": vs}


def d4_mixed(work: str, dev, seed: int, taps: list[int], launches: dict) -> dict:
    """D4: two chip rates in one ``sdr.param`` (``MultiBankReceiver``), and
    the window-form kernel at the slower geometry's launch shape."""
    from amaranth_twstft_tpu_torch.models import tracker
    from amaranth_twstft_tpu_torch.ops import lagbank

    cap = os.path.join(work, "mixed.sc16")
    truths = synthesize(dev, seed + 4, taps, cap, n_seconds=D_SECONDS, groups=[
        Emissions(4), Emissions(4, chip_rate=D_SLOW_CHIP_RATE)], dop_span=D_DOP_SPAN)
    slow_nobs = code_samples(D_SLOW_CHIP_RATE)
    kw = dict(frange=D_FRANGE)
    lb: dict = {}
    orig_lb = tracker.lag_bank_windows

    def keep_slow(obs, wav_ext, nlag, power_scale=0.5):
        if obs.shape[-1] == slow_nobs:
            lb.update(obs=obs, wav_ext=wav_ext, nlag=nlag, power_scale=power_scale)
        return orig_lb(obs, wav_ext, nlag, power_scale)

    lagbank.lag_bank_kernel.launches = 0
    tracker.lag_bank_windows = keep_slow
    try:
        card = dllpll_verb(work, "mixed", cap, truths, dev, **kw)
    finally:
        tracker.lag_bank_windows = orig_lb
    launches["d4_mixed"] = lagbank.lag_bank_kernel.launches
    if "2 channel geometries" not in card["stderr"]:
        raise RuntimeError("D4: the verb did not report two geometry groups")
    order = [int(ln.split()[2][3:]) for _, ln in card["printed"]
             if int(ln.split()[0]) == D_SECONDS - 1]
    if order != sorted(k[1] for k in truths):
        raise RuntimeError(f"D4: rows of second {D_SECONDS - 1} in order {order}")
    log(f"D4 dllpll with {len(truths)} channels at {CHIP_RATE / 1e3:g} and "
        f"{D_SLOW_CHIP_RATE / 1e3:g} kcps: two geometry groups (MultiBankReceiver), "
        f"rows in sdr.param's order; wall {card['wall']:.3f} s for {D_SECONDS} s; "
        f"{launches['d4_mixed']} window-form launches")
    gate = truth_gate("D4 mixed geometries", card["rows"], truths, D_SECONDS - 1)
    cpu = dllpll_verb(work, "mixed_cpu", cap, truths, "cpu", "--seconds",
                      str(D_CPU_SECONDS), **kw)
    vs = card_vs_cpu("D4 mixed geometries", card, cpu)
    os.remove(cap)

    # the window form at the slower geometry's launch shape
    (abs_err, pow_err, ph_err), kern64, plain64, w_mat = check_kernel(lb)
    obs, wav_ext, nlag, scale = lb["obs"], lb["wav_ext"], lb["nlag"], lb["power_scale"]
    G, _, P, K = obs.shape
    nl = 2 * nlag + 1
    ms = cuda_ms(lambda: lagbank.lag_bank_windows(obs, wav_ext, nlag, scale), 20)
    plain_ms = cuda_ms(lambda: lagbank.lag_bank_windows_plain(obs, wav_ext, nlag, scale), 5)
    nbytes = 4.0 * (obs.numel() + wav_ext.numel() + 4 * G * P * nl)
    bound_bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    bound_tf32x3_ms = 1e3 * 3 * (2.0 * 2 * G * P * nl * K) / PEAK_TF32_FLOPS
    log(f"  window form at (G, P, K, NL) = ({G}, {P}, {K}, {nl}): kernel {ms:.4f} ms per "
        f"launch, plain {plain_ms:.4f} ms (CUDA events); bytes floor {bound_bytes_ms:.4f} "
        f"ms ({nbytes:.3e} B), 3xTF32 bound {bound_tf32x3_ms:.4f} ms -> "
        f"{100 * max(bound_bytes_ms, bound_tf32x3_ms) / ms:.1f}% of the bound")
    del lb, obs, wav_ext, w_mat
    return {"channels": len(truths), "wall_s": card["wall"], **gate, "vs_cpu": vs,
            "slow_launch": {"shape": [G, P, K, nl], "ms": ms, "plain_ms": plain_ms,
                            "bound_bytes_ms": bound_bytes_ms,
                            "bound_tf32x3_ms": bound_tf32x3_ms, "max_abs_err": abs_err,
                            "max_err_over_row_max": pow_err,
                            "max_phase_err_cycles": ph_err, "f64_err": kern64[0],
                            "plain_f64_err": plain64[0]}}


def d5_follow(work: str, cap: str, truths: dict, dev, launches: dict) -> dict:
    """D5: ``dllpll --follow`` on a file that a writer thread grows from
    the main capture, one second per second, against a run without
    ``--follow`` on the finished file."""
    from amaranth_twstft_tpu_torch.ops import lagbank

    fs, nobs = int(FS), code_samples(CHIP_RATE)
    grow = os.path.join(work, "follow.sc16")
    open(grow, "wb").close()
    appended: list[float] = []
    writer_error: list[BaseException] = []

    def writer():
        try:
            with open(cap, "rb") as src, open(grow, "ab") as dst:
                t_start = time.monotonic()
                for k in range(D_SECONDS):
                    # one second per second, as a receiver writes; the last
                    # append carries the one code the last second reads on
                    time.sleep(max(0.0, t_start + k - time.monotonic()))
                    dst.write(src.read(8 * (fs + (nobs if k == D_SECONDS - 1 else 0))))
                    dst.flush()
                    appended.append(time.monotonic())
        except BaseException as e:  # noqa: BLE001 — raised below
            writer_error.append(e)

    yielded: list[float] = []
    wt = threading.Thread(target=writer, daemon=True)
    lagbank.lag_bank_kernel.launches = 0
    wt.start()
    followed = dllpll_verb(work, "follow", grow, truths, dev, "--follow",
                           "--idle-timeout", "2", stream_times=yielded)
    launches["d5_follow"] = lagbank.lag_bank_kernel.launches
    wt.join(timeout=60.0)
    if wt.is_alive() or writer_error:
        raise RuntimeError(f"D5: the writer failed: {writer_error}")
    finished = dllpll_verb(work, "finished", grow, truths, dev)
    if [ln for _, ln in followed["printed"]] != [ln for _, ln in finished["printed"]] \
            or followed["log"] != finished["log"]:
        raise RuntimeError("D5: --follow printed other rows than the finished file's run")
    gate = truth_gate("D5 --follow", followed["rows"], truths, D_SECONDS - 1)
    lags = [y - a for y, a in zip(yielded, appended)]
    row_lags = {}
    for t, ln in followed["printed"]:
        s = int(ln.split()[0])
        row_lags[s] = t - appended[s]
    log(f"D5 dllpll --follow --idle-timeout 2 on a file grown one second per second: "
        f"{len(followed['printed'])} rows equal to the finished file's run, the same "
        f"log; wall {followed['wall']:.3f} s (finished file {finished['wall']:.3f} s); "
        f"lag from each second's append to its reports {[round(x, 3) for x in lags]} s, "
        f"to its last printed row {({k: round(v, 3) for k, v in row_lags.items()})} s "
        f"(run_stream reports second k once second k+1 is uploaded)")
    os.remove(grow)
    return {"rows": len(followed["printed"]), "wall_s": followed["wall"],
            "finished_wall_s": finished["wall"], "lag_s": lags,
            "row_lag_s": row_lags, **gate}


def modes_phase(work: str, cap: str, truths: dict, dev, seed: int,
                taps: list[int]) -> dict:
    """Phase D: the DLL/PLL receiver's modes; returns the numbers of the
    ``{"dllpll_modes": ...}`` line."""
    nobs = code_samples(CHIP_RATE)
    t0 = time.perf_counter()
    secs = list(sc16_seconds(cap, N_SECONDS, nobs))
    log(f"D: {N_SECONDS} s of the main capture read in {time.perf_counter() - t0:.1f} s")
    out = d1_transfers(work, truths, dev, secs)
    del secs
    launches = out["launches"]
    out["follow"] = d5_follow(work, cap, truths, dev, launches)
    out["sic"] = d2_sic(work, dev, seed, taps, launches)
    out["real"] = d3_real(work, dev, seed, taps, launches)
    out["mixed"] = d4_mixed(work, dev, seed, taps, launches)
    idle = [k for k, n in launches.items() if n <= 0]
    if idle:
        raise RuntimeError(f"D: the window-form kernel never launched on {idle}")
    return out


def parity_capture(work: str) -> dict:
    """The JAX suite's fractional-delay capture (``tests_tpu/
    test_device_parity.py:22-48``, its arithmetic copied): ``P_EPOCHS``
    epochs at production geometry, channel 1 at a delay of 1234 plus a
    uniform fraction per epoch, amplitude 800 in noise 300, channel 2 at
    56.25 samples, amplitude 2000 in noise 150, both at 0 Hz."""
    from amaranth_twstft_tpu_torch.config import SignalConfig
    from amaranth_twstft_tpu_torch.ops.lfsr import prn_chips, write_prn_file
    from amaranth_twstft_tpu_torch.ops.prn import chips_to_pm1, upsample_zoh

    cfg = SignalConfig()
    L = cfg.samples_per_code
    code64 = chips_to_pm1(upsample_zoh(prn_chips(cfg.bit_len, cfg.taps, cfg.code_len),
                                       cfg.samples_per_chip), np.float64)
    spec = np.fft.fft(code64)
    k = np.fft.fftfreq(L)
    rng = np.random.default_rng(42)
    fracs = rng.uniform(0, 1, P_EPOCHS)
    pdir = os.path.join(work, "parity")
    os.makedirs(pdir, exist_ok=True)
    cap, code = os.path.join(pdir, "cap.bin"), os.path.join(pdir, "code.bin")
    write_prn_file(code, cfg.bit_len, cfg.code_len, cfg.taps)
    frames = np.empty((P_EPOCHS * L, 4), np.int16)
    for i in range(P_EPOCHS):
        s = np.fft.ifft(spec * np.exp(-2j * np.pi * k * (1234 + fracs[i])))
        z1 = 800 * s + rng.normal(0, 300, L) + 1j * rng.normal(0, 300, L)
        z2 = (2000 * np.fft.ifft(spec * np.exp(-2j * np.pi * k * 56.25))
              + rng.normal(0, 150, L) + 1j * rng.normal(0, 150, L))
        sl = slice(i * L, (i + 1) * L)
        frames[sl, 0] = np.clip(np.round(z1.real), -32768, 32767)
        frames[sl, 1] = np.clip(np.round(z1.imag), -32768, 32767)
        frames[sl, 2] = np.clip(np.round(z2.real), -32768, 32767)
        frames[sl, 3] = np.clip(np.round(z2.imag), -32768, 32767)
    frames.tofile(cap)
    return {"dir": pdir, "cap": cap, "code": code, "code64": code64, "spec": spec,
            "fracs": fracs}


def oracle_delays(cap: str, code: str, df: float) -> np.ndarray:
    """Channel 1's delay per epoch from the port's complex128 correlator on
    the CPU (the full zero-padded IFFT, nint = 1, Hamming-windowed code),
    the float64 oracle of ``tests_tpu/test_device_parity.py:50-80``."""
    from amaranth_twstft_tpu_torch.config import ProcessingConfig, SignalConfig
    from amaranth_twstft_tpu_torch.models.godual import build_replica
    from amaranth_twstft_tpu_torch.ops.correlator import correlate_epochs
    from amaranth_twstft_tpu_torch.utils import io as sc16

    cfg = SignalConfig()
    rep = build_replica(code, cfg, ProcessingConfig(hamming_window=True),
                        dtype=torch.complex128)
    d, n = sc16.read_sc16_epochs(cap, 0, P_EPOCHS, rep.samples_per_code,
                                 dtype=np.complex128)
    res = correlate_epochs(
        torch.from_numpy(d[0, :n]), torch.from_numpy(rep.fcode),
        torch.full((n,), df, dtype=torch.float64), torch.from_numpy(rep.code_interp),
        cfg.fs, fcode_interp=torch.from_numpy(rep.fcode_interp)).to_host()
    return (res.indice.astype(np.float64) + res.correction) / 3.0


def parity_phase(work: str, dev) -> dict:
    """Steps P1-P3; returns the numbers of the ``{"parity": ...}`` line."""
    from amaranth_twstft_tpu_torch import pipeline
    from amaranth_twstft_tpu_torch.config import ProcessingConfig, SignalConfig
    from amaranth_twstft_tpu_torch.ops import boundary
    from amaranth_twstft_tpu_torch.ops.doppler import (
        PREPASS_MAX_SAMPLES,
        bound_prepass_window,
        per_file_df_ri,
    )
    from amaranth_twstft_tpu_torch.ops.prn import interp_code
    from amaranth_twstft_tpu_torch.utils import io as sc16

    cfg = SignalConfig()
    ps_per_sample = 1e12 / cfg.fs
    t0 = time.perf_counter()
    pc = parity_capture(work)
    log(f"P capture: {P_EPOCHS} epochs x 2 channels in {time.perf_counter() - t0:.1f} s")
    out: dict = {"forms": {}}
    oracles: dict = {}
    # -- P1. every ingest form against the float64 oracle ------------------
    for mode in ("float16", "int8", "int8-pow2", "sc16"):
        if mode == "int8-pow2":
            os.environ["TWSTFT_Q8_POW2"] = "1"
        try:
            t0 = time.perf_counter()
            o = pipeline.process_capture_overlapped(
                pc["cap"], pc["code"], cfg, ProcessingConfig(hamming_window=True),
                batch_epochs=P_BATCH, ingest_dtype=mode.split("-")[0],
                out_mat=os.path.join(pc["dir"], f"o_{mode}.mat"), device=dev)
            wall = time.perf_counter() - t0
        finally:
            os.environ.pop("TWSTFT_Q8_POW2", None)
        df = float(o["df"][0])
        if df not in oracles:
            t0 = time.perf_counter()
            oracles[df] = oracle_delays(pc["cap"], pc["code"], df)
            log(f"P oracle at df {df!r} Hz: {time.perf_counter() - t0:.2f} s")
        d_t = delays_samples(o["ch1"])
        if len(d_t) != P_EPOCHS:
            raise RuntimeError(f"parity {mode}: {len(d_t)} epochs")
        err_ps = np.abs(d_t - oracles[df]) * ps_per_sample
        p50, p99 = (float(np.percentile(err_ps, q)) for q in (50, 99))
        mx = float(err_ps.max())
        out["forms"][mode] = {"p50_ps": p50, "p99_ps": p99, "max_ps": mx,
                              "bound_p99_ps": P99_BOUND_PS[mode], "df_hz": df,
                              "wall_s": wall}
        log(f"P1 {mode}: p50 {p50:.2f} p99 {p99:.2f} max {mx:.2f} ps against the float64 "
            f"oracle (p99 bound {P99_BOUND_PS[mode]:g}); df {df!r} Hz; run {wall:.3f} s")
        if not p99 < P99_BOUND_PS[mode]:
            raise RuntimeError(f"parity {mode}: p99 {p99} ps")
    # -- P2. nint = 4 at adversarial fractions ------------------------------
    L, r = cfg.samples_per_code, 9
    k = np.fft.fftfreq(L)
    spec = pc["spec"]
    fracs = np.asarray(NINT4_FRACS)
    step = boundary.make_ranging_step(
        np.conj(spec).astype(np.complex64),
        interp_code(pc["code64"].astype(np.float32), r).astype(np.float32),
        np.ones(L, bool), cfg.fs, nint=4, packed=True, device=dev)
    frames = np.empty((len(fracs), L, 2), np.float32)
    for i, fr in enumerate(fracs):
        s = np.fft.ifft(spec * np.exp(-2j * np.pi * k * (1234 + fr)))
        frames[i, :, 0], frames[i, :, 1] = 3000 * s.real, 3000 * s.imag
    rows = step(torch.from_numpy(frames).to(dev),
                df_fixed=torch.zeros(len(fracs), dtype=torch.float32, device=dev))
    res = boundary.to_epoch_result(boundary.unpack_outputs(rows.cpu().numpy()))
    d = (res.indice.astype(np.float64) + res.correction) / r
    err_ps = np.abs(d - (1234 + fracs)) * ps_per_sample
    log(f"P2 nint=4 at fractions {list(NINT4_FRACS)}: errors "
        f"{[round(float(e), 3) for e in err_ps]} ps, max {err_ps.max():.3f} "
        f"(bound {NINT4_BOUND_PS:g})")
    if not err_ps.max() < NINT4_BOUND_PS:
        raise RuntimeError(f"nint=4 bias {err_ps.max()} ps")
    out["nint4"] = {"errors_ps": err_ps.tolist(), "max_ps": float(err_ps.max()),
                    "bound_ps": NINT4_BOUND_PS}
    # -- P3. the int8-packed df pre-pass against the float32 one ------------
    # (tests_tpu/test_device_parity.py:120-154's arithmetic)
    proc = ProcessingConfig(hamming_window=True)
    dec = bound_prepass_window(sc16.decimate_sc16(
        pc["cap"], proc.df_decimation, channels=2, max_out=PREPASS_MAX_SAMPLES))
    bin_hz = cfg.fs / proc.df_decimation / dec.shape[-1]
    dfs = {}
    for dt in (np.float32, np.int8, np.int16):
        ri = torch.as_tensor(pipeline._pack_prepass(dec[0], dt)).to(dev)
        dfs[np.dtype(dt).name] = float(per_file_df_ri(ri, cfg.fs, proc.df_decimation))
    d8 = abs(dfs["int8"] - dfs["float32"])
    d16 = abs(dfs["int16"] - dfs["float32"])
    log(f"P3 df pre-pass: float32 {dfs['float32']!r} Hz, int8 {dfs['int8']!r} Hz, int16 "
        f"{dfs['int16']!r} Hz (bin {bin_hz:.6f} Hz); int8 {d8:.3e} Hz from float32 (bound "
        f"2 bins + 1e-6 Hz), int16 {d16:.3e} Hz (bound 1e-6 Hz)")
    if not (d8 <= 2 * bin_hz + 1e-6 and d16 <= 1e-6):
        raise RuntimeError(f"df pre-pass: int8 {d8} Hz, int16 {d16} Hz from float32")
    out["prepass"] = {"df_hz": dfs, "bin_hz": bin_hz, "int8_diff_hz": d8,
                      "int16_diff_hz": d16}
    shutil.rmtree(pc["dir"])
    return out


# -- phase W: the device options no earlier phase passed ----------------------
def lag_bounds(nbytes: float, flops: float) -> dict:
    """The card's least time for a lag bank: its bytes over the memory rate
    and its 3xTF32 products over the TF32 peak, the larger of the two."""
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    ops_ms = 1e3 * 3 * flops / PEAK_TF32_FLOPS
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_bytes_ms": bytes_ms, "bound_tf32x3_ms": ops_ms, "bytes": nbytes}


def walk_window_shape(lb: dict) -> dict:
    """The window form at one of W1's launch shapes: against its plain
    version (``compare_lag_banks``) and float64 (within W_F64_TOL of the
    row maximum), timed beside its plain version, ``torch.matmul`` of the
    same product and its bounds."""
    from amaranth_twstft_tpu_torch.ops import lagbank

    obs, wav_ext, nlag, scale = lb["obs"], lb["wav_ext"], lb["nlag"], lb["power_scale"]
    G, _, P, K = obs.shape
    nl = 2 * nlag + 1
    what = f"W1 window form at (G, P, K, NL) = ({G}, {P}, {K}, {nl})"
    kern = lagbank.lag_bank_windows(obs, wav_ext, nlag, scale)
    plain = lagbank.lag_bank_windows_plain(obs, wav_ext, nlag, scale)
    abs_err, rel_err, ph_err = compare_lag_banks(what, kern, plain)
    ref64 = lagbank.lag_bank_windows_plain(obs.double(), wav_ext.double(), nlag, scale)
    k64, p64 = lagbank.lag_bank_errors(kern, ref64), lagbank.lag_bank_errors(plain, ref64)
    del ref64, kern, plain
    if k64[0] > W_F64_TOL or k64[1] > W_F64_TOL:
        raise RuntimeError(f"{what}: float64 errors {k64}")
    ms = cuda_ms(lambda: lagbank.lag_bank_windows(obs, wav_ext, nlag, scale), 10)
    plain_ms = cuda_ms(lambda: lagbank.lag_bank_windows_plain(obs, wav_ext, nlag, scale), 3,
                       warmup=1)
    w_mat = wav_ext.unfold(-1, K, 1).flip(-2).transpose(-1, -2).contiguous()
    obs2 = obs.reshape(G, 2 * P, K)
    library_ms = cuda_ms(lambda: torch.matmul(obs2, w_mat), 5)
    del w_mat, obs2
    b = lag_bounds(4.0 * (obs.numel() + wav_ext.numel() + 4 * G * P * nl),
                   2.0 * 2 * G * P * nl * K)
    log(f"  {what}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul "
        f"{library_ms:.4f} ms (CUDA events); bytes floor {b['bound_bytes_ms']:.4f} ms "
        f"({b['bytes']:.3e} B), 3xTF32 {b['bound_tf32x3_ms']:.4f} ms -> "
        f"{100 * b['bound_ms'] / ms:.1f}% of the bound; float64 err {k64[0]:.3e} of the "
        f"row max, phase {k64[1]:.3e} cycles (fp32 plain {p64[0]:.3e}, {p64[1]:.3e})")
    return {"form": "window", "shape": [G, P, K, nl], "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, **b, "max_abs_err": abs_err,
            "max_err_over_row_max": rel_err, "max_phase_err_cycles": ph_err,
            "f64_err": k64[0], "f64_phase_err_cycles": k64[1], "plain_f64_err": p64[0],
            "plain_f64_phase_err_cycles": p64[1]}


def walk_explicit_shape(obs: torch.Tensor, w: torch.Tensor, times: dict) -> dict:
    """The explicit form at one of W1's host launch shapes, (2, C, K) x (K,
    NL): against its plain version and float64 (within W_F64_TOL of the
    row maximum), two launches the same bits, with its times from
    :func:`explicit_times` (``times``, measured in a fresh process on
    inputs of the same shape) beside its bounds."""
    from amaranth_twstft_tpu_torch.ops import lagbank

    _, C, K = obs.shape
    nl = w.shape[1]
    what = f"W1 explicit form at (2, {C}, {K}) x ({K}, {nl})"
    kern = lagbank.lag_bank_correlate(obs, w)
    again = lagbank.lag_bank_correlate(obs, w)
    if not all(torch.equal(a, b) for a, b in zip(kern, again)):
        raise RuntimeError(f"{what}: two launches differ")
    plain = lagbank.lag_bank_plain(obs, w)
    abs_err, rel_err, ph_err = compare_lag_banks(what, kern, plain)
    ref64 = lagbank.lag_bank_plain(obs.double(), w.double())
    k64, p64 = lagbank.lag_bank_errors(kern, ref64), lagbank.lag_bank_errors(plain, ref64)
    del ref64, kern, again, plain
    if k64[0] > W_F64_TOL or k64[1] > W_F64_TOL:
        raise RuntimeError(f"{what}: float64 errors {k64}")
    ms = times["ms"][0]
    b = lag_bounds(4.0 * (obs.numel() + w.numel() + 2 * C * nl), 2.0 * 2 * C * nl * K)
    log(f"  {what}: two launches the same bits; float64 err {k64[0]:.3e} of the row max, "
        f"phase {k64[1]:.3e} cycles (fp32 plain {p64[0]:.3e}, {p64[1]:.3e}); bytes floor "
        f"{b['bound_bytes_ms']:.4f} ms ({b['bytes']:.3e} B), 3xTF32 "
        f"{b['bound_tf32x3_ms']:.4f} ms -> {100 * b['bound_ms'] / ms:.1f}% of the bound")
    return {"form": "explicit", "shape": [2, C, K, nl], "ms": ms,
            **{k: times[k] for k in EXPLICIT_TIME_KEYS}, **b,
            "max_abs_err": abs_err, "max_err_over_row_max": rel_err,
            "max_phase_err_cycles": ph_err, "f64_err": k64[0], "f64_phase_err_cycles": k64[1],
            "plain_f64_err": p64[0], "plain_f64_phase_err_cycles": p64[1],
            "deterministic": True}


#: the explicit form's times that :func:`explicit_times` gives each shape
EXPLICIT_TIME_KEYS = ("device_ms", "host_ms", "kernels_per_call", "plain_ms", "library_ms",
                      "library_device_ms")
#: the explicit form's lag counts: the host receiver's --nlag 28, 32, 100, 201
EXPLICIT_NLS = (57, 65, 201, 403)
EXPLICIT_SEED = 14  # of explicit_times' inputs


def per_call_device(fn, reps: int = 10) -> tuple:
    """Device time per call (ms) and CUDA kernels per call of ``fn`` from
    ``torch.profiler``; the time is None unless the trace holds a whole
    number of kernels per call (a trace short of events would give a
    short time)."""
    dev_ms, ops, _ = profile_device(fn, reps)
    if ops is None or abs(ops - round(ops)) > 1e-9 or round(ops) < 1:
        return None, ops
    return dev_ms, ops


def explicit_times(tree: str, seed: int) -> dict:
    """The explicit (K, NL) form of the ``amaranth_twstft_tpu_torch`` in
    ``tree`` (this checkout, or a ``git archive`` of another commit) at
    the host receiver's shape (2, 24, 200 000) x (200 000, NL) for each of
    EXPLICIT_NLS, on seeded inputs: the call time by CUDA events (20 calls
    back to back, twice, first and last), the host time of a call, the
    device time and CUDA kernels per call (:func:`per_call_device`), the
    plain version's and ``torch.matmul``'s times, the float64 errors of
    the kernel and of the float32 plain version, and whether two launches
    give the same bits; then ``lag_bank_correlate_channels`` over two
    channels at NL 403 beside its per-channel calls, their plain versions
    and one batched ``torch.matmul``.  Run in a process of its own
    (``--explicit-times TREE``): a trace in a long-lived process can come
    back short of its device events."""
    sys.path.insert(0, os.path.abspath(tree))
    from amaranth_twstft_tpu_torch.ops import lagbank

    C, K = 24, 200_000
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    obs = torch.randn(2, C, K, generator=gen, device=dev)
    obs2 = obs.reshape(2 * C, K)
    out: dict = {"tree": tree}
    for nl in EXPLICIT_NLS:
        w = torch.randn(K, nl, generator=gen, device=dev)

        def call(w=w):
            return lagbank.lag_bank_correlate(obs, w)

        kern, again = call(), call()
        same = all(torch.equal(a, b) for a, b in zip(kern, again))
        plain = lagbank.lag_bank_plain(obs, w)
        ref64 = lagbank.lag_bank_plain(obs.double(), w.double())
        k64, p64 = lagbank.lag_bank_errors(kern, ref64), lagbank.lag_bank_errors(plain, ref64)
        del ref64, kern, again, plain
        ms = cuda_ms(call, 20)
        device_ms, ops = per_call_device(call)
        lib_device_ms, lib_ops = per_call_device(lambda w=w: torch.matmul(obs2, w))
        r = {"ms": [ms], "host_ms": host_ms(call), "device_ms": device_ms,
             "kernels_per_call": ops,
             "library_ms": cuda_ms(lambda w=w: torch.matmul(obs2, w), 20),
             "library_device_ms": lib_device_ms, "library_kernels_per_call": lib_ops,
             "plain_ms": cuda_ms(lambda w=w: lagbank.lag_bank_plain(obs, w), 10),
             "f64_err": k64, "plain_f64_err": p64, "deterministic": same}
        r["ms"].append(cuda_ms(call, 20))
        out[str(nl)] = r
        log(f"  NL {nl}: call {r['ms'][0]:.4f} / {r['ms'][1]:.4f} ms (CUDA events), host "
            f"{r['host_ms']:.4f} ms, device {device_ms} ms in {ops} kernels per call; "
            f"torch.matmul {r['library_ms']:.4f} ms (device {lib_device_ms} in {lib_ops}); "
            f"plain {r['plain_ms']:.4f} ms; float64 err {k64[0]:.3e} (plain {p64[0]:.3e}); "
            f"two launches the same bits: {same}")
        del w
    nl = EXPLICIT_NLS[-1]
    w = torch.randn(K, nl, generator=gen, device=dev)
    obs_c = torch.stack([obs, obs.flip(-1)])
    w_c = torch.stack([w, w.roll(1, 0)])
    obs_c2 = obs_c.reshape(2, 2 * C, K)
    ch_device_ms, ch_ops = per_call_device(lambda: lagbank.lag_bank_correlate_channels(obs_c, w_c))
    ch = {"ms": cuda_ms(lambda: lagbank.lag_bank_correlate_channels(obs_c, w_c), 10),
          "device_ms": ch_device_ms, "kernels_per_call": ch_ops,
          "per_channel_ms": cuda_ms(lambda: [lagbank.lag_bank_correlate(obs_c[i], w_c[i])
                                             for i in range(2)], 10),
          "plain_ms": cuda_ms(lambda: [lagbank.lag_bank_plain(obs_c[i], w_c[i])
                                       for i in range(2)], 5),
          "library_ms": cuda_ms(lambda: torch.matmul(obs_c2, w_c), 10)}
    out[f"channels_{nl}"] = ch
    log(f"  lag_bank_correlate_channels, 2 x NL {nl}: {ch['ms']:.4f} ms (device "
        f"{ch_device_ms} in {ch_ops} kernels per call); 2 single-channel calls "
        f"{ch['per_channel_ms']:.4f} ms, plain {ch['plain_ms']:.4f} ms, one batched "
        f"torch.matmul {ch['library_ms']:.4f} ms")
    return out


def fresh_explicit_times(tree: str, seed: int) -> dict:
    """:func:`explicit_times` of ``tree`` in a new process (its lines go to
    this log); fails if that process fails."""
    run = subprocess.run([sys.executable, os.path.abspath(__file__), "--explicit-times", tree,
                          "--seed", str(seed)], capture_output=True, text=True, timeout=600)
    for line in run.stdout.splitlines()[:-1]:
        log(line)
    if run.returncode != 0:
        raise RuntimeError(f"explicit_times({tree}) failed: {run.stderr[-2000:]}")
    return json.loads(run.stdout.splitlines()[-1])


#: the bank's second at production: fs + nobs samples of each of two inputs
PACK_SHAPE = (2, 5_200_000, 2)


def pack_times(seed: int) -> dict:
    """The device pack's kernel (``ops/pack.pack_rows``) at the bank's
    second, PACK_SHAPE float32 rows of int16-valued samples: its float16
    bits and statistics against the plain version, two launches' bits,
    its time by CUDA events (50 launches), its device time and kernels per
    call, the plain version's time on the card, and its bytes floor (the
    rows read once, their float16 written once, at 3.35 TB/s)."""
    from amaranth_twstft_tpu_torch.ops import pack

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(-2048, 2048, PACK_SHAPE, generator=gen, device=dev).float()
    nsum = 5_000_000
    half = torch.empty_like(x, dtype=torch.float16)
    stats = torch.empty(PACK_SHAPE[0] + 1, dtype=torch.float64, device=dev)

    def call():
        pack.pack_rows(x, nsum, half, stats)

    call()
    h1, s1 = half.clone(), stats.clone()
    call()
    same = torch.equal(h1.view(torch.int16), half.view(torch.int16)) and torch.equal(s1, stats)
    want_h, want_s = pack.pack_rows_plain(x, nsum)
    bits = torch.equal(want_h.view(torch.int16), half.view(torch.int16))
    rel = float(((stats - want_s).abs() / want_s.abs()).max())
    if not (same and bits and rel < 1e-12):
        raise RuntimeError(f"pack kernel: deterministic {same}, bits {bits}, stats {rel}")
    nbytes = x.numel() * 6 + stats.numel() * 8
    device_ms, ops = per_call_device(call)
    out = {"shape": list(PACK_SHAPE), "nsum": nsum, "ms": cuda_ms(call, 50),
           "device_ms": device_ms, "kernels_per_call": ops, "host_ms": host_ms(call),
           "plain_ms": cuda_ms(lambda: pack.pack_rows_plain(x, nsum), 10),
           "bound_ms": 1e3 * nbytes / 3.35e12, "bound_by": "bytes", "bytes": nbytes,
           "stats_rel_err": rel, "deterministic": same, "bits_equal": bits}
    log(f"pack kernel at {PACK_SHAPE}: {out['ms']:.4f} ms (CUDA events), device "
        f"{device_ms} ms in {ops} kernels, host {out['host_ms']:.4f} ms; plain "
        f"{out['plain_ms']:.4f} ms; bytes floor {out['bound_ms']:.4f} ms; float16 bits "
        f"equal, stats within {rel:.2e}, two launches the same bits")
    return out


def explicit_entry(k: dict, walk_shapes: list) -> dict:
    """The explicit (K, NL) form's entry of the kernels line: step 20's
    numbers at the host receiver's NL 57 (its main path) and, under
    ``shapes``, those of NL 57 and W1's launch shapes (NL 65, 201, 403,
    and ``lag_bank_correlate_channels`` at 403)."""
    nl57 = {"form": "explicit", "shape": [2, 24, 200_000, 57], "ms": k["ms_explicit"],
            "device_ms": k["device_ms_explicit"], "host_ms": k["host_ms_explicit"],
            "kernels_per_call": k["kernels_per_call_explicit"],
            "plain_ms": k["plain_ms_explicit"], "library_ms": k["library_ms_explicit"],
            "library_device_ms": k["library_device_ms_explicit"],
            "bound_ms": k["bound_explicit_ms"], "bound_by": k["bound_explicit_by"],
            "f64_err": k["explicit_f64_err"], "plain_f64_err": k["explicit_plain_f64_err"],
            "launches": k["launches_explicit"]}
    return {
        "name": "lagbank_explicit",
        "route": "cuda",
        "source": "amaranth_twstft_tpu_torch/csrc/lagbank.cu",
        "replaces": "amaranth_twstft_tpu/ops/lagbank.py:96",
        "launches": k["launches_explicit"],
        "max_abs_err": k["explicit_max_abs_err"],
        "ms": k["ms_explicit"],
        "plain_ms": k["plain_ms_explicit"],
        "bound_ms": k["bound_explicit_ms"],
        "bound_by": k["bound_explicit_by"],
        "library_ms": k["library_ms_explicit"],
        "device_ms": k["device_ms_explicit"],
        "host_ms": k["host_ms_explicit"],
        "library_device_ms": k["library_device_ms_explicit"],
        "kernels_per_call": k["kernels_per_call_explicit"],
        "f64_err": k["explicit_f64_err"],
        "plain_f64_err": k["explicit_plain_f64_err"],
        "shapes": [nl57, *(s for s in walk_shapes if s["form"].startswith("explicit"))],
    }


def walk_channels_shape(obs: torch.Tensor, w: torch.Tensor, times: dict) -> dict:
    """``lag_bank_correlate_channels`` (the sharded lag-bank step's launch)
    over two channels at the host's NL-403 shape: one launch of the
    explicit form, each channel's bits those of its own
    ``lag_bank_correlate``, with its times from :func:`explicit_times`
    (``times``)."""
    from amaranth_twstft_tpu_torch.ops import lagbank

    obs_c = torch.stack([obs, obs.flip(-1)])
    w_c = torch.stack([w, w.roll(1, 0)])
    before = lagbank.lag_bank_correlate.launches
    power, phase = lagbank.lag_bank_correlate_channels(obs_c, w_c)
    if lagbank.lag_bank_correlate.launches != before + 1:
        raise RuntimeError("lag_bank_correlate_channels: not one launch")
    for i in range(2):
        own = lagbank.lag_bank_correlate(obs_c[i], w_c[i])
        if not (torch.equal(power[i], own[0]) and torch.equal(phase[i], own[1])):
            raise RuntimeError(f"lag_bank_correlate_channels: channel {i} differs")
    _, C, P, K = obs_c.shape
    nl = w.shape[1]
    b = lag_bounds(4.0 * (obs_c.numel() + w_c.numel() + 2 * C * P * nl),
                   2.0 * 2 * C * P * nl * K)
    log(f"  W1 lag_bank_correlate_channels over {C} channels of (2, {P}, {K}) x ({K}, {nl}): "
        f"one launch, each channel's bits its own launch's; bytes floor "
        f"{b['bound_bytes_ms']:.4f} ms")
    del obs_c, w_c, power, phase
    return {"form": "explicit_channels", "shape": [C, 2, P, K, nl], **times, **b}


def w1_w2_bank(work: str, cap: str, truths: dict, dev, main_rows: dict) -> dict:
    """W1 (the bank) and W2: ``dllpll --nlag`` and ``--group`` on the main
    path's capture and 120 channels, each against the truths at second
    W_SECONDS - 1 and against the main path's (nlag 28, group 8) rows;
    then the window form at the new launch shapes."""
    from amaranth_twstft_tpu_torch.models import tracker
    from amaranth_twstft_tpu_torch.ops import lagbank

    out: dict = {"nlag": {}, "group": {}, "launches": {}}
    n_chan = len(truths)
    tracked = W_SECONDS - 1
    inputs: dict = {}
    orig = tracker.lag_bank_windows
    for opt, values in (("--nlag", W_NLAGS), ("--group", W_GROUPS)):
        for v in values:
            kept: dict = {}

            def keep(obs, wav_ext, nlag, power_scale=0.5, _k=kept):
                _k.update(obs=obs, wav_ext=wav_ext, nlag=nlag, power_scale=power_scale)
                return orig(obs, wav_ext, nlag, power_scale)

            name = f"w_{opt[2:]}{v}"
            tracker.lag_bank_windows = keep
            lagbank.lag_bank_kernel.launches = 0
            try:
                run = dllpll_verb(work, name, cap, truths, dev, opt, str(v), "--seconds",
                                  str(W_SECONDS))
            finally:
                tracker.lag_bank_windows = orig
            launches = lagbank.lag_bank_kernel.launches
            group = v if opt == "--group" else 8
            want = math.ceil(n_chan / group) * tracked
            what = f"W{1 if opt == '--nlag' else 2} dllpll {opt} {v}"
            log(f"{what}: {W_SECONDS} s of {n_chan} channels in {run['wall']:.3f} s; "
                f"{launches} window-form launches ({launches / tracked:g} per tracked "
                f"second), last launch (G, P, K, NL) = {tuple(kept['obs'].shape[:1])} x "
                f"{tuple(kept['obs'].shape[2:])}, NL {2 * kept['nlag'] + 1}")
            if launches != want:
                raise RuntimeError(f"{what}: {launches} window-form launches, want {want}")
            gate = truth_gate(what, run["rows"], truths, W_SECONDS - 1)
            vs = rows_vs(f"{what} against the main path's rows (--nlag 28 --group 8)",
                         run["rows"], main_rows, W_SECONDS)
            out[opt[2:]][str(v)] = {"wall_s": run["wall"], "launches": launches,
                                    "launches_per_s": launches / tracked, **gate,
                                    "vs_main": vs}
            out["launches"][name] = launches
            if opt == "--nlag":
                inputs[2 * v + 1] = kept
            else:
                kept.clear()
    # the window form at NL 65 and 201 on the runs' last launch, and at 403
    # on the NL-201 run's observations with the replica extended by 201 lags
    lb201 = inputs[2 * W_NLAGS[-1] + 1]
    n = W_NLAGS[-1]
    wav = lb201["wav_ext"][:, n : lb201["obs"].shape[-1] + n]
    big = W_KERNEL_NLAG
    inputs[2 * big + 1] = dict(lb201, nlag=big,
                               wav_ext=torch.cat([wav[:, -big:], wav, wav[:, :big]], 1))
    out["kernel"] = [dict(walk_window_shape(inputs[nl]),
                          launches=out["launches"].get(f"w_nlag{(nl - 1) // 2}", 0))
                     for nl in sorted(inputs)]
    return out


def w1_host(work: str, cap: str, truths: dict, dev) -> dict:
    """W1 (the host receiver): ``dllpll --host --nlag`` 32, 100 and 201 on
    the host cell's 8 channels, W_HOST_SECONDS each: one explicit-form
    launch per tracked channel-second, the truths at the last second, the
    NL-403 run against the CPU; then the explicit form at the runs' last
    launch shapes and ``lag_bank_correlate_channels`` at NL 403."""
    from amaranth_twstft_tpu_torch.models import dllpll
    from amaranth_twstft_tpu_torch.ops import lagbank

    out: dict = {"nlag": {}, "launches": {}}
    inputs: dict = {}
    orig = dllpll.lag_bank_correlate
    for nlag in W_HOST_NLAGS:
        kept: dict = {}

        def keep(obs_ri, wav_lags, _k=kept):
            _k.update(obs=obs_ri, w=wav_lags)
            return orig(obs_ri, wav_lags)

        dllpll.lag_bank_correlate = keep
        lagbank.lag_bank_correlate.launches = 0
        lagbank.lag_bank_kernel.launches = 0
        try:
            run = dllpll_verb(work, f"w_host{nlag}", cap, truths, dev, "--host", "--nlag",
                              str(nlag), "--seconds", str(W_HOST_SECONDS))
        finally:
            dllpll.lag_bank_correlate = orig
        launches = lagbank.lag_bank_correlate.launches
        want = len(truths) * (W_HOST_SECONDS - 1)
        what = f"W1 dllpll --host --nlag {nlag}"
        log(f"{what}: {W_HOST_SECONDS} s of {len(truths)} channels in {run['wall']:.3f} s; "
            f"{launches} explicit-form launches at NL {2 * nlag + 1}")
        if launches != want or lagbank.lag_bank_kernel.launches != want:
            raise RuntimeError(f"{what}: {launches} explicit-form launches, "
                               f"{lagbank.lag_bank_kernel.launches} of the kernel, want {want}")
        gate = truth_gate(what, run["rows"], truths, W_HOST_SECONDS - 1)
        entry = {"wall_s": run["wall"], "launches": launches, **gate}
        if nlag == W_HOST_NLAGS[-1]:
            cpu = dllpll_verb(work, f"w_host{nlag}_cpu", cap, truths, "cpu", "--host",
                              "--nlag", str(nlag), "--seconds", str(D_CPU_SECONDS))
            entry["vs_cpu"] = card_vs_cpu(what, run, cpu)
        out["nlag"][str(nlag)] = entry
        out["launches"][f"w_host{nlag}"] = launches
        inputs[2 * nlag + 1] = kept
    # the times in a fresh process (a trace in this one can come back
    # short of its device events), on inputs of the same shapes
    log("W1 explicit-form times, in a process of its own:")
    times = fresh_explicit_times(os.path.dirname(os.path.abspath(__file__)), EXPLICIT_SEED)
    out["kernel"] = [dict(walk_explicit_shape(inputs[nl]["obs"], inputs[nl]["w"],
                                              times[str(nl)]),
                          launches=out["launches"][f"w_host{(nl - 1) // 2}"])
                     for nl in sorted(inputs)]
    big = inputs[max(inputs)]
    out["kernel"].append(walk_channels_shape(big["obs"], big["w"],
                                             times[f"channels_{max(inputs)}"]))
    out["stages_at_nl57"] = explicit_stages_at_57(inputs[min(inputs)])
    return out


def explicit_stages_at_57(x: dict) -> dict:
    """The explicit form's two stage layouts at the host receiver's NL 57
    on the same lags (the NL-65 inputs' middle 57): whole matrix rows (a
    pitch of 57, the receiver's launch) and the blocks' 64-lag windows (a
    pitch of 100 takes them); each against the plain version, device time
    by the profiler (None when the trace is short of kernels)."""
    from amaranth_twstft_tpu_torch.ops import lagbank

    obs = x["obs"].clone()  # lag_bank_kernel takes 16-byte-aligned rows only
    _, C, K = obs.shape
    w57 = x["w"][:, 4:61].contiguous()
    plain = lagbank.lag_bank_plain(obs, w57)
    out = {}
    for name, w in (("whole_rows", w57), ("windows", torch.nn.functional.pad(w57, (0, 43)))):
        pitch = w.shape[1]

        def fn(w=w, pitch=pitch):
            return lagbank.lag_bank_kernel(obs, w, G=1, P=C, K=K, NL=57,
                                           obs_strides=(0, C * K, K),
                                           w_layout=(0, pitch, 1, 0, K * pitch),
                                           power_scale=0.5)

        got = fn()
        compare_lag_banks(f"W1 explicit form at NL 57, pitch {pitch} ({name})",
                          (got[0][0], got[1][0]), plain)
        out[f"{name}_device_ms"] = per_call_device(fn, 20)[0]
    log(f"  W1 explicit form at NL 57: whole-row stages {out['whole_rows_device_ms']} ms, "
        f"window stages {out['windows_device_ms']} ms of device time (profiler)")
    return out


def check_goranging(what: str, out: dict, truths: list, grid: int = 3) -> dict:
    """Each channel's median delay within GR_DELAY_TOL and its df within
    GR_DF_TOL of its truth; ``truths``: (delay, Doppler) per channel."""
    errs = {}
    for c, (delay, dop) in enumerate(truths):
        ch = f"ch{c + 1}"
        d_err = float(np.median(delays_samples(out[ch], grid)) - delay)
        df_err = float(abs(out["df"][c] - dop))
        log(f"  {what} {ch}: {len(out[ch]['indice'])} epochs, median delay err "
            f"{d_err:+.5f} sample, |df - truth| {df_err:.4f} Hz")
        if abs(d_err) > GR_DELAY_TOL or df_err > GR_DF_TOL:
            raise RuntimeError(f"{what} {ch}: truth check failed")
        errs[ch] = {"delay_err_samples": d_err, "df_err_hz": df_err}
    return errs


def epochs_vs(what: str, a: dict, b: dict, grid: int = 3, tol: float = 1e-4,
              same_indice: bool = True) -> dict:
    """Two ranging results epoch for epoch, each channel that ``b`` holds:
    the same epochs, indice identical (unless ``same_indice`` is off),
    delays within ``tol`` sample; records the largest delay difference and
    whether the per-epoch dfs are equal."""
    worst = 0.0
    same_df = True
    for ch in ("ch1", "ch2"):
        if b.get(ch) is None:
            continue
        ia, ib = np.asarray(a[ch]["indice"]), np.asarray(b[ch]["indice"])
        if ia.shape != ib.shape or (same_indice and not np.array_equal(ia, ib)):
            raise RuntimeError(f"{what} {ch}: indice differs")
        worst = max(worst, float(np.abs(delays_samples(a[ch], grid)
                                        - delays_samples(b[ch], grid)).max()))
        same_df &= bool(np.array_equal(np.asarray(a[ch]["df"], np.float64),
                                       np.asarray(b[ch]["df"], np.float64)))
    log(f"  {what}: {'indice identical, ' if same_indice else ''}max delay diff "
        f"{worst:.3e} sample (tolerance {tol:g}); df equal: {same_df}")
    if worst > tol:
        raise RuntimeError(f"{what}: delays differ by {worst}")
    return {"max_delay_diff_samples": worst, "df_equal": same_df}


def w3_w4_ranging(work: str, cap: str, code: str, truth: dict, dev) -> dict:
    """W3 (``--f64``) and W4 (``goranging --remote --foffset --nint``) on
    the GoRanging capture's first W_SECONDS; "against the CPU" runs the
    same argv on a 1-s prefix on the card and on the CPU."""
    from amaranth_twstft_tpu_torch import pipeline
    from amaranth_twstft_tpu_torch.models import godual, goranging

    fs = int(FS)
    cap4, pre = os.path.join(work, "walk_gr.bin"), os.path.join(work, "walk_gr_1s.bin")
    copy_prefix(cap, cap4, W_SECONDS * fs)
    copy_prefix(cap, pre, fs)
    truths = list(zip(truth["delay"], truth["doppler"]))
    out: dict = {}
    card = ["--device", str(dev)]

    def on_prefix(module, name, argv, tol, grid=3):
        got = {d: kept_verb(module, name, [argv[0], pre, *argv[1:], "--device", d])
               for d in (str(dev), "cpu")}
        vs = epochs_vs(f"W3-W4 {' '.join(a for a in argv if a != code)} card vs CPU, "
                       f"1-s prefix", got[str(dev)][0],
                       got["cpu"][0], grid, tol)
        vs["cpu_wall_s"] = got["cpu"][2]
        return vs

    # -- W3. --f64: complex128 on the card ----------------------------------
    g64, _, wall = kept_verb(goranging, "process_file",
                             ["goranging", cap4, code, "--f64", *card])
    log(f"W3 goranging --f64 (the plain chain, complex128 on the card): {W_SECONDS} s "
        f"in {wall:.3f} s")
    out["goranging_f64"] = {"wall_s": wall,
                            "errors": check_goranging("W3 goranging --f64", g64, truths),
                            "vs_cpu": on_prefix(goranging, "process_file",
                                                ["goranging", code, "--f64"],
                                                W_F64_DELAY_TOL)}
    r64, _, wall = kept_verb(godual, "process_file",
                             ["ranging", cap4, code, "--f64", "--op", "-v", *card])
    log(f"W3 ranging --f64 --op -v (godual's host branch, complex128 on the card): "
        f"{W_SECONDS} s in {wall:.3f} s")
    out["ranging_f64"] = {"wall_s": wall,
                          "errors": check_ranging("W3 ranging --f64 --op -v", r64, truths,
                                                  fine=False),
                          "vs_cpu": on_prefix(godual, "process_file",
                                              ["ranging", code, "--f64", "--op", "-v"],
                                              W_F64_DELAY_TOL)}
    err: list = []
    f64f, _, wall = kept_verb(pipeline, "process_capture_overlapped",
                              ["goranging", cap4, code, "--fast", "--f64", *card], err)
    if "forcing ingest_dtype=float32" not in err[0]:
        raise RuntimeError(f"goranging --fast --f64 printed no float32 warning: {err[0]!r}")
    log(f"W3 goranging --fast --f64: the float32-ingest warning, {W_SECONDS} s in "
        f"{wall:.3f} s")
    out["goranging_fast_f64"] = {
        "wall_s": wall, "warning": True,
        "errors": check_goranging("W3 goranging --fast --f64", f64f, truths)}

    # -- W4. --remote --foffset --nint ---------------------------------------
    rcap, rpre = os.path.join(work, "walk_remote.bin"), os.path.join(work, "walk_remote_1s.bin")
    shifted_copy(cap, rcap, W_SECONDS, W_FOFFSET_HZ, 2, dev)
    copy_prefix(rcap, rpre, fs)
    grid = 2 * W_NINT + 1
    opts = ["--remote", "--foffset", repr(W_FOFFSET_HZ), "--nint", str(W_NINT)]
    r_truth = [(truth["delay"][0], truth["doppler"][0] + W_FOFFSET_HZ)]
    plain, _, pwall = kept_verb(goranging, "process_file",
                                ["goranging", rcap, code, *opts, *card])
    fast, _, fwall = kept_verb(pipeline, "process_capture_overlapped",
                               ["goranging", rcap, code, *opts, "--fast", *card])
    log(f"W4 goranging {' '.join(opts)} on {W_SECONDS} s with channel 1 moved by "
        f"{W_FOFFSET_HZ:g} Hz: plain {pwall:.3f} s, --fast {fwall:.3f} s")
    if plain["ch2"] is not None or fast["ch2"] is not None:
        raise RuntimeError("W4: --remote processed channel 2")
    out["remote"] = {
        "plain_wall_s": pwall, "fast_wall_s": fwall,
        "plain": check_goranging("W4 plain", plain, r_truth, grid),
        "fast": check_goranging("W4 --fast", fast, r_truth, grid),
        "plain_vs_fast": epochs_vs("W4 plain vs --fast", plain, fast, grid),
    }
    got = {d: kept_verb(goranging, "process_file", ["goranging", rpre, code, *opts,
                                                    "--device", d])[0]
           for d in (str(dev), "cpu")}
    out["remote"]["vs_cpu"] = epochs_vs("W4 plain card vs CPU, 1-s prefix", got[str(dev)],
                                        got["cpu"], grid)
    n2, _, wall = kept_verb(pipeline, "process_capture_overlapped",
                            ["goranging", cap4, code, "--nint", str(W_NINT), "--fast", *card])
    log(f"W4 goranging --nint {W_NINT} --fast: {W_SECONDS} s in {wall:.3f} s")
    out["nint_fast"] = {
        "wall_s": wall, "errors": check_goranging(f"W4 --nint {W_NINT} --fast", n2, truths,
                                                  grid),
        "vs_cpu": on_prefix(pipeline, "process_capture_overlapped",
                            ["goranging", code, "--nint", str(W_NINT), "--fast"], 1e-4, grid)}
    for f in (cap4, pre, rcap, rpre):
        os.remove(f)
    return out


def w5_batch_remote(root: str, dev, kept: dict) -> dict:
    """W5: ``batch --remote`` over a directory holding OP's loopback moved
    into the ranging window (phase B's copy) and OP's remote capture: the
    default station picks ``*_2.bin``; the archive (``remoteclaudio``)
    equals ``claudio.process_file(remote=True, ranging=True)`` on the same
    file, the chain ``batch`` runs (both packages pass ``ranging=True``),
    and lies on the truth; the ``claudio --remote`` verb (``ranging=False``,
    the remote window) is run on it too and recorded."""
    import gzip

    import scipy.io as sio

    from amaranth_twstft_tpu_torch.config import ProcessingConfig, SignalConfig, StationConfig
    from amaranth_twstft_tpu_torch.models import claudio

    wdir = os.path.join(root, "walk")
    name = next(f for f in sorted(os.listdir(wdir)) if f.endswith("_2.bin"))
    other = next(f for f in sorted(os.listdir(wdir)) if f.endswith("_1.bin"))
    code9 = kept["codes"]["OP"]
    ref_dir = os.path.join(root, "walk_ref")
    os.makedirs(ref_dir, exist_ok=True)
    t0 = time.perf_counter()
    # process_directory's own arguments: ProcessingConfig() and the default
    # station (both packages)
    ref = claudio.process_file(os.path.join(wdir, name), code9, SignalConfig(),
                               ProcessingConfig(), StationConfig(), remote=True,
                               ranging=True, out_dir=ref_dir, device=dev)
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t0
    verb, _, verb_wall = kept_verb(claudio, "process_file",
                                   ["claudio", os.path.join(wdir, name), code9, "--remote",
                                    "--op", "--device", str(dev)])
    os.remove(verb["mat_path"])
    rep_out, wall = run_verb(["batch", wdir, code9, "--remote", "--device", str(dev)])
    rep = json.loads(rep_out.strip().splitlines()[-1])
    if rep != {"processed": [os.path.join(wdir, name)], "skipped": [], "failed": []} \
            or not os.path.exists(os.path.join(wdir, other)):
        raise RuntimeError(f"W5 batch --remote: {rep}")
    gz = os.path.join(wdir, "remoteclaudio" + name.replace(".bin", ".mat.gz"))
    bare = gunzipped(gz)
    n_fields = mat_fields_equal(bare, ref["mat_path"])
    os.remove(bare)
    with gzip.open(gz) as f:
        m = sio.loadmat(f)
    _, delay, dop, _ = kept["truths"][("OP", "_2")]
    tracked = m["indice1"].ravel() + m["correction1"].ravel() / 3.0
    d_err = float(np.median(tracked) - folded_delay(delay))
    df_err = float(np.abs(m["df"].ravel() - (dop + B_RANGING_SHIFT_HZ)).max())
    log(f"W5 batch --remote: wall {wall:.3f} s, processed {name} ({other} not picked); "
        f"its remoteclaudio archive equals claudio.process_file(remote=True, "
        f"ranging=True) ({ref_wall:.3f} s) in {n_fields} fields; median delay err "
        f"{d_err:+.5f} sample, max |df - truth| {df_err:.4f} Hz; the claudio --remote "
        f"verb ({verb_wall:.3f} s) searches the remote window and finds "
        f"{'a line' if verb['found'] else 'nothing'} in the same file")
    if not ref["found"] or abs(d_err) > TW_DELAY_TOL or df_err > TW_DF_TOL:
        raise RuntimeError("W5 batch --remote: truth check failed")
    return {"wall_s": wall, "mat_fields": n_fields, "processed": [name],
            "not_picked": [other], "delay_err_samples": d_err, "df_err_hz": df_err,
            "remote_verb_found": bool(verb["found"]),
            "capture": os.path.join(wdir, "donetw", name)}


def w6_monitor(work: str, cap: str, code: str, delay: float, dev) -> dict:
    """W6: ``monitor --channels 1 --epochs 50 --serve --serve-host`` on a
    single-channel capture that a writer grows one second per second, with
    ``monitor --connect`` consumers in subprocesses (one printing rows,
    one with ``--plot --plot-file`` when matplotlib imports); then
    ``monitor --once`` on the finished file."""
    import importlib.util

    from amaranth_twstft_tpu_torch import cli

    fs, epochs = int(FS), W_MON_SECONDS * round(CHIP_RATE / CODE_LEN)
    L = CODE_LEN * int(FS // CHIP_RATE)
    grow = os.path.join(work, "walk_grow.bin")
    png = os.path.join(work, "walk_monitor.png")
    open(grow, "wb").close()
    port = free_port()
    plot = importlib.util.find_spec("matplotlib") is not None
    stdout = io.StringIO()
    procs: dict = {}
    appended: list[float] = []
    errors: list[BaseException] = []
    repo = os.path.dirname(os.path.abspath(__file__))

    def consumer(*extra):
        return subprocess.Popen(
            [sys.executable, "-m", "amaranth_twstft_tpu_torch", "monitor", "--connect",
             f"127.0.0.1:{port}", "--timeout", "30", *extra],
            cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def wait_for(text: str, seconds: float) -> None:
        deadline = time.monotonic() + seconds
        while text not in stdout.getvalue():
            if time.monotonic() > deadline:
                raise RuntimeError(f"the monitor never printed {text!r}")
            time.sleep(0.05)

    def feeder():
        try:
            wait_for("# serving on", 60.0)
            procs["rows"] = consumer()
            if plot:
                procs["plot"] = consumer("--plot", "--plot-file", png)
            wait_for("# epoch ch", 60.0)
            with open(cap, "rb") as src, open(grow, "ab") as dst:
                t_start = time.monotonic()
                for k in range(W_MON_SECONDS):
                    time.sleep(max(0.0, t_start + k - time.monotonic()))
                    dst.write(src.read(fs * 4))
                    dst.flush()
                    appended.append(time.monotonic())
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(e)

    common = [grow, code, "--channels", "1", "--epochs", str(W_MON_EPOCHS),
              "--device", str(dev)]
    th = threading.Thread(target=feeder, daemon=True)
    th.start()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main(["monitor", *common, "--serve", str(port), "--serve-host",
                           "127.0.0.1", "--serve-min-clients", str(1 + plot),
                           "--timeout", "3"])
        wall = time.perf_counter() - t0
        th.join(timeout=60.0)
        outs = {k: p.communicate(timeout=60) for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    if rc != 0 or th.is_alive() or errors:
        raise RuntimeError(f"W6 monitor exited {rc}; the feeder thread: {errors}")
    if any(p.returncode != 0 for p in procs.values()):
        raise RuntimeError(f"W6 monitor --connect exited "
                           f"{[p.returncode for p in procs.values()]}: {outs}")
    printed = [ln for ln in stdout.getvalue().splitlines() if not ln.startswith("#")]
    consumed = [ln for ln in outs["rows"][0].splitlines() if not ln.startswith("#")]
    got = [int(r.split()[0]) for r in printed]
    if got != list(range(epochs)) or any(r.split()[1] != "0" for r in printed):
        raise RuntimeError(f"W6 monitor printed {len(printed)} rows, want one per "
                           f"epoch 0..{epochs - 1} of channel 0")
    if consumed != printed:
        raise RuntimeError("W6 the --connect consumer's rows differ from the printed rows")
    dl = np.array([float(r.split()[2]) for r in printed])
    err = (float(np.median(dl)) - delay + L / 2) % L - L / 2
    if abs(err) > GR_DELAY_TOL:
        raise RuntimeError(f"W6 monitor median delay err {err}")
    once_out, once_wall = run_verb(["monitor", *common, "--once"])
    once = [ln for ln in once_out.splitlines() if not ln.startswith("#")]
    if once != printed:
        raise RuntimeError("W6 monitor --once on the finished file printed other rows")
    png_bytes = os.path.getsize(png) if plot and os.path.exists(png) else 0
    if plot and not png_bytes:
        raise RuntimeError("W6 monitor --connect --plot wrote no snapshot")
    log(f"W6 monitor --channels 1 --epochs {W_MON_EPOCHS} --serve --serve-host 127.0.0.1 "
        f"on a file grown one second per second: {len(printed)} rows (one per epoch), "
        f"verb wall {wall:.3f} s; the --connect consumer printed the same rows; median "
        f"delay err {err:+.5f} sample; monitor --once on the finished file ({once_wall:.3f} "
        f"s) printed the same rows; matplotlib "
        + (f"imports: --connect --plot --plot-file wrote {png_bytes} B"
           if plot else "does not import: --plot* not run"))
    for f in (grow, png):
        if os.path.exists(f):
            os.remove(f)
    return {"rows": len(printed), "wall_s": wall, "delay_err_samples": err,
            "once_wall_s": once_wall, "consumer_rows_equal": True,
            "matplotlib": plot, "plot_file_bytes": png_bytes}


def w7_geometries(work: str, dev, seed: int) -> dict:
    """W7: off-default code geometries through the verbs: 1000 kcps (a
    dual-channel capture through ``goranging --fast`` and ``ranging``, a
    single-channel one through ``claudio`` and ``batch``), ``claudio --fs
    1e7`` (a 2e7-bin hunt) and an 18-bit code through ``goranging --fast``."""
    from amaranth_twstft_tpu_torch import pipeline
    from amaranth_twstft_tpu_torch.config import ProcessingConfig, SignalConfig, StationConfig
    from amaranth_twstft_tpu_torch.models import claudio, godual
    from amaranth_twstft_tpu_torch.models.godual import build_replica
    from amaranth_twstft_tpu_torch.ops import boundary, doppler
    from amaranth_twstft_tpu_torch.ops.lfsr import find_mseq_taps, write_prn_file
    from amaranth_twstft_tpu_torch.utils import io as sc16

    out: dict = {}
    fs = int(FS)
    card = ["--device", str(dev)]
    code = os.path.join(work, "walk_code17.bin")
    write_prn_file(code, BIT_LEN, CODE_LEN, 9)
    rng = np.random.default_rng(seed + 13)

    # -- 1000 kcps, dual channel: goranging --fast and ranging ----------------
    slow = ["--chip-rate", repr(W_SLOW_CHIP_RATE)]
    L = CODE_LEN * int(FS // W_SLOW_CHIP_RATE)
    cap, pre = os.path.join(work, "walk_slow.bin"), os.path.join(work, "walk_slow_1s.bin")
    truth = synthesize_ranging(dev, seed + 7, code, cap, W_SECONDS, W_SLOW_CHIP_RATE)
    truths = list(zip(truth["delay"], truth["doppler"]))
    copy_prefix(cap, pre, fs)
    fast, _, fwall = kept_verb(pipeline, "process_capture_overlapped",
                               ["goranging", cap, code, "--fast", *slow, *card])
    rg, _, rwall = kept_verb(godual, "process_file", ["ranging", cap, code, *slow, *card])
    log(f"W7 {W_SLOW_CHIP_RATE / 1e3:g} kcps (L = {L}), {W_SECONDS} s dual-channel: "
        f"goranging --fast {fwall:.3f} s, ranging {rwall:.3f} s")
    entry = {"fast_wall_s": fwall, "ranging_wall_s": rwall,
             "fast": check_goranging("W7 1000 kcps goranging --fast", fast, truths),
             "ranging": check_ranging("W7 1000 kcps ranging", rg, truths, fine=False, L=L)}
    got = {d: kept_verb(pipeline, "process_capture_overlapped",
                        ["goranging", pre, code, "--fast", *slow, "--device", d])[0]
           for d in (str(dev), "cpu")}
    entry["fast_vs_cpu"] = epochs_vs("W7 1000 kcps goranging --fast card vs CPU, 1-s prefix",
                                     got[str(dev)], got["cpu"])
    card_rg = kept_verb(godual, "process_file", ["ranging", pre, code, *slow, *card])[0]
    cpu_rg = kept_verb(godual, "process_file", ["ranging", pre, code, *slow,
                                                "--device", "cpu"])[0]
    entry["ranging_vs_cpu_host_branch"] = epochs_vs(
        "W7 1000 kcps ranging card (bound step) vs the CPU's host branch, 1-s prefix",
        card_rg, cpu_rg, tol=GR_DELAY_TOL, same_indice=False)
    out["slow_dual"] = entry
    for f in (cap, pre):
        os.remove(f)

    # -- 1000 kcps and 10 MS/s, single channel: claudio (and batch) -----------
    block_s = ProcessingConfig(conjugate_data=True).block_seconds
    for key, sig_fs, chip_rate, argv in (
            ("slow_claudio", FS, W_SLOW_CHIP_RATE, slow),
            ("fs1e7_claudio", W_FAST_FS, CHIP_RATE, ["--fs", repr(W_FAST_FS)])):
        cfg = SignalConfig(fs=sig_fs, chip_rate=chip_rate, code_len=CODE_LEN,
                           bit_len=BIT_LEN)
        Lc = cfg.samples_per_code
        half_bin = sig_fs / (sig_fs * block_s) / 2
        dop = round(rng.uniform(-3000.0, 3000.0) / half_bin) * half_bin
        delay = float(rng.integers(Lc // 20, Lc - Lc // 20)) + rng.uniform(0.1, 0.4)
        d_verb, d_batch = os.path.join(work, f"walk_{key}"), os.path.join(work, f"walk_{key}_b")
        for d in (d_verb, d_batch):
            os.makedirs(d, exist_ok=True)
        cap = os.path.join(d_verb, "1755400000_2.bin")
        t0 = time.perf_counter()
        synthesize_single(dev, seed + 17, code, delay, dop, TW_LOOPBACK_AMPLITUDE, cap,
                          TW_SECONDS, sig_fs, chip_rate)
        t_syn = time.perf_counter() - t0
        res, _, wall = kept_verb(claudio, "process_file", ["claudio", cap, code, *argv, *card])
        dl = tracked_delays(res) if res["found"] else np.zeros(0)
        d_err = float(np.median(dl) - folded_delay(delay)) if len(dl) else float("nan")
        df_err = float(np.abs(res["df"] - dop).max()) if res["found"] else float("nan")
        n_iq = sc16.n_samples_sc16(cap, channels=1)
        log(f"W7 claudio {' '.join(argv)} (L = {Lc}, {TW_SECONDS} s single-channel, "
            f"{os.path.getsize(cap) / 1e6:.0f} MB written in {t_syn:.1f} s): verb wall "
            f"{wall:.3f} s -> {n_iq / res['timing']['total_s'] / 1e6:.2f} IQ MS/s; "
            f"{len(dl)} codes, median delay err {d_err:+.5f} sample (folded truth "
            f"{folded_delay(delay):.4f}), max |df - truth {dop:g}| {df_err:.4f} Hz, "
            f"moved {res.get('moved')}")
        if not res["found"] or not abs(d_err) <= TW_DELAY_TOL or not df_err <= TW_DF_TOL:
            raise RuntimeError(f"W7 claudio {' '.join(argv)}: truth check failed")
        entry = {"wall_s": wall, "samples_per_code": Lc, "codes": len(dl),
                 "delay_err_samples": d_err, "df_err_hz": df_err,
                 "iq_msps": n_iq / res["timing"]["total_s"] / 1e6}
        if key == "slow_claudio":
            # batch over a directory holding the same file
            os.link(cap, os.path.join(d_batch, os.path.basename(cap)))
            rep_out, bwall = run_verb(["batch", d_batch, code, *argv, *card])
            rep = json.loads(rep_out.strip().splitlines()[-1])
            if rep["processed"] != [os.path.join(d_batch, os.path.basename(cap))] \
                    or rep["failed"]:
                raise RuntimeError(f"W7 batch {' '.join(argv)}: {rep}")
            bare = gunzipped(os.path.join(
                d_batch, os.path.basename(res["mat_path"]) + ".gz"))
            entry["batch"] = {"wall_s": bwall,
                              "mat_fields": mat_fields_equal(bare, res["mat_path"])}
            log(f"  W7 batch {' '.join(argv)}: wall {bwall:.3f} s, its archive equals the "
                f"claudio verb's in {entry['batch']['mat_fields']} fields")
            # the card against the CPU on a 4-s prefix (no hunt skip)
            prefix = os.path.join(d_verb, "prefix_2.bin")
            copy_prefix(cap, prefix, TW_PREFIX_SECONDS * fs, channels=1)
            runs = {}
            for nm, d in (("card", dev), ("cpu", "cpu")):
                od = os.path.join(d_verb, f"prefix_{nm}")
                os.makedirs(od, exist_ok=True)
                runs[nm] = claudio.process_file(
                    prefix, code, cfg, ProcessingConfig(conjugate_data=True, skip_seconds=0.0),
                    StationConfig(), ranging=True, out_dir=od, device=d, transfer="int8")
            diff = float(np.abs(tracked_delays(runs["card"])
                                - tracked_delays(runs["cpu"])).max())
            if not np.array_equal(runs["card"]["df"], runs["cpu"]["df"]) \
                    or runs["card"]["moved"] != runs["cpu"]["moved"] \
                    or diff > TW_CPU_DELAY_TOL:
                raise RuntimeError(f"W7 claudio {' '.join(argv)} card vs CPU: delay {diff}")
            log(f"  W7 claudio {' '.join(argv)} card vs CPU ({TW_PREFIX_SECONDS}-s prefix, "
                f"no hunt skip, resident int8): df and moved identical, max delay diff "
                f"{diff:.2e} sample")
            entry["vs_cpu_max_delay_diff"] = diff
        else:
            # the hunt's first block (after the 30-s skip), on the resident
            # hunt's inputs (claudio._hunt), card against CPU
            proc = ProcessingConfig(conjugate_data=True)
            block = int(sig_fs * block_s)
            raw, _ = sc16.read_raw16(cap, int(proc.skip_seconds * sig_fs), block)
            q8, _ = claudio._quantize_q8(raw)
            dc = raw[:Lc].astype(np.float32)
            dc -= dc.mean(axis=0, keepdims=True)
            fcode_ri = boundary.pack_complex(build_replica(code, cfg, proc,
                                                           conjugate=False).fcode)
            mask = doppler.window_mask(block, sig_fs, *claudio.claudio_df_window(
                StationConfig(op=False), True))
            hunt = {}
            for d in (str(dev), "cpu"):
                t0 = time.perf_counter()
                kb, n_above = doppler.search_df_candidates_ri(
                    *(torch.from_numpy(a).to(d) for a in (q8, dc, fcode_ri)), sig_fs,
                    torch.from_numpy(mask).to(d), threshold=proc.df_threshold)
                hunt[d] = (int(kb), int(n_above))
                hunt[d + "_s"] = time.perf_counter() - t0
            line = float(np.fft.fftshift(np.fft.fftfreq(block, 1 / sig_fs))[hunt["cpu"][0]])
            log(f"  W7 the hunt over the {block}-bin block at {proc.skip_seconds:g} s: card "
                f"{hunt[str(dev)]} ({hunt[str(dev) + '_s']:.2f} s), CPU {hunt['cpu']} "
                f"({hunt['cpu_s']:.2f} s) as (kbon, n_above); kbon's bin {line:.2f} Hz, "
                f"twice the truth {2 * dop:.2f} Hz")
            if hunt[str(dev)] != hunt["cpu"] or hunt["cpu"][0] < 0:
                raise RuntimeError(f"W7 hunt card {hunt[str(dev)]} vs CPU {hunt['cpu']}")
            entry["hunt"] = {"bins": block, "kbon": hunt["cpu"][0],
                             "n_above": hunt["cpu"][1], "card_s": hunt[str(dev) + "_s"],
                             "cpu_s": hunt["cpu_s"]}
            del q8, dc, raw
        out[key] = entry
        shutil.rmtree(d_verb)
        shutil.rmtree(d_batch)

    # -- another code: an 18-bit m-sequence through goranging --fast ----------
    taps18 = find_mseq_taps(W_OTHER_BITLEN, 1)[0]
    code18 = os.path.join(work, "walk_code18.bin")
    write_prn_file(code18, W_OTHER_BITLEN, CODE_LEN, taps18)
    cap = os.path.join(work, "walk_code18_cap.bin")
    truth = synthesize_ranging(dev, seed + 19, code18, cap, 2)
    o18, _, wall = kept_verb(pipeline, "process_capture_overlapped",
                             ["goranging", cap, code18, "--fast", "--bitlen",
                              str(W_OTHER_BITLEN), "--taps", str(taps18), *card])
    log(f"W7 goranging --fast --bitlen {W_OTHER_BITLEN} --taps {taps18}: 2 s in {wall:.3f} s")
    out["code18"] = {"taps": taps18, "wall_s": wall, "errors": check_goranging(
        f"W7 {W_OTHER_BITLEN}-bit code", o18, list(zip(truth["delay"], truth["doppler"])))}
    for f in (cap, code, code18):
        os.remove(f)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--explicit-times", metavar="TREE",
                    help="only print explicit_times() of the checkout TREE as one JSON line "
                         "(W1 runs it in a fresh process; run it on two trees to compare "
                         "them)")
    ap.add_argument("--pack-times", action="store_true",
                    help="only check and time the device pack's kernel at the bank's "
                         "second and print one JSON line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if args.explicit_times:
        print(json.dumps(explicit_times(args.explicit_times, args.seed)), flush=True)
        return 0
    if args.pack_times:
        print(json.dumps(pack_times(args.seed)), flush=True)
        return 0
    os.environ.setdefault("TWSTFT_BANK_CACHE", "")  # no ~300 MB cache entry

    from amaranth_twstft_tpu_torch import native
    from amaranth_twstft_tpu_torch.ops import lagbank, pack
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
    # the native host library, ahead of every timed phase
    nat_build = native.build(force=True)
    native.load()
    log(f"build: native host library (g++ {nat_build['flags']}) in "
        f"{nat_build['seconds']:.1f} s")

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
    pack.pack_rows.launches = 0
    t0 = time.perf_counter()
    main_reports: list = []
    reps, times, e2e_walls, rxlog, lb_inputs = run_dllpll(work, truths, cap, dev,
                                                          main_reports)
    torch.cuda.synchronize()
    wall_total = time.perf_counter() - t0
    launches = lagbank.lag_bank_kernel.launches
    pack_launches = pack.pack_rows.launches
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
    if pack_launches != N_SECONDS:
        raise RuntimeError(f"{pack_launches} pack launches on the main path, "
                           f"{N_SECONDS} seconds")
    log(f"pack launches on the main path: {pack_launches} (one a second)")
    pack_k = pack_times(args.seed)

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

    # -- M1-M2. the process group and the bank on a 1x1 NCCL mesh ----------
    import torch.distributed as dist

    from amaranth_twstft_tpu_torch.parallel.mesh import init_distributed, make_mesh

    t0 = time.perf_counter()
    init_distributed(device=dev)
    if dist.get_backend() != "nccl":
        raise RuntimeError(f"process group on {dist.get_backend()}, not NCCL")
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = make_mesh(1, 1)
    t_mesh = time.perf_counter() - t0
    log(f"init_distributed (NCCL, world 1) {t_init:.3f} s, make_mesh(1, 1) {t_mesh:.4f} s")
    t0 = time.perf_counter()
    sharded = bank_on_mesh(work, truths, cap, dev, mesh, main_reports, launches, rxlog)
    sharded.update(init_s=t_init, make_mesh_s=t_mesh)
    log(f"mesh bank phase: {time.perf_counter() - t0:.1f} s")

    # -- D1-D6. the DLL/PLL receiver's modes --------------------------------
    t0 = time.perf_counter()
    modes = modes_phase(work, cap, truths, dev, args.seed, taps)
    modes["phase_s"] = time.perf_counter() - t0
    log(f"dllpll modes phase: {modes['phase_s']:.1f} s")

    # -- W1-W2. dllpll --nlag and --group on the main capture ----------------
    t0 = time.perf_counter()
    walk = {"bank": w1_w2_bank(work, cap, truths, dev, reps)}
    walk["bank"]["phase_s"] = time.perf_counter() - t0
    log(f"walk W1-W2 (the bank): {walk['bank']['phase_s']:.1f} s")
    os.remove(cap)

    # -- 16-20. the host-sequential receiver (dllpll --host --serve) -------
    t0 = time.perf_counter()
    host = host_phase(work, dev, args.seed, taps)
    log(f"host phase: {time.perf_counter() - t0:.1f} s")

    # -- W1. dllpll --host --nlag on the host capture -------------------------
    t0 = time.perf_counter()
    host_cap, host_truths = host.pop("capture")
    walk["host"] = w1_host(work, host_cap, host_truths, dev)
    walk["host"]["phase_s"] = time.perf_counter() - t0
    os.remove(host_cap)
    log(f"walk W1 (the host receiver): {walk['host']['phase_s']:.1f} s")

    # -- 7-10. the GoRanging slice -----------------------------------------
    t0 = time.perf_counter()
    (gr_cap, gr_code, gr_truth), gr = goranging_phase(work, dev, args.seed)
    log(f"goranging phase: {time.perf_counter() - t0:.1f} s")

    # -- N1-N2. the native library and the paths routed through it ---------
    t0 = time.perf_counter()
    nat = native_phase(work, gr_cap, gr_code, gr_truth, dev, gr)
    nat.update(build_s=nat_build["seconds"], build_flags=nat_build["flags"])
    t_native = time.perf_counter() - t0
    log(f"native phase: {t_native:.1f} s")

    # -- 21-24. monitor --serve on a growing copy, goranging --profile ------
    t0 = time.perf_counter()
    mon = monitor_phase(work, gr_cap, gr_code, gr_truth, dev)
    prof = profile_phase(work, gr_cap, gr_code, dev)
    log(f"monitor and profile phases: {time.perf_counter() - t0:.1f} s")

    # -- M3-M7. goranging --sharded, the sharded steps, torchrun -------------
    t0 = time.perf_counter()
    sharded.update(sharded_phase(work, gr_cap, gr_code, gr_truth, dev, mesh))
    dist.destroy_process_group()
    log(f"sharded phase: {time.perf_counter() - t0:.1f} s")

    # -- R1-R4. ranging: godual's card branch on the GoRanging capture -------
    t0 = time.perf_counter()
    rg = ranging_phase(work, gr_cap, gr_code, gr_truth, dev)
    rg["phase_s"] = time.perf_counter() - t0
    log(f"ranging phase: {rg['phase_s']:.1f} s")

    # -- W3-W4. --f64, goranging --remote --foffset --nint ---------------------
    t0 = time.perf_counter()
    walk["ranging"] = w3_w4_ranging(work, gr_cap, gr_code, gr_truth, dev)
    walk["ranging"]["phase_s"] = time.perf_counter() - t0
    log(f"walk W3-W4 (ranging options): {walk['ranging']['phase_s']:.1f} s")
    batch_root, batch_code = batch_sources(work, gr_cap, gr_code)
    for f in (gr_cap, gr_code):
        os.remove(f)

    # -- 11-15. the claudio chain and the two-way products ------------------
    t0 = time.perf_counter()
    keep = {"dirs": {"_2": os.path.join(batch_root, "src"),
                     "_1": os.path.join(batch_root, "claudio")}}
    tw = twoway_phase(work, dev, args.seed, next(t for t in taps if t != 9), keep)
    log(f"two-way phase: {time.perf_counter() - t0:.1f} s")

    # -- B1-B4. batch over its three chains ----------------------------------
    t0 = time.perf_counter()
    bt = batch_phase(batch_root, dev, batch_code, keep)
    bt["phase_s"] = time.perf_counter() - t0
    log(f"batch phase: {bt['phase_s']:.1f} s")

    # -- W5-W6. batch --remote; monitor --channels 1 --serve --connect ----------
    t0 = time.perf_counter()
    walk["batch_remote"] = w5_batch_remote(batch_root, dev, keep)
    walk["monitor"] = w6_monitor(work, walk["batch_remote"].pop("capture"),
                                 keep["codes"]["OP"], keep["truths"][("OP", "_2")][1], dev)
    walk["batch_remote"]["phase_s"] = time.perf_counter() - t0
    shutil.rmtree(batch_root)
    log(f"walk W5-W6 (batch --remote, monitor): {walk['batch_remote']['phase_s']:.1f} s")
    nat["claudio_read_s"] = {k: f["timing"]["read_s"] for k, f in tw["files"].items()}
    log(f"N2 claudio raw reads through the native library: read_s "
        f"{nat['claudio_read_s']}")

    # -- M. the staged matmul FFT against cuFFT ------------------------------
    t0 = time.perf_counter()
    mx = mxufft_phase(dev, args.seed)
    t_mx = time.perf_counter() - t0
    log(f"mxufft phase: {t_mx:.1f} s")

    # -- S. the studies at production geometry -------------------------------
    t0 = time.perf_counter()
    st = studies_phase(dev)
    t_st = time.perf_counter() - t0
    log(f"studies phase: {t_st:.1f} s; native, mxufft and studies phases together "
        f"{t_native + t_mx + t_st:.1f} s")

    # -- P1-P2. the JAX package's on-chip parity checks ----------------------
    t0 = time.perf_counter()
    par = parity_phase(work, dev)
    par["phase_s"] = time.perf_counter() - t0
    log(f"parity phase: {par['phase_s']:.1f} s")

    # -- W7. off-default code geometries ---------------------------------------
    t0 = time.perf_counter()
    walk["geometries"] = w7_geometries(work, dev, args.seed)
    walk["geometries"]["phase_s"] = time.perf_counter() - t0
    walk["phase_s"] = sum(v.get("phase_s", 0.0) for v in walk.values())
    log(f"walk W7 (code geometries): {walk['geometries']['phase_s']:.1f} s; phase W in "
        f"all {walk['phase_s']:.1f} s")

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi_line())
    log(json.dumps({"goranging": gr}))
    log(json.dumps({"twoway": tw}))
    log(json.dumps({"host": host["host"]}))
    log(json.dumps({"monitor": mon, "profile": prof}))
    log(json.dumps({"sharded": sharded}))
    log(json.dumps({"native": nat, "mxufft": mx, "studies": st}))
    log(json.dumps({"ranging": rg}))
    log(json.dumps({"batch": bt}))
    log(json.dumps({"parity": par}))
    log(json.dumps({"dllpll_modes": modes}))
    log(json.dumps({"walk": walk}))
    slow = modes["mixed"]["slow_launch"]
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
        "launches_mesh_bank": sharded["bank_launches"],
        "launches_sharded_lagbank_step": sharded["lagbank_step_launches"],
        "ms_sharded_lagbank_step": sharded["lagbank_step_ms"],
        "bound_ms_sharded_lagbank_step": sharded["lagbank_step_bound_ms"],
        "launches_dllpll_modes": modes["launches"],
        "shape_slow_geometry": slow["shape"],
        "ms_slow_geometry": slow["ms"],
        "plain_ms_slow_geometry": slow["plain_ms"],
        "bound_ms_slow_geometry": max(slow["bound_bytes_ms"], slow["bound_tf32x3_ms"]),
        "max_err_over_row_max_slow_geometry": slow["max_err_over_row_max"],
        "f64_err_slow_geometry": slow["f64_err"],
        "launches_walk": {**walk["bank"]["launches"], **walk["host"]["launches"]},
        "walk_shapes": walk["bank"]["kernel"] + walk["host"]["kernel"],
    }, explicit_entry(host["kernel"], walk["host"]["kernel"]), {
        "name": "pack",
        "route": "cuda",
        "source": "amaranth_twstft_tpu_torch/csrc/pack.cu",
        "replaces": None,
        "launches": pack_launches,
        **pack_k,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
