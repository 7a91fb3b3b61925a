"""Command-line interface of the PyTorch port (``twstft-torch``).

Ported verbs so far:

- ``dllpll`` — the DLL/PLL multi-channel receiver (``rxcomplex.cpp
  data.bin`` with ``sdr.param``), through the device-banked receiver;
- ``ranging`` — the archived dual-channel chain (``godual_ranging.m``);
- ``goranging`` — the C++ batch chain (``processing/CPP/main.cpp``:
  ``GoRanging data.bin code.bin [remote] [foffset]``); ``--fast`` runs
  the IO-overlapped pipeline;
- ``claudio`` — the per-code aligned chain (``claudio_*.m``) on one
  single-channel capture;
- ``batch`` — directory batch processing (``goprocess.sh``);
- ``gofinal`` — per-record text extraction (``gofinal_ltfb.m``);
- ``twoway`` — the daily two-way solve of two text tables (``tw.m``);
- ``go1s`` — a session's four claudio archives -> ``.1s``/``.1sc``
  products (``go_1s.m``);
- ``campaign`` — campaign series from the go1s summaries.

``gofinal``, ``twoway``, ``go1s`` and ``campaign`` are host
post-processing (NumPy) and take no device.  Every other verb runs on the
card unless ``--device cpu`` is given.  ``dllpll
--host`` (the host-sequential receiver), ``dllpll --serve`` (the TCP
monitor), ``goranging --sharded`` and ``goranging --profile`` are not
ported yet and exit with an error.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np


def _add_device_arg(p) -> None:
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the "
                        "kernels' plain versions)")


def _add_signal_args(p) -> None:
    p.add_argument("--fs", type=float, default=5e6)
    p.add_argument("--chip-rate", type=float, default=2.5e6)
    p.add_argument("--code-len", type=int, default=100_000)
    p.add_argument("--bitlen", type=int, default=17)
    p.add_argument("--taps", type=int, default=9)


def _signal(args):
    from amaranth_twstft_tpu_torch.config import SignalConfig

    return SignalConfig(fs=args.fs, chip_rate=args.chip_rate,
                        code_len=args.code_len, bit_len=args.bitlen,
                        taps=args.taps)


def _ranging_parsers(sub) -> None:
    p = sub.add_parser("ranging", help="archived dual-channel chain")
    p.add_argument("capture")
    p.add_argument("code")
    _add_signal_args(p)
    p.add_argument("--remote", action="store_true")
    p.add_argument("--op", action="store_true", help="OP station (vs LTFB)")
    p.add_argument("--f64", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    _add_device_arg(p)

    p = sub.add_parser("goranging", help="C++-chain semantics (fixed df)")
    p.add_argument("capture")
    p.add_argument("code")
    _add_signal_args(p)
    p.add_argument("--remote", action="store_true")
    p.add_argument("--foffset", type=float, default=0.0)
    p.add_argument("--f64", action="store_true",
                   help="complex128 (without --fast)")
    p.add_argument("--fast", action="store_true",
                   help="IO-overlapped pipeline (raw sc16 ingest on the "
                        "card, one dual-channel step per batch)")
    p.add_argument("--sharded", action="store_true",
                   help="multi-device pipeline (not ported yet)")
    p.add_argument("--batch-epochs", type=int, default=None,
                   help="epochs per channel per batch")
    p.add_argument("--parity-ns", type=float, default=None,
                   help="delay-parity budget vs the float64 oracle; "
                        ">= 0.08 selects int8 ingest, else int16")
    p.add_argument("--nint", type=int, default=1,
                   help="interpolation half-factor (grid = 2*nint+1); 1 "
                        "matches the reference's 3x grid, 4 cuts the "
                        "parabola bias (PARITY.md deviation 11)")
    p.add_argument("--profile", metavar="LOGDIR", default=None,
                   help="profiler trace of the run (not ported yet)")
    _add_device_arg(p)


def _claudio_parsers(sub) -> None:
    p = sub.add_parser("claudio", help="per-code aligned tracking chain")
    p.add_argument("capture")
    p.add_argument("code")
    _add_signal_args(p)
    p.add_argument("--remote", action="store_true")
    p.add_argument("--local", action="store_true",
                   help="local channel instead of ranging")
    p.add_argument("--op", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    _add_device_arg(p)

    p = sub.add_parser("batch", help="process a capture directory")
    p.add_argument("datadir")
    p.add_argument("code")
    _add_signal_args(p)
    p.add_argument("--chain", choices=["claudio", "godual", "goranging"],
                   default="claudio")
    p.add_argument("--remote", action="store_true")
    _add_device_arg(p)


def _twoway_parsers(sub) -> None:
    p = sub.add_parser("gofinal", help="per-record text extraction")
    p.add_argument("local_mat")
    p.add_argument("remote_mat")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--end-unix", type=float)
    p.add_argument("--fs", type=float, default=5e6)

    p = sub.add_parser("twoway", help="two-way daily solve of text tables")
    p.add_argument("op_txt")
    p.add_argument("ltfb_txt")

    p = sub.add_parser(
        "go1s", help="session workflow: four archives -> .1s products"
    )
    p.add_argument("op_dir")
    p.add_argument("ltfb_dir")
    p.add_argument("-o", "--output", default=None, help="default: op_dir")
    p.add_argument("--fs", type=float, default=5e6)
    p.add_argument("--nint", type=int, default=1)
    p.add_argument("--no-1s", action="store_true", help="solve only")
    p.add_argument("--codes-per-second", type=int, default=25)

    p = sub.add_parser(
        "campaign", help="campaign products from go1s summaries: step "
        "corrections, ladate/resmean25 text series, figures "
        "(go_1s.m:356-429)"
    )
    p.add_argument("summary_dir",
                   help="directory holding go1s_summary.txt (the go1s "
                   "output dir)")
    p.add_argument("-o", "--output", default=None,
                   help="series output dir (default: summary_dir)")
    p.add_argument("--corrections", default=None,
                   help="operator step-correction table: JSON "
                   "[[mjd, ns], ...] or '<mjd> <ns>' rows")
    p.add_argument("--nint", type=int, default=1)
    p.add_argument("--no-fold", action="store_true",
                   help="skip the half-ambiguity display fold")
    p.add_argument("--plot", default=None, metavar="PNG",
                   help="also draw the campaign figure (matplotlib)")


def _dllpll_parser(sub) -> None:
    p = sub.add_parser("dllpll", help="DLL/PLL multi-channel receiver")
    p.add_argument("capture")
    p.add_argument("--param", required=True, help="sdr.param channel file")
    p.add_argument("--fs", type=float, default=5e6)
    p.add_argument("--seconds", type=int, default=0, help="0 = whole file")
    _add_device_arg(p)
    p.add_argument("--host", action="store_true",
                   help="host-sequential receiver (not ported yet)")
    p.add_argument("--out-dir", default=None,
                   help="write per-channel .dat rows + rxcomplex.log here "
                        "(rxcomplex.cpp:724,736-753)")
    p.add_argument("--real", action="store_true",
                   help="rx.cpp real-sample mode (non-IQ capture)")
    p.add_argument("--follow", action="store_true",
                   help="tail a GROWING capture, processing each second "
                        "as it completes; stops after --idle-timeout "
                        "without growth")
    p.add_argument("--idle-timeout", type=float, default=10.0,
                   help="--follow: seconds without file growth = end of "
                        "acquisition")
    p.add_argument("--serve", type=int, metavar="PORT", default=None,
                   help="broadcast reports to TCP subscribers (not "
                        "ported yet)")
    p.add_argument("--group", type=int, default=8,
                   help="channels per batched lag-bank launch")
    # the reference derives code geometry from an internal PRN table
    # keyed by the sdr.param row's id (rxcomplex.cpp:298-320); these
    # flags play that table's role for non-default codes
    p.add_argument("--bitlen", type=int, default=None,
                   help="LFSR bits of every channel's code")
    p.add_argument("--code-len", type=int, default=None,
                   help="chips per code of every channel")
    p.add_argument("--nlag", type=int, default=None)
    p.add_argument("--taps-map", default=None,
                   help="per-PRN taps, e.g. '100=9,101=27'")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="twstft-torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    _dllpll_parser(sub)
    _ranging_parsers(sub)
    _claudio_parsers(sub)
    _twoway_parsers(sub)
    args = parser.parse_args(argv)
    if args.cmd == "dllpll":
        if args.host:
            parser.error("dllpll --host: the host-sequential receiver is "
                         "not ported yet")
        if args.serve is not None:
            parser.error("dllpll --serve: the report server is not ported "
                         "yet")
        return _dllpll(args)
    if args.cmd == "ranging":
        return _ranging(args)
    if args.cmd == "goranging":
        if args.sharded:
            parser.error("goranging --sharded: the multi-device pipeline is "
                         "not ported yet")
        if args.profile:
            parser.error("goranging --profile: the profiler trace is not "
                         "ported yet")
        return _goranging(args)
    verbs = {"claudio": _claudio, "batch": _batch, "gofinal": _gofinal,
             "twoway": _twoway, "go1s": _go1s, "campaign": _campaign}
    if args.cmd in verbs:
        return verbs[args.cmd](args)
    parser.error(f"unknown command {args.cmd}")
    return 2


def _dtype(args):
    import torch

    return torch.complex128 if args.f64 else torch.complex64


def _ranging(args) -> int:
    from amaranth_twstft_tpu_torch.config import ProcessingConfig, StationConfig
    from amaranth_twstft_tpu_torch.models import godual

    out = godual.process_file(
        args.capture, args.code, _signal(args), ProcessingConfig(),
        StationConfig(op=args.op), remote=args.remote, dtype=_dtype(args),
        verbose=args.verbose, device=args.device,
    )
    print(out["mat_path"])
    return 0


def _goranging(args) -> int:
    from amaranth_twstft_tpu_torch.config import ProcessingConfig

    proc = ProcessingConfig(hamming_window=True, nint=args.nint)
    kw = {"batch_epochs": args.batch_epochs} if args.batch_epochs else {}
    if args.fast:
        from amaranth_twstft_tpu_torch import pipeline

        ingest = None
        if args.f64:
            print(
                "warning: --fast runs float32 on device; forcing "
                "ingest_dtype=float32 (full-precision ingest) instead "
                "of the float64 oracle — drop --fast for true f64",
                file=sys.stderr,
            )
            ingest = "float32"
        out = pipeline.process_capture_overlapped(
            args.capture, args.code, _signal(args), proc, remote=args.remote,
            foffset_hz=args.foffset, ingest_dtype=ingest,
            parity_ns=args.parity_ns, device=args.device, **kw,
        )
        print(f"timing={out['timing']}", file=sys.stderr)
    else:
        if args.parity_ns is not None or args.batch_epochs:
            print(
                "note: --parity-ns/--batch-epochs apply to the --fast "
                "pipeline; the plain path reads sc16 at full precision",
                file=sys.stderr,
            )
        from amaranth_twstft_tpu_torch.models import goranging

        out = goranging.process_file(
            args.capture, args.code, _signal(args), proc, remote=args.remote,
            foffset_hz=args.foffset, dtype=_dtype(args), device=args.device,
        )
    print(f"df1={out['df'][0]:.3f}", file=sys.stderr)
    print(out["mat_path"])
    return 0


def _claudio(args) -> int:
    from amaranth_twstft_tpu_torch.config import ProcessingConfig, StationConfig
    from amaranth_twstft_tpu_torch.models import claudio

    out = claudio.process_file(
        args.capture, args.code, _signal(args),
        ProcessingConfig(conjugate_data=True), StationConfig(op=args.op),
        remote=args.remote, ranging=not (args.remote or args.local),
        verbose=args.verbose, device=args.device,
    )
    if out is None:
        print("already done", file=sys.stderr)
        return 0
    print(out["mat_path"])
    return 0


def _batch(args) -> int:
    from amaranth_twstft_tpu_torch.pipeline import process_directory

    rep = process_directory(
        args.datadir, args.code, _signal(args), chain=args.chain,
        remote=args.remote, device=args.device,
    )
    print(json.dumps({"processed": rep.processed, "skipped": rep.skipped,
                      "failed": rep.failed}))
    return 0 if not rep.failed else 1


def _gofinal(args) -> int:
    from amaranth_twstft_tpu_torch.models import gofinal

    out = gofinal.extract_session(
        args.local_mat, args.remote_mat, capture_end_unix=args.end_unix,
        fs=args.fs, out_txt=args.output,
    )
    if out is None:
        print("already processed", file=sys.stderr)
        return 0
    print(f"{len(out['rows'])} rows -> {args.output}")
    return 0


def _twoway(args) -> int:
    from amaranth_twstft_tpu_torch.models import gofinal, twoway

    res = twoway.pair_and_solve_daily(gofinal.read_rows(args.op_txt),
                                      gofinal.read_rows(args.ltfb_txt))
    if not res["ok"]:
        print(res["reason"], file=sys.stderr)
        return 1
    print(json.dumps({"mean_ns": res["mean_ns"], "std_ns": res["std_ns"],
                      "n": int(len(res["res_ns"]))}))
    return 0


def _go1s(args) -> int:
    from amaranth_twstft_tpu_torch.config import SignalConfig
    from amaranth_twstft_tpu_torch.models import go1s
    from amaranth_twstft_tpu_torch.models.twoway import GatingPolicy

    # gating levels scale with the sample period (the reference's
    # constants are written for Ts=200 ns); production fs maps to the
    # defaults exactly
    policy = GatingPolicy.for_signal(
        SignalConfig(fs=args.fs), nint=args.nint,
        codes_per_second=args.codes_per_second,
    )
    res = go1s.process_sessions(
        args.op_dir, args.ltfb_dir, args.output, fs=args.fs, nint=args.nint,
        policy=policy, gen_1s=not args.no_1s, verbose=True,
    )
    print(json.dumps([{k: v for k, v in r.items() if k != "files"}
                      for r in res], default=str))
    return 0


def _campaign(args) -> int:
    from amaranth_twstft_tpu_torch.models import campaign, go1s

    rows = go1s.read_summary(os.path.join(args.summary_dir, go1s.SUMMARY_NAME))
    if not rows:
        print(f"no {go1s.SUMMARY_NAME} rows in {args.summary_dir}", flush=True)
        return 1
    corr = (campaign.load_corrections(args.corrections)
            if args.corrections else [])
    series = campaign.campaign_series(
        rows, nint=args.nint, corrections=corr, fold=not args.no_fold
    )
    paths = campaign.write_campaign_series(args.output or args.summary_dir,
                                           series)
    if args.plot:
        paths.append(campaign.plot_campaign(series, args.plot))
    print(json.dumps({"sessions": len(series["ladate"]),
                      "corrections": len(corr), "products": paths}, indent=1))
    return 0


def _dllpll(args) -> int:
    from amaranth_twstft_tpu_torch.models.dllpll import parse_sdr_param
    from amaranth_twstft_tpu_torch.models.tracker import (
        BankedReceiver,
        MultiBankReceiver,
    )
    from amaranth_twstft_tpu_torch.utils import io

    with open(args.param) as f:
        chans = parse_sdr_param(f.read())
    if args.bitlen or args.code_len or args.nlag or args.taps_map:
        taps_map = {}
        if args.taps_map:
            for kv in args.taps_map.split(","):
                k, v = kv.split("=")
                taps_map[int(k)] = int(v)
        chans = [
            dataclasses.replace(
                c,
                bit_len=args.bitlen or c.bit_len,
                code_len=args.code_len or c.code_len,
                nlag=args.nlag or c.nlag,
                taps=taps_map.get(c.prn_id, c.taps),
            )
            for c in chans
        ]
    # one banked receiver per homogeneous channel geometry
    geoms = {
        (int(round(args.fs / c.chip_rate)) * c.code_len,
         c.codes_per_second, c.nlag)
        for c in chans
    }
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
    if len(geoms) > 1:
        print(
            f"{len(geoms)} channel geometries: one banked pass per group "
            "(MultiBankReceiver)",
            file=sys.stderr,
        )
    cls = BankedReceiver if len(geoms) == 1 else MultiBankReceiver
    rx = cls(
        chans, fs=args.fs, group=args.group, real_input=args.real,
        out_dir=args.out_dir, device=args.device,
    )

    fs = int(args.fs)
    # each tracked second wants fs + nobs samples (the receivers pad a
    # shorter tail), so second s is processable once (s+1)*fs exist
    max_nobs = max(
        int(round(args.fs / c.chip_rate)) * c.code_len for c in chans
    )

    def seconds_gen():
        """Per-second sample dicts with the --follow/idle contract."""
        s = 0
        idle = 0.0
        last_total = -1
        while True:
            total = io.n_samples_sc16(args.capture, channels=2)
            if total > last_total:
                # --follow idleness = no FILE GROWTH
                idle = 0.0
                last_total = total
            if args.seconds and s >= args.seconds:
                return
            if total < (s + 1) * fs:
                if not args.follow or idle >= args.idle_timeout:
                    return
                time.sleep(0.2)
                idle += 0.2
                continue
            n_take = min(fs + max_nobs, total - s * fs)
            d, _ = io.read_sc16_epochs(args.capture, s * fs, 1, n_take,
                                       channels=2)
            if d.shape[1] == 0:
                return
            sec = {"A": d[0, 0], "B": d[1, 0]}
            if args.real:
                sec = {k: np.real(v) for k, v in sec.items()}
            yield sec
            s += 1

    def emit(sec_idx, reports):
        for ch, rep in zip(rx.channels, reports):
            if rep is None:
                continue
            print(
                f"{sec_idx} {ch.cfg.physical} PRN{ch.cfg.prn_id} "
                f"{rep.fc_hz:14.6f} {rep.phi_cycles:11.8f} "
                f"{rep.cnt:3d} {rep.gd_ns:14.6f} {rep.dg_ns_per_s:11.6f} "
                f"{rep.sdgd_ns:8.4f} {rep.pk_dbm:7.3f} {rep.pnoise_dbm:7.3f}"
            )

    if len(geoms) == 1:
        # prefetching stream driver: second s+1's upload is queued before
        # second s is processed (run_stream serializes SIC configs itself)
        for s_idx, reports in enumerate(rx.run_stream(seconds_gen())):
            emit(s_idx, reports)
    else:
        for s_idx, sec in enumerate(seconds_gen()):
            emit(s_idx, rx.process_second(sec))
    for line in rx.log:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
