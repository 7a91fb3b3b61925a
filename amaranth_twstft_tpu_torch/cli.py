"""Command-line interface of the PyTorch port (``twstft-torch``).

The JAX package's 14 verbs (``twstft-tpu``), with the same arguments:

- ``prn`` — PRN code file generation / taps search;
- ``ranging`` — the archived dual-channel chain (``godual_ranging.m``);
- ``goranging`` — the C++ batch chain (``processing/CPP/main.cpp``:
  ``GoRanging data.bin code.bin [remote] [foffset]``); ``--fast`` runs
  the IO-overlapped pipeline, ``--profile LOGDIR`` writes a
  ``torch.profiler`` Chrome trace of the run;
- ``claudio`` — the per-code aligned chain (``claudio_*.m``) on one
  single-channel capture;
- ``gofinal`` — per-record text extraction (``gofinal_ltfb.m``);
- ``twoway`` — the daily two-way solve of two text tables (``tw.m``);
- ``go1s`` — a session's four claudio archives -> ``.1s``/``.1sc``
  products (``go_1s.m``);
- ``campaign`` — campaign series from the go1s summaries;
- ``dllpll`` — the DLL/PLL multi-channel receiver (``rxcomplex.cpp
  data.bin`` with ``sdr.param``): the device-banked receiver, or with
  ``--host`` the host-sequential one; ``--serve PORT`` broadcasts every
  report to TCP subscribers;
- ``batch`` — directory batch processing (``goprocess.sh``);
- ``monitor`` — near-real-time follow of a growing capture (the
  ``zmq_rx.py`` role), ``--serve`` to broadcast, ``--connect`` to
  subscribe (``--plot`` draws the live view);
- ``acquire`` — record an fc32 sample stream to an sc16 capture;
- ``emit`` — synthesize a capture;
- ``config`` — dump or validate a TwstftConfig JSON.

``prn``, ``gofinal``, ``twoway``, ``go1s``, ``campaign``, ``acquire``,
``emit``, ``config`` and ``monitor --connect`` take no device.  Every
other verb runs on the card unless ``--device cpu`` is given.
``goranging --sharded`` (the multi-device pipeline) is not ported yet and
exits with an error.
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
                   help="wrap the run in a torch.profiler trace (CPU and "
                        "CUDA activity; a Chrome trace JSON in LOGDIR)")
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
                   help="force the host-sequential oracle Receiver "
                        "(default: the device-banked receiver)")
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
                   help="broadcast per-second tracking reports to TCP "
                   "subscribers on PORT (the monitor --serve protocol; "
                   "consume with monitor --connect)")
    p.add_argument("--serve-min-clients", type=int, default=0, metavar="N",
                   help="--serve: wait for N subscribers before tracking "
                   "starts")
    p.add_argument("--serve-host", default="127.0.0.1",
                   help="--serve bind address (0.0.0.0 for remote "
                   "consumers)")
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


def _live_parsers(sub) -> None:
    p = sub.add_parser("monitor", help="near-real-time follow of a growing "
                       "capture (zmq_rx.py equivalent)")
    p.add_argument("capture", nargs="?",
                   help="growing sc16 capture (omit with --connect)")
    p.add_argument("code", nargs="?",
                   help="PRN code file (omit with --connect)")
    _add_signal_args(p)
    p.add_argument("--channels", type=int, default=2)
    p.add_argument("--epochs", type=int, default=25,
                   help="epochs per processing batch (default 1 s)")
    p.add_argument("--timeout", type=float, default=10.0,
                   help="stop after this many idle seconds")
    p.add_argument("--once", action="store_true",
                   help="process what is there and exit (no tailing)")
    p.add_argument("--serve", type=int, metavar="PORT", default=None,
                   help="also broadcast rows + decimated spectra to TCP "
                   "subscribers on PORT (0 = ephemeral; the ZMQ pub role "
                   "of x310_twstft_gr.py)")
    p.add_argument("--connect", metavar="HOST:PORT", default=None,
                   help="subscribe to a --serve producer and print its "
                   "rows (the zmq_rx.py consumer role); no processing "
                   "happens locally")
    p.add_argument("--plot", action="store_true",
                   help="--connect: render the live view (spectra + "
                   "delay/SNR tracks, the zmq_rx.py Qt GUI role) with "
                   "matplotlib instead of printing rows; headless hosts "
                   "get a refreshing PNG snapshot (--plot-file)")
    p.add_argument("--plot-file", default="monitor_live.png",
                   help="--plot: snapshot path (default %(default)s)")
    p.add_argument("--plot-interactive", action="store_true",
                   help="--plot: open a live matplotlib window instead "
                   "of writing snapshots (needs a display)")
    p.add_argument("--serve-min-clients", type=int, default=0,
                   metavar="N", help="--serve: wait for N subscribers "
                   "before processing starts (scripted/batch use where "
                   "consumers must not miss the head of the stream)")
    p.add_argument("--serve-host", default="127.0.0.1",
                   help="--serve bind address (0.0.0.0 for remote "
                   "consumers, the zmq_rx.py use case)")
    _add_device_arg(p)

    p = sub.add_parser(
        "acquire", help="record an fc32 sample stream to an sc16 capture "
        "(the b210_file.py flowgraph stages: interleave, x32767, "
        "complex-to-ishort, head)"
    )
    p.add_argument("output", help="sc16 capture file")
    p.add_argument("--from", dest="source", default="-",
                   help="byte source: '-' stdin (default), tcp:HOST:PORT, "
                   "or a file/FIFO path")
    p.add_argument("--fs", type=float, default=5e6)
    p.add_argument("--seconds", type=float, default=185.0,
                   help="head bound (fs*seconds frames; b210_file.py "
                   "records 185 s)")
    p.add_argument("--channels", type=int, default=2)
    p.add_argument("--scale", type=float, default=32767.0)


def _tool_parsers(sub) -> None:
    p = sub.add_parser("prn", help="generate PRN code files / search taps")
    p.add_argument("--bitlen", type=int, required=True)
    p.add_argument("--noiselen", type=int)
    p.add_argument("--taps", type=int)
    p.add_argument("--taps-b", type=int)
    p.add_argument("--search", type=int, metavar="N",
                   help="search the first N maximal-length taps")
    p.add_argument("-o", "--output")

    p = sub.add_parser("emit", help="synthesize a capture (FPGA TX chain + "
                       "channel simulation at baseband)")
    p.add_argument("output", help="sc16 output file")
    _add_signal_args(p)
    p.add_argument("--seconds", type=int, default=1)
    p.add_argument("--delay", type=float, default=0.0, help="samples")
    p.add_argument("--doppler", type=float, default=0.0, help="Hz")
    p.add_argument("--amplitude", type=float, default=1000.0)
    p.add_argument("--noise", type=float, default=100.0)
    p.add_argument("--delay2", type=float, help="2nd channel delay (samples)")
    p.add_argument("--doppler2", type=float, default=0.0)
    p.add_argument("--qpsk", action="store_true")
    p.add_argument("--taps-b", type=int, help="QPSK second LFSR taps")
    p.add_argument("--timecode", choices=["off", "invert", "timecode"],
                   default="off")
    p.add_argument("--seed", type=int, default=0)

    p = sub.add_parser("config", help="dump or round-trip a config JSON")
    p.add_argument("--load")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="twstft-torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    _tool_parsers(sub)
    _dllpll_parser(sub)
    _ranging_parsers(sub)
    _claudio_parsers(sub)
    _twoway_parsers(sub)
    _live_parsers(sub)
    args = parser.parse_args(argv)
    if args.cmd == "goranging":
        if args.sharded:
            parser.error("goranging --sharded: the multi-device pipeline is "
                         "not ported yet")
        from amaranth_twstft_tpu_torch.utils.profiling import trace

        with trace(args.profile):
            return _goranging(args)
    verbs = {"prn": _prn, "dllpll": _dllpll, "ranging": _ranging,
             "claudio": _claudio, "batch": _batch, "gofinal": _gofinal,
             "twoway": _twoway, "go1s": _go1s, "campaign": _campaign,
             "monitor": _monitor, "acquire": _acquire, "emit": _emit,
             "config": _config}
    return verbs[args.cmd](args)


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
    from amaranth_twstft_tpu_torch.models.dllpll import (
        Receiver,
        dat_filename,
        parse_sdr_param,
    )
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
    # the device-banked receiver (one receiver per homogeneous channel
    # geometry) unless --host forces the sequential oracle
    geoms = {
        (int(round(args.fs / c.chip_rate)) * c.code_len,
         c.codes_per_second, c.nlag)
        for c in chans
    }
    use_bank = not args.host
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
    if not use_bank:
        rx = Receiver(chans, fs=args.fs, device=args.device)
    else:
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

    server = None
    if args.serve is not None:
        from amaranth_twstft_tpu_torch.utils.stream import MonitorServer

        server = MonitorServer(
            host=args.serve_host, port=args.serve,
            hello={"fs": args.fs, "mode": "dllpll", "channels": len(chans),
                   "capture": os.path.basename(args.capture)},
        )
        print(f"# serving on {server.host}:{server.port}", flush=True)

    def emit(sec_idx, reports):
        for ch, rep in zip(rx.channels, reports):
            if rep is None:
                continue
            if server is not None:
                server.publish({
                    "type": "track", "second": sec_idx,
                    "physical": ch.cfg.physical,
                    "prn": int(ch.cfg.prn_id),
                    "fc_hz": round(float(rep.fc_hz), 6),
                    "phi_cycles": round(float(rep.phi_cycles), 8),
                    "cnt": int(rep.cnt),
                    "gd_ns": round(float(rep.gd_ns), 6),
                    "dg_ns_per_s": round(float(rep.dg_ns_per_s), 6),
                    "sdgd_ns": round(float(rep.sdgd_ns), 4),
                    "pk_dbm": round(float(rep.pk_dbm), 3),
                    "pnoise_dbm": round(float(rep.pnoise_dbm), 3),
                })
            print(
                f"{sec_idx} {ch.cfg.physical} PRN{ch.cfg.prn_id} "
                f"{rep.fc_hz:14.6f} {rep.phi_cycles:11.8f} "
                f"{rep.cnt:3d} {rep.gd_ns:14.6f} {rep.dg_ns_per_s:11.6f} "
                f"{rep.sdgd_ns:8.4f} {rep.pk_dbm:7.3f} {rep.pnoise_dbm:7.3f}"
            )
            if args.out_dir and not use_bank:
                # the banked receiver writes its own .dat rows
                with open(os.path.join(args.out_dir, dat_filename(ch.cfg)),
                          "a") as f:
                    f.write(rep.row(ch.nobs / args.fs) + "\n")

    try:
        if server is not None and args.serve_min_clients:
            t0 = time.time()
            while (server.n_clients < args.serve_min_clients
                   and time.time() - t0 < args.idle_timeout + 30.0):
                time.sleep(0.05)
        if use_bank and len(geoms) == 1:
            # prefetching stream loop: second s+1's upload runs on a
            # copy stream beside second s's compute (run_stream
            # serializes SIC configs itself)
            for s_idx, reports in enumerate(rx.run_stream(seconds_gen())):
                emit(s_idx, reports)
        else:
            # host oracle / heterogeneous MultiBank: sequential
            for s_idx, sec in enumerate(seconds_gen()):
                emit(s_idx, rx.process_second(sec))
        if args.out_dir and not use_bank:
            with open(os.path.join(args.out_dir, "rxcomplex.log"), "a") as f:
                for line in rx.log:
                    f.write(line + "\n")
        for line in rx.log:
            print(line, file=sys.stderr)
    finally:
        if server is not None:
            server.close()
    return 0


def _prn(args) -> int:
    from amaranth_twstft_tpu_torch.ops.lfsr import (
        find_mseq_taps,
        prn_default_filename,
        write_prn_file,
    )

    if args.search:
        for t in find_mseq_taps(args.bitlen, args.search):
            print(t)
        return 0
    if args.taps is None or args.noiselen is None:
        print("need --taps and --noiselen (or --search)", file=sys.stderr)
        return 2
    out = args.output or prn_default_filename(
        args.bitlen, args.noiselen, args.taps, args.taps_b
    )
    write_prn_file(out, args.bitlen, args.noiselen, args.taps, args.taps_b)
    print(out)
    return 0


def _print_track_msg(msg: dict) -> None:
    """One ``dllpll --serve`` report as the dllpll verb prints it."""
    print(
        f"{msg['second']} {msg['physical']} PRN{msg['prn']} "
        f"{msg['fc_hz']:14.6f} {msg['phi_cycles']:11.8f} {msg['cnt']:3d} "
        f"{msg['gd_ns']:14.6f} {msg['dg_ns_per_s']:11.6f} "
        f"{msg['sdgd_ns']:8.4f} {msg['pk_dbm']:7.3f} {msg['pnoise_dbm']:7.3f}",
        flush=True,
    )


def _monitor_connect(args) -> int:
    """The consumer role (``zmq_rx.py``): print or plot a producer's
    messages; no processing happens locally."""
    from amaranth_twstft_tpu_torch.utils.stream import connect_monitor

    host, _, port = args.connect.rpartition(":")
    if not port.isdigit():
        print(f"monitor --connect: expected HOST:PORT, got {args.connect!r}",
              flush=True)
        return 2
    msgs = connect_monitor(host or "127.0.0.1", int(port),
                           timeout_s=args.timeout + 30.0)
    try:
        if args.plot:
            # live view (the zmq_rx.py Qt GUI role)
            from amaranth_twstft_tpu_torch.utils.plotview import LiveMonitorPlot

            view = LiveMonitorPlot(
                interactive=args.plot_interactive,
                save_path=None if args.plot_interactive else args.plot_file,
            )
            out = view.run(msgs)
            if out:
                print(out, flush=True)
            return 0
        print("# epoch ch delay_samp df_hz snr_db cn0_dbhz "
              "| track: s phys PRN fc phi cnt gd dg sdgd Pk Pn", flush=True)
        for msg in msgs:
            if msg.get("type") == "row":
                print(f"{msg['epoch']:6d} {msg['ch']} "
                      f"{msg['delay_samp']:12.4f} {msg['df_hz']:9.2f} "
                      f"{msg['snr_db']:7.2f} {msg['cn0_dbhz']:6.2f}",
                      flush=True)
            elif msg.get("type") == "track":
                _print_track_msg(msg)
    except (ConnectionRefusedError, ConnectionResetError) as e:
        # consumers routinely start before/around producers
        print(f"monitor --connect: {e} (is the producer --serve-ing on "
              f"{args.connect}?)", flush=True)
        return 1
    except (TimeoutError, OSError) as e:
        print(f"monitor --connect: {e}", flush=True)
        return 1
    return 0


def _monitor(args) -> int:
    if args.connect:
        return _monitor_connect(args)
    if not args.capture or not args.code:
        print("monitor: capture and code are required unless --connect",
              flush=True)
        return 2
    import torch

    from amaranth_twstft_tpu_torch.config import ProcessingConfig
    from amaranth_twstft_tpu_torch.models.godual import build_replica
    from amaranth_twstft_tpu_torch.models.twoway import cn0_dbhz
    from amaranth_twstft_tpu_torch.ops import boundary, doppler
    from amaranth_twstft_tpu_torch.pipeline import follow_capture
    from amaranth_twstft_tpu_torch.utils.platform import resolve_device

    sig = _signal(args)
    dev = resolve_device(args.device)
    rep = build_replica(args.code, sig, ProcessingConfig())
    mask = doppler.window_mask(sig.samples_per_code, sig.fs, -20e3, 20e3)
    # the complex64 epochs go to the step as they are (the JAX package's
    # pack_complex relay boundary is not carried over); one packed fetch
    # per batch
    step = boundary.make_ranging_step(rep.fcode, rep.code_interp, mask, sig.fs,
                                      packed=True, device=dev)
    server = None
    if args.serve is not None:
        from amaranth_twstft_tpu_torch.utils.stream import (
            MonitorServer,
            spectrum_summary,
        )

        server = MonitorServer(
            host=args.serve_host, port=args.serve,
            hello={"fs": sig.fs, "channels": args.channels,
                   "capture": os.path.basename(args.capture)},
        )
        print(f"# serving on {server.host}:{server.port}", flush=True)
    try:
        if server is not None and args.serve_min_clients:
            t0 = time.time()
            while (server.n_clients < args.serve_min_clients
                   and time.time() - t0 < args.timeout + 30.0):
                time.sleep(0.05)
        print("# epoch ch delay_samp df_hz snr_db cn0_dbhz", flush=True)
        for epoch0, ch, iq in follow_capture(
            args.capture, sig, channels=args.channels,
            epochs_per_batch=args.epochs, timeout_s=args.timeout,
            stop_when_idle=args.once,
        ):
            out = boundary.unpack_outputs(
                step(torch.from_numpy(iq).to(dev)).cpu().numpy())
            delay = out.delay_samples()
            snr = out.snr_db()
            cn0 = cn0_dbhz(out.snr_r, out.snr_i, sig.fs)
            for i in range(len(delay)):
                print(f"{epoch0 + i:6d} {ch} {delay[i]:12.4f} "
                      f"{out.df[i]:9.2f} {snr[i]:7.2f} {cn0:6.2f}", flush=True)
                if server is not None:
                    server.publish({
                        "type": "row", "epoch": int(epoch0 + i), "ch": int(ch),
                        "delay_samp": round(float(delay[i]), 4),
                        "df_hz": round(float(out.df[i]), 2),
                        "snr_db": round(float(snr[i]), 2),
                        "cn0_dbhz": round(float(cn0), 2),
                    })
            if server is not None:
                bins, flo, fhi = spectrum_summary(iq, sig.fs)
                server.publish({
                    "type": "spectrum", "epoch": int(epoch0), "ch": int(ch),
                    "bins_db": bins, "f_lo_hz": flo, "f_hi_hz": fhi,
                })
    finally:
        if server is not None:
            server.close()
    return 0


def _acquire(args) -> int:
    from amaranth_twstft_tpu_torch.utils.recorder import (
        open_source,
        record_fc32_stream,
    )

    src = open_source(args.source)
    try:
        n = record_fc32_stream(src, args.output, args.fs, args.seconds,
                               channels=args.channels, scale=args.scale)
    finally:
        if src is not sys.stdin.buffer:
            src.close()
    print(json.dumps({"frames": n, "seconds": n / args.fs,
                      "path": args.output}))
    return 0 if n > 0 else 1


def _emit(args) -> int:
    from amaranth_twstft_tpu_torch.config import Modulation, TimeCoderMode
    from amaranth_twstft_tpu_torch.models.emitter import (
        ChannelSim,
        synthesize_capture,
    )
    from amaranth_twstft_tpu_torch.utils import io as uio

    tc = {"off": TimeCoderMode.OFF, "invert": TimeCoderMode.INVERT_FIRST_CODE,
          "timecode": TimeCoderMode.TIMECODE}[args.timecode]
    sig = dataclasses.replace(
        _signal(args),
        modulation=Modulation.QPSK if args.qpsk else Modulation.BPSK,
        taps_b=args.taps_b, timecoder=tc,
    )
    chans = [ChannelSim(delay_samples=args.delay, doppler_hz=args.doppler,
                        amplitude=args.amplitude, noise_sigma=args.noise)]
    if args.delay2 is not None:
        chans.append(ChannelSim(delay_samples=args.delay2,
                                doppler_hz=args.doppler2,
                                amplitude=args.amplitude,
                                noise_sigma=args.noise))
    streams = synthesize_capture(sig, chans, n_seconds=args.seconds,
                                 seed=args.seed)
    uio.write_sc16(args.output, *streams)
    print(args.output)
    return 0


def _config(args) -> int:
    from amaranth_twstft_tpu_torch.config import TwstftConfig

    if args.load:
        try:
            with open(args.load) as f:
                cfg = TwstftConfig.from_json(f.read())
        except (OSError, ValueError, TypeError) as e:
            print(f"invalid config {args.load}: {e}", file=sys.stderr)
            return 1
        print(f"ok hash={cfg.config_hash()}", file=sys.stderr)
        print(cfg.to_json())
    else:
        print(TwstftConfig().to_json())
    return 0


if __name__ == "__main__":
    sys.exit(main())
