"""Driver of the ``rx_bank`` configuration: the banked DLL/PLL receiver
(``models/tracker.BankedReceiver``, built as the ``dllpll`` verb builds
it) over a stream of seconds read from a ring capture.

Set-up writes the ring, builds the receiver and pulls the stream's
first seconds (acquisition, the first tracked second, the first
reports).  The window pulls seconds until ``--seconds`` have passed.
Second s is read with the verb's own call,
``read_sc16_epochs(ring, (s mod N) fs, 1, fs + nobs, channels=2)``.

The check follows the receiver second by second: for the seconds drawn
from the seed, each channel's report is held to the plain reference
(``reference/bank.py``) run from the state the receiver started that
second with, and the state the receiver carries into the next second to
the reference's update.  The start, the acquisition that the reference
does not follow, is held to the injected truths: a channel whose first
window second reports its carrier more than half a hertz or its delay
more than half a sample off the truth would round to another state.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from reference import bank as ref_bank
from traffic import generate
from traffic.lfsr import chips as lfsr_chips

#: the numbers the check can compare, in the order they are printed; a cell
#: compares those its traffic file gives a limit
NUMBERS = ("lock_missing", "start_off_truth", "state_mismatch", "state_phase_gap_cyc",
           "fc_gap_hz", "phi_excess_gap_cyc", "gd_gap_ns", "pk_gap_db", "pnoise_gap_db")
#: the receiver reports ``phi = (c0p + 1000) mod 1`` with ``c0p`` in float32,
#: so its phase is rounded to a multiple of 2**-14 cycles (the ulp of 1000 in
#: float32), off by up to 2**-15; the phase gap is compared beyond that
PHI_ROUNDING_CYC = 2.0 ** -15


def gate_gap_ns(gate_ns: np.ndarray, extra: int) -> float:
    """The least gap of a code's delay statistic that explains a code
    count ``extra`` above the reference's (below it where negative): the
    gate took ``extra`` codes that the reference's left, or left codes it
    took, so the program's statistic of each lies at least the
    ``|extra|``-th least distance to the gate away from the reference's
    (``gate_ns``: each code's distance, negative where the gate passes
    it, NaN where an earlier gate dropped it).  Infinite where there are
    not so many codes on that side."""
    d = np.sort(gate_ns[gate_ns >= 0] if extra > 0 else -gate_ns[gate_ns < 0])
    k = abs(int(extra))
    return float(d[k - 1]) if len(d) >= k else float("inf")


class Driver:
    def __init__(self, cell, seed: int, device, work: str, trace: bool,
                 transfer: str | None = None):
        self.cfg, self.mix = cell.config, cell.traffic
        self.seed, self.dev, self.work = seed, device, work
        self.transfer = transfer or self.cfg["transfer"]
        c = self.cfg
        self.fs = int(c["fs"])
        self.nobs = int(c["code_len"]) * int(round(c["fs"] / c["chip_rate"]))
        self.N = int(self.mix["ring_seconds"])
        self.ring = os.path.join(work, "ring.sc16")
        self.read_start: dict[int, float] = {}
        self.seconds: list[dict] = []  # per pulled second: index, state, reports, end
        self.t0 = self.t1 = None

    # -- the stream -------------------------------------------------------------
    def _stream(self):
        s = 0
        while True:
            t = time.perf_counter()
            d, _ = self.io.read_sc16_epochs(self.ring, (s % self.N) * self.fs, 1,
                                            self.fs + self.nobs, channels=2)
            self.read_start[s] = t
            yield {"A": d[0, 0], "B": d[1, 0]}
            s += 1

    def _pull(self) -> dict:
        state = [(st.pt, st.fc, st.last_phi, st.is_trk, st.is_first) for st in self.rx.states]
        reports = next(self.stream)
        rec = {"s": len(self.seconds), "state": state, "reports": reports,
               "end": time.perf_counter()}
        self.seconds.append(rec)
        return rec

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        from amaranth_twstft_tpu_torch.models.dllpll import ChannelConfig
        from amaranth_twstft_tpu_torch.models.tracker import BankedReceiver
        from amaranth_twstft_tpu_torch.utils import io

        self.io = io
        c = self.cfg
        t0 = time.perf_counter()
        self.truths = generate.ring_capture(c, c["taps"], self.mix, self.seed, self.dev,
                                            self.ring)
        chans = [ChannelConfig(physical=t["input"], prn_id=100 + i, bit_len=c["bit_len"],
                               taps=t["taps"], fc_init_hz=c["fc_init_hz"],
                               chip_rate=c["chip_rate"], code_len=c["code_len"],
                               filter_hz=c["filter_hz"], acq_range_hz=c["acq_range_hz"],
                               acq_step_hz=c["acq_step_hz"], snr_min_db=c["snr_min_db"],
                               nlag=c["nlag"])
                 for i, t in enumerate(self.truths)]
        t1 = time.perf_counter()
        dat = os.path.join(self.work, "dat")
        os.makedirs(dat)
        self.rx = BankedReceiver(chans, fs=c["fs"], group=c["group"], out_dir=dat,
                                 transfer=self.transfer, device=self.dev)
        self.stream = self.rx.run_stream(self._stream())
        t2 = time.perf_counter()
        for _ in range(int(self.mix["setup_seconds"])):
            self._pull()
        print(f"set-up: ring written in {t1 - t0:.3f} s, receiver built in {t2 - t1:.3f} s, "
              f"first seconds {[round(r['end'] - t2, 3) for r in self.seconds]} s",
              file=sys.stderr)

    # -- the window -------------------------------------------------------------
    def window(self, seconds: float, spans) -> None:
        self.first = len(self.seconds)
        self.t0 = time.perf_counter()
        while time.perf_counter() - self.t0 < seconds:
            self._pull()
        self.t1 = self.seconds[-1]["end"]
        ends = [self.t0] + [r["end"] for r in self._window_seconds()]
        step = np.diff(ends)
        print(f"window: {len(step)} seconds; step s (min, median, max) "
              f"{np.percentile(step, [0, 50, 100]).round(4)}", file=sys.stderr)

    def _window_seconds(self) -> list[dict]:
        return self.seconds[self.first:]

    def end_to_end(self) -> dict:
        win = self._window_seconds()
        n = sum(r is not None for rec in win for r in rec["reports"])
        lat = [rec["end"] - self.read_start[rec["s"]] for rec in win
               if self.read_start[rec["s"]] >= self.t0]
        return {"chan_s_per_s": n / (self.t1 - self.t0),
                "second_p90_ms": 1e3 * float(np.percentile(lat, 90))}

    def span_targets(self) -> list:
        """The layers' spans of a traced window; the lag bank's launch
        shapes are kept too, for its roofline."""
        from amaranth_twstft_tpu_torch.models import tracker

        self.shapes: list[tuple] = []
        self._lag_bank = orig = tracker.lag_bank_windows

        def shaped(obs, wav_ext, nlag, *a, **kw):
            self.shapes.append((*obs.shape, nlag))
            return orig(obs, wav_ext, nlag, *a, **kw)

        tracker.lag_bank_windows = shaped
        cls = tracker.BankedReceiver
        return [(self.io, "read_sc16_epochs", "read"), (cls, "_pack_second", "pack"),
                (cls, "upload_second", "upload"), (cls, "process_second", "process")]

    def layer_data(self, spans, trace) -> dict:
        return {"spans": spans, "trace": trace, "t0": self.t0, "t1": self.t1,
                "lag_bank_shapes": getattr(self, "shapes", []), "config": self.cfg}

    def release(self) -> None:
        if hasattr(self, "_lag_bank"):
            from amaranth_twstft_tpu_torch.models import tracker

            tracker.lag_bank_windows = self._lag_bank
        self.stream.close()
        del self.stream, self.rx

    # -- the check ----------------------------------------------------------------
    def check_seconds(self) -> list[dict]:
        """The window seconds the check follows: ``mix["check_seconds"]``
        drawn from the seed, the first always among them."""
        win = self._window_seconds()
        rng = np.random.default_rng(self.seed)
        k = min(len(win) - 1, int(self.mix["check_seconds"]) - 1)
        pick = [0] + sorted(rng.choice(np.arange(1, len(win)), k, replace=False).tolist())
        return [win[i] for i in pick]

    def reference_second(self, rec: dict, wav, psbb, chunk: int = 8) -> dict:
        """The reference's fields, (C,) each, for one pulled second."""
        c = self.cfg
        s = rec["s"] % self.N
        raw = np.fromfile(self.ring, np.int16, count=(self.fs + self.nobs) * 4,
                          offset=s * self.fs * 8).reshape(-1, 4).astype(np.float64)
        x = torch.from_numpy(np.stack([raw[:, 0] + 1j * raw[:, 1],
                                       raw[:, 2] + 1j * raw[:, 3]])).to(self.dev)
        rows = [0 if t["input"] == "A" else 1 for t in self.truths]
        pt = np.array([st[0] for st in rec["state"]], np.float64)
        fc = np.array([st[1] for st in rec["state"]], np.float64)
        lp = np.array([st[2] for st in rec["state"]], np.float64)
        parts = []
        for j0 in range(0, len(rows), chunk):
            j1 = min(len(rows), j0 + chunk)
            parts.append(ref_bank.track(
                x, rows[j0:j1], wav[j0:j1], psbb[j0:j1], pt[j0:j1], fc[j0:j1], lp[j0:j1],
                fs=float(c["fs"]), bps=self.fs // self.nobs, nlag=int(c["nlag"])))
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    def compare(self, checked, refs) -> dict:
        """The numbers over the followed seconds.  Where a channel's code
        count differs from the reference's, its fields and the state it
        carries on (the last phase is the last gated code's) rest on other
        codes and are not compared; the codes its gate took or left
        otherwise give ``gd_gap_ns`` their distance to the gate
        (``gate_gap_ns``)."""
        nums = {k: 0.0 for k in NUMBERS}
        ns = 1e9 / self.fs
        period = self.nobs * ns
        nxt = {rec["s"]: rec for rec in self.seconds}
        for rec, ref in zip(checked, refs):
            after = nxt.get(rec["s"] + 1)
            for i, rep in enumerate(rec["reports"]):
                if rep is None or not ref["locked"][i]:
                    nums["lock_missing"] += 1
                    continue
                if rep.cnt != ref["cnt"][i]:
                    nums["gd_gap_ns"] = max(nums["gd_gap_ns"],
                                            gate_gap_ns(ref["gate_ns"][i], rep.cnt - ref["cnt"][i]))
                    continue
                if after is not None:
                    pt1, fc1, lp1 = after["state"][i][:3]
                    nums["state_mismatch"] += (pt1 != ref["pt_next"][i]
                                               or fc1 != ref["fc_next"][i])
                    nums["state_phase_gap_cyc"] = max(nums["state_phase_gap_cyc"],
                                                      abs(lp1 - ref["last_phi_next"][i]))
                dphi = (rep.phi_cycles - ref["phi_cycles"][i] + 0.5) % 1.0 - 0.5
                for key, gap in (("fc_gap_hz", rep.fc_hz - ref["fc_hz"][i]),
                                 ("phi_excess_gap_cyc", max(abs(dphi) - PHI_ROUNDING_CYC, 0.0)),
                                 ("gd_gap_ns", rep.gd_ns - ref["gd_ns"][i]),
                                 ("pk_gap_db", rep.pk_dbm - ref["pk_dbm"][i]),
                                 ("pnoise_gap_db", rep.pnoise_dbm - ref["pnoise_dbm"][i])):
                    nums[key] = max(nums[key], abs(float(gap)))
        fc_gap = gd_gap = 0.0
        for i, rep in enumerate(checked[0]["reports"]):
            if rep is None:
                continue
            t = self.truths[i]
            err = (rep.gd_ns - t["delay"] * ns) % period
            f, g = abs(rep.fc_hz - t["doppler"]), min(err, period - err) / ns
            nums["start_off_truth"] += f > 0.5 or g > 0.5
            fc_gap, gd_gap = max(fc_gap, f), max(gd_gap, g)
        print(f"start against the truths: carrier {fc_gap!r} Hz, delay {gd_gap!r} samples "
              f"at most", file=sys.stderr)
        return nums

    def check(self):
        from harness import Compared

        c = self.cfg
        checked = self.check_seconds()
        chips = lfsr_chips(c["bit_len"], [t["taps"] for t in self.truths], c["code_len"])
        wav, psbb = ref_bank.replicas(chips, int(round(c["fs"] / c["chip_rate"])),
                                      float(c["fs"]), float(c["filter_hz"]), self.dev)
        refs = [self.reference_second(rec, wav, psbb) for rec in checked]
        nums = self.compare(checked, refs)
        cmp = Compared()
        for k in NUMBERS:
            if k in self.mix["limits"]:
                cmp.add(k, nums[k], self.mix["limits"][k])
        win = self._window_seconds()
        attempted = len(win) * len(self.truths)
        failed = sum(r is None for rec in win for r in rec["reports"])
        return cmp, attempted, failed


def control(cell, seed: int, device, work: str, seconds: float):
    """The control: the program's own int8 transfer (the step below the
    float16 the configuration states) over a window of ``seconds``,
    checked as a run is.  Returns the numbers and limits."""
    drv = Driver(cell, seed, device, work, False, transfer="int8")
    drv.setup()
    drv.window(seconds, None)
    drv.release()
    return drv.check()[0]
