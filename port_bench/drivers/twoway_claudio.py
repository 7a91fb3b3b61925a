"""Driver of the ``twoway_claudio`` configuration: a station's files of a
two-way session through ``models/claudio.process_file``.

Set-up writes the traffic's files and code files under the run's work
directory and processes each file once (both codes' resident steps
built).  The window processes the files in turn, each into a fresh
output directory, until ``--seconds`` have passed; the file under way
then completes.  The check reads every ``.mat`` the window wrote and
holds it to the plain reference (``reference/claudio.py``) of its file.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import scipy.io as sio

from reference import claudio as ref_claudio
from traffic import generate
from traffic.lfsr import chips as lfsr_chips

#: the numbers the check compares, in the order they are printed
NUMBERS = ("structure", "df_bin_mismatch", "delay_gap_ns", "xval_gap_rel", "snr_gap_db")


def read_mat(path: str) -> dict:
    md = sio.loadmat(path)
    col = lambda k: np.asarray(md[k]).reshape(-1)  # noqa: E731
    return {"indice": col("indice1"), "correction": col("correction1"),
            "xval": col("xval1"), "snr_r": col("SNR1r"), "snr_i": col("SNR1i"),
            "df": col("df"), "moved": [int(v) for v in col("moved")],
            "carry_trimmed": "carry_trimmed" in md}


def compare(prog: dict, ref: dict, fs: float, interp: int, df_bin: float) -> dict:
    """The numbers of one file: ``structure`` counts a disagreement in
    what was found, the codes' count, the slips or a carry trim (every
    gap is then infinite); the gaps are each the worst code's.  The df is
    an argmax on the squaring spectrum's bins, ``df_bin`` apart on the df
    axis, read off the port's float32 frequency axis: the codes whose df
    lies on another bin than the reference's are counted.  The complex
    peak is held whole, its phase with its magnitude:
    ``|xval - xval_ref| / |xval_ref|``."""
    n = len(prog.get("indice", ()))
    same = (ref["found"] and n == len(ref["indice"]) and n > 0
            and prog["moved"] == ref["moved"] and not prog["carry_trimmed"])
    if not same:
        return dict({k: float("inf") for k in NUMBERS}, structure=1.0)
    delay = lambda r: r["indice"] + r["correction"] / interp  # noqa: E731
    snr = lambda r: 10 * np.log10(np.maximum(r["snr_r"] + r["snr_i"], 1e-30))  # noqa: E731
    return {
        "structure": 0.0,
        "df_bin_mismatch": float(np.sum(np.abs(prog["df"] - ref["df"]) > df_bin / 2)),
        "delay_gap_ns": float(np.max(np.abs(delay(prog) - delay(ref)))) * 1e9 / fs,
        "xval_gap_rel": float(np.max(np.abs(prog["xval"] - ref["xval"]) / np.abs(ref["xval"]))),
        "snr_gap_db": float(np.max(np.abs(snr(prog) - snr(ref)))),
    }


class Driver:
    def __init__(self, cell, seed: int, device, work: str, trace: bool):
        self.cfg, self.mix = cell.config, cell.traffic
        self.seed, self.dev, self.work = seed, device, work
        self.done: list[dict] = []
        self.t0 = self.t1 = None

    # -- set-up ---------------------------------------------------------------
    def _proc_kwargs(self, spec: dict) -> dict:
        from amaranth_twstft_tpu_torch.config import ProcessingConfig, SignalConfig, StationConfig

        c, p = self.cfg, self.cfg["processing"]
        return dict(
            signal=SignalConfig(fs=c["fs"], chip_rate=c["chip_rate"], code_len=c["code_len"],
                                bit_len=c["bit_len"]),
            proc=ProcessingConfig(
                conjugate_data=True, nint=p["nint"], block_seconds=p["block_seconds"],
                skip_seconds=p["skip_seconds"], df_threshold=p["df_threshold"],
                snr_gate_db=p["snr_gate_db"]),
            station=StationConfig(op=c["station"] == "OP"),
            remote=spec["remote"], ranging=False, transfer=c["transfer"],
            max_slip_passes=p["max_slip_passes"],
            df_window_hz=tuple(c["df_window_hz"]),
            device=self.dev)

    def make_files(self) -> None:
        c = self.cfg
        self.codes = {}
        for name, taps in c["codes"].items():
            path = os.path.join(self.work, f"code_{name}.bin")
            generate.write_code_file(path, lfsr_chips(c["bit_len"], [taps], c["code_len"])[0])
            self.codes[name] = path
        specs = self.mix["files"]
        paths = [os.path.join(self.work, f"{s['name']}.bin") for s in specs]
        self.files = generate.single_channel_files(
            c, specs, c["codes"], dict(self.mix, seconds=c["file_seconds"]), self.seed,
            self.dev, paths)
        for f, s in zip(self.files, specs):
            f["spec"] = s
            f["kw"] = self._proc_kwargs(s)
            f["n_iq"] = os.path.getsize(f["path"]) // 4

    def setup(self) -> None:
        from amaranth_twstft_tpu_torch.models import claudio

        self.claudio = claudio
        t0 = time.perf_counter()
        self.make_files()
        t1 = time.perf_counter()
        for i, f in enumerate(self.files):  # each code's resident steps, warm
            self._process(f, os.path.join(self.work, "warm", str(i)))
        print(f"set-up: files written in {t1 - t0:.3f} s, warm files "
              f"{time.perf_counter() - t1:.3f} s", file=sys.stderr)

    def _process(self, f: dict, out_dir: str) -> dict:
        os.makedirs(out_dir)
        out = self.claudio.process_file(f["path"], self.codes[f["code"]], out_dir=out_dir,
                                        **f["kw"])
        if out is None:
            raise RuntimeError(f"{out_dir}: output already there")
        return out

    # -- the window -------------------------------------------------------------
    def window(self, seconds: float, spans) -> None:
        self.t0 = time.perf_counter()
        k = 0
        while time.perf_counter() - self.t0 < seconds:
            i = k % len(self.files)
            out = self._process(self.files[i], os.path.join(self.work, "out", str(k)))
            t = time.perf_counter()
            self.done.append({"file": i, "mat": out["mat_path"], "timing": out["timing"],
                              "found": out["found"], "end": t})
            k += 1
        self.t1 = self.done[-1]["end"]
        q = lambda key: np.percentile([d["timing"][key] for d in self.done], [0, 50, 100])  # noqa: E731
        print(f"window: {len(self.done)} files; per file total_s {q('total_s').round(3)}, "
              f"quantize_s {q('quantize_s').round(3)}, read_s {q('read_s').round(3)} "
              f"(min, median, max)", file=sys.stderr)

    def end_to_end(self) -> dict:
        n = sum(self.files[d["file"]]["n_iq"] for d in self.done)
        return {"iq_msps": n / (self.t1 - self.t0) / 1e6}

    def span_targets(self) -> list:
        from amaranth_twstft_tpu_torch.utils import io, matio

        cl = self.claudio
        return [(io, "read_raw16", "read"), (cl, "_quantize_q8", "quantize"),
                (cl, "_hunt", "hunt"), (cl._Resident, "block_step", "block_step"),
                (cl, "_decode_packed", "decode"), (matio, "save_claudio_style", "mat_write")]

    def layer_data(self, spans, trace) -> dict:
        return {"files": [d["timing"] for d in self.done], "spans": spans, "trace": trace,
                "t0": self.t0, "t1": self.t1, "config": self.cfg}

    def release(self) -> None:
        self.claudio._RESIDENT_CACHE.clear()

    # -- the check ----------------------------------------------------------------
    def df_bin(self) -> float:
        """The spacing of the df axis: half the block spectrum's bin."""
        return 1.0 / self.cfg["processing"]["block_seconds"] / 2.0

    def reference(self, i: int, quant_bits: int | None = None) -> dict:
        f, c = self.files[i], self.cfg
        raw = np.fromfile(f["path"], np.int16).reshape(-1, 2)
        chips = lfsr_chips(c["bit_len"], [c["codes"][f["code"]]], c["code_len"])[0]
        return ref_claudio.process(raw, chips, c, c["processing"], c["df_window_hz"], self.dev,
                                   quant_bits=quant_bits)

    def check(self):
        from harness import Compared

        interp = 2 * self.cfg["processing"]["nint"] + 1
        refs = {i: self.reference(i) for i in sorted({d["file"] for d in self.done})}
        worst = {k: 0.0 for k in NUMBERS}
        failed, shown = 0, set()
        for d in self.done:
            prog = read_mat(d["mat"]) if d["found"] else {"moved": []}
            nums = compare(prog, refs[d["file"]], self.cfg["fs"], interp, self.df_bin())
            if nums["structure"] == 0 and d["file"] not in shown:
                shown.add(d["file"])
                rot = np.angle(prog["xval"] / refs[d["file"]]["xval"])
                print(f"file {d['file']}: xval phase against the reference (rad): median "
                      f"{np.median(rot):+.5f}, min {rot.min():+.5f}, max {rot.max():+.5f}",
                      file=sys.stderr)
            failed += nums["structure"] > 0
            worst = {k: max(worst[k], nums[k]) for k in NUMBERS}
            os.remove(d["mat"])
        cmp = Compared()
        for k in NUMBERS:
            cmp.add(k, worst[k], self.mix["limits"][k])
        return cmp, len(self.done), failed


def control(cell, seed: int, device, work: str, seconds: float):
    """The control: the reference with each block's samples in int4 (the
    step below the int8 the program ships) in the program's place, held
    to the float64 reference on the cell's files.  Returns the numbers
    and limits as the check reports them."""
    from harness import Compared

    drv = Driver(cell, seed, device, work, False)
    drv.make_files()
    interp = 2 * drv.cfg["processing"]["nint"] + 1
    worst = {k: 0.0 for k in NUMBERS}
    for i in range(len(drv.files)):
        ctl = dict(drv.reference(i, quant_bits=4), carry_trimmed=False)
        nums = compare(ctl, drv.reference(i), drv.cfg["fs"], interp, drv.df_bin())
        worst = {k: max(worst[k], nums[k]) for k in NUMBERS}
    cmp = Compared()
    for k in NUMBERS:
        cmp.add(k, worst[k], drv.mix["limits"][k])
    return cmp
