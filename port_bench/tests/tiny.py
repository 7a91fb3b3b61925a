"""A tiny copy of the benchmark's cells for the CPU tests: the same
drivers, metrics and checks, at sizes a CPU run holds (a 1000-chip
10-bit code at 100 kS/s)."""

from __future__ import annotations

import copy
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

SIG = {"fs": 1e5, "chip_rate": 5e4, "code_len": 1000, "bit_len": 10}
TAPS10 = [9, 27, 39, 45, 101, 111, 129, 139, 197, 215, 231, 243, 255, 269, 281, 291]

CONFIGS = {
    "twoway_claudio": dict(
        SIG, name="twoway_claudio", codes={"OP": 9, "LTFB": 27}, station="OP",
        df_window_hz=[-3000.0, -1800.0],
        processing={"conjugate_data": True, "nint": 1, "block_seconds": 2.0,
                    "skip_seconds": 4.0, "df_threshold": 20.0, "snr_gate_db": -30.0,
                    "max_slip_passes": 4},
        transfer="int8", file_seconds=8),
    "rx_bank": dict(
        SIG, name="rx_bank", nlag=28, group=8, transfer="f16", filter_hz=5e4,
        fc_init_hz=0.0, acq_range_hz=400.0, acq_step_hz=50.0, snr_min_db=7.0,
        taps=TAPS10),
}

WORKLOADS = {
    "claudio.pair": {
        "files": [
            {"name": "t_2", "code": "OP", "remote": False, "amplitude": 1000.0},
            {"name": "t_1", "code": "LTFB", "remote": True, "amplitude": 300.0}],
        "noise_sigma": 300.0, "doppler_hz": [1000.0, 1400.0],
        "doppler_sign": -1.0, "delay_frac": [0.1, 0.4], "delay_margin": 0.05},
    "bank.f16_8ch": {
        "n_per_input": 4, "amplitude": 300.0, "noise_sigma": 300.0,
        "dop_span_hz": 300.0, "dop_grid_hz": 100.0, "dop_offset_hz": 5.0,
        "max_frac": 0.3, "ring_seconds": 4, "setup_seconds": 3, "check_seconds": 3},
}


CELL_CONFIG = {"claudio.pair": "twoway_claudio", "bank.f16_8ch": "rx_bank"}

#: limits at the tiny size, from its own readings (CPU, seeds 5, 6 and
#: 4294967311): sound runs read claudio's delay gap 4-8 ns (a sample is
#: 10 us here), the control 124-135 ns; the bank's gd gap 0.0014 ns, its
#: int8 control 1.3-2.0 ns
LIMITS = {
    "claudio.pair": {"structure": 0, "df_bin_mismatch": 0, "delay_gap_ns": 30.0,
                     "xval_gap_rel": 0.005, "snr_gap_db": 0.05},
    "bank.f16_8ch": {"lock_missing": 0, "state_mismatch": 0, "state_phase_gap_cyc": 1e-4,
                     "fc_gap_hz": 2e-5, "phi_excess_gap_cyc": 1e-3, "gd_gap_ns": 0.1,
                     "pk_gap_db": 1e-4, "pnoise_gap_db": 1e-4, "start_off_truth": 0},
}


def tiny_bench(tmp: str) -> tuple[dict, str]:
    """A ``BENCHMARK.json`` (as a dict) with the tiny configurations and
    cells only, the configurations written under ``tmp``, with the tiny
    limits (a configuration that ``BENCHMARK.json`` does not list keeps
    its driver, and its cell's end-to-end metric is added); and the
    directory of the tiny traffic files."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = copy.deepcopy(json.load(f))
    wdir = os.path.join(tmp, "workloads")
    os.makedirs(wdir, exist_ok=True)
    bench["configs"] = []
    for name, cfg in CONFIGS.items():
        path = os.path.join(tmp, f"{name}.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        bench["configs"].append({"name": name, "file": path})
    bench["workloads"] = [{"name": w, "config": CELL_CONFIG[w], "chips": 1} for w in WORKLOADS]
    for name, mix in WORKLOADS.items():
        with open(os.path.join(wdir, f"{name}.json"), "w") as f:
            json.dump(dict(mix, limits=LIMITS[name]), f)
    if all(m["name"] != "iq_msps" for m in bench["end_to_end"]):
        bench["end_to_end"].append({"name": "iq_msps", "unit": "MS/s",
                                    "workloads": ["claudio.pair"]})
    return bench, wdir
