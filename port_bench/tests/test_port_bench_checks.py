"""CPU tests of the checks that decide ``correct``, at the tiny size: a
sound run comes out correct; the control (the step below each
configuration's precision) and each fault a cell can have, planted in the
timed path, come out not correct.  The runs skip the look for a card and
drive the rest of a run on the CPU path of the program."""

from __future__ import annotations

import contextlib
import io
import json

import numpy as np
import pytest

import control
import run
from tiny import tiny_bench

SEED = 4294967311  # more than 32 bits hold


def _correct(tmp_path, cell: str, seconds: str = "2") -> tuple[bool, dict]:
    bench, wdir = tiny_bench(str(tmp_path))
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds", seconds,
                       "--trace", "0"], bench=bench, workloads_dir=wdir, device="cpu",
                      need_card=False)
    assert rc == 0, err.getvalue()
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    return line["correct"], line["compared"]


@pytest.mark.parametrize("cell", ["claudio.pair", "bank.f16_8ch"])
def test_a_sound_run_is_correct(tmp_path, cell):
    ok, compared = _correct(tmp_path, cell)
    assert ok, compared


@pytest.mark.parametrize("cell", ["claudio.pair", "bank.f16_8ch"])
def test_the_control_is_not_correct(tmp_path, cell):
    bench, wdir = tiny_bench(str(tmp_path))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        control.main(["--workload", cell, "--seeds", "5,6,7", "--seconds", "3"], bench=bench,
                     workloads_dir=wdir, device="cpu")
    lines = [json.loads(s) for s in out.getvalue().strip().splitlines()]
    assert len(lines) == 3 and all(ln["control_fails"] for ln in lines), lines


def _claudio_faults(monkeypatch, fault):
    from amaranth_twstft_tpu_torch.models import claudio

    if fault == "answer_altered":
        orig = claudio._decode_packed

        def altered(packed, n):
            res = orig(packed, n)
            res.correction[0] += 0.05
            return res

        monkeypatch.setattr(claudio, "_decode_packed", altered)
    elif fault == "half_left_out":
        orig = claudio._decode_packed

        def half(packed, n):
            res = orig(packed, n)
            h = max(1, n // 2)
            for f in ("indice", "correction", "xval", "snr_r", "snr_i"):
                a = getattr(res, f)
                a[h:] = a[:h].mean() if f != "indice" else a[:h][0]
            return res

        monkeypatch.setattr(claudio, "_decode_packed", half)
    elif fault == "state_unchanged":
        # the block step's carry: the previous block's tail never reaches
        # the next buffer
        orig = claudio._Resident.assemble

        def no_carry(self, x, prev, tail, dold_len, q8, scale):
            return orig(self, x, prev.new_zeros(prev.shape), tail, dold_len, q8, scale)

        monkeypatch.setattr(claudio._Resident, "assemble", no_carry)


def _bank_faults(monkeypatch, fault):
    from amaranth_twstft_tpu_torch.models import tracker

    if fault == "answer_altered":
        orig = tracker.BankedReceiver.process_second

        def altered(self, *a, **kw):
            reps = orig(self, *a, **kw)
            if reps[0] is not None:
                reps[0].gd_ns += 0.5
            return reps

        monkeypatch.setattr(tracker.BankedReceiver, "process_second", altered)
    elif fault == "half_left_out":
        orig = tracker.lag_bank_windows

        def half(obs, wav_ext, nlag, *a, **kw):
            obs = obs.clone()
            obs[:, :, obs.shape[2] // 2:] = 0.0
            return orig(obs, wav_ext, nlag, *a, **kw)

        monkeypatch.setattr(tracker, "lag_bank_windows", half)
    elif fault == "state_unchanged":
        orig = tracker.BankedReceiver._track_all

        def frozen(self, pending, warm, reports):
            before = [(s.pt, s.fc, s.last_phi) for s in self.states]
            orig(self, pending, warm, reports)
            for s, (pt, fc, lp) in zip(self.states, before):
                if not s.is_first and s.is_trk and pt:
                    s.pt, s.fc, s.last_phi = pt, fc, lp

        monkeypatch.setattr(tracker.BankedReceiver, "_track_all", frozen)


@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out", "state_unchanged"])
@pytest.mark.parametrize("cell", ["claudio.pair", "bank.f16_8ch"])
def test_a_fault_in_the_timed_path_is_not_correct(tmp_path, monkeypatch, cell, fault):
    """The faults a one-card cell can have (there is no exchange between
    cards to leave out)."""
    (_claudio_faults if cell.startswith("claudio") else _bank_faults)(monkeypatch, fault)
    ok, compared = _correct(tmp_path, cell)
    assert not ok, compared
    assert np.isfinite([v["value"] for v in compared.values()]).any()


def test_a_count_off_the_reference_is_a_gap_of_the_delay():
    """A channel whose gate took one code more than the reference's shows
    its delay statistic at least the nearest left code's distance off;
    one code fewer, the nearest taken code's; more than there are, an
    infinite gap."""
    import harness

    drv = harness.load_module(f"{harness.HERE}/drivers/rx_bank.py", "rx_bank_driver")
    gate = np.array([-0.5, -0.02, np.nan, 0.003, 0.2, -1.0])
    assert drv.gate_gap_ns(gate, 1) == pytest.approx(0.003)
    assert drv.gate_gap_ns(gate, 2) == pytest.approx(0.2)
    assert drv.gate_gap_ns(gate, -1) == pytest.approx(0.02)
    assert drv.gate_gap_ns(gate, -2) == pytest.approx(0.5)
    assert drv.gate_gap_ns(gate, 3) == float("inf")
