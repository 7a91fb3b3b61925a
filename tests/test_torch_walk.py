"""The device options no earlier CPU test passes, against the JAX package
on the CPU at the small_cfg geometry (L = 2000, 50 codes per second): the
lag bank past one 64-lag block (the bank and the host receiver), the bank
with a last group shorter than ``group``, the host receiver above 402
lags, the claudio hunt above 2^24 spectrum bins, and ``goranging`` /
``ranging`` with ``--f64``, ``--remote --foffset`` and ``--nint 2``
through the CLI.

Tolerances:

| What | Against | Tolerance |
| --- | --- | --- |
| bank: log lines, ``cnt``, locks, code heads | JAX | identical |
| bank: fc / gd / phi | JAX | 1e-3 Hz / 1 ns / 1e-4 cycles (``tests/test_torch_tracker.py``) |
| host receiver: log, ``cnt``, locks, code heads | JAX | identical |
| host receiver: fc / gd / phi | JAX | 1e-4 Hz / 1e-3 ns / 1e-6 cycles (``tests/test_torch_dllpll_host.py``) |
| host receiver: dg / sdgd / pk / pnoise | JAX | 1e-2 ns/s / 1e-2 ns / 1e-3 dB / 1e-3 dB |
| hunt: ``kbon``, ``n_above`` | JAX | identical |
| hunt's median above 2^24 bins | ``torch.nanquantile`` | the same bits |
| ``.mat`` ``indice*``, ``df*``, ``code`` | JAX | identical |
| ``.mat`` ``correction*`` | JAX | 1e-9 sample (complex128), 1e-4 (complex64) |
| ``.mat`` other fields | JAX | 1e-3 relative (``tests/test_torch_goranging.py``'s snr bound) |

Every run is also held to its truth: Doppler within 1 Hz and a quarter
sample for the receivers, the median delay within 0.1 sample for the
ranging chains.
"""

import dataclasses
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

from amaranth_twstft_tpu import cli as jcli
from amaranth_twstft_tpu.models import dllpll as jd
from amaranth_twstft_tpu.models import tracker as jt
from amaranth_twstft_tpu.models.emitter import ChannelSim, synthesize_capture
from amaranth_twstft_tpu.ops import doppler as jdop
from amaranth_twstft_tpu.utils import io as jio
from amaranth_twstft_tpu_torch import cli as tcli
from amaranth_twstft_tpu_torch.models import dllpll as td
from amaranth_twstft_tpu_torch.models import tracker as tt
from amaranth_twstft_tpu_torch.ops import doppler as tdop
from amaranth_twstft_tpu_torch.ops.lfsr import _find_mseq_taps_np, prn_chips, write_prn_file
from amaranth_twstft_tpu_torch.ops.prn import chips_to_pm1, upsample_zoh

BANK_TOL = {"fc": 1e-3, "gd": 1.0, "phi": 1e-4}
HOST_TOL = {"fc": 1e-4, "gd": 1e-3, "phi": 1e-6, "dg": 1e-2, "sdgd": 1e-2, "db": 1e-3}
CORR_TOL = {"c128": 1e-9, "c64": 1e-4}
MAT_RTOL = 1e-3


def small_chan(mod, taps, fc=0.0, prn_id=100, physical="A", **kw):
    base = dict(
        physical=physical, prn_id=prn_id, bit_len=10, taps=taps,
        fc_init_hz=fc, chip_rate=5e4, code_len=1000, filter_hz=5e4,
        acq_range_hz=500.0, acq_step_hz=50.0, snr_min_db=20.0, nlag=8,
    )
    base.update(kw)
    return mod.ChannelConfig(**base)


def _capture(small_cfg, emissions, n_seconds, seed):
    """One input carrying ``emissions`` = [(taps, delay, Doppler)], the
    first with noise; returns the stream."""
    sims = [(dataclasses.replace(small_cfg, taps=taps),
             ChannelSim(delay_samples=delay, doppler_hz=dop, amplitude=900,
                        noise_sigma=120.0 if i == 0 else 0.0))
            for i, (taps, delay, dop) in enumerate(emissions)]
    cfg0, sim0 = sims[0]
    (stream,) = synthesize_capture(cfg0, [sim0], n_seconds=n_seconds, seed=seed,
                                   extra_emissions=sims[1:])
    return stream


def _seconds(stream, small_cfg, n):
    fs, L = int(small_cfg.fs), small_cfg.samples_per_code
    return [{"A": stream[s * fs : (s + 1) * fs + 2 * L]} for s in range(n)]


TWO = ((9, 137.0, 120.0), (27, 555.0, -210.0))
# eight 10-bit m-sequences; Dopplers on the 50-Hz acquisition grid (off
# it, at 50 codes per second, a channel can settle a BPSK half-cycle,
# 25 Hz, away) and >= 100 Hz apart, so no emission's squaring line falls
# in another's fine-frequency search (+-100 Hz on the doubled axis)
EIGHT_TAPS = _find_mseq_taps_np(10, 8)
EIGHT_DOPS = (-400.0, -250.0, -150.0, -50.0, 50.0, 150.0, 250.0, 400.0)
EIGHT = tuple((taps, 137.0 + 211.0 * i, dop)
              for i, (taps, dop) in enumerate(zip(EIGHT_TAPS, EIGHT_DOPS)))


@pytest.fixture(scope="module")
def two_stream(small_cfg):
    return _capture(small_cfg, TWO, 5, seed=17)


@pytest.fixture(scope="module")
def eight_stream(small_cfg):
    return _capture(small_cfg, EIGHT, 5, seed=23)


def _chans(mod, emissions, **kw):
    return [small_chan(mod, taps, prn_id=100 + i, **kw)
            for i, (taps, _, _) in enumerate(emissions)]


def _on_truth(rep, delay, dop, small_cfg):
    """Locked, Doppler within 1 Hz, code delay within a quarter sample."""
    L = small_cfg.samples_per_code
    fs_ns = 1e9 / small_cfg.fs
    assert rep is not None and rep.locked
    assert abs(rep.fc_hz - dop) < 1.0, rep.fc_hz
    err = (rep.gd_ns - (delay % L) * fs_ns) % (L * fs_ns)
    assert min(err, L * fs_ns - err) < 0.25 * fs_ns, rep.gd_ns


def _reports_match(rep_j, rep_t, tol, host=False):
    n = 0
    for sec_j, sec_t in zip(rep_j, rep_t, strict=True):
        for a, b in zip(sec_j, sec_t, strict=True):
            assert (a is None) == (b is None)
            if a is None:
                continue
            n += 1
            assert a.locked == b.locked and a.cnt == b.cnt and a.ib == b.ib
            assert abs(a.fc_hz - b.fc_hz) < tol["fc"]
            assert abs(a.gd_ns - b.gd_ns) < tol["gd"]
            assert abs(a.phi_cycles - b.phi_cycles) < tol["phi"]
            if host:
                assert abs(a.dg_ns_per_s - b.dg_ns_per_s) < tol["dg"]
                assert abs(a.sdgd_ns - b.sdgd_ns) < tol["sdgd"]
                assert abs(a.pk_dbm - b.pk_dbm) < tol["db"]
                assert abs(a.pnoise_dbm - b.pnoise_dbm) < tol["db"]
    return n


def _states_match(states_j, states_t, fc_tol):
    for sj, st in zip(states_j, states_t, strict=True):
        assert (sj.is_trk, sj.is_first, sj.pt) == (st.is_trk, st.is_first, st.pt)
        assert abs(sj.fc - st.fc) < fc_tol


# ----------------------------------------------------------------------
# the bank past one lag block, and a short last group
# ----------------------------------------------------------------------
@pytest.mark.parametrize("nlag,group,emissions", [
    (40, 1, "two"),   # NL 81: two 64-lag blocks of the kernel
    (40, 2, "two"),   # the same in one group of both channels
    (8, 3, "eight"),  # 8 channels in groups of 3: the last group holds 2
])
def test_bank_lags_and_groups_match_jax(small_cfg, two_stream, eight_stream, nlag,
                                        group, emissions):
    """Four seconds of ``run_stream``: the JAX bank's log lines, reports
    and states, and every channel on its truth at second 3."""
    emis, stream = {"two": (TWO, two_stream), "eight": (EIGHT, eight_stream)}[emissions]
    kw = dict(fs=small_cfg.fs, group=group)
    rx_j = jt.BankedReceiver(_chans(jd, emis, nlag=nlag), **kw)
    rx_t = tt.BankedReceiver(_chans(td, emis, nlag=nlag), device="cpu", **kw)
    secs = _seconds(stream, small_cfg, 4)
    rep_j = list(rx_j.run_stream(iter(secs)))
    rep_t = list(rx_t.run_stream(iter(secs)))
    assert rx_t.log == rx_j.log
    assert _reports_match(rep_j, rep_t, BANK_TOL) >= len(emis)
    _states_match(rx_j.states, rx_t.states, BANK_TOL["fc"])
    for rep, (_, delay, dop) in zip(rep_t[3], emis, strict=True):
        _on_truth(rep, delay, dop, small_cfg)


# ----------------------------------------------------------------------
# the host receiver past one lag block and above 402 lags
# ----------------------------------------------------------------------
@pytest.mark.parametrize("nlag", [40, 202])  # NL 81 and 405
def test_host_receiver_lags_match_jax(small_cfg, two_stream, nlag):
    """The host-sequential receiver (``dllpll --host``) at NL 81 (two
    64-lag blocks of the explicit form on the card) and NL 405 (past the
    402 lags the explicit form's whole-row stages could hold): four
    seconds against the JAX receiver, through the plain version here."""
    secs = _seconds(two_stream, small_cfg, 4)
    rx_j = jd.Receiver(_chans(jd, TWO, nlag=nlag), fs=small_cfg.fs)
    rx_t = td.Receiver(_chans(td, TWO, nlag=nlag), fs=small_cfg.fs, device="cpu")
    assert rx_t._lag_matrix(0).shape == (small_cfg.samples_per_code, 2 * nlag + 1)
    rep_j = [rx_j.process_second(s) for s in secs]
    rep_t = [rx_t.process_second(s) for s in secs]
    assert rx_t.log == rx_j.log
    assert _reports_match(rep_j, rep_t, HOST_TOL, host=True) == 4
    for rep, (_, delay, dop) in zip(rep_t[3], TWO, strict=True):
        _on_truth(rep, delay, dop, small_cfg)


# ----------------------------------------------------------------------
# the claudio hunt above 2^24 bins
# ----------------------------------------------------------------------
def test_hunt_above_quantile_limit_matches_jax():
    """A block of 2^24 + 2^20 bins (a 2-s claudio block above 8.39 MS/s)
    with a BPSK line on the doubled axis: the port's hunt, which takes
    the median by a sort there, gives the JAX package's ``kbon`` and
    ``n_above``, and finds the line.  The port refused this block before
    (``torch.nanquantile``'s limit)."""
    fs, n = 1e5, tdop.QUANTILE_MAX_ELEMENTS + (1 << 20)
    code = chips_to_pm1(upsample_zoh(prn_chips(10, 9, 1000), 2), np.float32)
    rng = np.random.default_rng(2)
    t = np.arange(n)
    dop = 2000 * fs / n  # twice it on bin 4000 of the squaring spectrum
    x = (800 * code[t % code.size] * np.exp(2j * np.pi * dop * t / fs)
         + 300 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    del t
    mask = tdop.window_mask(n, fs, -2000.0, 2000.0)
    fcode = np.fft.fft(code).astype(np.complex64)
    d = torch.from_numpy(x)
    got = tdop.search_df_candidates(d, d[: code.size], torch.from_numpy(fcode), fs, mask)
    del d
    dj = jnp.asarray(x)
    want = jdop.search_df_candidates(dj, dj[: code.size], jnp.asarray(fcode), fs,
                                     jnp.asarray(mask))
    assert got == tuple(int(v) for v in want)
    assert got[0] >= 0 and got[1] > 0


@pytest.mark.parametrize("n_valid", [0, 1, 6, 7])
def test_hunt_median_by_sort_equals_nanquantile(monkeypatch, n_valid):
    """The sort path (forced here by a limit of 4 bins) gives the bits of
    ``torch.nanquantile(..., 0.5)``, the path at or below the limit: the
    two middle values mixed by ``lerp``, NaN with nothing masked in."""
    x = torch.from_numpy(np.random.default_rng(n_valid).uniform(0, 9, 12))
    mask = torch.zeros(12, dtype=torch.bool)
    mask[:n_valid] = True
    want = tdop._nan_median(x, mask)
    assert want.dtype == x.dtype
    monkeypatch.setattr(tdop, "QUANTILE_MAX_ELEMENTS", 4)
    got = tdop._nan_median(x, mask)
    if n_valid == 0:
        assert bool(torch.isnan(got)) and bool(torch.isnan(want))
    else:
        assert float(got) == float(want)


# ----------------------------------------------------------------------
# goranging / ranging options through the CLI
# ----------------------------------------------------------------------
SIG_ARGS = ["--fs", "100000.0", "--chip-rate", "50000.0", "--code-len", "1000",
            "--bitlen", "10", "--taps", "9"]
DOP1 = 1500.0  # channel 1; --foffset 1400 brings it into the pre-pass window
FOFFSET = 1400.0


@pytest.fixture(scope="module")
def walk_files(small_cfg, tmp_path_factory):
    """A 1-s dual-channel capture (50 epochs: channel 1 at 431.4 samples
    and 1500 Hz, channel 2 at 12.75 samples and 5 Hz) and its code.  At
    the small geometry the pre-pass's decimated axis spans +-2 kHz, so
    channel 1's doubled line folds unless ``--foffset`` moves it."""
    tmp = tmp_path_factory.mktemp("walk")
    code = str(tmp / "code.bin")
    write_prn_file(code, 10, 1000, 9)
    meas, ref = synthesize_capture(
        small_cfg,
        [ChannelSim(431.4, DOP1, amplitude=900, noise_sigma=250),
         ChannelSim(12.75, 5.0, amplitude=2000, noise_sigma=100)],
        n_seconds=1, seed=31)
    cap = str(tmp / "1755400000.bin")
    jio.write_sc16(cap, meas, ref)
    return {"code": code, "cap": cap}


def _run_both(walk_files, tmp_path, argv, capsys):
    """``argv`` (verb first; the capture and code are inserted) through
    both packages' CLIs on copies of the capture in their own directories;
    returns the two ``.mat`` files loaded."""
    mats = {}
    for name, main, extra in (("jax", jcli.main, []), ("torch", tcli.main,
                                                        ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        cap = str(d / os.path.basename(walk_files["cap"]))
        shutil.copy(walk_files["cap"], cap)
        capsys.readouterr()
        assert main([argv[0], cap, walk_files["code"], *argv[1:], *SIG_ARGS, *extra]) == 0
        path = capsys.readouterr().out.strip().splitlines()[-1]
        mats[name] = sio.loadmat(path)
        assert os.path.basename(path) in os.listdir(d)
    return mats["torch"], mats["jax"]


def _mat_close(got, ref, cdtype):
    keys = sorted(k for k in ref if not k.startswith("__"))
    assert sorted(k for k in got if not k.startswith("__")) == keys
    for k in keys:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.shape == r.shape, k
        if k.startswith(("indice", "df", "code")):
            np.testing.assert_array_equal(g, r, err_msg=k)
        elif k.startswith("correction"):
            np.testing.assert_allclose(g, r, rtol=0, atol=CORR_TOL[cdtype], err_msg=k)
        else:
            np.testing.assert_allclose(g, r, rtol=MAT_RTOL, atol=0, err_msg=k)


def _median_delay(mat, ch, grid=3, octave=False):
    """Median delay in samples: ``grid`` = 2*nint+1 interpolated points
    per sample; the Octave-style fields hold a 1-based ``indice``."""
    if octave:
        return float(np.median(mat[f"indice{ch}"] - 1 + mat[f"correction{ch}"]) / grid)
    return float(np.median(mat[f"correction{ch}"]) / grid)


# (argv, dtype, channels written, the one on its truth, grid): without
# --foffset only channel 2 lies in the pre-pass window
GORANGING_CASES = [
    (["goranging", "--f64"], "c128", 2, 2, 3),
    (["goranging", "--remote", "--foffset", str(FOFFSET)], "c64", 1, 1, 3),
    (["goranging", "--fast", "--remote", "--foffset", str(FOFFSET)], "c64", 1, 1, 3),
    (["goranging", "--nint", "2"], "c64", 2, 2, 5),
    (["goranging", "--fast", "--nint", "2"], "c64", 2, 2, 5),
]


@pytest.mark.parametrize("argv,cdtype,n_chan,on_truth,grid", GORANGING_CASES)
def test_goranging_options_match_jax(walk_files, tmp_path, capsys, argv, cdtype,
                                     n_chan, on_truth, grid):
    """``goranging`` with ``--f64`` (the plain chain in complex128),
    ``--remote --foffset`` (channel 1 alone, the pre-pass window moved
    onto it) and ``--nint 2``, plain and ``--fast``: the JAX package's
    ``.mat`` field for field, and the channel in the window on its
    truth."""
    got, ref = _run_both(walk_files, tmp_path, argv, capsys)
    _mat_close(got, ref, cdtype)
    assert ("correction2" in got) == (n_chan == 2)
    truth = {1: 431.4, 2: 12.75}[on_truth]
    assert abs(_median_delay(got, on_truth, grid) - truth) < 0.1
    if "--remote" in argv:
        assert abs(float(np.median(got["df1"])) - DOP1) < 1.0


def test_goranging_without_foffset_misses_the_line(walk_files, tmp_path, capsys):
    """The case above needs ``--foffset``: without it both packages fold
    channel 1's doubled line (3 kHz on a +-2 kHz axis) to the same wrong
    df."""
    got, ref = _run_both(walk_files, tmp_path, ["goranging", "--remote"], capsys)
    _mat_close(got, ref, "c64")
    assert abs(float(np.median(got["df1"])) - DOP1) > 100.0


def test_ranging_f64_op_verbose_matches_jax(walk_files, tmp_path, capsys):
    """``ranging --f64 --op -v``: godual's host branch in complex128 with
    the OP station and the verbose print, the JAX package's ``.mat``
    field for field, both delays on their truths."""
    got, ref = _run_both(walk_files, tmp_path, ["ranging", "--f64", "--op", "-v"], capsys)
    _mat_close(got, ref, "c128")
    assert abs(_median_delay(got, 1, octave=True) - 431.4) < 0.1
    assert abs(_median_delay(got, 2, octave=True) - 12.75) < 0.1
    assert abs(float(np.median(got["df1"])) - DOP1) < 50.0  # the per-epoch bins
