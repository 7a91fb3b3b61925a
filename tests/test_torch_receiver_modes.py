"""The DLL/PLL bank's modes against the JAX package's, on the CPU at the
small_cfg geometry (L = 2000, 50 codes per second, 17 lags): SIC rows on
the bank, the bank's ``reload_params``, the int8 / f32 / real-input int4
streams, the int2 transfer (repaired in the port), ``dllpll --follow`` on
a growing capture and mixed code geometries through the CLI.

Tolerances are ``tests/test_torch_tracker.py``'s (float32 on both sides,
sums and transcendental functions from different libraries): log lines,
``cnt``, lock states and code heads identical; fc within 1e-3 Hz; gd
within 1 ns (1e-4 sample at fs = 1e5); phi within 1e-4 cycles.  Printed
``dllpll`` rows: the same rows, ``cnt`` identical, fc / phi / gd as above,
pk and pnoise within 1e-3 dB, and the two fitted columns, dg (ns/s) and
sdgd (ns), within 5e-2: they are float32 fits of up to 49 code phases of
~1e4-1e5 ns each, whose roundoff reached 1.5e-2 ns/s on the 25-kcps
channel below (5e-2 is 5e-6 sample per second at fs = 1e5).
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from amaranth_twstft_tpu.cli import main as jax_main
from amaranth_twstft_tpu.models import dllpll as jd
from amaranth_twstft_tpu.models import tracker as jt
from amaranth_twstft_tpu.models.emitter import ChannelSim, synthesize_capture
from amaranth_twstft_tpu_torch.cli import main as torch_main
from amaranth_twstft_tpu_torch.models import dllpll as td
from amaranth_twstft_tpu_torch.models import tracker as tt
from amaranth_twstft_tpu_torch.utils.io import write_sc16

FC_HZ = 1e-3
GD_NS = 1.0
PHI_CYCLES = 1e-4
# printed row columns (second phys PRN fc phi cnt gd dg sdgd pk pnoise) ->
# tolerance; the first three and cnt must be identical
ROW_TOL = {3: FC_HZ, 4: PHI_CYCLES, 6: GD_NS, 7: 5e-2, 8: 5e-2, 9: 1e-3, 10: 1e-3}


def small_chan(mod, taps, fc=0.0, prn_id=100, physical="A", **kw):
    base = dict(
        physical=physical, prn_id=prn_id, bit_len=10, taps=taps,
        fc_init_hz=fc, chip_rate=5e4, code_len=1000, filter_hz=5e4,
        acq_range_hz=500.0, acq_step_hz=50.0, snr_min_db=20.0, nlag=8,
    )
    base.update(kw)
    return mod.ChannelConfig(**base)


def chans_for(mod, **kw):
    return [small_chan(mod, 9, **kw), small_chan(mod, 27, prn_id=101, **kw)]


@pytest.fixture(scope="module")
def two_prn_stream(small_cfg):
    """The two-PRN stream of tests/test_tracker.py: PRN 9 at 137 samples
    and 120 Hz, PRN 27 at 555 samples and -210 Hz."""
    cfg_b = dataclasses.replace(small_cfg, taps=27)
    (stream,) = synthesize_capture(
        small_cfg,
        [ChannelSim(delay_samples=137.0, doppler_hz=120.0, amplitude=900,
                    noise_sigma=120)],
        n_seconds=5, seed=17,
        extra_emissions=[(cfg_b, ChannelSim(delay_samples=555.0, doppler_hz=-210.0,
                                            amplitude=900, noise_sigma=0.0))],
    )
    return stream


TRUTHS = ((137.0, 120.0), (555.0, -210.0))  # (delay samples, Doppler Hz)


def _seconds(stream, small_cfg, n=4, real=False):
    fs, L = int(small_cfg.fs), small_cfg.samples_per_code
    out = [stream[s * fs : (s + 1) * fs + 2 * L] for s in range(n)]
    return [{"A": np.real(x) if real else x} for x in out]


def _assert_reports_match(rep_j, rep_t):
    for sec_j, sec_t in zip(rep_j, rep_t, strict=True):
        for a, b in zip(sec_j, sec_t, strict=True):
            assert (a is None) == (b is None)
            if a is None:
                continue
            assert a.locked == b.locked and a.cnt == b.cnt and a.ib == b.ib
            assert abs(a.fc_hz - b.fc_hz) < FC_HZ
            assert abs(a.gd_ns - b.gd_ns) < GD_NS
            assert abs(a.phi_cycles - b.phi_cycles) < PHI_CYCLES


def _assert_states_match(states_j, states_t):
    for sj, st in zip(states_j, states_t, strict=True):
        assert (sj.is_trk, sj.is_first, sj.pt) == (st.is_trk, st.is_first, st.pt)
        assert abs(sj.fc - st.fc) < FC_HZ


def _on_truth(rep, delay, dop, small_cfg):
    """tests/test_tracker.py:350-366's bounds: locked, Doppler within 1 Hz,
    code delay within a quarter sample."""
    L = small_cfg.samples_per_code
    fs_ns = 1e9 / small_cfg.fs
    assert rep is not None and rep.locked
    assert abs(rep.fc_hz - dop) < 1.0, rep.fc_hz
    err = (rep.gd_ns - (delay % L) * fs_ns) % (L * fs_ns)
    assert min(err, L * fs_ns - err) < 0.25 * fs_ns, rep.gd_ns


# ----------------------------------------------------------------------
# SIC rows on the bank
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def sic_seconds(small_cfg):
    """tests/test_torch_dllpll_host.py's SIC capture: PRN 27 at amplitude
    110 under PRN 9 at 2500 (27 dB), which it acquires only once PRN 9's
    replica is subtracted."""
    fs, L = int(small_cfg.fs), small_cfg.samples_per_code
    cfg_b = dataclasses.replace(small_cfg, taps=27)
    (stream,) = synthesize_capture(
        small_cfg,
        [ChannelSim(delay_samples=137.0, doppler_hz=120.0, amplitude=2500,
                    noise_sigma=40)],
        n_seconds=5, seed=5,
        extra_emissions=[(cfg_b, ChannelSim(delay_samples=555.0, doppler_hz=-210.0,
                                            amplitude=110, noise_sigma=0.0))],
    )
    return [{"A": stream[s * fs : (s + 1) * fs + 2 * L]} for s in range(4)]


@pytest.mark.parametrize("sic", [True, False])
def test_bank_sic_matches_jax(small_cfg, sic_seconds, sic):
    """Four seconds of run_stream with the weak channel (PRN 101) on an
    ``S`` row: the same log lines, reports and states as the JAX bank, and
    the weak channel (logged as PRN#151) acquires on the cleaned row and
    reaches code lock on its truth in both.  On an ``N`` row it never
    acquires."""
    mk = lambda mod: [small_chan(mod, 9),  # noqa: E731
                      small_chan(mod, 27, prn_id=101, is_sic=sic)]
    rx_j = jt.BankedReceiver(mk(jd), fs=small_cfg.fs, group=1)
    rx_t = tt.BankedReceiver(mk(td), fs=small_cfg.fs, group=1, device="cpu")
    rep_j = list(rx_j.run_stream(iter(sic_seconds)))
    rep_t = list(rx_t.run_stream(iter(sic_seconds)))
    assert rx_t.log == rx_j.log
    _assert_reports_match(rep_j, rep_t)
    _assert_states_match(rx_j.states, rx_t.states)
    _on_truth(rep_t[3][0], 137.0, 120.0, small_cfg)
    weak = rx_t.states[1]
    if sic:
        assert "code lock   : Ch. A, PRN#151, count = 49 / 50" in rx_t.log
        assert weak.is_trk and weak.pt == 555 and abs(weak.fc - -210.0) < 1.0
    else:
        assert not any(ln.startswith("code lock   : Ch. A, PRN#101") for ln in rx_t.log)
        assert "acq failed  : Ch. A, PRN#101, count = 0 / 50" in rx_t.log
        assert not weak.is_trk


# ----------------------------------------------------------------------
# reload_params on the bank
# ----------------------------------------------------------------------
def test_bank_reload_params_matches_jax(small_cfg, two_prn_stream):
    """tests/test_tracker.py:239-268's cases on both banks: identical rows
    change nothing; a changed fc re-initializes that row alone, the kept
    row keeps its state; then both carry on identically and the changed
    row re-acquires."""
    secs = _seconds(two_prn_stream, small_cfg, 5)
    rx_j = jt.BankedReceiver(chans_for(jd), fs=small_cfg.fs, group=1)
    rx_t = tt.BankedReceiver(chans_for(td), fs=small_cfg.fs, group=1, device="cpu")
    for s in secs[:3]:
        rx_j.process_second(s)
        rx_t.process_second(s)
    assert all(s.is_trk for s in rx_t.states)
    same = "A N 100 0.0 50 50 500 50 20\nA N 101 0.0 50 50 500 50 20\n"
    before = [dataclasses.asdict(s) for s in rx_t.states]
    assert rx_t.reload_params(same) == rx_j.reload_params(same) == []
    assert [dataclasses.asdict(s) for s in rx_t.states] == before
    changed = "A N 100 0.0 50 50 500 50 20\nA N 101 -100.0 50 50 500 50 20\n"
    assert rx_t.reload_params(changed) == rx_j.reload_params(changed) == [1]
    assert dataclasses.asdict(rx_t.states[0]) == before[0]
    assert rx_t.states[0].is_trk and not rx_t.states[1].is_trk
    assert rx_t.channels[1].cfg.fc_init_hz == -100.0 and rx_t.channels[1].cfg.taps == 27
    _assert_states_match(rx_j.states, rx_t.states)
    rep_j = [rx_j.process_second(s) for s in secs[3:]]
    rep_t = [rx_t.process_second(s) for s in secs[3:]]
    assert rx_t.log == rx_j.log
    _assert_reports_match(rep_j, rep_t)
    _assert_states_match(rx_j.states, rx_t.states)
    assert rx_t.states[1].is_trk and rx_t.states[1].pt == 555
    _on_truth(rep_t[-1][0], 137.0, 120.0, small_cfg)


# ----------------------------------------------------------------------
# transfer formats through run_stream
# ----------------------------------------------------------------------
@pytest.mark.parametrize("transfer,real", [("int8", False), ("f32", False),
                                           ("int4", True)])
def test_run_stream_transfer_matches_jax(small_cfg, two_prn_stream, transfer, real):
    """Four seconds of run_stream per format (the f16 and complex int4
    streams are in tests/test_torch_tracker.py): the same uploaded bytes,
    log lines, lock counts and code heads; fc/gd/phi within the
    tolerances; every channel on its truth at second 3."""
    if real:
        # rx.cpp real-sample mode: one emission on a 20 kHz carrier
        (stream,) = synthesize_capture(
            small_cfg,
            [ChannelSim(delay_samples=321.0, doppler_hz=20e3, amplitude=1200,
                        noise_sigma=80.0)],
            n_seconds=5, seed=11,
        )
        mk = lambda mod: [small_chan(mod, 9, fc=20e3, acq_range_hz=400.0,  # noqa: E731
                                     snr_min_db=15.0)]
        truths = ((321.0, 20e3),)
    else:
        stream, mk, truths = two_prn_stream, chans_for, TRUTHS
    kw = dict(fs=small_cfg.fs, transfer=transfer, real_input=real, group=1)
    rx_j = jt.BankedReceiver(mk(jd), **kw)
    rx_t = tt.BankedReceiver(mk(td), device="cpu", **kw)
    secs = _seconds(stream, small_cfg, 4, real=real)
    packed_j, scale_j, _, _ = rx_j._pack_second(secs[0])
    packed_t, scale_t, _, _ = rx_t._pack_second(secs[0])
    assert packed_t.dtype == packed_j.dtype and np.array_equal(packed_t, packed_j)
    assert scale_t == scale_j
    rep_j = list(rx_j.run_stream(iter(secs)))
    rep_t = list(rx_t.run_stream(iter(secs)))
    assert rx_t.log == rx_j.log
    _assert_reports_match(rep_j, rep_t)
    _assert_states_match(rx_j.states, rx_t.states)
    for rep, (delay, dop) in zip(rep_t[3], truths, strict=True):
        _on_truth(rep, delay, dop, small_cfg)


# ----------------------------------------------------------------------
# int2: repaired in the port
# ----------------------------------------------------------------------
def test_int2_uploads_packed_bytes_and_tracks_truth(small_cfg, two_prn_stream):
    """The port's int2 bank uploads pack_int2_ri's bytes (uint8, one byte
    per two complex samples per buffer row) with its threshold as the
    scale, the decode gives the quantized levels back, and the bank locks
    both PRNs on their truths within tests/test_tracker.py:350-366's
    bounds."""
    rx = tt.BankedReceiver(chans_for(td), fs=small_cfg.fs, transfer="int2",
                           device="cpu")
    secs = _seconds(two_prn_stream, small_cfg, 4)
    S = int(small_cfg.fs) + small_cfg.samples_per_code
    pending = rx.upload_second(secs[0])
    assert pending.dev.dtype == torch.uint8
    assert tuple(pending.dev.shape) == (2, S // 2)  # raw + SIC rows of input A
    bufs = np.zeros((2, S, 2), np.float32)
    x = secs[0]["A"][:S]
    bufs[:, :, 0], bufs[:, :, 1] = np.real(x), np.imag(x)
    want, t = tt.pack_int2_ri(bufs)
    assert np.array_equal(pending.dev.numpy(), want)
    assert float(pending.scale) == np.float32(t)
    dec = tt._bufs_to_f32(pending.dev, pending.scale).numpy()
    assert dec.shape == (2, S, 2)
    assert set(np.unique(np.round(dec / np.float32(t)))) <= {-3.0, -1.0, 1.0, 3.0}
    reports = list(rx.run_stream(iter(secs)))
    for rep, (delay, dop) in zip(reports[3], TRUTHS, strict=True):
        _on_truth(rep, delay, dop, small_cfg)


def test_int2_upload_is_float32_in_the_jax_package(small_cfg, two_prn_stream):
    """The deviation this port records (ROADMAP Queue 3): the JAX package's
    ``_pack_second`` has no int2 branch, so its int2 bank uploads the
    float32 buffer, 16x the port's bytes."""
    sec = _seconds(two_prn_stream, small_cfg, 1)[0]
    packed_j, scale_j, _, _ = jt.BankedReceiver(
        chans_for(jd), fs=small_cfg.fs, transfer="int2")._pack_second(sec)
    packed_t, scale_t, _, _ = tt.BankedReceiver(
        chans_for(td), fs=small_cfg.fs, transfer="int2", device="cpu")._pack_second(sec)
    assert packed_j.dtype == np.float32 and scale_j is None
    assert packed_t.dtype == np.uint8 and scale_t is not None
    assert packed_j.nbytes == 16 * packed_t.nbytes


def test_int2_refuses_an_odd_second(small_cfg):
    """Two samples per byte: an odd S = fs + nobs is refused at
    construction rather than decoded one row long."""
    with pytest.raises(ValueError, match="even"):
        tt.BankedReceiver(chans_for(td), fs=small_cfg.fs + 1, transfer="int2",
                          device="cpu")


# ----------------------------------------------------------------------
# the dllpll verb: --follow and mixed geometries
# ----------------------------------------------------------------------
def _row_pairs(out_j, out_t):
    rows_j = [ln.split() for ln in out_j.splitlines() if ln and not ln.startswith("#")]
    rows_t = [ln.split() for ln in out_t.splitlines() if ln and not ln.startswith("#")]
    assert len(rows_j) == len(rows_t) > 0
    for cj, ct in zip(rows_j, rows_t):
        assert len(cj) == len(ct) == 11
        assert cj[:3] == ct[:3] and cj[5] == ct[5]
        for k, tol in ROW_TOL.items():
            assert abs(float(cj[k]) - float(ct[k])) < tol, (k, cj, ct)
    return rows_t


DLLPLL_ARGS = ["--fs", "1e5", "--bitlen", "10", "--code-len", "1000", "--nlag", "8"]


def test_cli_dllpll_follow_matches_jax(small_cfg, two_prn_stream, tmp_path, capsys):
    """``dllpll --follow`` on a capture a writer thread grows one second
    at a time: the port prints the JAX verb's rows, and the rows of a run
    without --follow on the finished file."""
    fs = int(small_cfg.fs)
    n_sec = 4
    full = tmp_path / "full.bin"
    write_sc16(str(full), two_prn_stream[: n_sec * fs + 2000],
               two_prn_stream[: n_sec * fs + 2000] * 0.5)
    data = full.read_bytes()
    param = tmp_path / "sdr.param"
    param.write_text("A N 100 0.0 50 50 500 50 20\nB N 101 0.0 50 50 500 50 20\n")
    common = ["--param", str(param), *DLLPLL_ARGS, "--taps-map", "100=9,101=27"]

    def followed(main, name, extra):
        grow = tmp_path / f"{name}.bin"
        grow.write_bytes(b"")
        done = threading.Event()

        def writer():
            step = 8 * fs  # one second of two sc16 channels
            with open(grow, "ab") as f:
                for k in range(n_sec):
                    time.sleep(0.3)
                    f.write(data[k * step : (k + 1) * step if k < n_sec - 1 else None])
                    f.flush()
            done.set()

        th = threading.Thread(target=writer, daemon=True)
        th.start()
        try:
            assert main(["dllpll", str(grow), *common, "--follow",
                         "--idle-timeout", "1.5", *extra]) == 0
        finally:
            th.join(timeout=30)
        assert done.is_set()
        return capsys.readouterr().out

    out_j = followed(jax_main, "jax", [])
    out_t = followed(torch_main, "torch", ["--device", "cpu"])
    rows = _row_pairs(out_j, out_t)
    assert {r[0] for r in rows} == {"2", "3"}  # seconds 2-3 report
    assert torch_main(["dllpll", str(full), *common, "--device", "cpu"]) == 0
    assert capsys.readouterr().out == out_t


def test_cli_dllpll_mixed_geometries_matches_jax(small_cfg, tmp_path, capsys):
    """Two chip rates in one sdr.param (50 and 25 kcps: L = 2000 and 4000,
    50 and 25 codes per second): both verbs take MultiBankReceiver, print
    the same rows in sdr.param's order, and every channel reports on its
    truth."""
    fs = int(small_cfg.fs)
    slow = dataclasses.replace(small_cfg, chip_rate=2.5e4, taps=27)
    (stream,) = synthesize_capture(
        small_cfg,
        [ChannelSim(delay_samples=137.0, doppler_hz=120.0, amplitude=900,
                    noise_sigma=120)],
        n_seconds=4, seed=23,
        extra_emissions=[(slow, ChannelSim(delay_samples=1555.0, doppler_hz=-210.0,
                                           amplitude=900, noise_sigma=0.0))],
    )
    cap = tmp_path / "cap.bin"
    write_sc16(str(cap), stream[: 4 * fs], stream[: 4 * fs] * 0.5)
    param = tmp_path / "sdr.param"
    param.write_text("A N 101 0.0 25 25 500 50 20\nA N 100 0.0 50 50 500 50 20\n")
    common = [str(cap), "--param", str(param), *DLLPLL_ARGS,
              "--taps-map", "100=9,101=27"]
    assert jax_main(["dllpll", *common]) == 0
    out_j = capsys.readouterr()
    assert torch_main(["dllpll", *common, "--device", "cpu"]) == 0
    out_t = capsys.readouterr()
    assert "2 channel geometries" in out_t.err and "2 channel geometries" in out_j.err
    rows = _row_pairs(out_j.out, out_t.out)
    by_sec: dict = {}
    for r in rows:
        by_sec.setdefault(r[0], []).append(r[2])
    assert by_sec["3"] == ["PRN101", "PRN100"]  # sdr.param's order
    truth = {"PRN100": (137.0, 120.0, 2000), "PRN101": (1555.0, -210.0, 4000)}
    for r in rows:
        if r[0] != "3":
            continue
        delay, dop, L = truth[r[2]]
        assert abs(float(r[3]) - dop) < 1.0
        err = (float(r[6]) - delay * 1e4) % (L * 1e4)
        assert min(err, L * 1e4 - err) < 0.25 * 1e4
