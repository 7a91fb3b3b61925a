"""The port's host-sequential DLL/PLL receiver (``models/dllpll.Receiver``,
``dllpll --host``) against the JAX package's on the CPU, at the small_cfg
geometry (L = 2000, 50 codes per second, 17 lags).

Tolerances: ``cnt``, lock states, code heads and log lines identical;
fc within 1e-4 Hz; gd within 1e-3 ns (1e-7 sample at fs = 1e5; 1e-2 ns
in the SIC case, see its test); phi
within 1e-6 cycles.  Both run the CAF and the squaring FFT in complex128
(the float64 the test harness turns on); the lag bank is float32 on both
sides (the port's plain version against the JAX package's jnp path), so
the last digits of the fitted rates differ: dg within 1e-2 ns/s, sdgd
within 1e-2 ns.
"""

import dataclasses
import os

import numpy as np
import pytest

from amaranth_twstft_tpu.models import dllpll as jd
from amaranth_twstft_tpu.models.emitter import ChannelSim, synthesize_capture
from amaranth_twstft_tpu_torch.models import dllpll as td
from amaranth_twstft_tpu_torch.models import tracker as tt

FC_HZ = 1e-4
GD_NS = 1e-3
PHI_CYCLES = 1e-6
DG_NS_S = 1e-2
SDGD_NS = 1e-2


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
    """The two-PRN stream of tests/test_tracker.py:44-58."""
    cfg_b = dataclasses.replace(small_cfg, taps=27)
    (stream,) = synthesize_capture(
        small_cfg,
        [ChannelSim(delay_samples=137.0, doppler_hz=120.0, amplitude=900,
                    noise_sigma=120)],
        n_seconds=5,
        seed=17,
        extra_emissions=[
            (cfg_b, ChannelSim(delay_samples=555.0, doppler_hz=-210.0,
                               amplitude=900, noise_sigma=0.0))
        ],
    )
    return stream


def _seconds(stream, small_cfg, n=4):
    fs, L = int(small_cfg.fs), small_cfg.samples_per_code
    return [{"A": stream[s * fs : (s + 1) * fs + 2 * L]} for s in range(n)]


def _assert_reports_match(rep_j, rep_t, gd_ns=GD_NS):
    n = 0
    for sec_j, sec_t in zip(rep_j, rep_t, strict=True):
        for a, b in zip(sec_j, sec_t, strict=True):
            assert (a is None) == (b is None)
            if a is None:
                continue
            n += 1
            assert a.locked == b.locked and a.cnt == b.cnt and a.ib == b.ib
            assert abs(a.fc_hz - b.fc_hz) < FC_HZ
            assert abs(a.gd_ns - b.gd_ns) < gd_ns
            assert abs(a.phi_cycles - b.phi_cycles) < PHI_CYCLES
            assert abs(a.dg_ns_per_s - b.dg_ns_per_s) < DG_NS_S
            assert abs(a.sdgd_ns - b.sdgd_ns) < SDGD_NS
            assert abs(a.pk_dbm - b.pk_dbm) < 1e-3
            assert abs(a.pnoise_dbm - b.pnoise_dbm) < 1e-3
    return n


def _assert_states_match(states_j, states_t):
    for sj, st in zip(states_j, states_t, strict=True):
        assert (sj.is_trk, sj.is_first, sj.pt) == (st.is_trk, st.is_first, st.pt)
        assert abs(sj.fc + sj.df - st.fc - st.df) < FC_HZ


def _both(chans_j, chans_t, secs, fs):
    rx_j = jd.Receiver(chans_j, fs=fs)
    rx_t = td.Receiver(chans_t, fs=fs, device="cpu")
    rep_j = [rx_j.process_second(s) for s in secs]
    rep_t = [rx_t.process_second(s) for s in secs]
    return rx_j, rx_t, rep_j, rep_t


def test_receiver_matches_jax(small_cfg, two_prn_stream):
    """Four seconds of the two-PRN stream: acquisition, code lock, two
    reported seconds on both channels."""
    rx_j, rx_t, rep_j, rep_t = _both(chans_for(jd), chans_for(td),
                                     _seconds(two_prn_stream, small_cfg), small_cfg.fs)
    assert rx_t.log == rx_j.log
    assert [ln.split(":")[0].strip() for ln in rx_t.log] == (
        ["acquisition"] * 2 + ["code lock"] * 2)
    assert _assert_reports_match(rep_j, rep_t) == 4
    _assert_states_match(rx_j.states, rx_t.states)
    for r, truth in zip(rep_t[3], (120.0, -210.0)):
        assert r.locked and abs(r.fc_hz - truth) < 0.05


def test_lock_loss_matches_jax(small_cfg):
    """tests/test_dllpll.py:87-106: acquire, lock, then pure noise."""
    fs, L = int(small_cfg.fs), small_cfg.samples_per_code
    (stream,) = synthesize_capture(
        small_cfg,
        [ChannelSim(delay_samples=60.0, doppler_hz=80.0, amplitude=1200,
                    noise_sigma=100)],
        n_seconds=3, seed=4,
    )
    rng = np.random.default_rng(0)
    noise = rng.normal(0, 100, 2 * fs) + 1j * rng.normal(0, 100, 2 * fs)
    secs = [{"A": stream[: fs + 2 * L]}, {"A": stream[fs : 2 * fs + 2 * L]},
            {"A": noise[: fs + 2 * L]}]
    rx_j, rx_t, rep_j, rep_t = _both([small_chan(jd, 9)], [small_chan(td, 9)],
                                     secs, small_cfg.fs)
    assert not rx_t.states[0].is_trk and rx_t.states[0].last_phi == 0.0
    assert any("lock lost" in ln for ln in rx_t.log)
    assert rx_t.log == rx_j.log
    _assert_reports_match(rep_j, rep_t)


def test_sic_matches_jax(small_cfg):
    """tests/test_dllpll.py:114-157: a weak PRN 27 dB under a strong one
    locks only with SIC; the port subtracts the same interferer.  The
    strong channel's float32 lag bank at 2500 amplitude and low noise
    rounds differently in the two packages' sums: gd within 1e-2 ns
    (1e-6 sample) here."""
    fs, L = int(small_cfg.fs), small_cfg.samples_per_code
    cfg_b = dataclasses.replace(small_cfg, taps=27)
    (stream,) = synthesize_capture(
        small_cfg,
        [ChannelSim(delay_samples=137.0, doppler_hz=120.0, amplitude=2500,
                    noise_sigma=40)],
        n_seconds=7, seed=5,
        extra_emissions=[(cfg_b, ChannelSim(delay_samples=555.0, doppler_hz=-210.0,
                                            amplitude=110, noise_sigma=0.0))],
    )
    secs = [{"A": stream[s * fs : (s + 1) * fs + 2 * L]} for s in range(6)]
    mk = lambda mod: [small_chan(mod, 9), small_chan(mod, 27, is_sic=True)]  # noqa: E731
    rx_j, rx_t, rep_j, rep_t = _both(mk(jd), mk(td), secs, small_cfg.fs)
    assert rx_t.log == rx_j.log
    assert any(ln.startswith("SIC") for ln in rx_t.log)
    _assert_reports_match(rep_j, rep_t, gd_ns=1e-2)
    weak = rep_t[-1][1]
    assert weak is not None and weak.locked
    assert abs(weak.gd_ns - 555.0 * 1e9 / fs) < 0.2 * 1e9 / fs


def test_reload_params_matches_jax(small_cfg, two_prn_stream):
    """tests/test_tracker.py:270-281: unchanged rows keep their state, a
    changed row (or a dropped one) re-initializes; then both receivers
    carry on identically."""
    secs = _seconds(two_prn_stream, small_cfg)
    rx_j, rx_t, _, _ = _both(chans_for(jd), chans_for(td), secs[:2], small_cfg.fs)
    same = "A N 100 0.0 50 50 500 50 20\nA N 101 0.0 50 50 500 50 20\n"
    assert rx_t.reload_params(same) == rx_j.reload_params(same) == []
    band = "A N 100 0.0 50 50 300 50 20\nA N 101 0.0 50 50 500 50 20\n"
    assert rx_t.reload_params(band) == rx_j.reload_params(band) == []
    changed = "A N 100 0.0 50 50 500 50 20\nA N 101 0.0 50 50 600 50 20\n"
    assert rx_t.reload_params(changed) == rx_j.reload_params(changed) == [1]
    assert rx_t.states[0].is_trk and not rx_t.states[1].is_trk
    assert 1 not in rx_t._wav_lags
    rep_j = [rx_j.process_second(s) for s in secs[2:]]
    rep_t = [rx_t.process_second(s) for s in secs[2:]]
    _assert_reports_match(rep_j, rep_t)
    _assert_states_match(rx_j.states, rx_t.states)
    assert rx_t.log == rx_j.log
    assert rx_t.reload_params("") == rx_j.reload_params("") == [0, 1]
    assert rx_t.channels == [] and rx_t._wav_lags == {}


def test_from_reference_mid_track(small_cfg, two_prn_stream):
    """The port started from the JAX receiver's replicas and state after
    two seconds reports what the JAX receiver reports for seconds 2-3."""
    secs = _seconds(two_prn_stream, small_cfg)
    rx_j = jd.Receiver(chans_for(jd), fs=small_cfg.fs)
    for s in secs[:2]:
        rx_j.process_second(s)
    assert all(s.is_trk and not s.is_first for s in rx_j.states)
    rx_t = td.Receiver.from_reference(
        [dict(cfg=dataclasses.asdict(c.cfg), nobs=c.nobs, wav=c.wav, fcode=c.fcode,
              psbb=c.psbb, chips=c.chips, sps_per_chip=c.sps_per_chip)
         for c in rx_j.channels],
        [dataclasses.asdict(s) for s in rx_j.states],
        rx_j._acq_attempt, fs=small_cfg.fs, device="cpu",
    )
    assert [c.cfg for c in rx_t.channels] == chans_for(td)
    rep_j = [rx_j.process_second(s) for s in secs[2:]]
    rep_t = [rx_t.process_second(s) for s in secs[2:]]
    assert _assert_reports_match(rep_j, rep_t) == 4
    _assert_states_match(rx_j.states, rx_t.states)
    with pytest.raises(ValueError):
        td.Receiver.from_reference([], [{}], 0, device="cpu")


def test_receiver_matches_banked(small_cfg, two_prn_stream):
    """tests/test_tracker.py:69-82 in the port: the bank (float32 on the
    device's path) reproduces the host receiver's solutions."""
    secs = _seconds(two_prn_stream, small_cfg)
    host = td.Receiver(chans_for(td), fs=small_cfg.fs, device="cpu")
    bank = tt.BankedReceiver(chans_for(td), fs=small_cfg.fs, device="cpu")
    rep_h = [host.process_second(s) for s in secs]
    rep_b = [bank.process_second(s) for s in secs]
    for rh, rb in zip(rep_h[3], rep_b[3]):
        assert rh is not None and rb is not None and rh.locked and rb.locked
        assert abs(rb.fc_hz - rh.fc_hz) < 1e-3
        assert abs(rb.gd_ns - rh.gd_ns) < 1.0  # ns
        assert rb.cnt == rh.cnt


def test_cli_host_out_dir_matches_jax(small_cfg, two_prn_stream, tmp_path, capsys):
    """dllpll --host --out-dir on a write_sc16 capture: the same .dat files
    and rxcomplex.log as the JAX CLI (integer columns identical, floats
    within the tolerances above), and the same printed rows."""
    from amaranth_twstft_tpu.cli import main as jax_main
    from amaranth_twstft_tpu_torch.cli import main as torch_main
    from amaranth_twstft_tpu_torch.utils.io import write_sc16

    fs = int(small_cfg.fs)
    cap = tmp_path / "cap.bin"
    write_sc16(str(cap), two_prn_stream[: 4 * fs], two_prn_stream[: 4 * fs] * 0.5)
    param = tmp_path / "sdr.param"
    param.write_text("A N 100 0.0 50 50 500 50 20\nB N 101 0.0 50 50 500 50 20\n")
    common = [str(cap), "--param", str(param), "--fs", "1e5", "--bitlen", "10",
              "--code-len", "1000", "--nlag", "8", "--taps-map", "100=9,101=27",
              "--host"]
    capsys.readouterr()
    assert jax_main(["dllpll", *common, "--out-dir", str(tmp_path / "jax")]) == 0
    out_j = capsys.readouterr().out.splitlines()
    assert torch_main(["dllpll", *common, "--device", "cpu",
                       "--out-dir", str(tmp_path / "torch")]) == 0
    out_t = capsys.readouterr().out.splitlines()
    dj, dt = tmp_path / "jax", tmp_path / "torch"
    assert sorted(os.listdir(dj)) == sorted(os.listdir(dt))
    assert (dt / "rxcomplex.log").read_text() == (dj / "rxcomplex.log").read_text()
    dats = [n for n in os.listdir(dj) if n.endswith(".dat")]
    assert len(dats) == 2
    # columns: fc phi cnt ib*dur gd dg sdgd pk_dbm pnoise_dbm
    tol = {0: FC_HZ, 1: PHI_CYCLES, 4: GD_NS, 5: DG_NS_S, 6: SDGD_NS, 7: 1e-3, 8: 1e-3}
    for name in dats:
        rows_j = (dj / name).read_text().splitlines()
        rows_t = (dt / name).read_text().splitlines()
        assert len(rows_j) == len(rows_t) == 2
        for rj, rt_ in zip(rows_j, rows_t):
            cj, ct = rj.split(), rt_.split()
            assert len(cj) == len(ct) == 9
            assert cj[2] == ct[2] and cj[3] == ct[3]
            for k, t in tol.items():
                assert abs(float(cj[k]) - float(ct[k])) < t, (name, k, rj, rt_)
    assert len(out_j) == len(out_t) == 4
    for lj, lt in zip(out_j, out_t):
        assert lj.split()[:3] == lt.split()[:3]
        assert abs(float(lj.split()[3]) - float(lt.split()[3])) < FC_HZ


@pytest.mark.parametrize("d2,locks_neighbour", [(150.0, True), (400.0, False)])
def test_squaring_line_of_a_neighbour_in_both_packages(small_cfg, d2, locks_neighbour):
    """Acquisition's fine frequency squares the whole second and searches
    +-2*max(acq_step, 4) Hz around twice the CAF's frequency on the doubled
    axis (``dllpll.py:736-744``).  Squaring strips the BPSK of every
    emission on the input, so a second emission whose Doppler lies within
    the mask (here 30 Hz from the first, mask +-50 Hz in fc) puts its line
    there too, and at equal amplitude it wins: the channel at 120 Hz
    starts tracking at the neighbour's 150 Hz.  Both packages do the same
    (the estimator is kept as the JAX package has it); 280 Hz apart, each
    channel keeps its own line."""
    (stream,) = synthesize_capture(
        small_cfg,
        [ChannelSim(delay_samples=137.0, doppler_hz=120.0, amplitude=900,
                    noise_sigma=120)],
        n_seconds=2, seed=0,
        extra_emissions=[(dataclasses.replace(small_cfg, taps=27),
                          ChannelSim(delay_samples=555.0, doppler_hz=d2,
                                     amplitude=900, noise_sigma=0.0))],
    )
    secs = _seconds(stream, small_cfg, 1)
    rx_j, rx_t, _, _ = _both(chans_for(jd), chans_for(td), secs, small_cfg.fs)
    assert rx_t.log == rx_j.log
    fc = [s.fc for s in rx_t.states]
    assert fc == [s.fc for s in rx_j.states]
    assert abs(fc[1] - d2) < 1.0
    assert (abs(fc[0] - d2) < 1.0) == locks_neighbour
    assert (abs(fc[0] - 120.0) < 1.0) != locks_neighbour
