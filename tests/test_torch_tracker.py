"""The port's DLL/PLL bank against the JAX package's on CPU: transfer
decoding, the tracking and acquisition steps from identical inputs, and
the whole slice (receivers over a stream, MultiBank, the dllpll CLI)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amaranth_twstft_tpu.models import dllpll as jd
from amaranth_twstft_tpu.models import tracker as jt
from amaranth_twstft_tpu.models.emitter import ChannelSim, synthesize_capture
from amaranth_twstft_tpu_torch.models import dllpll as td
from amaranth_twstft_tpu_torch.models import tracker as tt

# Tolerances of the port against the JAX package (float32 on both sides,
# sums and transcendental functions from different libraries):
FC_HZ = 1e-3  # carrier frequency
GD_NS = 1.0  # code phase, ns (1e-4 sample at fs = 1e5)
PHI_CYCLES = 1e-4  # carrier phase
# packed (C, 9) tracking rows (c0p, c1p, c0g, c1g, chi2, cnt, pk_mean,
# last_phi, locked): 1e-4 relative, with an absolute floor per column for
# entries near zero — cycles and Hz 1e-4, code phase 1e-2 ns (1e-6
# sample: the f32 roundoff of the HRC ratios after cos/sin that differ by
# an ulp between XLA and torch), code rate 1e-2 ns/s
ROW_RTOL = 1e-4
ROW_ATOL = np.array([1e-4, 1e-4, 1e-2, 1e-2, 0.0, 0.0, 0.0, 1e-4, 0.0])
DF_HZ = 1e-3  # acquisition fine frequency


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
    """The two-PRN stream of tests/test_tracker.py."""
    cfg_b = dataclasses.replace(small_cfg, taps=27)
    streams = synthesize_capture(
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
    return streams[0]


def _seconds(stream, small_cfg, n=4, real=False):
    fs, L = int(small_cfg.fs), small_cfg.samples_per_code
    out = [stream[s * fs : (s + 1) * fs + 2 * L] for s in range(n)]
    return [{"A": np.real(x) if real else x} for x in out]


def _assert_reports_match(rep_j, rep_t):
    for sec_j, sec_t in zip(rep_j, rep_t):
        for a, b in zip(sec_j, sec_t):
            assert (a is None) == (b is None)
            if a is None:
                continue
            assert a.locked == b.locked and a.cnt == b.cnt and a.ib == b.ib
            assert abs(a.fc_hz - b.fc_hz) < FC_HZ
            assert abs(a.gd_ns - b.gd_ns) < GD_NS
            assert abs(a.phi_cycles - b.phi_cycles) < PHI_CYCLES


def _assert_states_match(states_j, states_t):
    for sj, st in zip(states_j, states_t):
        assert (sj.is_trk, sj.is_first, sj.pt) == (st.is_trk, st.is_first, st.pt)
        assert abs(sj.fc - st.fc) < FC_HZ


# ----------------------------------------------------------------------
# transfer formats
# ----------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["f16", "int8", "int4", "int2"])
def test_bufs_to_f32_bit_identical(fmt):
    rng = np.random.default_rng(3)
    bufs = rng.normal(0, 300, (2, 63, 2)).astype(np.float32)
    bufs[0, 0] = (1000.0, -1000.0)
    scale = None
    if fmt == "f16":
        packed = bufs.astype(np.float16)
    elif fmt == "int8":
        scale = float(np.max(np.abs(bufs))) / 127.0
        packed = np.clip(np.round(bufs / scale), -127, 127).astype(np.int8)
    elif fmt == "int4":
        packed, scale = tt.pack_int4_ri(bufs)
        packed_j, scale_j = jt.pack_int4_ri(bufs)
        assert np.array_equal(packed, packed_j) and scale == scale_j
    else:
        packed, scale = tt.pack_int2_ri(bufs)
        packed_j, scale_j = jt.pack_int2_ri(bufs)
        assert np.array_equal(packed, packed_j) and scale == scale_j
    s_np = None if scale is None else np.float32(scale)
    ref = np.asarray(jt._bufs_to_f32(
        jnp.asarray(packed), None if s_np is None else jnp.asarray(s_np)
    ))
    got = tt._bufs_to_f32(
        torch.from_numpy(packed),
        None if s_np is None else torch.tensor(s_np),
    ).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.array_equal(got, ref)


# ----------------------------------------------------------------------
# the per-second device steps from identical inputs
# ----------------------------------------------------------------------
def _reference_after(small_cfg, stream, n_seconds, **kw):
    rx = jt.BankedReceiver(chans_for(jd), fs=small_cfg.fs, **kw)
    for sec in _seconds(stream, small_cfg, n_seconds):
        rx.process_second(sec)
    return rx


def _port_from(rx_j, small_cfg, **kw):
    return tt.BankedReceiver.from_reference(
        chans_for(td),
        {
            "wav_ext": rx_j.bank.wav_ext,
            "psbb": rx_j.bank.psbb,
            "fcode_ri": rx_j.bank.fcode_ri,
            "_buf_idx": rx_j._buf_idx,
        },
        [dataclasses.asdict(s) for s in rx_j.states],
        fs=small_cfg.fs,
        acq_attempt=rx_j._acq_attempt,
        device="cpu",
        **kw,
    )


@pytest.mark.parametrize("transfer", ["auto", "int4"])
def test_track_step_matches_jax_from_reference_state(small_cfg, two_prn_stream,
                                                     transfer):
    rx_j = _reference_after(small_cfg, two_prn_stream, 2, transfer=transfer)
    assert all(s.is_trk for s in rx_j.states)
    rx_t = _port_from(rx_j, small_cfg, transfer=transfer)
    sec = _seconds(two_prn_stream, small_cfg, 3)[2]

    packed, scale, _, _ = rx_j._pack_second(sec)
    packed_t, scale_t, _, _ = rx_t._pack_second(sec)
    assert np.array_equal(packed, packed_t) and scale == scale_t
    b = rx_j.bank
    pt = np.array([s.pt for s in rx_j.states], np.int32)
    fc = np.array([s.fc for s in rx_j.states], np.float64)
    last_phi = np.array([s.last_phi for s in rx_j.states], np.float32)
    theta, t1, t2 = jt.phase_tables(b, pt, fc)
    for a, c in zip((theta, t1, t2), tt.phase_tables(rx_t.bank, pt, fc)):
        assert np.array_equal(a, c)
    kw = dict(ncodes=b.ncodes, nobs=b.nobs, nlag=b.nlag, bps=b.bps,
              fs=small_cfg.fs, group=1)
    s32 = None if scale is None else np.float32(scale)
    ref = np.asarray(jt.banked_track_step(
        jnp.asarray(packed), jnp.asarray(b.wav_ext), jnp.asarray(b.psbb),
        jnp.asarray(rx_j._buf_idx), jnp.asarray(pt), jnp.asarray(theta),
        jnp.asarray(t1), jnp.asarray(t2), jnp.asarray(last_phi),
        None if s32 is None else jnp.asarray(s32), **kw,
    ))
    T = torch.from_numpy
    got = tt.banked_track_step(
        T(packed), T(rx_t.bank.wav_ext), T(rx_t.bank.psbb), T(rx_t._buf_idx),
        T(pt), T(theta), T(t1), T(t2), T(last_phi),
        None if s32 is None else torch.tensor(s32), **kw,
    ).numpy()
    assert got.shape == ref.shape == (2, 9)
    np.testing.assert_array_equal(got[:, 5], ref[:, 5])  # cnt
    np.testing.assert_array_equal(got[:, 8], ref[:, 8])  # locked
    assert np.all(np.abs(got - ref) <= ROW_ATOL + ROW_RTOL * np.abs(ref)), got - ref

    # and both receivers carry on identically from that state
    reps_j = [rx_j.process_second(s) for s in _seconds(two_prn_stream, small_cfg, 4)[2:]]
    reps_t = [rx_t.process_second(s) for s in _seconds(two_prn_stream, small_cfg, 4)[2:]]
    _assert_reports_match(reps_j, reps_t)
    _assert_states_match(rx_j.states, rx_t.states)


def test_acquire_step_matches_jax(small_cfg, two_prn_stream):
    rx_j = jt.BankedReceiver(chans_for(jd), fs=small_cfg.fs)
    sec = _seconds(two_prn_stream, small_cfg, 1)[0]
    packed, _, _, _ = rx_j._pack_second(sec)
    b = rx_j.bank
    bin_hz = small_cfg.fs / b.nobs
    shifts = np.arange(int(np.floor(-500 / bin_hz)), int(np.ceil(500 / bin_hz)) + 1,
                       dtype=np.int32)
    freqs = shifts * bin_hz
    hyp_ok = np.stack([np.abs(freqs) <= 500 + bin_hz] * 2)
    buf_idx = np.array([0, 0], np.int32)
    nsec = b.bps * b.nobs
    kw = dict(nobs=b.nobs, nsec=nsec, fs=small_cfg.fs, win=33, chunk=4)
    for start in (25 * b.nobs, 3 * b.nobs):
        ref = jt.banked_acquire_step(
            jnp.asarray(packed), jnp.asarray(b.fcode_ri), jnp.asarray(buf_idx),
            jnp.asarray(shifts), jnp.asarray(hyp_ok), jnp.asarray(np.int32(start)),
            **kw,
        )
        got = tt.banked_acquire_step(
            torch.from_numpy(packed), torch.from_numpy(b.fcode_ri),
            torch.from_numpy(buf_idx).long(), torch.from_numpy(shifts),
            torch.from_numpy(hyp_ok), start, **kw,
        )
        df_j, pt_j, snr_j, pk_j = (np.asarray(x) for x in ref)
        df_t, pt_t, snr_t, pk_t = (x.numpy() for x in got)
        np.testing.assert_array_equal(pt_t, pt_j)
        assert np.abs(df_t - df_j).max() < DF_HZ
        np.testing.assert_allclose(snr_t, snr_j, rtol=1e-3)
        np.testing.assert_allclose(pk_t, pk_j, rtol=1e-4)


# ----------------------------------------------------------------------
# the slice as a whole
# ----------------------------------------------------------------------
@pytest.mark.parametrize("transfer,real", [("auto", False), ("int4", False),
                                           ("auto", True)])
def test_run_stream_matches_jax(small_cfg, two_prn_stream, transfer, real):
    """Four seconds of run_stream: same log lines, lock counts and code
    heads; fc/gd/phi within the stated tolerances."""
    if real:
        # rx.cpp real-sample mode: one emission on a 20 kHz carrier
        (stream,) = synthesize_capture(
            small_cfg,
            [ChannelSim(delay_samples=321.0, doppler_hz=20e3, amplitude=1200,
                        noise_sigma=80.0)],
            n_seconds=5, seed=11,
        )
        mk = lambda mod: [small_chan(mod, 9, fc=20e3, acq_range_hz=400.0,
                                     snr_min_db=15.0)]
    else:
        stream = two_prn_stream
        mk = chans_for
    kw = dict(fs=small_cfg.fs, transfer=transfer, real_input=real, group=1)
    rx_j = jt.BankedReceiver(mk(jd), **kw)
    rx_t = tt.BankedReceiver(mk(td), device="cpu", **kw)
    secs = _seconds(stream, small_cfg, 4, real=real)
    rep_j = list(rx_j.run_stream(iter(secs)))
    rep_t = list(rx_t.run_stream(iter(secs)))
    assert rx_t.log == rx_j.log
    assert any("code lock" in ln for ln in rx_t.log)
    _assert_reports_match(rep_j, rep_t)
    _assert_states_match(rx_j.states, rx_t.states)
    assert all(r is not None and r.locked for r in rep_t[3])


@pytest.mark.parametrize("frac", [0.3, 0.45])
def test_fractional_delay_matches_jax(small_cfg, frac):
    """A fractional code delay at 2 samples per chip: the port reports the
    JAX package's code phase, estimator bias included.  The HRC
    discriminator overshoots the fraction as it nears one half: within a
    quarter sample of the truth at 0.3, beyond it at 0.45 (which is why
    chip_smoke.py injects fractions within +-0.3 sample)."""
    delay = 137.0 + frac
    (stream,) = synthesize_capture(
        small_cfg,
        [ChannelSim(delay_samples=delay, doppler_hz=120.0, amplitude=900,
                    noise_sigma=30)],
        n_seconds=4, seed=1,
    )
    mk = lambda mod: [small_chan(mod, 9, snr_min_db=10.0)]
    rx_j = jt.BankedReceiver(mk(jd), fs=small_cfg.fs)
    rx_t = tt.BankedReceiver(mk(td), fs=small_cfg.fs, device="cpu")
    secs = _seconds(stream, small_cfg, 3)
    rep_j = [rx_j.process_second(s) for s in secs]
    rep_t = [rx_t.process_second(s) for s in secs]
    _assert_reports_match(rep_j, rep_t)
    err = rep_t[2][0].gd_ns * small_cfg.fs / 1e9 - delay
    if frac < 0.4:
        assert abs(err) < 0.25, err
    else:
        assert err > 0.25, err


def test_multibank_two_geometries_matches_jax(small_cfg, two_prn_stream):
    mk = lambda mod: [small_chan(mod, 9, fc=120.0),
                      small_chan(mod, 27, fc=-210.0, prn_id=101, nlag=12)]
    rx_j = jt.MultiBankReceiver(mk(jd), fs=small_cfg.fs)
    rx_t = tt.MultiBankReceiver(mk(td), fs=small_cfg.fs, device="cpu")
    assert len(rx_t.receivers) == 2
    secs = _seconds(two_prn_stream, small_cfg, 4)
    rep_j = [rx_j.process_second(s) for s in secs]
    rep_t = [rx_t.process_second(s) for s in secs]
    assert rx_t.log == rx_j.log
    assert [c.cfg.prn_id for c in rx_t.channels] == [100, 101]
    _assert_reports_match(rep_j, rep_t)
    _assert_states_match(rx_j.states, rx_t.states)


def test_cli_dllpll_round_trip_matches_jax(small_cfg, two_prn_stream, tmp_path,
                                           capsys):
    """dllpll --out-dir on a write_sc16 capture: the same .dat files and
    rxcomplex.log lines as the JAX CLI (integer columns identical, floats
    within the tolerances above)."""
    from amaranth_twstft_tpu.cli import main as jax_main
    from amaranth_twstft_tpu_torch.cli import main as torch_main
    from amaranth_twstft_tpu_torch.utils.io import write_sc16

    fs = int(small_cfg.fs)
    cap = tmp_path / "cap.bin"
    write_sc16(str(cap), two_prn_stream[: 4 * fs], two_prn_stream[: 4 * fs] * 0.5)
    param = tmp_path / "sdr.param"
    param.write_text("A N 100 0.0 50 50 500 50 20\nB N 101 0.0 50 50 500 50 20\n")
    common = [str(cap), "--param", str(param), "--fs", "1e5", "--bitlen", "10",
              "--code-len", "1000", "--nlag", "8", "--taps-map", "100=9,101=27"]
    jax_main(["dllpll", *common, "--out-dir", str(tmp_path / "jax")])
    torch_main(["dllpll", *common, "--device", "cpu",
                "--out-dir", str(tmp_path / "torch")])
    capsys.readouterr()
    dj, dt = tmp_path / "jax", tmp_path / "torch"
    assert sorted(os.listdir(dj)) == sorted(os.listdir(dt))
    assert (dt / "rxcomplex.log").read_text() == (dj / "rxcomplex.log").read_text()
    dats = [n for n in os.listdir(dj) if n.endswith(".dat")]
    assert dats
    # columns: fc phi cnt ib*dur gd dg sdgd pk_dbm pnoise_dbm
    tol = {0: FC_HZ, 1: PHI_CYCLES, 4: GD_NS, 5: 1e-2, 6: 1e-2, 7: 1e-3, 8: 1e-3}
    for name in dats:
        rows_j = (dj / name).read_text().splitlines()
        rows_t = (dt / name).read_text().splitlines()
        assert len(rows_j) == len(rows_t) > 0
        for rj, rt_ in zip(rows_j, rows_t):
            cj, ct = rj.split(), rt_.split()
            assert len(cj) == len(ct) == 9
            assert cj[2] == ct[2] and cj[3] == ct[3]
            for k, t in tol.items():
                assert abs(float(cj[k]) - float(ct[k])) < t, (name, k, rj, rt_)


def test_cli_refuses_unported_modes(tmp_path, capsys):
    """The one mode still refused is goranging --sharded (the multi-GPU
    pipeline); dllpll --host and --serve now run (tests/
    test_torch_dllpll_host.py, tests/test_torch_live.py)."""
    from amaranth_twstft_tpu_torch.cli import main as torch_main

    with pytest.raises(SystemExit) as e:
        torch_main(["goranging", "cap.bin", "code.bin", "--sharded",
                    "--device", "cpu"])
    assert e.value.code == 2
    assert "not ported yet" in capsys.readouterr().err
    param = tmp_path / "sdr.param"
    param.write_text("A N 100 0.0 50 50 500 50 20\n")
    cap = tmp_path / "empty.bin"
    cap.write_bytes(b"")
    for flag in (["--host"], ["--serve", "0"]):
        assert torch_main(["dllpll", str(cap), "--param", str(param), "--fs", "1e5",
                           "--bitlen", "10", "--code-len", "1000", "--nlag", "8",
                           "--device", "cpu", *flag]) == 0


def test_process_second_without_input_raises(small_cfg):
    rx = tt.BankedReceiver(chans_for(td), fs=small_cfg.fs, device="cpu")
    with pytest.raises(ValueError):
        rx.process_second()
