"""The port's device-free copies against the JAX package.

``ops/nco``, ``models/gateware``, ``models/tutorial_radio``, ``control``,
``utils/obslog``, ``ops/lfsr.TapsCache``/``prn_states_np`` are copied into
the port (NumPy/stdlib, never imported from the reference).  Each case
below is a port of one case of ``tests/test_gateware.py``,
``test_formal.py``, ``test_tutorial_radio.py``,
``test_control_pipeline.py`` or ``test_lfsr.py``: it runs the original
assertions on BOTH packages with the same seeded inputs and returns what
it computed, and the two results must be equal byte for byte (arrays by
dtype, shape and bytes; enums by name and value).

``ops/resample.polyphase_decimate`` (``test_resample_phase.py``) is torch
``conv1d`` in the port: it matches the JAX package to 1e-12 in float64.
"""

import datetime as dt
import enum
import math
import types

import numpy as np
import pytest
import torch

import amaranth_twstft_tpu.config as j_config
import amaranth_twstft_tpu.control as j_control
import amaranth_twstft_tpu.models.emitter as j_emitter
import amaranth_twstft_tpu.models.gateware as j_gateware
import amaranth_twstft_tpu.models.gofinal as j_gofinal
import amaranth_twstft_tpu.models.tutorial_radio as j_radio
import amaranth_twstft_tpu.ops.lfsr as j_lfsr
import amaranth_twstft_tpu.ops.nco as j_nco
import amaranth_twstft_tpu.pipeline as j_pipeline
import amaranth_twstft_tpu.utils.matio as j_matio
import amaranth_twstft_tpu.utils.obslog as j_obslog
import amaranth_twstft_tpu_torch.config as t_config
import amaranth_twstft_tpu_torch.control as t_control
import amaranth_twstft_tpu_torch.models.emitter as t_emitter
import amaranth_twstft_tpu_torch.models.gateware as t_gateware
import amaranth_twstft_tpu_torch.models.gofinal as t_gofinal
import amaranth_twstft_tpu_torch.models.tutorial_radio as t_radio
import amaranth_twstft_tpu_torch.ops.lfsr as t_lfsr
import amaranth_twstft_tpu_torch.ops.nco as t_nco
import amaranth_twstft_tpu_torch.pipeline as t_pipeline
import amaranth_twstft_tpu_torch.utils.matio as t_matio
import amaranth_twstft_tpu_torch.utils.obslog as t_obslog

JAX = types.SimpleNamespace(
    config=j_config, control=j_control, emitter=j_emitter,
    gateware=j_gateware, gofinal=j_gofinal, radio=j_radio, lfsr=j_lfsr,
    nco=j_nco, pipeline=j_pipeline, matio=j_matio, obslog=j_obslog,
)
PORT = types.SimpleNamespace(
    config=t_config, control=t_control, emitter=t_emitter,
    gateware=t_gateware, gofinal=t_gofinal, radio=t_radio, lfsr=t_lfsr,
    nco=t_nco, pipeline=t_pipeline, matio=t_matio, obslog=t_obslog,
)


def _norm(x):
    """A byte-exact, package-independent form of a result."""
    if isinstance(x, enum.Enum):
        return ("enum", type(x).__name__, x.name, x.value)
    if isinstance(x, np.ndarray):
        return ("nd", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, np.generic):
        return ("np", x.dtype.str, x.tobytes())
    if isinstance(x, float):
        return ("f", x.hex())
    if isinstance(x, dict):
        return ("d", sorted((repr(_norm(k)), _norm(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [_norm(v) for v in x])
    return x


# ----------------------------------------------------------------------
# tests/test_gateware.py
# ----------------------------------------------------------------------
def _gw_cfg(P, **kw):
    base = dict(fs=5e4, chip_rate=2.5e4, code_len=100, bit_len=10, taps=9,
                f_carrier=70e4)
    base.update(kw)
    return P.config.SignalConfig(**base)


def _gw_geom(P):
    return P.gateware.GatewareGeometry(f_clock=2.8e6, f_carrier=70e4,
                                       f_code=2.5e4)


def gw_geometry_ratios(P, tmp):
    g = _gw_geom(P)
    assert (g.ticks_per_period, g.periods_per_symbol, g.ticks_per_chip) == (4, 28, 112)
    prod = P.gateware.GatewareGeometry()
    assert (prod.ticks_per_period, prod.periods_per_symbol) == (4, 28)
    with pytest.raises(ValueError):
        P.gateware.GatewareGeometry(f_clock=2.8e6, f_carrier=69e4, f_code=2.5e4)
    return g.ticks_per_period, g.periods_per_symbol, g.ticks_per_chip


def gw_oscillator_invariants(P, tmp):
    t = 8
    out, out90, phase_end = P.gateware.oscillator_waveforms(4 * t, t)
    assert out[:4].all() and not out[4:8].any()
    assert np.array_equal(out90, np.roll(out, t // 4))
    assert np.array_equal(np.flatnonzero(phase_end), np.arange(t - 1, 4 * t, t))
    return out, out90, phase_end, P.gateware.oscillator_waveforms(21, 4, -1)


def gw_safe_timer_exact_n_ticks(P, tmp):
    timer = P.gateware.SafeTimer(37)
    trace = [timer.step(reset=True)]
    for i in range(36):
        trace.append(timer.step())
        assert not trace[-1], f"finished early at tick {i + 1}"
    trace += [timer.step(), timer.step()]
    assert trace[-2] and trace[-1]
    timer.step(reset=True)
    assert not timer.finished
    with pytest.raises(ValueError):
        P.gateware.SafeTimer(0)
    return trace


def gw_synchronizer_pps_flags(P, tmp):
    geom = _gw_geom(P)
    code_ticks = 100 * geom.ticks_per_chip
    aligned = P.gateware.synchronizer_pps_flags(3 * code_ticks - 1, geom, 100)
    assert not any(aligned.values())
    late = P.gateware.synchronizer_pps_flags(3 * code_ticks, geom, 100)
    assert all(late.values())
    f = P.gateware.synchronizer_pps_flags(geom.ticks_per_period - 1, geom, 100)
    assert not f["oscil_unaligned"]
    assert f["symbol_unaligned"] and f["code_unaligned"]
    return aligned, late, f


def gw_mixer_modes(P, tmp):
    M = P.config.Modulation
    c = np.array([0, 1, 0, 1], dtype=np.uint8)
    c90 = np.array([0, 0, 1, 1], dtype=np.uint8)
    d0 = np.array([1, 1, 0, 0], dtype=np.uint8)
    z = np.zeros(4, dtype=np.uint8)
    tc = np.array([1, 0, 1, 0], dtype=np.uint8)
    mix = P.gateware.mixer_out
    assert not mix(c, c90, d0, z, z, M.OFF).any()
    assert np.array_equal(mix(c, c90, d0, z, z, M.CARRIER), c)
    assert np.array_equal(mix(c, c90, d0, z, z, M.BPSK), c ^ d0)
    assert np.array_equal(mix(c, c90, d0, z, tc, M.BPSK), c ^ d0 ^ tc)
    return [mix(c, c90, d0, d0 ^ tc, tc, m) for m in M]


def gw_bpsk_if_demodulates_to_chips(P, tmp):
    cfg, geom = _gw_cfg(P), _gw_geom(P)
    bits = P.gateware.digital_if_second(cfg, geom, n_codes=2)
    assert bits.dtype == np.uint8 and len(bits) == 2 * 100 * 112
    env = P.gateware.downconvert_if(bits, geom)
    chips = P.lfsr.prn_chips(cfg.bit_len, cfg.taps, cfg.code_len, cfg.seed)
    pm = 1.0 - 2.0 * np.tile(chips, 2)
    np.testing.assert_allclose(env / env[0], pm * pm[0], atol=1e-9)
    assert abs(abs(env[0]) - np.sqrt(2) / 2) < 1e-9
    return bits, env


def gw_bpsk_if_matches_baseband_model(P, tmp):
    cfg, geom = _gw_cfg(P), _gw_geom(P)
    bits = P.gateware.digital_if_second(cfg, geom, n_codes=2)
    env = P.gateware.downconvert_if(bits, geom, decim=int(geom.f_clock / cfg.fs))
    ref = np.tile(P.emitter.baseband_second(cfg)[: cfg.samples_per_code], 2)
    corr = np.vdot(ref, env) / (np.linalg.norm(ref) * np.linalg.norm(env))
    assert abs(corr) > 0.999999
    return env, corr


def gw_qpsk_if_matches_gray_map(P, tmp):
    cfg = _gw_cfg(P, taps_b=17, modulation=P.config.Modulation.QPSK)
    geom = _gw_geom(P)
    env = P.gateware.downconvert_if(
        P.gateware.digital_if_second(cfg, geom, n_codes=3), geom)
    ref = P.emitter.baseband_second(cfg)[:: cfg.samples_per_chip][: 3 * cfg.code_len]
    if len(ref) < 3 * cfg.code_len:
        ref = np.tile(ref[: cfg.code_len], 3)
    np.testing.assert_allclose(env / env[0], ref / ref[0], atol=1e-6)
    return env


def gw_timecode_inverts_first_code(P, tmp):
    geom = _gw_geom(P)
    cfg_tc = _gw_cfg(P, timecoder=P.config.TimeCoderMode.INVERT_FIRST_CODE)
    env_tc = P.gateware.downconvert_if(
        P.gateware.digital_if_second(cfg_tc, geom, n_codes=2), geom)
    env = P.gateware.downconvert_if(
        P.gateware.digital_if_second(_gw_cfg(P), geom, n_codes=2), geom)
    np.testing.assert_allclose(env_tc[:100], -env[:100], atol=1e-9)
    np.testing.assert_allclose(env_tc[100:], env[100:], atol=1e-9)
    return env_tc


def gw_nco_lut_and_spurs(P, tmp):
    lut = P.nco.make_cosine_lut(8)
    assert lut[0] == 255 and lut.min() == 0 and len(lut) == 256
    fs, f0, n = 2_000_000.0, 262.0 * 32, 1 << 14
    x = P.nco.nco_wave(fs, f0, n, resol=8)
    xf = x.astype(np.float64) - x.mean()
    k = np.argmax(np.abs(np.fft.rfft(xf * np.hanning(n))))
    assert abs(k * fs / n - f0) < 2 * fs / n
    spur = P.nco.nco_spur_floor(fs, f0, n, resol=8)
    assert spur < -40.0
    return lut, x, P.nco.nco_wave(280e6, 1e6, 4096, exact=True), spur


# ----------------------------------------------------------------------
# tests/test_formal.py
# ----------------------------------------------------------------------
def fm_lfsr_exhaustive_all_seeds_match_oracle(P, tmp):
    bit_len = 8
    taps = P.lfsr.find_mseq_taps(bit_len, 1)[0]
    cur = np.arange(1, 1 << bit_len, dtype=np.uint64)
    walk = []
    for _ in range(64):
        nxt = np.array([P.lfsr.lfsr_next(int(s), taps, bit_len) for s in cur],
                       dtype=np.uint64)
        msb = np.uint64(1) << np.uint64(bit_len - 1)
        x = cur & np.uint64(taps)
        for sh in (32, 16, 8, 4, 2, 1):
            x = x ^ (x >> np.uint64(sh))
        np.testing.assert_array_equal((cur >> np.uint64(1)) | ((x & np.uint64(1)) * msb), nxt)
        walk.append(nxt)
        cur = nxt
    return taps, np.stack(walk)


def fm_lfsr_mseq_period_exhaustive(P, tmp):
    bit_len = 10
    taps = P.lfsr.find_mseq_taps(bit_len, 1)[0]
    seen = np.zeros(1 << bit_len, dtype=bool)
    s = 1
    for _ in range((1 << bit_len) - 1):
        assert not seen[s]
        seen[s] = True
        s = P.lfsr.lfsr_next(s, taps, bit_len)
        assert s != 0
    assert s == 1 and seen[1:].all()
    return taps, seen


def _fm_safe_timer(n):
    def case(P, tmp):
        trace = []
        for reset_at in range(2 * n):
            t = P.gateware.SafeTimer(n)
            for _ in range(reset_at):
                t.step()
            t.step(reset=True)
            for k in range(1, 2 * n + 1):
                fin = t.step()
                assert fin == (k >= n), (n, reset_at, k)
                trace.append(fin)
        return trace
    return case


def fm_synchronizer_pps_flags_exhaustive(P, tmp):
    geom = P.gateware.GatewareGeometry(f_clock=112, f_carrier=28, f_code=4)
    ticks_per_code = geom.ticks_per_chip * 5
    clean, flags_all = [], []
    for pps in range(2 * ticks_per_code):
        flags = P.gateware.synchronizer_pps_flags(pps, geom, 5)
        tpp = geom.ticks_per_period
        assert flags["oscil_unaligned"] == (pps % tpp != tpp - 1)
        assert flags["symbol_unaligned"] == (
            (pps // tpp) % geom.periods_per_symbol != geom.periods_per_symbol - 1)
        if not any(flags.values()):
            clean.append(pps)
        flags_all.append(flags)
    assert clean == [ticks_per_code - 1, 2 * ticks_per_code - 1]
    return flags_all


def fm_mixer_truth_table_exhaustive(P, tmp):
    M = P.config.Modulation
    table = []
    for mode in M:
        for c, c90, d0, d1, tc in np.ndindex(2, 2, 2, 2, 2):
            out = int(P.gateware.mixer_out(
                np.array([c]), np.array([c90]), np.array([d0]),
                np.array([d1]), np.array([tc]), mode)[0])
            if mode == M.OFF:
                exp = 0
            elif mode == M.CARRIER:
                exp = c ^ tc
            elif mode == M.BPSK:
                exp = c ^ d0 ^ tc
            else:
                exp = d0 ^ (c if (d0 ^ d1) else c90) ^ tc
            assert out == exp
            table.append(out)
    return table


def fm_timecoder_all_seconds_exhaustive(P, tmp):
    T = P.config.TimeCoderMode
    rows = []
    for second in range(122):
        bits = P.emitter.timecode_bits(T.TIMECODE, second, 25)
        assert bits[0] == 1
        assert sum(int(bits[1 + i]) << i for i in range(6)) == second % 60
        assert not bits[7:].any()
        assert not P.emitter.timecode_bits(T.OFF, second, 25).any()
        rows.append(bits)
    return np.stack(rows)


def fm_oscillator_quadrature_exhaustive(P, tmp):
    outs = []
    for tpp in (4, 8, 12, 28):
        out, out90, pe = P.gateware.oscillator_waveforms(3 * tpp, tpp)
        for k in range(3 * tpp):
            assert out[k] == (k % tpp < tpp // 2)
            assert out90[k] == (tpp // 4 <= k % tpp < (3 * tpp) // 4)
            assert pe[k] == (k % tpp == tpp - 1)
        assert int(pe.sum()) == 3
        outs += [out, out90, pe]
    return outs


# ----------------------------------------------------------------------
# tests/test_tutorial_radio.py
# ----------------------------------------------------------------------
def tr_prescaler_period_and_enable_gating(P, tmp):
    tpp = math.ceil(10e6 / 1e6)
    out = P.radio.prescaler_wave(10e6, 1e6, np.ones(204, bool))
    pulses = np.flatnonzero(out)
    assert pulses[0] == tpp - 1 and np.all(np.diff(pulses) == tpp)
    en2 = np.concatenate([np.ones(25, bool), np.zeros(100, bool), np.ones(200, bool)])
    out2 = P.radio.prescaler_wave(10e6, 1e6, en2)
    assert out2[25:125].sum() == 0
    resumed = np.flatnonzero(out2[125:])
    assert resumed[0] == tpp - 1 and np.all(np.diff(resumed) == tpp)
    return out, out2


def tr_get_partition_expansion(P, tmp):
    p = P.radio.get_partition("mi2", 2, "si", 1, 440, 3)
    N = P.radio.NOTES
    assert p == [N["mi2"], N["mi2"], N["si"], 440, 440, 440]
    tetris = P.radio.get_partition(*P.radio.TETRIS_PARTITION)
    assert len(tetris) == sum(P.radio.TETRIS_PARTITION[1::2])
    assert N["si2"] == 2 * N["la"]
    return p, tetris, N


def tr_partition_to_samples_loops(P, tmp):
    notes = P.radio.partition_to_samples(["do", "re"], 10, sample_rate=8, beat_s=0.25)
    assert notes.tolist() == [262, 262, 294, 294, 262, 262, 294, 294, 262, 262]
    return notes


def tr_myradio_fm_carrier_band(P, tmp):
    f_clk, carrier, exc = 2_000_000, 200_000, 10
    radio, base = P.radio.myradio_waveform(
        P.radio.NOTES["re2"], 1 << 18, f_clk, sample_rate=5000, resol=8,
        carrier=carrier, excursion=exc, exact=True)
    assert set(np.unique(radio)) <= {0, 1}
    x = radio.astype(np.float64) - radio.mean()
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    pk = np.fft.rfftfreq(len(x), 1.0 / f_clk)[np.argmax(spec)]
    assert carrier - 500 <= pk <= carrier + exc * 255 + 500, pk
    assert base.max() - base.min() > 200
    return radio, base


def tr_myradio_unit_exponent_quirk(P, tmp):
    f_clk, carrier = 2_600_000, 200_000

    def peak(exact):
        radio, _ = P.radio.myradio_waveform(
            P.radio.NOTES["la"], 1 << 17, f_clk, sample_rate=4096, resol=8,
            carrier=carrier, excursion=0, exact=exact)
        x = radio.astype(np.float64) - radio.mean()
        return radio, np.fft.rfftfreq(len(x), 1.0 / f_clk)[np.argmax(np.abs(np.fft.rfft(x)))]

    r_exact, pk_exact = peak(True)
    r_quirk, pk_quirk = peak(False)
    assert abs(pk_exact - carrier) < 200
    assert abs(pk_quirk - carrier / 2) < 200
    return r_exact, r_quirk


# ----------------------------------------------------------------------
# tests/test_control_pipeline.py
# ----------------------------------------------------------------------
def _pair(P):
    t = P.control.LoopbackTransport()
    station = P.control.EmulatedStation(t)
    return t, station, P.control.StationController(t, bit_len=17, station=station)


def _station_state(st):
    return (st.mode, st.timecoder, st.calib_mode, st.taps_a, st.taps_b,
            st.time_s, st.pps_phase, st.calibrated)


def cp_wire_format(P, tmp):
    C = P.control.SerialInCommand
    enc = P.control.encode_command
    assert enc(C.MODE_BPSK) == bytes([5])
    w = enc(C.SET_TAPS_A, 0x12345, bit_len=17)
    assert w == bytes([2]) + (0x12345).to_bytes(3, "little")
    assert enc(C.SET_TIME, 75) == bytes([8, 15])
    with pytest.raises(ValueError):
        enc(C.SET_TAPS_B)
    return [enc(c, 0x1ABCD if c in (C.SET_TAPS_A, C.SET_TAPS_B, C.SET_TIME) else None)
            for c in C], list(P.control.SerialOutCode), list(P.control.CalibrationMode)


def cp_station_command_fsm(P, tmp):
    t, station, ctl = _pair(P)
    M, T, CM = P.config.Modulation, P.config.TimeCoderMode, P.control.CalibrationMode
    states = []
    ctl.set_mode(M.BPSK)
    assert station.mode == M.BPSK
    ctl.set_taps(taps_a=9, taps_b=85)
    assert station.taps_a == 9 and station.taps_b == 85
    ctl.set_time(42)
    assert station.time_s == 42
    ctl.set_timecode_mode(T.TIMECODE)
    assert station.timecoder == T.TIMECODE
    ctl.set_calib_mode(CM.PPS)
    assert station.calib_mode == CM.PPS
    states.append(_station_state(station))
    ctl.reset()
    assert station.mode == M.OFF and not station.calibrated
    states.append(_station_state(station))
    return states


def cp_ask_calib_returns_pps_phase(P, tmp):
    t, station, ctl = _pair(P)
    station.pps_phase = 7
    assert ctl.ask_calib() == 7
    assert station.calibrated
    return _station_state(station)


def cp_unknown_command_reported(P, tmp):
    t, station, ctl = _pair(P)
    t.write(bytes([99]))
    station.step()
    codes = []
    SO = P.control.SerialOutCode
    n = ctl.monitor({SO.UNKNOWN_COMMAND_ERROR: [lambda c, code: codes.append(code)]},
                    max_events=1)
    assert codes == [SO.UNKNOWN_COMMAND_ERROR]
    return n, codes


def cp_pps_synchronized_time_set(P, tmp):
    t, station, ctl = _pair(P)
    station.pps_tick(good=True)
    ctl.set_time_on_pps(lambda: 10)
    assert station.time_s == 11
    return _station_state(station)


def cp_schedule_windows(P, tmp):
    now = dt.datetime(2026, 8, 17, 12, 0)
    start, dur = P.pipeline.next_sampling_window(now)
    assert start.hour % 2 == 1 and start.minute in (3, 45)
    assert start > now and dur == 330.0
    proc_t = P.pipeline.next_processing_time(now)
    assert proc_t.minute == 53 and proc_t.hour % 2 == 1
    start2, _ = P.pipeline.next_sampling_window(dt.datetime(2026, 8, 17, 13, 2))
    assert (start2.hour, start2.minute) == (13, 3)
    return start.isoformat(), dur, proc_t.isoformat(), start2.isoformat()


def cp_retry_until_valid(P, tmp):
    calls = []

    def action():
        calls.append(1)
        return "ok" if len(calls) >= 3 else "bad"

    out = P.pipeline.retry_until_valid(action, lambda r: r == "ok", attempts=5,
                                       delay_s=0.0)
    assert out == "ok" and len(calls) == 3
    none = P.pipeline.retry_until_valid(lambda: "bad", lambda r: r == "ok",
                                        attempts=2, delay_s=0.0)
    assert none is None
    return out, len(calls), none


def cp_epoch_row_format(P, tmp):
    row = P.obslog.EpochRow(n=3, dt_s=0.000123456789012, df_hz=137.5, p_db=60.2,
                            snr_db=12.3)
    s = P.obslog.format_epoch_row(row)
    assert s == "3\t0.000123456789\t137.500\t60.2\t12.3"
    return s


def cp_event_log(P, tmp):
    path = tmp / "events.jsonl"
    log = P.obslog.EventLog(str(path))
    log.emit("lock_lost", channel="A", cnt=3)
    log.emit("slip", epoch=17)
    assert len(log.of_kind("slip")) == 1
    text = path.read_text().splitlines()
    assert len(text) == 2 and '"lock_lost"' in text[0]
    # the timestamps differ between runs; everything else must not
    return [{k: v for k, v in e.items() if k != "t"} for e in log.events], \
        [line.split(", ", 1)[1] for line in text]


def cp_gofinal_roundtrip(P, tmp):
    n = 60
    rng = np.random.default_rng(0)

    def mk(base):
        return {
            "indice": np.full(n, base, float),
            "correction": rng.normal(0, 0.01, n),
            "snr_r": np.full(n, 10.0), "snr_i": np.full(n, 5.0),
            "df": np.full(n, 100.0), "puissance": np.ones(n),
            "puissance_code": np.ones(n), "puissance_noise": np.ones(n),
            "xval": np.ones(n, complex), "xvalm1": np.ones(n, complex),
            "xvalp1": np.ones(n, complex),
        }

    local = str(tmp / "1755400000_local.mat")
    remote = str(tmp / "1755400000_remote.mat")
    P.matio.save_octave_style(local, mk(600.0), mk(60.0))
    P.matio.save_c_style(remote, mk(1500.0), None)
    out_txt = str(tmp / "1755400000ltfb.txt")
    out = P.gofinal.extract_session(local, remote, fs=1e5, out_txt=out_txt)
    assert out is not None and len(out["rows"]) == n
    rows = P.gofinal.read_rows(out_txt)
    assert rows.shape == (n, 15)
    np.testing.assert_allclose(rows[:, 6], 600.0 / 3 / 1e5, atol=1e-7)
    assert P.gofinal.extract_session(local, remote, fs=1e5, out_txt=out_txt) is None
    with open(out_txt, "rb") as f:
        return f.read(), rows


def cp_pps_calibration_bench_sweep(P, tmp):
    t = P.control.LoopbackTransport()
    st = P.control.EmulatedStation(t)
    ctl = P.control.StationController(t, station=st)
    bench = P.control.PpsCalibrationBench(st, ctl, seed=7)
    rows = bench.sweep(np.arange(0.0, 360.0, 0.25), repeats=6)
    med = np.array([r[1] for r in rows])
    ndist = np.array([r[2] for r in rows])
    early = np.array([r[3] for r in rows])
    assert set(np.unique(med).astype(int)) >= set(range(28))
    assert 0.0 < np.mean(ndist > 1) < 0.35
    assert np.all(early[ndist > 1] > 0)
    assert np.all(ndist[early == 0] == 1)
    return rows


def cp_fd_transport_over_real_pty(P, tmp):
    import fcntl
    import os

    master, slave = os.openpty()
    fcntl.fcntl(master, fcntl.F_SETFL,
                fcntl.fcntl(master, fcntl.F_GETFL) | os.O_NONBLOCK)

    class MasterAdapter:
        def station_read_all(self):
            try:
                return os.read(master, 4096)
            except BlockingIOError:
                return b""

        def station_write(self, data):
            os.write(master, data)

    station = P.control.EmulatedStation(transport=MasterAdapter())
    t = P.control.open_serial(os.ttyname(slave))
    assert isinstance(t, P.control.FdTransport)
    try:
        ctl = P.control.StationController(t, station=station)
        ctl.set_mode(P.config.Modulation.BPSK)
        station.step()
        assert station.mode == P.config.Modulation.BPSK
        ctl.set_taps(taps_a=0b1001)
        station.step()
        assert station.taps_a == 0b1001
        ctl.set_time(37)
        station.step()
        assert station.time_s == 37
        station.pps_tick(good=True)
        seen = []
        for _ in range(100):
            b = t.read(1)
            if b:
                seen.append(b[0])
                break
        assert seen and seen[0] == P.control.SerialOutCode.PPS_GOOD.value
    finally:
        t.close()
        os.close(master)
        os.close(slave)
    return _station_state(station), seen


def cp_uart_8e1_frame_bits(P, tmp):
    f = P.control.uart_frame_bits
    assert f(0xA5) == [0, 1, 0, 1, 0, 0, 1, 0, 1, 0, 1]
    assert f(0x01) == [0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 1]
    assert len(f(0xFF, parity="N")) == 10
    return [f(b, p) for b in range(256) for p in ("E", "O", "N")]


def cp_uart_line_roundtrip_and_errors(P, tmp):
    enc, dec = P.control.uart_encode, P.control.uart_decode
    data = bytes(range(0, 256, 7)) + b"\x00\xff"
    res = []
    for oversample in (1, 4):
        bits = enc(data, oversample=oversample)
        back, errs = dec(bits, oversample=oversample)
        assert back == data and errs == []
        res.append(bits)
    bits = enc(b"\x12\x34", oversample=1)
    bits[2] ^= 1
    back, errs = dec(bits, oversample=1)
    assert back == b"\x34"
    assert len(errs) == 1 and errs[0]["parity"] and not errs[0]["frame"]
    res.append((back, errs))
    bits = enc(b"\x55", oversample=1)
    bits[1 + 10] = 0
    back, errs = dec(bits, oversample=1)
    assert back == b"" and errs[0]["frame"]
    res.append((back, errs))
    return res


def cp_station_protocol_over_wire_transport(P, tmp):
    t = P.control.WireTransport(oversample=4)
    station = P.control.EmulatedStation(t)
    ctl = P.control.StationController(t, bit_len=17, station=station)
    ctl.set_mode(P.config.Modulation.BPSK)
    assert station.mode == P.config.Modulation.BPSK
    ctl.set_taps(taps_a=9, taps_b=85)
    assert station.taps_a == 9 and station.taps_b == 85
    assert t.bits_on_wire > 0 and t.line_errors == []
    t.corrupt_next_bit = True
    ctl.set_time(42)
    assert station.time_s != 42
    assert len(t.line_errors) == 1 and t.line_errors[0]["parity"]
    ctl.set_time(17)
    assert station.time_s == 17
    return _station_state(station), t.line_errors, t.bits_on_wire


def cp_calibration_bench_over_8e1_wire(P, tmp):
    t = P.control.WireTransport(oversample=2)
    st = P.control.EmulatedStation(t)
    ctl = P.control.StationController(t, station=st)
    rows = P.control.PpsCalibrationBench(st, ctl, seed=7).sweep(
        np.arange(0.0, 360.0, 6.0), repeats=3)
    med = np.array([r[1] for r in rows])
    assert t.line_errors == []
    assert med.min() >= 0 and med.max() < 28
    assert len(set(med.astype(int))) >= 20
    return rows, t.bits_on_wire


# ----------------------------------------------------------------------
# tests/test_lfsr.py: TapsCache, prn_states_np
# ----------------------------------------------------------------------
def lf_taps_cache(P, tmp):
    path = tmp / "taps.json"
    cache = P.lfsr.TapsCache(str(path))
    taps = cache.autofill(7, 2)
    assert taps == P.lfsr.find_mseq_taps(7, 2)
    assert P.lfsr.TapsCache(str(path)).autofill(7, 2) == taps
    return taps, path.read_bytes()


def lf_taps_cache_autofill_17(P, tmp):
    golden = P.config.GOLDEN_TAPS_17
    path = tmp / "taps.json"
    taps = P.lfsr.TapsCache(str(path)).autofill(17, 4)
    assert tuple(taps) == golden[:4]
    assert P.lfsr.TapsCache(str(path)).get(17)[:4] == list(golden[:4])
    return taps, path.read_bytes()


def lf_prn_states_np(P, tmp):
    rng = np.random.default_rng(5)
    taps = rng.integers(1, 1 << 17, 64)
    states = P.lfsr.prn_states_np(17, taps, 300, seed=3)
    for j in range(4):  # against the Python-int oracle
        s = 3
        for _ in range(300):
            s = P.lfsr.lfsr_next(s, int(taps[j]), 17)
        assert int(states[j]) == s
    return states, P.lfsr.prn_states_np(10, np.array([9, 27], np.uint64), 1023)


CASES = {
    f.__name__: f
    for f in [
        gw_geometry_ratios, gw_oscillator_invariants,
        gw_safe_timer_exact_n_ticks, gw_synchronizer_pps_flags,
        gw_mixer_modes, gw_bpsk_if_demodulates_to_chips,
        gw_bpsk_if_matches_baseband_model, gw_qpsk_if_matches_gray_map,
        gw_timecode_inverts_first_code, gw_nco_lut_and_spurs,
        fm_lfsr_exhaustive_all_seeds_match_oracle,
        fm_lfsr_mseq_period_exhaustive, fm_synchronizer_pps_flags_exhaustive,
        fm_mixer_truth_table_exhaustive, fm_timecoder_all_seconds_exhaustive,
        fm_oscillator_quadrature_exhaustive,
        tr_prescaler_period_and_enable_gating, tr_get_partition_expansion,
        tr_partition_to_samples_loops, tr_myradio_fm_carrier_band,
        tr_myradio_unit_exponent_quirk,
        cp_wire_format, cp_station_command_fsm, cp_ask_calib_returns_pps_phase,
        cp_unknown_command_reported, cp_pps_synchronized_time_set,
        cp_schedule_windows, cp_retry_until_valid, cp_epoch_row_format,
        cp_event_log, cp_gofinal_roundtrip, cp_pps_calibration_bench_sweep,
        cp_fd_transport_over_real_pty, cp_uart_8e1_frame_bits,
        cp_uart_line_roundtrip_and_errors,
        cp_station_protocol_over_wire_transport,
        cp_calibration_bench_over_8e1_wire,
        lf_taps_cache, lf_taps_cache_autofill_17, lf_prn_states_np,
    ]
}
for _n in (1, 2, 3, 7, 8, 9, 16, 33):
    CASES[f"fm_safe_timer_exhaustive_reset_points_{_n}"] = _fm_safe_timer(_n)


@pytest.mark.parametrize("name", sorted(CASES))
def test_copy_matches_jax_package(name, tmp_path):
    case = CASES[name]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = case(JAX, tmp_path / "jax")
    got = case(PORT, tmp_path / "port")
    assert _norm(got) == _norm(want)


# ----------------------------------------------------------------------
# tests/test_lfsr.py: prn_chips_jax -> prn_chips_device
# ----------------------------------------------------------------------
@pytest.mark.parametrize("bit_len,taps,n", [(7, 3, 500), (10, 9, 500),
                                            (17, 9, 500), (7, 3, 264)])
def test_prn_chips_device_matches_prn_chips_jax(bit_len, taps, n):
    got = t_lfsr.prn_chips_device(bit_len, taps, n, device="cpu")
    assert got.dtype == torch.int8 and got.device.type == "cpu"
    want = np.asarray(j_lfsr.prn_chips_jax(bit_len, taps, n))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        t_lfsr.prn_chips_device(33, 3, 10, device="cpu")


# ----------------------------------------------------------------------
# tests/test_resample_phase.py
# ----------------------------------------------------------------------
def test_polyphase_matches_direct_convolution_and_jax(rng):
    import jax.numpy as jnp

    from amaranth_twstft_tpu.ops import resample as j_resample
    from amaranth_twstft_tpu_torch.ops import resample as t_resample

    decim, n = 5, 1000
    x = rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))
    h = t_resample.design_lowpass(decim, taps_per_phase=6)
    np.testing.assert_array_equal(h, j_resample.design_lowpass(decim, taps_per_phase=6))
    got = t_resample.polyphase_decimate(torch.from_numpy(x), h, decim).numpy()
    nh = len(h)
    pad_lo = (nh - 1) // 2
    want = np.stack([np.convolve(row, h, mode="full")[pad_lo: pad_lo + n: decim]
                     for row in x])
    np.testing.assert_allclose(got, want[:, : got.shape[-1]], atol=1e-10)
    jx = np.asarray(j_resample.polyphase_decimate(jnp.asarray(x), jnp.asarray(h), decim))
    assert got.shape == jx.shape
    np.testing.assert_allclose(got, jx, rtol=0, atol=1e-12)


def test_polyphase_antialiases_vs_pick():
    from amaranth_twstft_tpu_torch.ops import resample as t_resample

    decim, n, fs = 10, 10000, 1e6
    x = np.exp(2j * np.pi * 0.4 * fs * np.arange(n) / fs)
    h = t_resample.design_lowpass(decim)
    y_poly = t_resample.polyphase_decimate(torch.from_numpy(x[None]), h, decim)[0].numpy()
    y_pick = t_resample.pick_decimate(x, decim)
    assert np.abs(y_poly[20:-20]).max() < 1e-3
    assert np.abs(y_pick[20:-20]).max() > 0.99


def test_carrier_phase_refine_recovers_slope_like_jax():
    from amaranth_twstft_tpu.models.twoway import carrier_phase_refine as j_cpr
    from amaranth_twstft_tpu_torch.models.twoway import carrier_phase_refine as t_cpr

    rng = np.random.default_rng(3)
    n, eps = 200, 25.0
    t = np.arange(n) / eps
    phi = 0.11 + 0.084 * t + rng.normal(0, 0.004, n)
    wrapped = ((phi + rng.integers(0, 2, n) * 0.5 + 0.5) % 1.0) - 0.5
    xval = np.exp(2j * np.pi * wrapped)
    xval[50] *= np.exp(2j * np.pi * 0.2)
    out = t_cpr(xval, epochs_per_second=eps)
    ref = j_cpr(xval, epochs_per_second=eps)
    assert abs(out["df_hz"] - 0.084) < 2e-3
    assert out["weights"].sum() >= n - 5
    assert abs(out["df_hz"] - ref["df_hz"]) < 1e-9
    np.testing.assert_array_equal(np.asarray(out["weights"]), np.asarray(ref["weights"]))


def test_carrier_smooth_delays_tracks_wander_like_jax():
    from amaranth_twstft_tpu.models.twoway import carrier_smooth_delays as j_csd
    from amaranth_twstft_tpu_torch.models.twoway import carrier_smooth_delays as t_csd

    rng = np.random.default_rng(7)
    n, eps, fc = 500, 25.0, 70e6
    t = np.arange(n) / eps
    tau_ns = 5000.0 + 0.8 * t + 0.15 * np.sin(2 * np.pi * 0.3 * t)
    code_ns = tau_ns + rng.normal(0, 0.08, n)
    xval = 1000.0 * np.exp(2j * np.pi * (-fc * tau_ns * 1e-9 + rng.normal(0, 2e-4, n)))
    sm = np.asarray(t_csd(code_ns, xval, fc, epochs_per_second=eps))
    ref = np.asarray(j_csd(code_ns, xval, fc, epochs_per_second=eps))
    assert abs(np.mean(sm) - np.mean(tau_ns)) < 0.05
    assert np.std(sm - tau_ns) < 0.15 * np.std(code_ns - tau_ns)
    assert np.std(sm - tau_ns) < 0.01
    np.testing.assert_allclose(sm, ref, rtol=0, atol=1e-9)


def test_package_exports_the_configs_like_jax():
    """The package root exports the JAX package's four configuration
    classes (its ``__init__.py`` imports), with the same field names."""
    import dataclasses

    import amaranth_twstft_tpu as jpkg
    import amaranth_twstft_tpu_torch as tpkg

    names = ["SignalConfig", "ProcessingConfig", "StationConfig", "MeshConfig"]
    assert sorted(tpkg.__all__) == sorted(names)
    for name in names:
        cls = getattr(tpkg, name)
        assert cls is getattr(t_config, name)
        assert ([f.name for f in dataclasses.fields(cls)]
                == [f.name for f in dataclasses.fields(getattr(jpkg, name))])
