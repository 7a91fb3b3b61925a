"""The port's ``studies`` against the JAX package's, on the CPU at the
JAX tests' sizes (``tests/test_studies.py``).

- The device-free studies return the JAX package's values bit for bit.
- The correlator studies run with ``device="cpu"``: per-epoch delays
  within 1e-6 sample of the JAX package's, summary fields within 1e-6
  relative; the f16-ingest study's percentiles within 1e-4 ns.
- Every assertion of ``tests/test_studies.py`` holds for both packages
  (the tests below are parametrized over them).
"""

import numpy as np
import pytest
import torch

from amaranth_twstft_tpu import studies as jst
from amaranth_twstft_tpu.config import SignalConfig as JSignal
from amaranth_twstft_tpu.models import twoway as jtw
from amaranth_twstft_tpu.ops import correlator as jcorr
from amaranth_twstft_tpu.ops import nco as jnco
from amaranth_twstft_tpu.ops.lfsr import prn_chips as jprn_chips
from amaranth_twstft_tpu_torch import studies as tst
from amaranth_twstft_tpu_torch.config import SignalConfig as TSignal
from amaranth_twstft_tpu_torch.models import twoway as ttw
from amaranth_twstft_tpu_torch.ops import nco as tnco
from amaranth_twstft_tpu_torch.ops.lfsr import prn_chips as tprn_chips
from amaranth_twstft_tpu_torch.ops.prn import chips_to_pm1

PKGS = ["jax", "torch"]
SIG = dict(fs=1e5, chip_rate=5e4, code_len=1000, bit_len=10, taps=9)
DELAY_TOL = 1e-6  # samples
REL_TOL = 1e-6
F16_TOL_NS = 1e-4

# study name -> (call, sample rate of its delays); the JAX tests' sizes
STUDIES = {
    "qpsk": (lambda m, kw: m.qpsk_vs_bpsk_study(
        (JSignal if m is jst else TSignal)(**SIG), **kw), SIG["fs"]),
    "code_length": (lambda m, kw: m.code_length_study(**kw), 5e6),
    "timing": (lambda m, kw: m.timing_interpolation_study(**kw), 5e6),
    "f16": (lambda m, kw: m.f16_ingest_error_study(n_epochs=64, chunk=32, **kw), 5e6),
    "gotracking": (lambda m, kw: m.gotracking_slope_study(n_seconds=12, seed=1, **kw), 1e5),
}
_RESULTS: dict = {}


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _run(pkg: str, study: str):
    """(output, per-call delay arrays in samples) of one package's study,
    computed once per module."""
    key = (pkg, study)
    if key not in _RESULTS:
        call, fs = STUDIES[study]
        mod, kw = (jst, {}) if pkg == "jax" else (tst, {"device": "cpu"})
        owner = jcorr if pkg == "jax" else tst
        orig = owner.delay_seconds
        delays = []

        def record(*a, **k):
            out = orig(*a, **k)
            delays.append(_host(out) * fs)
            return out

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(owner, "delay_seconds", record)
            _RESULTS[key] = (call(mod, kw), delays)
    return _RESULTS[key]


def _mod(pkg):
    return jst if pkg == "jax" else tst


def _code():
    return chips_to_pm1(tprn_chips(12, 0x53, 4000))


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


def test_public_names_and_campaign_match():
    assert tst.__all__ == jst.__all__
    assert tst.CODE_LENGTH_CAMPAIGN == jst.CODE_LENGTH_CAMPAIGN
    np.testing.assert_array_equal(tprn_chips(12, 0x53, 4000), jprn_chips(12, 0x53, 4000))


def _equal_dicts(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("case", ["sweep", "interp1", "interp3", "satre",
                                  "satre_cont", "slip", "estimators"])
def test_device_free_studies_bit_identical(case):
    code = _code()
    rng = np.random.default_rng(5)
    x = 1e-9 * rng.normal(0, 0.3, 2000) + 5e-9 * np.arange(2000) ** 2 / 2000**2
    x[700] += 50e-9
    calls = {
        "sweep": lambda m: m.snr_estimator_sweep(code, np.logspace(-1.5, 3, 17), seed=2),
        "interp1": lambda m: m.interpolation_effect(code[:1000]),
        "interp3": lambda m: m.interpolation_effect(code[:1000], factors=(0.1, 1.0, 10.0),
                                                    interp_code=3),
        "satre": lambda m: m.analyse_satre_series(x),
        "satre_cont": lambda m: m.analyse_satre_series(x, continuous=True),
        "slip": lambda m: m.slip_repair_study(),
        "estimators": lambda m: {
            "despread": m.snr_despreading(np.stack([code * 2 + 0.1, code - 0.3]), code),
            "xcorr": m.snr_xcorr_floor(np.stack([code * 2 + 0.1, np.roll(code, 7)]), code),
        },
    }
    _equal_dicts(calls[case](tst), calls[case](jst))


@pytest.mark.parametrize("study", ["qpsk", "code_length", "timing"])
def test_correlator_studies_match_jax(study):
    """Per-epoch delays within 1e-6 sample, summary fields within 1e-6
    relative of the JAX package's."""
    (t_out, t_dl), (j_out, j_dl) = _run("torch", study), _run("jax", study)
    assert len(t_dl) == len(j_dl) > 0
    for a, b in zip(t_dl, j_dl):
        assert a.shape == b.shape
        assert np.max(np.abs(a - b)) < DELAY_TOL
    assert sorted(t_out) == sorted(j_out)
    for k in t_out:
        np.testing.assert_allclose(np.asarray(t_out[k], float),
                                   np.asarray(j_out[k], float),
                                   rtol=REL_TOL, atol=0, err_msg=k)


def test_gotracking_study_matches_jax():
    t, j = _run("torch", "gotracking")[0], _run("jax", "gotracking")[0]
    assert sorted(t) == sorted(j)
    for k in t:
        np.testing.assert_allclose(np.asarray(t[k], float), np.asarray(j[k], float),
                                   rtol=REL_TOL, atol=0, err_msg=k)


def test_f16_study_matches_jax():
    """The percentile tables within 1e-4 ns (the port runs its chains in
    torch, the JAX package in NumPy around torch's CPU FFT)."""
    t, j = _run("torch", "f16")[0], _run("jax", "f16")[0]
    assert sorted(t) == sorted(j)
    for chain in ("quant", "f32", "int8"):
        assert t[chain]["n"] == j[chain]["n"] == 64
        for k in ("p50_ns", "p90_ns", "p99_ns", "max_ns"):
            assert abs(t[chain][k] - j[chain][k]) < F16_TOL_NS, (chain, k)
    assert (t["snr_db"], t["amp"], t["sigma"]) == (j["snr_db"], j["amp"], j["sigma"])


def test_correlator_studies_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tst.code_length_study(configs=((10, 9, 500),), n_epochs=2),
                 lambda: tst.f16_ingest_error_study(n_epochs=2, code_len=500),
                 lambda: tst.gotracking_slope_study(n_seconds=1),
                 lambda: tst.timing_interpolation_study(code_len=500, n_epochs=2),
                 lambda: tst.qpsk_vs_bpsk_study(TSignal(**SIG))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# ---------------------------------------------------------------------------
# the conclusions of tests/test_studies.py, for both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_despreading_tracks_truth(pkg):
    out = _mod(pkg).snr_estimator_sweep(_code(), np.logspace(-1.5, 1.5, 13), seed=2)
    err = out["claudio_db"] - out["snr_th_db"]
    assert np.max(np.abs(err)) < 1.5, err


@pytest.mark.parametrize("pkg", PKGS)
def test_xcorr_estimator_saturates_at_high_snr(pkg):
    out = _mod(pkg).snr_estimator_sweep(_code(), np.array([1.0, 10.0, 100.0, 1000.0]),
                                        seed=4)
    xc, cl = out["xcorr_db"], out["claudio_db"]
    assert cl[-1] - cl[0] > 25
    assert xc[-1] - xc[0] < 15


@pytest.mark.parametrize("pkg", PKGS)
def test_interpolation_invariance(pkg):
    code = _code()[:1000]
    m = _mod(pkg)
    for interp in (1, 3):
        out = m.interpolation_effect(code, factors=(0.1, 1.0, 10.0), interp_code=interp)
        err = 10 * np.log10(out["snr_claudio"] / out["snr_th"])
        assert np.max(np.abs(err)) < 1.0, err


@pytest.mark.parametrize("pkg", PKGS)
def test_cn0_operating_point(pkg):
    cn0_dbhz = (jtw if pkg == "jax" else ttw).cn0_dbhz
    snr_lin = 10 ** (-13 / 10)
    got = cn0_dbhz(np.full(5, snr_lin), np.zeros(5), 5e6)
    assert abs(got - (10 * np.log10(snr_lin * 5e6))) < 1e-9
    assert 53.0 < got < 55.0


@pytest.mark.parametrize("pkg", PKGS)
def test_qpsk_does_not_improve_timing(pkg):
    r = _run(pkg, "qpsk")[0]
    assert abs(r["bpsk_mean"] - 137.25) < 0.1, r
    assert abs(r["qpsk_mean"] - 137.25) < 0.2, r
    assert r["qpsk_std_samples"] > 0.8 * r["bpsk_std_samples"], r


@pytest.mark.parametrize("pkg", PKGS)
def test_slip_repair_study(pkg):
    out = _mod(pkg).slip_repair_study()
    assert out["n_flagged"] >= 20
    assert out["std_repaired"] < 0.1 * out["std_raw"]
    assert out["std_repaired"] < 0.05


@pytest.mark.parametrize("pkg", PKGS)
def test_code_length_study_sqrt_scaling(pkg):
    out = _run(pkg, "code_length")[0]
    assert np.all(np.abs(out["mean_samples"] - 123.0) < 0.5), out
    assert out["std_samples"][0] > out["std_samples"][1] > out["std_samples"][2]
    ratio = out["std_samples"][0] / out["std_samples"][2]
    assert 2.0 < ratio < 8.0, out


@pytest.mark.parametrize("pkg", PKGS)
def test_campaign_geometries_are_expressible(pkg):
    cfg_cls = JSignal if pkg == "jax" else TSignal
    for bit_len, taps, code_len in _mod(pkg).CODE_LENGTH_CAMPAIGN:
        cfg = cfg_cls(code_len=code_len, bit_len=bit_len, taps=taps)
        assert cfg.samples_per_code == 2 * code_len
        assert code_len < 2**bit_len
    one_s = cfg_cls(code_len=2_500_000, bit_len=22, taps=3)
    assert one_s.codes_per_second == 1.0
    assert one_s.code_duration == 1.0


@pytest.mark.parametrize("pkg", PKGS)
def test_timing_interpolation_mandatory(pkg):
    s0, s1, s2 = _run(pkg, "timing")[0]["std_samples"]
    assert s0 > 5.0 * s1
    assert s2 < 2.0 * s1
    assert s1 < 0.05


@pytest.mark.parametrize("pkg", PKGS)
def test_analyse_satre_outlier_policy(pkg):
    m = _mod(pkg)
    rng = np.random.default_rng(5)
    x = 1e-9 * rng.normal(0, 0.3, 2000) + 5e-9 * np.arange(2000) ** 2 / 2000**2
    x[700] += 50e-9
    out = m.analyse_satre_series(x)
    assert not out["kept"][699] and not out["kept"][700] and not out["kept"][701]
    assert out["kept"].sum() == 1997
    assert out["std"] < 1e-9
    cont = m.analyse_satre_series(x, continuous=True)
    assert 4 <= len(cont["clean"]) <= 9
    assert cont["std"] < out["std"]


@pytest.mark.parametrize("pkg", PKGS)
def test_f16_ingest_error_subpicosecond(pkg):
    res = _run(pkg, "f16")[0]
    assert res["quant"]["max_ns"] < 0.01, res["quant"]
    assert res["f32"]["max_ns"] < 0.01, res["f32"]
    assert res["int8"]["max_ns"] < 0.1, res["int8"]
    assert res["f32"]["n"] == 64


@pytest.mark.parametrize("pkg", PKGS)
def test_gotracking_slope_noise_floor(pkg):
    out = _run(pkg, "gotracking")[0]
    floor = out["noise_floor_s_per_s"]
    assert floor < 1e-12, floor
    n = len(out["slopes_s_per_s"])
    assert abs(out["slope_mean"] - out["slope_true"]) < 3 * floor / np.sqrt(n), out
    assert out["floor_production_extrapolated"] < 3e-13


@pytest.mark.parametrize("pkg", PKGS)
def test_nco_tutorial_halving_quirk_and_exact_mode(pkg):
    nco_wave = (jnco if pkg == "jax" else tnco).nco_wave

    def peak_hz(wave, fs):
        x = wave.astype(float) - wave.mean()
        spec = np.abs(np.fft.rfft(x * np.hanning(len(x))))
        return np.argmax(spec) * fs / len(x)

    fs, f0, n = 280e6, 4.375e6, 1 << 14
    assert abs(peak_hz(nco_wave(fs, f0, n), fs) - f0 / 2) < fs / n
    assert abs(peak_hz(nco_wave(fs, f0, n, exact=True), fs) - f0) < fs / n
    fs2, f02 = 2e6, 125e3
    assert abs(peak_hz(nco_wave(fs2, f02, n), fs2) - f02) < fs2 / n
    assert abs(peak_hz(nco_wave(fs2, f02, n, exact=True), fs2) - f02) < fs2 / n
