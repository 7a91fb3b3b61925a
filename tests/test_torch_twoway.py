"""The port's two-way products against the JAX package's, on the CPU:
``utils/mjd``, ``gofinal``, every ``twoway`` function, ``go1s``,
``campaign``, the verbs ``gofinal``/``twoway``/``go1s``/``campaign``, and
one end-to-end chain (single-channel captures of both sites -> claudio ->
go1s) at small geometry.

These modules are host NumPy in both packages; inputs are made from a
seed with NumPy.  Tolerances:

| What | Tolerance |
| --- | --- |
| ``mjd``, ``gofinal`` text files, ``.1s`` files, campaign text series | identical (bytes) |
| ``twoway`` results | identical, except ``carrier_phase_refine`` and what uses it: 1e-12 relative |
| ``.1sc`` values | 1e-6 ns |
| ``go1s`` summary rows | 1e-9 relative |
| end-to-end: ``.1s``, summary rows | identical bytes, 1e-9 relative |

``carrier_phase_refine`` computes its quantiles with torch in the port and
with ``jnp`` in the JAX package (both float64), which may round the last
bit differently.
"""

import dataclasses
import gzip
import json
import os

import numpy as np
import pytest

from amaranth_twstft_tpu import cli as jcli
from amaranth_twstft_tpu.config import ProcessingConfig as JProc
from amaranth_twstft_tpu.config import SignalConfig as JSignal
from amaranth_twstft_tpu.config import StationConfig as JStation
from amaranth_twstft_tpu.models import campaign as jcamp
from amaranth_twstft_tpu.models import claudio as jcl
from amaranth_twstft_tpu.models import go1s as jgo
from amaranth_twstft_tpu.models import gofinal as jgf
from amaranth_twstft_tpu.models import twoway as jtw
from amaranth_twstft_tpu.models.emitter import ChannelSim, synthesize_capture
from amaranth_twstft_tpu.ops.lfsr import write_prn_file
from amaranth_twstft_tpu.utils import io as jio
from amaranth_twstft_tpu.utils import matio as jmat
from amaranth_twstft_tpu.utils import mjd as jmjd
from amaranth_twstft_tpu_torch import cli as tcli
from amaranth_twstft_tpu_torch.config import ProcessingConfig as TProc
from amaranth_twstft_tpu_torch.config import SignalConfig as TSignal
from amaranth_twstft_tpu_torch.config import StationConfig as TStation
from amaranth_twstft_tpu_torch.models import campaign as tcamp
from amaranth_twstft_tpu_torch.models import claudio as tcl
from amaranth_twstft_tpu_torch.models import go1s as tgo
from amaranth_twstft_tpu_torch.models import gofinal as tgf
from amaranth_twstft_tpu_torch.models import twoway as ttw
from amaranth_twstft_tpu_torch.utils import mjd as tmjd

FS = 5e6
N_CODES = 300
TRUE_OFFSET_NS = 37.5


def _same(got, want, rtol=0.0, path="out"):
    """Recursive equality of results (NaN equals NaN); ``rtol`` > 0
    compares floats within that relative tolerance."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, path
        for f in dataclasses.fields(want):
            _same(getattr(got, f.name), getattr(want, f.name), rtol,
                  f"{path}.{f.name}")
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _same(got[k], want[k], rtol, f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)) and not (
            want and isinstance(want[0], (int, float, np.number))):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, rtol, f"{path}[{i}]")
    elif isinstance(want, (str, type(None), bool)):
        assert got == want, path
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape, path
        if rtol and np.issubdtype(w.dtype, np.inexact):
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=path)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)


# ---------------------------------------------------------------------------
# mjd


MJD_CASES = {
    "julian_day": lambda m: [m.julian_day(y, mo, d) for y, mo, d in
                             [(2025, 8, 17.5), (1582, 10, 4.0), (1, 1, 1.0),
                              (-100, 3, 1.0), (2024, 2, 29.25)]],
    "mjd_from_unix": lambda m: [m.mjd_from_unix(t) for t in (0.0, 1755400000.0,
                                                             1.5e9 + 0.25)],
    "unix_from_mjd": lambda m: [m.unix_from_mjd(x) for x in (40587.0, 60904.5)],
    "epoch_start_unix": lambda m: [m.epoch_start_unix(1755400300.0, 300),
                                   m.epoch_start_unix(1755400300.0, 7500, 0.04)],
    "timestamp_from_name": lambda m: [m.timestamp_from_name(n) for n in (
        "1755400000_2.bin", "localclaudio1755400007_2.mat.gz", "x12.bin", "")],
    "datestr_utc": lambda m: [m.datestr_utc(t) for t in (0, 1755400000.7)],
}


@pytest.mark.parametrize("fn", sorted(MJD_CASES))
def test_mjd_matches_jax(fn):
    assert MJD_CASES[fn](tmjd) == MJD_CASES[fn](jmjd)


# ---------------------------------------------------------------------------
# gofinal


@pytest.fixture(scope="module")
def gofinal_archives(tmp_path_factory):
    """One session's dual-channel local archive and remote archive
    (Octave field convention), 200 one-second epochs."""
    tmp = tmp_path_factory.mktemp("gofinal")
    rng = np.random.default_rng(11)
    n = 200

    def chan(level, snr):
        delay = level + rng.normal(0, 0.05, n)
        ind = np.floor(delay * 3)
        return dict(indice=ind, correction=delay * 3 - ind,
                    snr_r=10 ** (snr / 10) * rng.uniform(0.5, 1.5, n),
                    snr_i=np.full(n, 1e-4), df=rng.normal(100, 1, n),
                    puissance=np.ones(n), puissance_code=np.ones(n),
                    puissance_noise=np.ones(n))

    lo = str(tmp / "1755400300.mat")
    re = str(tmp / "remote1755400300.mat")
    jmat.save_octave_style(lo, chan(431.2, 10), chan(12.7, 20))
    jmat.save_octave_style(re, chan(900.4, 5), None)
    return lo, re


@pytest.mark.parametrize("end_unix", [None, 1755400333.0])
def test_gofinal_text_is_byte_identical(gofinal_archives, tmp_path, end_unix):
    lo, re = gofinal_archives
    outs = []
    for mod, sub in ((jgf, "j.txt"), (tgf, "t.txt")):
        path = str(tmp_path / sub)
        res = mod.extract_session(lo, re, capture_end_unix=end_unix, fs=FS,
                                  out_txt=path)
        outs.append((res, path))
        # resume: an existing table is left alone
        assert mod.extract_session(lo, re, out_txt=path) is None
    (jr, jp), (tr, tp) = outs
    _same(tr, jr)
    with open(jp, "rb") as f1, open(tp, "rb") as f2:
        data = f1.read()
        assert f2.read() == data
    assert data.count(b"\r\n") == 1  # the reference's header ending
    _same(tgf.read_rows(tp), jgf.read_rows(jp))


@pytest.mark.parametrize("kind", ["clean", "two_clusters", "short"])
def test_drift_disambiguate_matches_jax(kind):
    rng = np.random.default_rng(4)
    n = {"clean": 300, "two_clusters": 300, "short": 2}[kind]
    res = 1e-4 + rng.normal(0, 1e-9, n)
    if kind == "two_clusters":
        res[120:] += 5e-5  # a 50 us jump: > 1 us scatter after detrend
    idx = np.arange(n) * 2
    _same(tgf.drift_disambiguate(res, idx), jgf.drift_disambiguate(res, idx))


# ---------------------------------------------------------------------------
# twoway


def _series(seed=7, n=400):
    rng = np.random.default_rng(seed)
    return {k: base + rng.normal(0, 0.05, n)
            for k, base in (("op_lo", 100.0), ("op_re", 387.5),
                            ("lt_lo", 80.0), ("lt_re", 292.5))}


def _xval(seed=8, n=400, fc=70e6):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 25.0
    tau = 100.0 + 0.02 * t + 0.15 * np.sin(2 * np.pi * 0.25 * t)
    phi = -fc * tau * 1e-9 + rng.normal(0, 2e-4, n)
    amp = np.full(n, 1000.0)
    amp[:5] = 10.0
    amp[200:203] = 5.0
    return amp * np.exp(2j * np.pi * phi)


def _daily_rows(t0, n, lo=2e-5, re=2.6e-5, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append([2023, 3, 15, 10, 0, t0 + i,
                    lo + rng.normal(0, 1e-10), 0.1, 30.0 + rng.normal(0, 2),
                    lo + 1e-6, 0.2, 31.0,
                    re + rng.normal(0, 1e-10), 0.3, 29.0])
    return np.asarray(out, dtype=float)


def _loopback_with_jump(first=False):
    s = 100.0 + np.random.default_rng(9).normal(0, 0.1, 200)
    s[0 if first else 120:] += 5.0
    return s


def _fold_input():
    r = np.zeros(100)
    r[50], r[60] = 30.0, -30.0
    return r


TWOWAY_CASES = {
    "gate_epochs": lambda m: m.gate_epochs(_xval()),
    "gate_epochs_empty": lambda m: m.gate_epochs(np.zeros(20, complex)),
    "trim_sample_loss": lambda m: m.trim_sample_loss(_loopback_with_jump()),
    "trim_sample_loss_first_step": lambda m: m.trim_sample_loss(
        _loopback_with_jump(first=True)),
    "snr_gate": lambda m: m.snr_gate(np.random.default_rng(1).normal(20, 6, 300)),
    # the r5 fix: both fold masks are taken before mutating
    "fold_sample_ambiguity": lambda m: m.fold_sample_ambiguity(_fold_input()),
    "twoway_residual": lambda m: m.twoway_residual(
        *(lambda s: (s["op_re"], s["op_lo"], s["lt_re"] + np.where(
            np.arange(400) == 7, 20.0, 0.0), s["lt_lo"]))(_series())),
    "sliding_mean": lambda m: m.sliding_mean(_series()["op_lo"], 25),
    "notch_dominant_line": lambda m: m.notch_dominant_line(
        _series()["op_lo"] + np.sin(2 * np.pi * 0.1 * np.arange(400))),
    "one_second_products": lambda m: m.one_second_products(
        60904.5, *(_series()[k] for k in ("op_lo", "op_re", "lt_lo", "lt_re"))),
    "solve_session": lambda m: m.solve_session(
        *(_series()[k] for k in ("op_lo", "op_re", "lt_lo", "lt_re")),
        1755400300.0),
    "carrier_phase_refine": lambda m: m.carrier_phase_refine(_xval()),
    "session_slope": lambda m: m.session_slope(_series()["op_re"], 25),
    "carrier_smooth_delays": lambda m: m.carrier_smooth_delays(
        _series()["op_lo"], _xval(), 70e6),
    "cn0_dbhz": lambda m: m.cn0_dbhz(np.full(50, 5e-4), np.full(50, 1e-5), FS),
    "ranging_detrend": lambda m: m.ranging_detrend(
        _series()["op_re"] * 1e-9, _series()["op_lo"] * 1e-9),
    "pair_rows_by_time": lambda m: m.pair_rows_by_time(
        _daily_rows(3, 50), _daily_rows(0, 40)),
    "pair_and_solve_daily": lambda m: m.pair_and_solve_daily(
        _daily_rows(3, 60, seed=1), _daily_rows(0, 60, seed=2)),
    # the r5 fix: an offset under the gate but past a table's rows
    "pair_and_solve_daily_no_overlap": lambda m: m.pair_and_solve_daily(
        _daily_rows(50, 5), _daily_rows(0, 10)),
    "pair_and_solve_daily_offset_too_large": lambda m: m.pair_and_solve_daily(
        _daily_rows(500, 5), _daily_rows(0, 10)),
    "gating_policy_for_signal": lambda m: [
        m.GatingPolicy.for_signal(sig, nint=n)
        for sig in (JSignal(), JSignal(fs=1e5, chip_rate=5e4, code_len=1000,
                                       bit_len=10, taps=9))
        for n in (1, 4)],
}

REFINED = {"carrier_phase_refine", "carrier_smooth_delays"}


@pytest.mark.parametrize("case", sorted(TWOWAY_CASES))
def test_twoway_matches_jax(case):
    got = TWOWAY_CASES[case](ttw)
    want = TWOWAY_CASES[case](jtw)
    _same(got, want, rtol=1e-12 if case in REFINED else 0.0)
    if case == "fold_sample_ambiguity":
        amb = ttw.GatingPolicy().ambiguity_ns
        assert got[50] == 30.0 - amb and got[60] == -30.0 + amb
    if case == "pair_and_solve_daily_no_overlap":
        assert got["ok"] is False


# ---------------------------------------------------------------------------
# go1s and campaign


def _archive(path, delay_ns, xval):
    delay_samples = np.asarray(delay_ns) * FS / 1e9
    indice = np.floor(delay_samples)
    n = len(delay_samples)
    ch = dict(indice=indice, correction=(delay_samples - indice) * 3.0,
              snr_r=np.full(n, 5e-4), snr_i=np.full(n, 1e-5),
              df=np.full(n, 100.0), puissance=np.full(n, 1.0), xval=xval)
    raw = path[:-3]
    jmat.save_claudio_style(raw, ch)
    with open(raw, "rb") as f:
        data = f.read()
    with gzip.open(path, "wb") as f:
        f.write(data)
    os.remove(raw)


def _session_dirs(root, phase):
    """tests/test_go1s.py's session fixtures: flat delays with random
    peak phases, or delays whose peak phases encode them at 70 MHz."""
    rng = np.random.default_rng(5 if phase else 3)
    op, lt = root / "OP", root / "LTFB"
    op.mkdir()
    lt.mkdir()
    t = np.arange(N_CODES) / 25.0
    wander = 0.15 * np.sin(2 * np.pi * 0.25 * t) if phase else 0.0
    truth = {"op_lo": 100.0 + wander, "lt_lo": 80.0 + wander}
    truth["op_re"] = truth["op_lo"] + 250.0 + TRUE_OFFSET_NS
    truth["lt_re"] = truth["lt_lo"] + 250.0 - TRUE_OFFSET_NS
    names = {"op_lo": op / "localclaudio1755400003_2.mat.gz",
             "op_re": op / "remoteclaudio1755400003_1.mat.gz",
             "lt_lo": lt / "localclaudio1755400007_2.mat.gz",
             "lt_re": lt / "remoteclaudio1755400007_1.mat.gz"}
    for key, tau in truth.items():
        amp = np.full(N_CODES, 1000.0)
        amp[:5] = 10.0
        amp[-3:] = 10.0
        if phase:
            phi = -70e6 * tau * 1e-9 + rng.normal(0, 2e-4, N_CODES)
            code_ns = tau + rng.normal(0, 0.08, N_CODES)
        else:
            phi = rng.uniform(0, 1, N_CODES)
            code_ns = tau + rng.normal(0, 0.02, N_CODES)
        _archive(str(names[key]), code_ns, amp * np.exp(2j * np.pi * phi))
    return str(op), str(lt)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _values(path):
    return np.loadtxt(path, comments="#")


def _compare_go1s_outputs(tdir, jdir, tres, jres):
    assert len(tres) == len(jres) >= 1
    strip = lambda rs: [{k: v for k, v in r.items()  # noqa: E731
                         if k not in ("files", "one_s_path", "summary_path")}
                        for r in rs]
    _same(strip(tres), strip(jres), rtol=1e-9)
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names
    for name in names:
        if name.endswith(".1sc"):
            np.testing.assert_allclose(_values(os.path.join(tdir, name)),
                                       _values(os.path.join(jdir, name)),
                                       rtol=0, atol=1e-6)
        elif name == jgo.SUMMARY_NAME:
            _same(tgo.read_summary(os.path.join(tdir, name)),
                  jgo.read_summary(os.path.join(jdir, name)), rtol=1e-9)
        else:
            assert _read(os.path.join(tdir, name)) == \
                _read(os.path.join(jdir, name)), name


@pytest.mark.parametrize("phase", [False, True])
def test_go1s_process_sessions_matches_jax(phase, tmp_path):
    op, lt = _session_dirs(tmp_path, phase)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    kw = dict(fs=FS, policy=jtw.GatingPolicy(codes_per_second=25))
    jres = jgo.process_sessions(op, lt, str(tmp_path / "j"), **kw)
    tres = tgo.process_sessions(op, lt, str(tmp_path / "t"), fs=FS,
                                policy=ttw.GatingPolicy(codes_per_second=25))
    _compare_go1s_outputs(str(tmp_path / "t"), str(tmp_path / "j"), tres, jres)
    one_s = [n for n in os.listdir(tmp_path / "t") if n.endswith(".1s")]
    head = _read(str(tmp_path / "t" / one_s[0])).split(b"\n")[0]
    assert head == b"# MJD\t\tOPlocal\tOPremote\tLTFBlocal\tLTBBremote"
    # resume: the session's .1s exists
    assert tgo.process_sessions(op, lt, str(tmp_path / "t"), fs=FS,
                                policy=ttw.GatingPolicy(codes_per_second=25)) == []


GO1S_CASES = {
    "find_sessions": lambda m, op, lt: [dataclasses.asdict(s)
                                        for s in m.find_sessions(op, lt)],
    "site_delays": lambda m, op, lt: m.site_delays(
        m.find_sessions(op, lt)[0].op_lo, m.find_sessions(op, lt)[0].op_re, FS,
        return_xval=True),
    "site_delays_tail_rule": lambda m, op, lt: m.site_delays(
        m.find_sessions(op, lt)[0].lt_lo, m.find_sessions(op, lt)[0].lt_re, FS,
        tail_rule=True),
    "go1s_mjd": lambda m, op, lt: [m.go1s_mjd(t) for t in (1755400000,
                                                           1755407200.5)],
    "mjd_name": lambda m, op, lt: [m._mjd_name(x) for x in (
        60904.045710648, 60904.129043981, 60904.5, 60904.50002)],
}


@pytest.mark.parametrize("case", sorted(GO1S_CASES))
def test_go1s_helpers_match_jax(case, tmp_path):
    op, lt = _session_dirs(tmp_path, False)
    _same(GO1S_CASES[case](tgo, op, lt), GO1S_CASES[case](jgo, op, lt))


def _summary_rows():
    rows = []
    for i, (mjd, res25) in enumerate(
        [(60900.0, 3.0), (60910.0, 3.2), (60930.0, 2.8), (60935.0, 0.0),
         (60940.0, 41.0)]
    ):
        rows.append(dict(
            mjd=mjd, res_mean_ns=res25, res_std_ns=0.3,
            res25_mean_ns=res25, res25_std_ns=0.05,
            filtered_std_ns=0.04, n_flagged=0,
            snr_op_db=50.0 + i, snr_lt_db=48.0 - i, n_codes=7000,
            res_refined_mean_ns=res25 - 0.01,
            res25_refined_std_ns=0.005,
        ))
    return rows


@pytest.mark.parametrize("fold", [True, False])
def test_campaign_series_and_writers_match_jax(fold, tmp_path):
    corr = tmp_path / "steps.json"
    corr.write_text(json.dumps([[60904.0, 1.5],
                                {"mjd_after": 60926.5, "offset_ns": -4.21}]))
    txt = tmp_path / "steps.txt"
    txt.write_text("# steps\n60904 1.5\n60926.5 -4.21\n")
    for path in (corr, txt):
        _same(tcamp.load_corrections(str(path)),
              jcamp.load_corrections(str(path)))
    tsteps = tcamp.load_corrections(str(corr))
    jsteps = jcamp.load_corrections(str(corr))
    tser = tcamp.campaign_series(_summary_rows(), nint=1, corrections=tsteps,
                                 fold=fold)
    jser = jcamp.campaign_series(_summary_rows(), nint=1, corrections=jsteps,
                                 fold=fold)
    _same(tser, jser)
    x = np.array([5.0, 105.0, 12.0, -3.0])
    _same(tcamp.fold_half_window(x, 1), jcamp.fold_half_window(x, 1))
    _same(tcamp.apply_step_corrections(x * 0 + 60920, x, tsteps),
          jcamp.apply_step_corrections(x * 0 + 60920, x, jsteps))
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tp = tcamp.write_campaign_series(str(tmp_path / "t"), tser)
    jp = jcamp.write_campaign_series(str(tmp_path / "j"), jser)
    assert [os.path.basename(p) for p in tp] == [os.path.basename(p) for p in jp]
    for a, b in zip(tp, jp):
        assert _read(a) == _read(b)


# ---------------------------------------------------------------------------
# the verbs


def _verb_run(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


@pytest.mark.parametrize("verb", ["gofinal", "twoway", "go1s", "campaign"])
def test_verbs_match_jax(verb, tmp_path, capsys, gofinal_archives):
    outs = []
    for main, sub in ((jcli.main, "j"), (tcli.main, "t")):
        root = tmp_path / sub
        root.mkdir()
        if verb == "gofinal":
            lo, re = gofinal_archives
            argv = ["gofinal", lo, re, "-o", str(root / "rows.txt"), "--fs", "5e6"]
        elif verb == "twoway":
            for name, rows in (("op.txt", _daily_rows(3, 60, seed=1)),
                               ("lt.txt", _daily_rows(0, 60, seed=2))):
                with open(root / name, "w") as f:
                    f.write("% header\n")
                    for r in rows:
                        f.write(" ".join(repr(float(v)) for v in r) + "\n")
            argv = ["twoway", str(root / "op.txt"), str(root / "lt.txt")]
        elif verb == "go1s":
            op, lt = _session_dirs(root, True)
            (root / "out").mkdir()
            argv = ["go1s", op, lt, "-o", str(root / "out")]
        else:
            (root / "out").mkdir()
            for r in _summary_rows():
                jgo.append_summary(str(root / "out"), r)
            (root / "steps.txt").write_text("60904 1.5\n")
            argv = ["campaign", str(root / "out"), "--corrections",
                    str(root / "steps.txt"), "--plot", str(root / "c.png")]
        rc, out, err = _verb_run(main, argv, capsys)
        files = {}
        for d, _, fs in os.walk(root):
            for f in fs:
                if f.endswith((".txt", ".1s", ".tsv")) and "steps" not in f:
                    files[os.path.relpath(os.path.join(d, f), root)] = _read(
                        os.path.join(d, f))
        outs.append((rc, out.replace(str(root), "R"), files))
        if verb == "campaign":
            assert os.path.getsize(root / "c.png") > 5000
    (jrc, jout, jfiles), (trc, tout, tfiles) = outs
    assert trc == jrc == 0
    if verb == "go1s":
        # the printed rows hold floats computed through the refinement
        assert len(json.loads(tout.splitlines()[-1])) == 1
        _same(tgo.read_summary(str(tmp_path / "t" / "out" / tgo.SUMMARY_NAME)),
              jgo.read_summary(str(tmp_path / "j" / "out" / jgo.SUMMARY_NAME)),
              rtol=1e-9)
        tfiles.pop("out/" + tgo.SUMMARY_NAME)
        jfiles.pop("out/" + jgo.SUMMARY_NAME)
    else:
        assert tout == jout
    assert tfiles == jfiles and tfiles


def test_campaign_verb_without_summary(tmp_path, capsys):
    assert tcli.main(["campaign", str(tmp_path)]) == 1
    assert "no go1s_summary.txt rows" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# end to end: captures of both sites -> claudio -> go1s


SMALL = dict(fs=1e5, chip_rate=5e4, code_len=1000, bit_len=10)


@pytest.fixture(scope="module")
def two_site_captures(tmp_path_factory):
    """One session of four 3-s single-channel captures: each site's
    loopback carries its own code, its remote the other site's."""
    root = tmp_path_factory.mktemp("session")
    codes = {"OP": 9, "LTFB": 27}
    for site, taps in codes.items():
        write_prn_file(str(root / f"code_{site}.bin"), 10, 1000, taps)
    roles = {("OP", "_2"): (433.3, -150.0), ("OP", "_1"): (1210.8, -170.0),
             ("LTFB", "_2"): (91.25, 130.0), ("LTFB", "_1"): (777.6, 110.0)}
    caps = []
    for i, ((site, ch), (delay, dop)) in enumerate(sorted(roles.items())):
        (root / site).mkdir(exist_ok=True)
        own = site if ch == "_2" else ("LTFB" if site == "OP" else "OP")
        cfg = JSignal(**SMALL, taps=codes[own])
        (s,) = synthesize_capture(cfg, [ChannelSim(delay, dop, amplitude=1500,
                                                   noise_sigma=150)],
                                  n_seconds=3, seed=40 + i)
        ts = 1755400000 + (4 if site == "LTFB" else 0)
        cap = str(root / site / f"{ts}{ch}.bin")
        jio.write_sc16(cap, s)
        caps.append((site, ch, cap, str(root / f"code_{own}.bin"), delay))
    return root, caps


def test_end_to_end_claudio_to_go1s_matches_jax(two_site_captures, tmp_path):
    root, caps = two_site_captures
    policy_kw = dict(nint=1, codes_per_second=50)
    results = {}
    for pkg in ("j", "t"):
        for site in ("OP", "LTFB"):
            (tmp_path / pkg / site).mkdir(parents=True)
        for site, ch, cap, code, _ in caps:
            kw = dict(remote=ch == "_1", ranging=False,
                      out_dir=str(tmp_path / pkg / site),
                      df_window_hz=(-8e3, 8e3))
            if pkg == "j":
                out = jcl.process_file(cap, code, JSignal(**SMALL, taps=9),
                                       JProc(conjugate_data=True, block_seconds=0.5,
                                             skip_seconds=0.0),
                                       JStation(op=site == "OP"), **kw)
            else:
                out = tcl.process_file(cap, code, TSignal(**SMALL, taps=9),
                                       TProc(conjugate_data=True, block_seconds=0.5,
                                             skip_seconds=0.0),
                                       TStation(op=site == "OP"), device="cpu",
                                       **kw)
            assert out["found"] and out["moved"]
        out_dir = tmp_path / pkg / "out"
        out_dir.mkdir()
        mod, tw = (jgo, jtw) if pkg == "j" else (tgo, ttw)
        sig = (JSignal if pkg == "j" else TSignal)(**SMALL, taps=9)
        results[pkg] = mod.process_sessions(
            str(tmp_path / pkg / "OP"), str(tmp_path / pkg / "LTFB"),
            str(out_dir), fs=SMALL["fs"],
            policy=tw.GatingPolicy.for_signal(sig, **policy_kw))
    _compare_go1s_outputs(str(tmp_path / "t" / "out"), str(tmp_path / "j" / "out"),
                          results["t"], results["j"])
    # the folded truths: the re-seek parks each peak at 21 - frac(delay)
    fold = {(s, c): 21.0 - (d - round(d)) for s, c, _, _, d in caps}
    truth = 0.5 * ((fold["OP", "_1"] - fold["OP", "_2"])
                   - (fold["LTFB", "_1"] - fold["LTFB", "_2"])) / SMALL["fs"] * 1e9
    assert abs(results["t"][0]["res_mean_ns"] - truth) < 0.01 * 1e9 / SMALL["fs"]
