"""The port's claudio chain against the JAX package's, on the CPU at small
geometry (L = 2000, 0.5-s blocks, no hunt skip): the df search and
refresh estimators, ``claudio.process_file`` on both of its paths, the
batch runner and the ``claudio``/``batch`` verbs.

Inputs are made from a seed with NumPy (``models/emitter``) and fed to
both packages.  Tolerances:

| What | Against | Tolerance |
| --- | --- | --- |
| ``kbon``, ``n_above`` | JAX, every form | identical |
| refresh ``df``, bin | JAX, every form | equal float values, identical |
| complex128 path: ``indice``, ``df``, ``moved`` | JAX (CPU) | identical |
| complex128 path: ``correction`` | JAX (CPU) | 1e-9 sample |
| complex128 path: ``xval``, ``snr_*``, ``puissance`` | JAX (CPU) | 1e-9 relative |
| resident / f32 paths: ``indice``, ``df``, ``moved`` | JAX's same path | identical |
| resident / f32 paths: ``correction`` | JAX's same path | 1e-5 sample |
| resident path: ``moved``, df bin | JAX (CPU, complex128) | identical |
| resident path: delay ``indice + correction/3`` | JAX (CPU, complex128) | 1e-3 sample |

The resident path quantizes each block to int8; its largest delay
difference from the complex128 chain on these fixtures is 1.6e-4 sample
(measured on the CPU with this file's fixtures), so 1e-3 sample leaves a
6x margin.  JAX's resident and f32 paths run on the CPU by switching its
``boundary.on_accelerator`` on, as they run on an accelerator.
"""

import gzip
import importlib.util
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

from amaranth_twstft_tpu import cli as jcli
from amaranth_twstft_tpu import pipeline as jpipe
from amaranth_twstft_tpu.config import ProcessingConfig as JProc
from amaranth_twstft_tpu.config import SignalConfig as JSignal
from amaranth_twstft_tpu.config import StationConfig as JStation
from amaranth_twstft_tpu.models import claudio as jcl
from amaranth_twstft_tpu.models.emitter import ChannelSim, synthesize_capture
from amaranth_twstft_tpu.ops import boundary as jbound
from amaranth_twstft_tpu.ops import doppler as jdop
from amaranth_twstft_tpu.ops.lfsr import write_prn_file
from amaranth_twstft_tpu.ops.prn import chips_to_pm1, code_spectrum, upsample_zoh
from amaranth_twstft_tpu.utils import io as jio
from amaranth_twstft_tpu_torch import cli as tcli
from amaranth_twstft_tpu_torch import pipeline as tpipe
from amaranth_twstft_tpu_torch.config import ProcessingConfig as TProc
from amaranth_twstft_tpu_torch.config import SignalConfig as TSignal
from amaranth_twstft_tpu_torch.config import StationConfig as TStation
from amaranth_twstft_tpu_torch.models import claudio as tcl
from amaranth_twstft_tpu_torch.ops import doppler as tdop

SIG = dict(fs=1e5, chip_rate=5e4, code_len=1000, bit_len=10, taps=9)
PROC = dict(conjugate_data=True, block_seconds=0.5, skip_seconds=0.0,
            df_threshold=20.0)
RESIDENT_DELAY_TOL = 1e-3  # samples, resident int8 vs complex128
ACCEL_CORR_TOL = 1e-5  # samples, the port's float32 paths vs JAX's
L = 2000
BLOCK = 50_000


def _jtsig():
    return JSignal(**SIG), TSignal(**SIG)


@pytest.fixture(scope="module")
def code_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("code") / "code.bin")
    write_prn_file(path, SIG["bit_len"], SIG["code_len"], SIG["taps"])
    return path


def _capture(path, delay, doppler, noise, seed, n_seconds=2, drop=0):
    (s,) = synthesize_capture(
        JSignal(**SIG),
        [ChannelSim(delay_samples=delay, doppler_hz=doppler, amplitude=1500,
                    noise_sigma=noise)],
        n_seconds=n_seconds, seed=seed,
    )
    if drop:
        # a gross code slip: samples lost at 1.0 s
        cut = int(SIG["fs"])
        s = np.concatenate([s[:cut], s[cut + drop:]])
    jio.write_sc16(path, s)
    return path


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory, code_file):
    """The tracking fixture and the slip fixture of tests/test_claudio.py."""
    tmp = tmp_path_factory.mktemp("caps")
    return {
        "tracking": _capture(str(tmp / "1755400000_2.bin"), 333.0, 150.0, 150, 9),
        "slip": _capture(str(tmp / "1755400001_2.bin"), 20.0, 0.0, 100, 3,
                         drop=500),
    }


def _run_pair(cap, code, tmp_path, transfer="auto", jax_accel=False,
              monkeypatch=None):
    jsig, tsig = _jtsig()
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jdir.mkdir(exist_ok=True)
    tdir.mkdir(exist_ok=True)
    if jax_accel:
        monkeypatch.setattr(jbound, "on_accelerator", lambda: True)
    j = jcl.process_file(cap, code, jsig, JProc(**PROC), JStation(),
                         ranging=True, out_dir=str(jdir), transfer=transfer)
    if jax_accel:
        monkeypatch.undo()
    t = tcl.process_file(cap, code, tsig, TProc(**PROC), TStation(),
                         ranging=True, out_dir=str(tdir), device="cpu",
                         transfer=transfer)
    return j, t


# ---------------------------------------------------------------------------
# the df search and refresh estimators


def _block(kind, seed=5):
    """A 0.5-s block, its first code period minus its mean, and the
    claudio replica spectrum (unconjugated)."""
    rng = np.random.default_rng(seed)
    cfg = JSignal(**SIG)
    code = chips_to_pm1(upsample_zoh(
        np.asarray(np.random.default_rng(1).integers(0, 2, SIG["code_len"]),
                   np.uint8), 2))
    t = np.arange(BLOCK)
    noise = rng.normal(0, 150, BLOCK) + 1j * rng.normal(0, 150, BLOCK)
    if kind == "line":
        sig = 1500 * np.tile(np.roll(code, 333), BLOCK // L) * np.exp(
            2j * np.pi * 150.0 * t / cfg.fs)
    elif kind == "other_code":
        # a squaring line that the trial correlation rejects: BPSK of
        # another code
        other = np.random.default_rng(2).choice([-1.0, 1.0], L)
        sig = 1500 * np.tile(other, BLOCK // L) * np.exp(
            2j * np.pi * 220.0 * t / cfg.fs)
    else:
        sig = 0
    d = np.round(sig + noise)
    dcode = d[:L] - d[:L].mean()
    return d, dcode, code_spectrum(code, conj=False)


# (kind, search window on the doubled axis)
SEARCH_CASES = {
    "line": ("line", (-8e3, 8e3)),
    "no_line": ("noise", (-8e3, 8e3)),
    "line_fails_snr": ("other_code", (-8e3, 8e3)),
    # an even count of masked bins: the median averages the middle two
    "even_mask": ("line", (-4e3, 4e3)),
}


@pytest.mark.parametrize("form", ["complex128", "ri_float32", "ri_int8"])
@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
def test_search_df_matches_jax(case, form):
    kind, (lo, hi) = SEARCH_CASES[case]
    d, dcode, fcode = _block(kind)
    fs = SIG["fs"]
    mask = jdop.window_mask(BLOCK, fs, lo, hi)
    if case == "even_mask":
        assert mask.sum() % 2 == 0
    if form == "complex128":
        want = jdop.search_df_candidates(jnp.asarray(d), jnp.asarray(dcode),
                                         jnp.asarray(fcode), fs, mask)
        got = tdop.search_df_candidates(torch.from_numpy(d), torch.from_numpy(dcode),
                                        torch.from_numpy(fcode), fs, mask)
    else:
        ri = jbound.pack_complex(d)
        if form == "ri_int8":
            ri = np.clip(np.round(ri / (np.abs(ri).max() / 127)), -127, 127
                         ).astype(np.int8)
        dc, fc = jbound.pack_complex(dcode), jbound.pack_complex(fcode)
        want = tuple(int(x) for x in jdop.search_df_candidates_ri(
            jnp.asarray(ri), jnp.asarray(dc), jnp.asarray(fc), fs,
            jnp.asarray(mask)))
        got = tuple(int(x) for x in tdop.search_df_candidates_ri(
            torch.from_numpy(ri), torch.from_numpy(dc), torch.from_numpy(fc), fs,
            torch.from_numpy(mask)))
    assert got == want
    kbon, n_above = got
    if case in ("line", "even_mask"):
        assert kbon >= 0 and n_above < 32  # fewer than 32 bins pass
    else:
        assert kbon == -1
    if case == "line_fails_snr":
        assert n_above >= 1


@pytest.mark.parametrize("form", ["complex128", "ri_int8"])
@pytest.mark.parametrize("where", ["first", "second", "middle", "last_but_one",
                                   "last"])
def test_refresh_df_matches_jax(where, form):
    """kbon near both spectrum edges: the window start is clipped and the
    absolute index rebuilt from the clipped start."""
    kbon = {"first": 0, "second": 1, "middle": BLOCK // 2 + 6,
            "last_but_one": BLOCK - 2, "last": BLOCK - 1}[where]
    d, _, _ = _block("line")
    fs = SIG["fs"]
    if form == "complex128":
        wdf, widx = jdop.refresh_df(jnp.asarray(d), fs, kbon)
        gdf, gidx = tdop.refresh_df(torch.from_numpy(d), fs, kbon)
        assert gdf.dtype == torch.float64
    else:
        ri = jbound.pack_complex(d)
        q = np.clip(np.round(ri / (np.abs(ri).max() / 127)), -127, 127).astype(np.int8)
        wdf, widx = jdop.refresh_df_ri(jnp.asarray(q), fs, kbon)
        gdf, gidx = tdop.refresh_df_ri(torch.from_numpy(q), fs, kbon)
        assert gdf.dtype == torch.float32
    assert int(gidx) == int(widx)
    assert float(gdf) == float(wdf)
    lo = min(max(kbon - 3, 0), BLOCK - 7)
    assert lo <= int(gidx) < lo + 7


def _leakage_tool():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "tools", "claudio_hunt_leakage.py")
    spec = importlib.util.spec_from_file_location("claudio_hunt_leakage", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("amp", [1000.0, 110.0])
def test_production_hunt_matches_jax(amp):
    """One production 2-s block (10^7 bins; ``tools/claudio_hunt_leakage.py``
    trial 0, seed 0) with its line between FFT bins, through the resident
    hunt's inputs: the JAX package's and the port's search and refresh
    give the same ``kbon``, ``n_above``, df and bin.  At amplitude 1000 (a
    loopback) the line's leakage passes the gate and both land the hunt
    about 16 bins above the line, the reference's own behaviour; at 110 (a
    remote signal) within one bin."""
    tool = _leakage_tool()
    code = tool.code_samples()
    raw, df = tool.trial_block(code, amp, 0, 0)
    q8, dc = tool.hunt_inputs(raw)
    np.testing.assert_array_equal(q8, jcl._quantize_q8(raw)[0])
    fc = jbound.pack_complex(np.fft.fft(code))
    mask = jdop.window_mask(tool.BLOCK, tool.FS, *tool.MASK_HZ)
    jk, jn = (int(v) for v in jdop.search_df_candidates_ri(
        jnp.asarray(q8), jnp.asarray(dc), jnp.asarray(fc), tool.FS, jnp.asarray(mask)))
    jdf, jidx = jdop.refresh_df_ri(jnp.asarray(q8), tool.FS, jk)
    tk, tn = (int(v) for v in tdop.search_df_candidates_ri(
        torch.from_numpy(q8), torch.from_numpy(dc), torch.from_numpy(fc), tool.FS,
        torch.from_numpy(mask)))
    tdf, tidx = tdop.refresh_df_ri(torch.from_numpy(q8), tool.FS, tk)
    assert (tk, tn) == (jk, jn)
    assert (float(tdf), int(tidx)) == (float(jdf), int(jidx))
    off = tool.bins_from_line(jk, df)
    if amp == 1000.0:
        assert jn > 100 and off > 10
    else:
        assert abs(off) < 1 and abs(float(jdf) - df) < 0.5


def test_search_refuses_quantile_overflow():
    """Above ``torch.nanquantile``'s 2^24 elements the search is no longer
    refused: it takes the median by a sort and gives the JAX package's
    ``(kbon, n_above)`` (none found on an all-zero block)."""
    n = tdop.QUANTILE_MAX_ELEMENTS + 1
    d = torch.zeros(n, dtype=torch.complex64)
    mask = np.ones(n, bool)
    got = tdop.search_df_candidates(d, d[:L], d[:L], 1e5, mask)
    dj = jnp.zeros(n, jnp.complex64)
    want = jdop.search_df_candidates(dj, dj[:L], dj[:L], 1e5, jnp.asarray(mask))
    assert got == tuple(int(v) for v in want) == (-1, 0)


# ---------------------------------------------------------------------------
# process_file


def _close_results(got, want, corr_tol, rel_tol):
    np.testing.assert_array_equal(got["indice"], want["indice"])
    np.testing.assert_array_equal(got["df"], want["df"])
    assert got["moved"] == want["moved"]
    np.testing.assert_allclose(got["correction"], want["correction"], rtol=0,
                               atol=corr_tol)
    for f in ("xval", "snr_r", "snr_i"):
        np.testing.assert_allclose(got[f], want[f], rtol=rel_tol, err_msg=f)


@pytest.mark.parametrize("name", ["tracking", "slip"])
def test_process_file_complex128_matches_jax(name, fixtures, code_file, tmp_path):
    j, t = _run_pair(fixtures[name], code_file, tmp_path)
    assert t["found"] and j["found"]
    _close_results(t, j, 1e-9, 1e-9)
    assert t["carry_trimmed"] == []
    # the .mat archives field for field
    mj = sio.loadmat(j["mat_path"])
    mt = sio.loadmat(t["mat_path"])
    keys = {k for k in mj if not k.startswith("__")}
    assert keys == {k for k in mt if not k.startswith("__")}
    assert "carry_trimmed" not in keys
    for k in sorted(keys):
        assert mt[k].shape == mj[k].shape, k
        if k in ("indice1", "df", "moved", "code"):
            np.testing.assert_array_equal(mt[k], mj[k], err_msg=k)
        elif k == "correction1":
            np.testing.assert_allclose(mt[k], mj[k], rtol=0, atol=1e-9)
        else:
            np.testing.assert_allclose(mt[k], mj[k], rtol=1e-9, err_msg=k)
    # the initial re-seek, and the slip on the slip fixture
    assert len(t["moved"]) >= (1 if name == "tracking" else 2)


@pytest.mark.parametrize("transfer", ["int8", "f32"])
@pytest.mark.parametrize("name", ["tracking", "slip"])
def test_float32_paths_match_jax_accelerator_paths(name, transfer, fixtures,
                                                   code_file, tmp_path,
                                                   monkeypatch):
    """The resident int8 path and the f32 per-call path against the JAX
    package's same paths (run on the CPU as on an accelerator)."""
    j, t = _run_pair(fixtures[name], code_file, tmp_path, transfer=transfer,
                     jax_accel=True, monkeypatch=monkeypatch)
    assert t["df"].dtype == np.float64 and t["df"][0] == np.float32(t["df"][0])
    _close_results(t, j, ACCEL_CORR_TOL, 1e-4)


def _df_bin(df):
    step = SIG["fs"] / (BLOCK - 1)
    return np.round((2.0 * np.asarray(df) + SIG["fs"] / 2) / step).astype(int)


@pytest.mark.parametrize("name", ["tracking", "slip"])
def test_resident_path_matches_jax_cpu(name, fixtures, code_file, tmp_path):
    """The port's resident int8 path on the CPU against the JAX package's
    CPU (complex128) result."""
    jsig, tsig = _jtsig()
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    j = jcl.process_file(fixtures[name], code_file, jsig, JProc(**PROC),
                         JStation(), out_dir=str(tmp_path / "j"))
    t = tcl.process_file(fixtures[name], code_file, tsig, TProc(**PROC),
                         TStation(), out_dir=str(tmp_path / "t"),
                         device="cpu", transfer="int8")
    assert t["moved"] == j["moved"]
    np.testing.assert_array_equal(_df_bin(t["df"]), _df_bin(j["df"]))
    dt = t["indice"] + t["correction"] / 3.0
    dj = j["indice"] + j["correction"] / 3.0
    assert np.abs(dt - dj).max() < RESIDENT_DELAY_TOL
    assert t["timing"]["block_step_ms"] and t["timing"]["cache_hit"] is not None


def test_resume_returns_none(fixtures, code_file, tmp_path):
    _, tsig = _jtsig()
    kw = dict(out_dir=str(tmp_path), device="cpu")
    out = tcl.process_file(fixtures["tracking"], code_file, tsig, TProc(**PROC),
                           TStation(), **kw)
    assert out is not None
    assert tcl.process_file(fixtures["tracking"], code_file, tsig,
                            TProc(**PROC), TStation(), **kw) is None
    with open(out["mat_path"], "rb") as f:
        data = f.read()
    os.remove(out["mat_path"])
    with gzip.open(out["mat_path"] + ".gz", "wb") as f:
        f.write(data)
    assert tcl.process_file(fixtures["tracking"], code_file, tsig,
                            TProc(**PROC), TStation(), **kw) is None


@pytest.mark.parametrize("op", [False, True])
@pytest.mark.parametrize("role", ["ranging", "local", "remote"])
def test_output_name_and_df_window(role, op):
    remote, ranging = role == "remote", role == "ranging"
    name = "/data/1755400000_2.bin"
    assert tcl.output_name(name, remote, ranging) == jcl.output_name(
        name, remote, ranging)
    assert tcl.claudio_df_window(TStation(op=op), ranging) == \
        jcl.claudio_df_window(JStation(op=op), ranging)


def test_resident_cache_key(fixtures, code_file, tmp_path):
    """Files with the same code share the bound steps; nint, the replica
    dtype and the device are part of the key (interp_factor = 2*nint+1,
    so nint covers it)."""
    _, tsig = _jtsig()
    tcl._RESIDENT_CACHE.clear()
    hits = []
    for i, (nint, dtype) in enumerate([(1, torch.complex128), (1, torch.complex128),
                                       (2, torch.complex128), (1, torch.complex64)]):
        (tmp_path / str(i)).mkdir()
        out = tcl.process_file(
            fixtures["tracking"], code_file, tsig, TProc(**PROC, nint=nint),
            TStation(), out_dir=str(tmp_path / str(i)), device="cpu",
            transfer="int8", dtype=dtype)
        hits.append(out["timing"]["cache_hit"])
    assert hits == [False, True, False, False]
    assert len(tcl._RESIDENT_CACHE) == 3
    for k in range(1, 5):
        assert TProc(nint=k).interp_factor == 2 * k + 1
    keys = list(tcl._RESIDENT_CACHE)
    assert {k[3] for k in keys} == {1, 2}  # nint
    assert {k[6] for k in keys} == {"complex128", "complex64"}
    assert {k[7] for k in keys} == {"cpu"}


def test_carry_trim_goes_to_its_own_field(fixtures, code_file, tmp_path):
    """A piled-up carry is trimmed into ``carry_trimmed`` (result and
    .mat), never into ``moved``.  The carry limit is lowered to force the
    trim on the slip fixture."""
    _, tsig = _jtsig()
    tcl._RESIDENT_CACHE.clear()
    cpu = torch.device("cpu")
    rep = tcl.build_replica(code_file, tsig, TProc(**PROC), conjugate=False,
                            dtype=torch.complex128)
    res = tcl._Resident(rep, L, BLOCK, SIG["fs"], 1, cpu)
    res.carry = 10
    key = tcl._resident_key(code_file, L, BLOCK, TProc(**PROC), SIG["fs"], rep, cpu)
    tcl._RESIDENT_CACHE[key] = res
    try:
        out = tcl.process_file(fixtures["slip"], code_file, tsig, TProc(**PROC),
                               TStation(), out_dir=str(tmp_path), device="cpu",
                               transfer="int8")
    finally:
        tcl._RESIDENT_CACHE.clear()
    assert out["carry_trimmed"], out["moved"]
    assert all(m > 0 for m in out["moved"])
    md = sio.loadmat(out["mat_path"])
    np.testing.assert_array_equal(md["carry_trimmed"].ravel(), out["carry_trimmed"])
    np.testing.assert_array_equal(md["moved"].ravel(), out["moved"])


def test_transfer_is_checked(fixtures, code_file, tmp_path):
    _, tsig = _jtsig()
    with pytest.raises(ValueError, match="transfer"):
        tcl.process_file(fixtures["slip"], code_file, tsig, TProc(**PROC),
                         out_dir=str(tmp_path), device="cpu", transfer="f16")


@pytest.mark.parametrize("start, n", [(0, 2000), (49_000, 2000), (199_995, 10),
                                      (250_000, 10)])
def test_read_raw16_matches_jax(start, n, fixtures, tmp_path):
    """Frame ranges of a single-channel capture, including a short read at
    the end and one past it, against the JAX package's ``read_raw16``
    (memmap branch); with ``out`` the frames land in the given buffer."""
    from amaranth_twstft_tpu import native as jnative
    from amaranth_twstft_tpu_torch.utils import io as tio

    cap = fixtures["tracking"]
    want, wn = jnative.read_raw16(cap, start, n, channels=1)
    got, gn = tio.read_raw16(cap, start, n)
    assert gn == wn == {199_995: 5, 250_000: 0}.get(start, n)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    buf = np.full((n + 3, 2), -1, np.int16)
    into, _ = tio.read_raw16(cap, start, n, out=buf)
    assert gn == 0 or np.shares_memory(into, buf)
    np.testing.assert_array_equal(buf[:gn], want)
    assert (buf[gn:] == -1).all()


def test_gzip_archives_matches_jax(tmp_path):
    for sub in ("j", "t"):
        d = tmp_path / sub
        d.mkdir()
        for name in ("rangingclaudio1755400000_2.mat", "remoteclaudio1755400000_1.mat"):
            (d / name).write_bytes(b"MATLAB 5.0 " + name.encode())
        (d / "notes.txt").write_text("kept")
    want = jpipe.gzip_archives(str(tmp_path / "j"))
    got = tpipe.gzip_archives(str(tmp_path / "t"))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == 2
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    for g, w in zip(got, want):
        with gzip.open(g) as fg, gzip.open(w) as fw:
            assert fg.read() == fw.read()


# ---------------------------------------------------------------------------
# the batch runner and the verbs


@pytest.fixture(scope="module")
def batch_src(tmp_path_factory, code_file):
    tmp = tmp_path_factory.mktemp("batch")
    for i, (delay, dopp) in enumerate([(50.0, 100.0), (75.0, -150.0)]):
        _capture(str(tmp / f"175540000{i}_2.bin"), delay, dopp, 150, 30 + i,
                 n_seconds=1)
    # a remote-channel file the claudio pattern does not pick
    _capture(str(tmp / "1755400009_1.bin"), 10.0, 0.0, 150, 39, n_seconds=1)
    return tmp


def _archives(d):
    out = {}
    for f in sorted(os.listdir(d)):
        if f.endswith(".mat.gz"):
            with gzip.open(os.path.join(d, f)) as g:
                out[f] = {k: v for k, v in sio.loadmat(g).items()
                          if not k.startswith("__")}
    return out


def _same_archives(got, want):
    assert sorted(got) == sorted(want)
    for f in want:
        assert sorted(got[f]) == sorted(want[f])
        for k in want[f]:
            np.testing.assert_allclose(got[f][k], want[f][k], rtol=1e-9,
                                       atol=1e-9, err_msg=f"{f} {k}")


@pytest.mark.parametrize("how", ["process_directory", "batch_verb"])
def test_batch_matches_jax(how, batch_src, code_file, tmp_path, capsys):
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    shutil.copytree(batch_src, jdir)
    shutil.copytree(batch_src, tdir)
    jsig, tsig = _jtsig()
    if how == "process_directory":
        jr = jpipe.process_directory(str(jdir), code_file, jsig, JProc(**PROC),
                                     chain="claudio")
        tr = tpipe.process_directory(str(tdir), code_file, tsig, TProc(**PROC),
                                     chain="claudio", device="cpu")
        want = (jr.processed, jr.skipped, jr.failed)
        got = (tr.processed, tr.skipped, tr.failed)
        # idempotent second pass: nothing to do
        again = tpipe.process_directory(str(tdir), code_file, tsig,
                                        TProc(**PROC), chain="claudio", device="cpu")
        assert not again.processed and not again.failed
    else:
        sig_args = ["--fs", "1e5", "--chip-rate", "5e4", "--code-len", "1000",
                    "--bitlen", "10", "--taps", "9"]
        # the CLI's production ProcessingConfig skips 30 s: nothing locks
        # on these 1-s files, and both packages write empty archives
        assert jcli.main(["batch", str(jdir), code_file, *sig_args]) == 0
        want_out = capsys.readouterr().out
        assert tcli.main(["batch", str(tdir), code_file, *sig_args,
                          "--device", "cpu"]) == 0
        got_out = capsys.readouterr().out
        assert got_out.replace(str(tdir), "D") == want_out.replace(str(jdir), "D")
        want = got = ()
    if want:
        names = lambda xs: [os.path.basename(x) for x in xs]  # noqa: E731
        assert names(got[0]) == names(want[0]) and len(want[0]) == 2
        assert names(got[1]) == names(want[1]) and got[2] == want[2] == []
    _same_archives(_archives(tdir), _archives(jdir))
    assert sorted(os.listdir(tdir / "donetw")) == sorted(os.listdir(jdir / "donetw"))
    assert len(os.listdir(tdir / "donetw")) == 2


@pytest.mark.parametrize("role", [[], ["--local"], ["--remote", "--op"]])
def test_claudio_verb_matches_jax(role, fixtures, code_file, tmp_path, capsys):
    sig_args = ["--fs", "1e5", "--chip-rate", "5e4", "--code-len", "1000",
                "--bitlen", "10", "--taps", "9"]
    outs = []
    for main, extra, sub in ((jcli.main, [], "j"), (tcli.main, ["--device", "cpu"], "t")):
        d = tmp_path / sub
        d.mkdir()
        cap = str(d / os.path.basename(fixtures["tracking"]))
        shutil.copy(fixtures["tracking"], cap)
        assert main(["claudio", cap, code_file, *sig_args, *role, *extra]) == 0
        path = capsys.readouterr().out.strip()
        assert os.path.dirname(path) == str(d)
        outs.append({k: v for k, v in sio.loadmat(path).items()
                     if not k.startswith("__")})
        # a second run finds the archive and does nothing
        assert main(["claudio", cap, code_file, *sig_args, *role, *extra]) == 0
        assert "already done" in capsys.readouterr().err
    assert sorted(outs[0]) == sorted(outs[1])
    for k in outs[0]:
        np.testing.assert_array_equal(outs[1][k], outs[0][k])


@pytest.mark.parametrize("verb", ["claudio", "batch"])
def test_verbs_need_a_card_without_device_cpu(verb, fixtures, code_file,
                                              tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    target = fixtures["slip"] if verb == "claudio" else str(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main([verb, target, code_file])
