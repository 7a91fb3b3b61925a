"""The port's ``ranging`` step with the fine frequency, the directory batch
runner's options, ``gzip_archives``' pattern and claudio's slip-pass bound,
against the JAX package on the CPU at small geometry (L = 2000).

Inputs are made from a seed with NumPy (``models/emitter``) and fed to
both packages.  Tolerances:

| What | Against | Tolerance |
| --- | --- | --- |
| the bound step, ``fine_freq=True``: ``indice`` | JAX's step | identical |
| 〃 delay ``(indice + correction) / (2 nint + 1)`` | 〃 | 1e-4 sample |
| 〃 per-epoch ``df`` | 〃 | 1e-2 Hz |
| 〃 SNR | 〃 | 1e-3 dB |
| ``process_directory``: reports, files left, ``donetw/`` | JAX | identical |
| 〃 archives (complex128 chains) | JAX | 1e-9 relative and absolute |
| ``gzip_archives``: names and bytes | JAX | identical |
| claudio ``max_slip_passes``: ``indice``, ``df``, ``moved`` | JAX | identical |
| 〃 complex128 path: ``correction``; ``xval``, ``snr_*`` | JAX (CPU) | 1e-9 sample; 1e-9 relative |
| 〃 resident int8 path: ``correction``; ``xval``, ``snr_*`` | JAX's same path | 1e-5 sample; 1e-4 relative |

The step's tolerances are those of ``tests/test_torch_live.py``'s bound-step
test; the claudio ones those of ``tests/test_torch_claudio.py``.
"""

import gzip
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

from amaranth_twstft_tpu import pipeline as jpipe
from amaranth_twstft_tpu.config import ProcessingConfig as JProc
from amaranth_twstft_tpu.config import SignalConfig as JSignal
from amaranth_twstft_tpu.config import StationConfig as JStation
from amaranth_twstft_tpu.models import claudio as jcl
from amaranth_twstft_tpu.models.emitter import ChannelSim, synthesize_capture
from amaranth_twstft_tpu.models.godual import build_replica as jbuild
from amaranth_twstft_tpu.ops import boundary as jb
from amaranth_twstft_tpu.ops import doppler as jdop
from amaranth_twstft_tpu.utils import io as jio
from amaranth_twstft_tpu_torch import pipeline as tpipe
from amaranth_twstft_tpu_torch.config import ProcessingConfig as TProc
from amaranth_twstft_tpu_torch.config import SignalConfig as TSignal
from amaranth_twstft_tpu_torch.config import StationConfig as TStation
from amaranth_twstft_tpu_torch.models import claudio as tcl
from amaranth_twstft_tpu_torch.models.godual import build_replica as tbuild
from amaranth_twstft_tpu_torch.ops import boundary as tb
from amaranth_twstft_tpu_torch.ops.lfsr import write_prn_file
from amaranth_twstft_tpu_torch.utils import io as tio

SIG = dict(fs=1e5, chip_rate=5e4, code_len=1000, bit_len=10, taps=9)
# claudio at small geometry: 0.5-s blocks and no hunt skip
CLAUDIO = dict(conjugate_data=True, block_seconds=0.5, skip_seconds=0.0,
               df_threshold=20.0)
L = 2000


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    """A code file; a dual-channel directory (one ``1*.bin`` capture of
    1 s and a ``2*.bin`` one the default pattern does not pick); a
    single-channel directory (two ``*_2.bin`` captures and one
    ``*_1.bin``); and a 2-s single-channel capture with a gross code
    slip at 1.0 s."""
    cfg = JSignal(**SIG)
    tmp = tmp_path_factory.mktemp("batch_ranging")
    code = str(tmp / "code.bin")
    write_prn_file(code, cfg.bit_len, cfg.code_len, cfg.taps)
    dual = tmp / "dual"
    dual.mkdir()
    for name, seed in (("1755400000.bin", 5), ("2755400000.bin", 6)):
        meas, ref = synthesize_capture(
            cfg, [ChannelSim(431.4, 130.0, amplitude=900, noise_sigma=250),
                  ChannelSim(12.75, 5.0, amplitude=2000, noise_sigma=100)],
            n_seconds=1, seed=seed)
        jio.write_sc16(str(dual / name), meas, ref)
    single = tmp / "single"
    single.mkdir()
    for name, delay, dopp, seed in (("1755400000_2.bin", 50.0, 100.0, 30),
                                    ("1755400001_2.bin", 75.0, -150.0, 31),
                                    ("1755400009_1.bin", 10.0, 40.0, 39)):
        (s,) = synthesize_capture(
            cfg, [ChannelSim(delay_samples=delay, doppler_hz=dopp, amplitude=1500,
                             noise_sigma=150)], n_seconds=1, seed=seed)
        jio.write_sc16(str(single / name), s)
    (s,) = synthesize_capture(
        cfg, [ChannelSim(delay_samples=20.0, doppler_hz=0.0, amplitude=1500,
                         noise_sigma=100)], n_seconds=2, seed=3)
    cut = int(cfg.fs)  # 500 samples lost at 1.0 s
    slip = str(tmp / "1755400001_2.bin")
    jio.write_sc16(slip, np.concatenate([s[:cut], s[cut + 500:]]))
    return {"cfg": cfg, "tsig": TSignal(**SIG), "code": code, "dual": dual,
            "single": single, "slip": slip}


# ---------------------------------------------------------------------------
# the bound ranging step with the fine frequency (godual's card branch)


@pytest.mark.parametrize("fast,nint", [(True, 1), (False, 1), (True, 4)])
@pytest.mark.parametrize("channel", [0, 1])
def test_ranging_step_fine_freq_matches_jax(channel, fast, nint, src):
    """``make_ranging_step(mask, fine_freq=True)`` on complex epochs with
    the per-epoch masked df, against the JAX package's step
    (``mxu_fft=False``, the CPU's transforms) on ``pack_complex`` of the
    same epochs."""
    cfg, tsig = src["cfg"], src["tsig"]
    d, n = tio.read_sc16_epochs(str(src["dual"] / "1755400000.bin"), 0, 50, L)
    assert n == 50
    mask = jdop.window_mask(L, cfg.fs, -20e3, 20e3)
    rep_j = jbuild(src["code"], cfg, JProc(nint=nint))
    step_j = jb.make_ranging_step(np.asarray(rep_j.fcode), np.asarray(rep_j.code_interp),
                                  mask, cfg.fs, nint=nint, fast=fast, fine_freq=True,
                                  mxu_fft=False)
    rep_t = tbuild(src["code"], tsig, TProc(nint=nint))
    step_t = tb.make_ranging_step(rep_t.fcode, rep_t.code_interp, mask, tsig.fs,
                                  nint=nint, fast=fast, fine_freq=True, packed=False,
                                  device="cpu")
    oj = step_j(jnp.asarray(jb.pack_complex(d[channel])))
    ot = step_t(torch.from_numpy(d[channel]))
    r = 2 * nint + 1
    np.testing.assert_array_equal(ot.indice.numpy(), np.asarray(oj.indice))
    np.testing.assert_allclose(ot.delay_samples(r), oj.delay_samples(r), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ot.df.numpy(), np.asarray(oj.df), rtol=0, atol=1e-2)
    np.testing.assert_allclose(ot.snr_db(), oj.snr_db(), rtol=0, atol=1e-3)
    # the refinement ran: neither 130 Hz nor 5 Hz lies on the squaring
    # spectrum's 25-Hz df grid at this geometry, and the refined df does
    truth = (130.0, 5.0)[channel]
    assert np.median(np.abs(ot.df.numpy() - truth)) < 1.0


# ---------------------------------------------------------------------------
# process_directory's options and gzip_archives' pattern

CASES = {
    # the claudio chain on the remote-channel file its default glob skips
    "pattern": dict(chain="claudio", pattern="*_1.bin"),
    # the local channel (ranging=False goes to claudio only), its df window
    # given as a chain keyword: the production one lies above fs / 2 here
    "ranging_false": dict(chain="claudio", ranging=False,
                          kw=dict(df_window_hz=(-8e3, 8e3))),
    # neither gzipped nor moved, godual in complex128 with its own batch
    "no_gzip_no_move": dict(chain="godual", gzip_outputs=False, move_done=False,
                            kw=dict(dtype="complex128", batch_epochs=20)),
    # chain keywords to goranging and to claudio
    "goranging_keywords": dict(chain="goranging",
                               kw=dict(dtype="complex128", batch_epochs=20)),
    "claudio_keyword": dict(chain="claudio", kw=dict(max_slip_passes=1)),
}


def _archives(d):
    """Every archive in ``d`` (bare or gzipped), as its fields."""
    out = {}
    for f in sorted(os.listdir(d)):
        p = os.path.join(d, f)
        if f.endswith(".mat.gz"):
            with gzip.open(p) as g:
                m = sio.loadmat(g)
        elif f.endswith(".mat"):
            m = sio.loadmat(p)
        else:
            continue
        out[f] = {k: v for k, v in m.items() if not k.startswith("__")}
    return out


def _listing(d):
    return sorted(os.path.relpath(os.path.join(dp, f), d)
                  for dp, _, fs in os.walk(d) for f in fs)


@pytest.mark.parametrize("case", sorted(CASES))
def test_process_directory_options_match_jax(case, src, tmp_path):
    """Each new option of ``process_directory`` against the JAX package's:
    the same report, the same files left behind (gzipped or not, moved to
    ``donetw/`` or not) and the same archives."""
    c = dict(CASES[case])
    chain = c.pop("chain")
    kw = c.pop("kw", {})
    kw_j, kw_t = dict(kw), dict(kw)
    if "dtype" in kw:
        kw_j["dtype"] = getattr(jnp, kw["dtype"])
        kw_t["dtype"] = getattr(torch, kw["dtype"])
    root = src["single"] if chain == "claudio" else src["dual"]
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    shutil.copytree(root, jdir)
    shutil.copytree(root, tdir)
    jp = JProc(**CLAUDIO) if chain == "claudio" else JProc()
    tp = TProc(**CLAUDIO) if chain == "claudio" else TProc()
    jr = jpipe.process_directory(str(jdir), src["code"], src["cfg"], jp, JStation(),
                                 chain=chain, **c, **kw_j)
    tr = tpipe.process_directory(str(tdir), src["code"], src["tsig"], tp, TStation(),
                                 chain=chain, device="cpu", **c, **kw_t)
    names = lambda xs: [os.path.basename(x) for x in xs]  # noqa: E731
    assert names(tr.processed) == names(jr.processed) and tr.processed
    assert tr.skipped == jr.skipped == []
    assert tr.failed == jr.failed == []
    assert _listing(tdir) == _listing(jdir)
    if c.get("move_done", True):
        assert sorted(os.listdir(tdir / "donetw")) == names(tr.processed)
    else:
        assert not (tdir / "donetw").exists()
    got, want = _archives(tdir), _archives(jdir)
    assert sorted(got) == sorted(want) and len(got) == len(tr.processed)
    gz = c.get("gzip_outputs", True)
    assert all(f.endswith(".mat.gz") == gz for f in got)
    if chain == "claudio":
        prefix = "localclaudio" if c.get("ranging", True) is False else "rangingclaudio"
        assert all(f.startswith(prefix) for f in got)
    for f in want:
        assert sorted(got[f]) == sorted(want[f])
        for k in want[f]:
            np.testing.assert_allclose(got[f][k], want[f][k], rtol=1e-9, atol=1e-9,
                                       err_msg=f"{f} {k}")


@pytest.mark.parametrize("pattern", ["*.mat", "remote*.mat", "*.dat"])
def test_gzip_archives_pattern_matches_jax(pattern, tmp_path):
    for sub in ("j", "t"):
        d = tmp_path / sub
        d.mkdir()
        for name in ("rangingclaudio1755400000_2.mat", "remoteclaudio1755400000_1.mat",
                     "rxcomplex.dat"):
            (d / name).write_bytes(b"MATLAB 5.0 " + name.encode())
    want = jpipe.gzip_archives(str(tmp_path / "j"), pattern=pattern)
    got = tpipe.gzip_archives(str(tmp_path / "t"), pattern=pattern)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == {"*.mat": 2, "remote*.mat": 1, "*.dat": 1}[pattern]
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    for g, w in zip(got, want):
        with gzip.open(g) as fg, gzip.open(w) as fw:
            assert fg.read() == fw.read()


# ---------------------------------------------------------------------------
# claudio's slip-pass bound


@pytest.mark.parametrize("transfer", ["auto", "int8"])
@pytest.mark.parametrize("passes", [0, 1])
def test_claudio_max_slip_passes_matches_jax(passes, transfer, src, tmp_path,
                                             monkeypatch):
    """``max_slip_passes`` on a capture that slips, on the complex128 path
    (``auto`` on the CPU) and the resident int8 path, against the JAX
    package's same path.  The capture's one slip takes one pass: with none
    it stays unrepaired, with one the result is the default's (four)."""
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    (tmp_path / "d").mkdir()
    if transfer == "int8":
        # the JAX package's resident path runs where it thinks it is on
        # an accelerator
        monkeypatch.setattr(jb, "on_accelerator", lambda: True)
    j = jcl.process_file(src["slip"], src["code"], src["cfg"], JProc(**CLAUDIO),
                         JStation(), out_dir=str(tmp_path / "j"), transfer=transfer,
                         max_slip_passes=passes)
    monkeypatch.undo()
    kw = dict(out_dir=str(tmp_path / "t"), device="cpu", transfer=transfer)
    t = tcl.process_file(src["slip"], src["code"], src["tsig"], TProc(**CLAUDIO),
                         TStation(), max_slip_passes=passes, **kw)
    np.testing.assert_array_equal(t["indice"], j["indice"])
    np.testing.assert_array_equal(t["df"], j["df"])
    assert t["moved"] == j["moved"]
    corr_tol, rel_tol = (1e-9, 1e-9) if transfer == "auto" else (1e-5, 1e-4)
    np.testing.assert_allclose(t["correction"], j["correction"], rtol=0, atol=corr_tol)
    for f in ("xval", "snr_r", "snr_i"):
        np.testing.assert_allclose(t[f], j[f], rtol=rel_tol, err_msg=f)
    kw["out_dir"] = str(tmp_path / "d")
    default = tcl.process_file(src["slip"], src["code"], src["tsig"], TProc(**CLAUDIO),
                               TStation(), **kw)
    if passes == 0:
        assert len(t["moved"]) < len(default["moved"])
    else:
        assert t["moved"] == default["moved"]
        np.testing.assert_array_equal(t["indice"], default["indice"])
