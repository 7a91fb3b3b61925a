"""The port's GoRanging chain against the JAX package's, on the CPU at
small geometry (L = 2000): the sc16 readers, the PRN files and replica
helpers, the ``.mat`` writers and loader, ``godual.process_file``,
``goranging.process_file``, the overlapped pipeline and the CLI verbs.

Inputs are made from a seed with NumPy (``models/emitter``) and fed to
both packages.  Chain outputs are compared per epoch within:

| Field | complex64 | complex128 |
| --- | --- | --- |
| indice | identical | identical |
| correction | 1e-4 sample | 1e-9 sample |
| df | equal float32 values | equal float32 values |
| snr_r / snr_i | 1e-3 of snr_r + snr_i | 1e-3 of snr_r + snr_i |
| puissance* | 1e-5 relative | 1e-5 relative |
| xval* | 1e-4 of abs(xval) | 1e-4 of abs(xval) |

Readers, PRN files and ``.mat`` fields must be identical.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

from amaranth_twstft_tpu import pipeline as jpipe
from amaranth_twstft_tpu.config import ProcessingConfig as JProc
from amaranth_twstft_tpu.config import SignalConfig as JSignal
from amaranth_twstft_tpu.config import StationConfig as JStation
from amaranth_twstft_tpu.models import godual as jgod
from amaranth_twstft_tpu.models import goranging as jgor
from amaranth_twstft_tpu.models.emitter import ChannelSim, synthesize_capture
from amaranth_twstft_tpu.ops import lfsr as jlfsr
from amaranth_twstft_tpu.ops import prn as jprn
from amaranth_twstft_tpu.utils import io as jio
from amaranth_twstft_tpu.utils import matio as jmat
from amaranth_twstft_tpu_torch import cli as tcli
from amaranth_twstft_tpu_torch import pipeline as tpipe
from amaranth_twstft_tpu_torch.config import ProcessingConfig as TProc
from amaranth_twstft_tpu_torch.config import SignalConfig as TSignal
from amaranth_twstft_tpu_torch.config import StationConfig as TStation
from amaranth_twstft_tpu_torch.models import godual as tgod
from amaranth_twstft_tpu_torch.models import goranging as tgor
from amaranth_twstft_tpu_torch.ops import lfsr as tlfsr
from amaranth_twstft_tpu_torch.ops import prn as tprn
from amaranth_twstft_tpu_torch.utils import io as tio
from amaranth_twstft_tpu_torch.utils import matio as tmat

C64, C128 = np.complex64, np.complex128
CORR_TOL = {C64: 1e-4, C128: 1e-9}
SIG = dict(fs=1e5, chip_rate=5e4, code_len=1000, bit_len=10, taps=9)


def _tsig(cfg: JSignal) -> TSignal:
    return TSignal(fs=cfg.fs, chip_rate=cfg.chip_rate, code_len=cfg.code_len,
                   bit_len=cfg.bit_len, taps=cfg.taps)


def _close_chan(got: dict, ref: dict, cdtype=C64):
    np.testing.assert_array_equal(got["indice"], ref["indice"])
    np.testing.assert_allclose(got["correction"], ref["correction"], rtol=0,
                               atol=CORR_TOL[cdtype])
    assert np.asarray(got["df"]).dtype == np.asarray(ref["df"]).dtype
    np.testing.assert_array_equal(got["df"], ref["df"])
    snr = np.asarray(ref["snr_r"]) + np.asarray(ref["snr_i"])
    for f in ("snr_r", "snr_i"):
        assert np.all(np.abs(got[f] - ref[f]) <= 1e-3 * snr), f
    for f in ("puissance", "puissance_code", "puissance_noise"):
        np.testing.assert_allclose(got[f], ref[f], rtol=1e-5, err_msg=f)
    for f in ("xval", "xvalm1", "xvalp1"):
        assert np.all(np.abs(got[f] - ref[f]) <= 1e-4 * np.abs(ref[f])), f


def _close_out(got: dict, ref: dict, cdtype=C64):
    assert (got["ch2"] is None) == (ref["ch2"] is None)
    _close_chan(got["ch1"], ref["ch1"], cdtype)
    if ref["ch2"] is not None:
        _close_chan(got["ch2"], ref["ch2"], cdtype)
    if "df" in ref:
        assert got["df"] == ref["df"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 2 s dual-channel capture (100 epochs: ch1 431.4 samples / 130 Hz,
    ch2 12.75 samples / 5 Hz) and its code file."""
    cfg = JSignal(**SIG)
    tmp = tmp_path_factory.mktemp("goranging")
    code = str(tmp / "code.bin")
    tlfsr.write_prn_file(code, cfg.bit_len, cfg.code_len, cfg.taps)
    meas, ref = synthesize_capture(
        cfg,
        [ChannelSim(431.4, 130.0, amplitude=900, noise_sigma=250),
         ChannelSim(12.75, 5.0, amplitude=2000, noise_sigma=100)],
        n_seconds=2, seed=5,
    )
    cap = str(tmp / "1755400000.bin")
    jio.write_sc16(cap, meas, ref)
    return {"cfg": cfg, "code": code, "cap": cap, "tmp": tmp}


# ---------------------------------------------------------------- host code
def test_prn_files_and_replica_helpers_match(tmp_path):
    """PRN files byte for byte (BPSK and QPSK), the reader, the default
    name; hamming, code_spectrum and interp_code equal."""
    for taps_b in (None, 27):
        a, b = str(tmp_path / "a.bin"), str(tmp_path / "b.bin")
        tlfsr.write_prn_file(a, 10, 1000, 9, taps_b)
        jlfsr.write_prn_file(b, 10, 1000, 9, taps_b)
        assert open(a, "rb").read() == open(b, "rb").read()
        np.testing.assert_array_equal(tlfsr.read_prn_file(a, qpsk=taps_b is not None),
                                      jlfsr.read_prn_file(b, qpsk=taps_b is not None))
        assert tlfsr.prn_default_filename(17, 1000, 9, taps_b) == \
            jlfsr.prn_default_filename(17, 1000, 9, taps_b)
    code = tprn.chips_to_pm1(tprn.upsample_zoh(tlfsr.read_prn_file(a), 2))
    np.testing.assert_array_equal(tprn.hamming(2000), jprn.hamming(2000))
    for conj in (False, True):
        for ham in (False, True):
            np.testing.assert_array_equal(
                tprn.code_spectrum(code, conj=conj, hamming_window=ham),
                jprn.code_spectrum(code, conj=conj, hamming_window=ham))
    np.testing.assert_array_equal(tprn.interp_code(code, 3), jprn.interp_code(code, 3))


@pytest.mark.parametrize("native", ["0", "1"])
def test_readers_byte_identical(files, monkeypatch, native):
    """Every epoch reader of the port returns the JAX package's arrays
    (dtype, shape, bytes, count, scale), with the JAX package's native
    library on and off (``TWSTFT_Q8_NATIVE`` switches only the JAX
    reader; the port's always reads through its library), with and
    without ``out`` buffers, including a short tail and a start past the
    end."""
    monkeypatch.setenv("TWSTFT_Q8_NATIVE", native)
    cap, L = files["cap"], 2000
    for start, n_ep in ((0, 7), (3 * L + 11, 5), (97 * L, 10), (200 * L, 4)):
        for sel in (None, 0, 1):
            jq, jn, js = jio.read_sc16_epochs_q8(cap, start, n_ep, L, select=sel)
            tq, tn, ts = tio.read_sc16_epochs_q8(cap, start, n_ep, L, select=sel)
            assert (tn, ts) == (jn, js) and tq.dtype == jq.dtype
            np.testing.assert_array_equal(tq, jq)
            jr, jn = jio.read_sc16_epochs_raw16(cap, start, n_ep, L, select=sel)
            tr, tn = tio.read_sc16_epochs_raw16(cap, start, n_ep, L, select=sel)
            assert tn == jn and tr.dtype == jr.dtype and tr.shape == jr.shape
            np.testing.assert_array_equal(tr, jr)
            for dt in (np.float32, np.float16):
                jf, jn = jio.read_sc16_epochs_ri(cap, start, n_ep, L, dtype=dt, select=sel)
                tf, tn = tio.read_sc16_epochs_ri(cap, start, n_ep, L, dtype=dt, select=sel)
                assert tn == jn and tf.dtype == jf.dtype
                np.testing.assert_array_equal(tf, jf)
        for dt in (np.float32, np.float16):
            jp, jn = jio.read_sc16_epochs_packed(cap, start, n_ep, L, dtype=dt)
            tp, tn = tio.read_sc16_epochs_packed(cap, start, n_ep, L, dtype=dt)
            assert tn == jn and tp.dtype == jp.dtype
            np.testing.assert_array_equal(tp, jp)
        if jn:
            out = np.full((n_ep + 2, L, 4), 99, np.int16)
            tr, tn = tio.read_sc16_epochs_raw16(cap, start, n_ep, L, out=out)
            np.testing.assert_array_equal(out[:tn], jio.read_sc16_epochs_raw16(
                cap, start, n_ep, L)[0])
            out8 = np.zeros((n_ep, L, 4), np.int8)
            tio.read_sc16_epochs_q8(cap, start, n_ep, L, out=out8)
            np.testing.assert_array_equal(out8[:tn], jio.read_sc16_epochs_q8(
                cap, start, n_ep, L)[0])
    for m in (None, 5000):
        np.testing.assert_array_equal(tio.decimate_sc16(cap, 5, max_out=m),
                                      jio.decimate_sc16(cap, 5, max_out=m))
    np.testing.assert_array_equal(tio.decimate_sc16(cap, 7, dtype=C128),
                                  jio.decimate_sc16(cap, 7, dtype=C128))


def _chan(rng, n):
    c = lambda: rng.normal(size=n) + 1j * rng.normal(size=n)  # noqa: E731
    return {"indice": rng.integers(0, 6000, n).astype(np.int32),
            "correction": rng.uniform(-0.5, 0.5, n),
            "snr_r": rng.uniform(1, 9, n), "snr_i": rng.uniform(0, 1, n),
            "df": rng.normal(size=n), "puissance": rng.uniform(1, 2, n),
            "puissance_code": rng.uniform(1, 2, n),
            "puissance_noise": rng.uniform(1, 2, n),
            "xval": c(), "xvalm1": c(), "xvalp1": c()}


def test_mat_files_match_field_for_field(tmp_path):
    """Octave, C and claudio conventions: the same fields and values as
    the JAX package's files; ``load_result`` of ``.mat`` and ``.mat.gz``
    equal, and the solutions round-trip."""
    rng = np.random.default_rng(8)
    ch1, ch2 = _chan(rng, 17), _chan(rng, 17)
    code = np.where(rng.uniform(size=40) > 0.5, 1.0, -1.0)
    writers = [
        ("oct", lambda m, p: m.save_octave_style(p, ch1, ch2, code)),
        ("oct1", lambda m, p: m.save_octave_style(p, ch1, None)),
        ("c", lambda m, p: m.save_c_style(p, ch1, ch2)),
        ("c1", lambda m, p: m.save_c_style(p, ch1, None)),
        ("cl", lambda m, p: m.save_claudio_style(p, ch1, code, moved=[3, 9])),
    ]
    for name, write in writers:
        pt, pj = str(tmp_path / f"t_{name}.mat"), str(tmp_path / f"j_{name}.mat")
        write(tmat, pt)
        write(jmat, pj)
        mt, mj = sio.loadmat(pt), sio.loadmat(pj)
        keys = sorted(k for k in mj if not k.startswith("__"))
        assert sorted(k for k in mt if not k.startswith("__")) == keys
        for k in keys:
            assert mt[k].dtype == mj[k].dtype and mt[k].shape == mj[k].shape, k
            np.testing.assert_array_equal(mt[k], mj[k], err_msg=k)
        lt = tmat.load_result(pt)
        gz = tmat.gzip_file(pt)
        assert gz.endswith(".mat.gz") and not os.path.exists(pt)
        lg, lj = tmat.load_result(gz), jmat.load_result(pj)
        for k in lj:
            if k != "raw":
                np.testing.assert_array_equal(lt[k], lj[k], err_msg=k)
                np.testing.assert_array_equal(lg[k], lj[k], err_msg=k)
        if name in ("oct", "c"):
            np.testing.assert_allclose(lt["solution2"],
                                       ch2["indice"] + ch2["correction"])


# ------------------------------------------------------------------ chains
@pytest.mark.parametrize("cdtype", [C64, C128])
def test_goranging_process_file_matches_jax(files, cdtype):
    """``goranging.process_file`` on the CPU (fixed per-file df, full
    zoom-IFFT correlator, C-convention ``.mat``) in complex64 and
    complex128: the module's table, equal dfs, equal ``.mat`` indices."""
    cfg, tmp = files["cfg"], files["tmp"]
    kw = dict(batch_epochs=30)
    name = np.dtype(cdtype).name
    ref = jgor.process_file(files["cap"], files["code"], cfg,
                            JProc(hamming_window=True, df_decimation=5),
                            dtype=getattr(jnp, name),
                            out_mat=str(tmp / f"j_{name}.mat"), **kw)
    got = tgor.process_file(files["cap"], files["code"], _tsig(cfg),
                            TProc(df_decimation=5), dtype=getattr(torch, name),
                            out_mat=str(tmp / f"t_{name}.mat"), device="cpu", **kw)
    _close_out(got, ref, cdtype)
    assert len(got["ch1"]["indice"]) == 100
    mt, mj = sio.loadmat(got["mat_path"]), sio.loadmat(ref["mat_path"])
    assert sorted(mt) == sorted(mj)
    np.testing.assert_array_equal(np.floor(mt["correction1"] + 0.5),
                                  np.floor(mj["correction1"] + 0.5))
    assert tgor.default_mat_name("/x/1755.bin", True) == \
        jgor.default_mat_name("/x/1755.bin", True)


def test_godual_process_file_matches_jax(files):
    """``godual.process_file`` on the CPU, local (both channels, per-epoch
    df in +/-20 kHz) in complex64, with the fine-frequency refinement in
    complex128: the module's table; Octave-convention ``.mat``."""
    cfg, tmp = files["cfg"], files["tmp"]
    for cdtype, fine in ((C64, False), (C128, True)):
        name = np.dtype(cdtype).name
        ref = jgod.process_file(files["cap"], files["code"], cfg,
                                JProc(fine_freq=fine), JStation(op=True),
                                batch_epochs=40, dtype=getattr(jnp, name),
                                out_mat=str(tmp / f"jg_{name}.mat"))
        got = tgod.process_file(files["cap"], files["code"], _tsig(cfg),
                                TProc(fine_freq=fine), TStation(op=True),
                                batch_epochs=40, dtype=getattr(torch, name),
                                out_mat=str(tmp / f"tg_{name}.mat"), device="cpu")
        if fine:
            # the refined df is a least-squares slope: 1e-9 Hz, not bits
            for ch in ("ch1", "ch2"):
                np.testing.assert_allclose(got[ch]["df"], ref[ch]["df"],
                                           rtol=0, atol=1e-9)
                got[ch]["df"] = ref[ch]["df"]
        _close_out(got, ref, cdtype)
        mt, mj = sio.loadmat(got["mat_path"]), sio.loadmat(ref["mat_path"])
        np.testing.assert_array_equal(mt["indice1"], mj["indice1"])
        np.testing.assert_array_equal(mt["code"], mj["code"])


@pytest.mark.parametrize("op", [True, False])
def test_godual_remote_windows_match_jax(tmp_path, op):
    """Remote channel, OP window (-120, -80) kHz and LTFB window (80, 120)
    kHz on the doubled axis, at fs = 250 kS/s with the remote emission
    50 kHz off (sign by station): same epochs as the JAX package (the
    module's complex64 table) and the delay recovered."""
    cfg = JSignal(fs=2.5e5, chip_rate=1.25e5, code_len=1000, bit_len=10, taps=9)
    code = str(tmp_path / "code.bin")
    jlfsr.write_prn_file(code, 10, 1000, 9)
    meas, ref_ch = synthesize_capture(
        cfg, [ChannelSim(431.4, -50e3 if op else 50e3, amplitude=900, noise_sigma=250),
              ChannelSim(12.75, 5.0, amplitude=2000, noise_sigma=100)],
        n_seconds=1, seed=6)
    cap = str(tmp_path / "remote.bin")
    jio.write_sc16(cap, meas[: 20 * 2000], ref_ch[: 20 * 2000])
    ref = jgod.process_file(cap, code, cfg, JProc(), JStation(op=op), remote=True,
                            batch_epochs=8, dtype=jnp.complex64)
    got = tgod.process_file(cap, code, _tsig(cfg), TProc(), TStation(op=op),
                            remote=True, batch_epochs=8, dtype=torch.complex64,
                            out_mat=str(tmp_path / "t_remote.mat"), device="cpu")
    assert os.path.basename(ref["mat_path"]) == "remoteremote.mat"
    assert tgod.df_window(TStation(op=op), True) == jgod.df_window(JStation(op=op), True)
    _close_out(got, ref)
    assert abs(np.median(got["ch1"]["df"]) - (-50e3 if op else 50e3)) < 100
    d1 = (got["ch1"]["indice"] + got["ch1"]["correction"]) / 3
    assert np.all(np.abs(d1 - 431.4) < 0.1)


# (remote, ingest) pairs; batches of 30 over 100 epochs end in a partial 10
PIPE_CASES = [(False, "float32"), (False, "sc16"), (False, "int8"),
              (True, "float32"), (True, "sc16"), (True, "int8")]


@pytest.mark.parametrize("remote,ingest", PIPE_CASES)
def test_pipeline_matches_jax(files, remote, ingest):
    """``process_capture_overlapped`` on the CPU against the JAX package's
    (local and remote; float32, sc16 and int8 ingest; a final partial
    batch): the module's complex64 table, equal dfs and ``.mat`` fields
    within it, and the ``timing`` keys."""
    cfg, tmp = files["cfg"], files["tmp"]
    tag = f"{int(remote)}{ingest}"
    kw = dict(remote=remote, batch_epochs=30, ingest_dtype=ingest)
    ref = jpipe.process_capture_overlapped(
        files["cap"], files["code"], cfg, JProc(hamming_window=True, df_decimation=5),
        out_mat=str(tmp / f"jp{tag}.mat"), **kw)
    got = tpipe.process_capture_overlapped(
        files["cap"], files["code"], _tsig(cfg), TProc(hamming_window=True, df_decimation=5),
        out_mat=str(tmp / f"tp{tag}.mat"), device="cpu", **kw)
    _close_out(got, ref)
    assert len(got["ch1"]["indice"]) == 100
    # both native quantizers add native_q8_s on the int8 runs
    assert set(got["timing"]) == set(ref["timing"])
    assert got["timing"]["n_batches"] == ref["timing"]["n_batches"] == 4
    assert got["timing"]["bytes_shipped"] == ref["timing"]["bytes_shipped"]
    mt, mj = sio.loadmat(got["mat_path"]), sio.loadmat(ref["mat_path"])
    assert sorted(mt) == sorted(mj)
    np.testing.assert_allclose(mt["correction1"], mj["correction1"], rtol=0, atol=1e-4)
    d1 = np.median(got["ch1"]["indice"] + got["ch1"]["correction"]) / 3
    assert abs(d1 - 431.4) < 0.1


def test_pipeline_sc16_bit_identical_and_failures(files, monkeypatch):
    """Within the port: sc16 ingest gives the same bits as float32 ingest;
    a reader that raises surfaces its exception; an empty capture raises
    ValueError; the ingest ladder resolves as the JAX package's."""
    cfg, tmp = files["cfg"], files["tmp"]
    kw = dict(batch_epochs=40, device="cpu")
    args = (files["cap"], files["code"], _tsig(cfg), TProc(hamming_window=True))
    o32 = tpipe.process_capture_overlapped(*args, ingest_dtype="float32",
                                           out_mat=str(tmp / "b32.mat"), **kw)
    o16 = tpipe.process_capture_overlapped(*args, ingest_dtype="sc16",
                                           out_mat=str(tmp / "b16.mat"), **kw)
    assert o32["df"] == o16["df"]
    for ch in ("ch1", "ch2"):
        for k, v in o32[ch].items():
            np.testing.assert_array_equal(o16[ch][k], v, err_msg=k)

    def broken(*a, **k):
        raise OSError("disk gone")

    monkeypatch.setattr(tio, "read_sc16_epochs_raw16", broken)
    with pytest.raises(OSError, match="disk gone"):
        tpipe.process_capture_overlapped(*args, ingest_dtype="int16",
                                         out_mat=str(tmp / "x.mat"), **kw)
    empty = str(tmp / "empty.bin")
    open(empty, "wb").write(b"\0" * 6)
    with pytest.raises(ValueError, match="empty"):
        tpipe.process_capture_overlapped(empty, *args[1:], out_mat=str(tmp / "e.mat"), **kw)
    for a in [("float16", 0.0, True), ("sc16", None, True), (None, None, False),
              (None, None, True), (None, 0.1, True), (None, 0.05, True)]:
        assert tpipe._resolve_ingest_dtype(*a) == jpipe._resolve_ingest_dtype(*a)


def test_entry_points_default_to_cuda(files, monkeypatch):
    """process_capture_overlapped, process_capture_sharded, both
    process_files and the CLI verbs run on cuda unless told otherwise, and
    raise without a card (under ``--profile`` and ``--sharded`` too),
    before any process group is started."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = (files["cap"], files["code"], _tsig(files["cfg"]))
    for fn in (tpipe.process_capture_overlapped, tpipe.process_capture_sharded,
               tgor.process_file):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(*args)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgod.process_file(*args, TProc())
    for flags in (["--fast"], ["--profile", str(files["tmp"] / "prof")], ["--sharded"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            tcli.main(["goranging", files["cap"], files["code"], *flags])
    assert not dist.is_initialized()


@pytest.mark.parametrize("verb", [["goranging"], ["goranging", "--fast"], ["ranging"]])
def test_cli_verbs_recover_delay(files, tmp_path, capsys, verb):
    """``twstft-torch goranging [--fast] --device cpu`` and ``ranging
    --device cpu``: the ``.mat`` they print loads and recovers the
    431.4-sample delay within 0.1."""
    cap = str(tmp_path / "1755400099.bin")
    with open(files["cap"], "rb") as f:
        open(cap, "wb").write(f.read(2000 * 8 * 30))
    cfg = files["cfg"]
    rc = tcli.main([verb[0], cap, files["code"], *verb[1:], "--device", "cpu",
                    "--fs", str(cfg.fs), "--chip-rate", str(cfg.chip_rate),
                    "--code-len", str(cfg.code_len), "--bitlen", str(cfg.bit_len),
                    "--taps", str(cfg.taps)])
    assert rc == 0
    mat_path = capsys.readouterr().out.strip().splitlines()[-1]
    loaded = tmat.load_result(mat_path)
    assert len(loaded["solution1"]) == 30
    assert abs(float(np.median(loaded["solution1"])) / 3.0 - 431.4) < 0.1

