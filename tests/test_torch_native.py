"""The port's native C++ library against the JAX package's and against
the port's plain versions, on the CPU (both libraries build with g++).

Every native output must equal the JAX package's byte for byte: the
ingest functions, the int8 quantizer over the full-scale, ``select``,
``pow2``, fused-decimation and all-zero cases of ``tests/test_native.py``,
the raw16 copy, the sc16 and MAT writers and the LFSR engine.  The
port's readers, which have no path around the library, must return the
JAX readers' arrays and scales under the JAX package's
``TWSTFT_Q8_NATIVE=0/1`` x ``TWSTFT_Q8_POW2=0/1``, the float and
decimating readers must read no sample through a memmap, and a failed
build must raise rather than fall back.
"""

import os
import time

import numpy as np
import pytest
import scipy.io as sio

from amaranth_twstft_tpu import native as jnative
from amaranth_twstft_tpu.ops import lfsr as jlfsr
from amaranth_twstft_tpu.utils import io as jio
from amaranth_twstft_tpu.utils import matio as jmat
from amaranth_twstft_tpu_torch import cli as tcli
from amaranth_twstft_tpu_torch import native as tnative
from amaranth_twstft_tpu_torch.ops import lfsr as tlfsr
from amaranth_twstft_tpu_torch.utils import io as tio
from amaranth_twstft_tpu_torch.utils import matio as tmat


@pytest.fixture(scope="module", autouse=True)
def jax_native_loaded():
    """The JAX package's library builds in place at first use, not
    atomically: another test process may be writing it when this one
    first loads it (its loader then returns None once).  Wait for a
    complete library before comparing against it."""
    deadline = time.monotonic() + 240
    while jnative.load() is None:
        if time.monotonic() > deadline:
            pytest.fail("the JAX package's native library did not load")
        time.sleep(0.5)


@pytest.fixture(scope="module")
def q8_file(tmp_path_factory):
    """4096-frame epochs of two channels at +-1800 with int16 full-scale
    sentinels (32767, -32768, +-32700: the pow2 path's sh = 9 rounding
    add would wrap in int16)."""
    rng = np.random.default_rng(11)
    L, n = 4096, 7
    raw = rng.integers(-1800, 1800, (n * L, 4)).astype(np.int16)
    raw[0, :2] = (32767, -32768)
    raw[1, :2] = (32700, -32700)
    raw[5 * L + 3, 2:] = (-32768, 32767)
    p = str(tmp_path_factory.mktemp("q8") / "q8.bin")
    raw.tofile(p)
    return p, raw, L, n


@pytest.fixture(scope="module")
def iq_file(tmp_path_factory):
    rng = np.random.default_rng(5)
    n = 50_000
    ch1 = (rng.normal(0, 1000, n) + 1j * rng.normal(0, 1000, n)).astype(np.complex64)
    ch2 = (rng.normal(0, 500, n) + 1j * rng.normal(0, 500, n)).astype(np.complex64)
    p = str(tmp_path_factory.mktemp("iq") / "cap.bin")
    tio.write_sc16(p, ch1, ch2)
    return p, n


def test_library_builds_into_the_build_dir():
    tnative.build()
    info = tnative.build()
    assert os.path.dirname(tnative._SO).endswith(os.path.join(
        "amaranth_twstft_tpu_torch", "build"))
    assert os.path.exists(tnative._SO)
    assert info["built"] is False  # up to date after the first build
    assert tnative.load() is tnative.load()


def test_ingest_functions_match_jax(iq_file):
    p, n = iq_file
    assert tnative.file_frames(p, 2) == jnative.file_frames(p, 2) == n
    assert tnative.file_frames(p, 1) == jnative.file_frames(p, 1) == 2 * n
    assert tnative.file_mtime(p) == jnative.file_mtime(p)
    for start, n_ep in ((100, 3), (n - 5_000, 3), (0, 5)):
        t, tn = tnative.ingest_epochs(p, start, n_ep, 10_000, channels=2)
        j, jn = jnative.ingest_epochs(p, start, n_ep, 10_000, channels=2)
        assert tn == jn and t.dtype == j.dtype and t.shape == j.shape
        np.testing.assert_array_equal(t, j)
        # the plain numpy slice of the file the port's readers used to take
        frames = np.fromfile(p, np.int16).reshape(-1, 4)[start : start + tn * 10_000]
        plain = frames.astype(np.float32).reshape(tn, 10_000, 2, 2).transpose(2, 0, 1, 3)
        np.testing.assert_array_equal(t, plain)
    ref, _ = tio.read_sc16_epochs(p, 100, 3, 10_000, channels=2)
    t, _ = tnative.ingest_epochs(p, 100, 3, 10_000, channels=2)
    np.testing.assert_array_equal(t[..., 0], ref.real)
    np.testing.assert_array_equal(t[..., 1], ref.imag)
    frames = np.fromfile(p, np.int16).reshape(-1, 4).astype(np.float32)
    for decim, max_out in ((7, None), (25, None), (7, 3_000), (25, 10 ** 9), (5, 0)):
        t = tnative.ingest_decimated(p, decim, channels=2, max_out=max_out)
        plain = frames[: None if max_out is None else max_out * decim : decim]
        assert t.shape == (2, len(plain), 2)
        np.testing.assert_array_equal(t, plain.reshape(-1, 2, 2).transpose(1, 0, 2))
        if max_out is None:
            np.testing.assert_array_equal(t, jnative.ingest_decimated(p, decim, channels=2))
        z = tio.decimate_sc16(p, decim, channels=2, max_out=max_out)
        assert z.dtype == np.complex64
        np.testing.assert_array_equal(z, (plain[:, 0::2] + 1j * plain[:, 1::2]).T)


def test_write_sc16_matches_jax_byte_for_byte(tmp_path):
    rng = np.random.default_rng(2)
    ri = [rng.normal(0, 20000, (9_000, 2)).astype(np.float32) for _ in range(2)]
    ri[0][:4] = [[40000.0, -40000.0], [32767.5, -32768.5], [0.5, 1.5], [-0.5, 2.5]]
    for k in (1, 2):
        pt, pj = str(tmp_path / f"t{k}.bin"), str(tmp_path / f"j{k}.bin")
        assert tnative.write_sc16(pt, *ri[:k]) == jnative.write_sc16(pj, *ri[:k]) == 9_000
        with open(pt, "rb") as a, open(pj, "rb") as b:
            assert a.read() == b.read()


def test_lfsr_engine_matches_jax_and_the_plain_versions():
    assert tnative.is_mseq(17, 9) and not tnative.is_mseq(17, 7)
    for taps in range(1, 64, 2):
        want = jlfsr._is_mseq_py(8, taps)
        assert tnative.is_mseq(8, taps) == jnative.is_mseq(8, taps) == want
        assert tlfsr.is_mseq(8, taps) == tlfsr._is_mseq_py(8, taps) == want
    assert tnative.is_mseq(8, 0x71, seed=5) == tlfsr._is_mseq_py(8, 0x71, seed=5)
    for bits, limit in ((10, 6), (12, 9)):
        want = jlfsr._find_mseq_taps_np(bits, limit)
        assert tnative.find_mseq(bits, limit) == jnative.find_mseq(bits, limit) == want
        assert tlfsr.find_mseq_taps(bits, limit) == tlfsr._find_mseq_taps_np(bits, limit) == want
    for bits, taps, seed in ((17, 9, 1), (10, 9, 3), (5, 5, 1)):
        t = tnative.prn_chips(bits, taps, 5000, seed)
        assert t.dtype == np.int8
        np.testing.assert_array_equal(t, jnative.prn_chips(bits, taps, 5000, seed))
        np.testing.assert_array_equal(t, tlfsr.prn_chips(bits, taps, 5000, seed))


def test_prn_search_verb_goes_through_the_engine(capsys, monkeypatch):
    calls = []
    orig = tnative.find_mseq
    monkeypatch.setattr(tnative, "find_mseq", lambda *a: calls.append(a) or orig(*a))
    assert tcli.main(["prn", "--bitlen", "10", "--search", "6"]) == 0
    got = [int(x) for x in capsys.readouterr().out.split()]
    assert got == jlfsr._find_mseq_taps_np(10, 6)
    assert calls == [(10, 6)]


QUANT_CASES = [(pow2, sel) for pow2 in (False, True) for sel in (-1, 0, 1)]


@pytest.mark.parametrize("pow2,select", QUANT_CASES)
def test_quantizer_matches_jax_and_the_plain_quantizer(q8_file, pow2, select):
    """Bytes and scale equal to the JAX package's native quantizer and to
    the port's plain torch quantizer, with and without ``out``."""
    p, raw, L, n = q8_file
    start, count = L, (n - 1) * L
    tq, tn, ts = tnative.quantize_q8(p, start, count, channels=2, select=select, pow2=pow2)
    jq, jn, js = jnative.quantize_q8(p, start, count, channels=2, select=select, pow2=pow2)
    assert tn == jn == count and ts == js and tq.dtype == np.int8
    np.testing.assert_array_equal(tq, jq)
    cols = raw[start:] if select < 0 else raw[start:, 2 * select : 2 * select + 2]
    plain = np.empty(cols.shape, np.int8)
    assert tio._quantize_q8_plain(np.ascontiguousarray(cols), pow2, plain) == ts
    np.testing.assert_array_equal(tq, plain)
    out = np.full(tq.shape, 99, np.int8)
    oq, _, os_ = tnative.quantize_q8(p, start, count, channels=2, select=select,
                                     pow2=pow2, out=out)
    assert np.shares_memory(oq, out)
    assert os_ == ts
    np.testing.assert_array_equal(out, tq)


@pytest.mark.parametrize("pow2", [False, True])
def test_quantizer_all_zero_short_and_decimated(tmp_path, pow2):
    """All-zero block: the floor scale (1/127 exact, 1 pow2) on the
    library, the JAX library and the plain quantizer; a read past the end
    is short; the fused decimation emits every decim-th selected frame
    from start."""
    rng = np.random.default_rng(3)
    p0 = str(tmp_path / "zero.bin")
    np.zeros((5000, 4), np.int16).tofile(p0)
    tq, tn, ts = tnative.quantize_q8(p0, 0, 5000, pow2=pow2)
    jq, jn, js = jnative.quantize_q8(p0, 0, 5000, pow2=pow2)
    floor = 1.0 if pow2 else 1.0 / 127.0
    assert ts == js == floor and tn == jn == 5000 and not tq.any()
    plain = np.empty((5000, 4), np.int8)
    assert tio._quantize_q8_plain(np.zeros((5000, 4), np.int16), pow2, plain) == floor
    raw = rng.integers(-3000, 3000, (10_000, 4)).astype(np.int16)
    p = str(tmp_path / "qd.bin")
    raw.tofile(p)
    tq, tn, ts = tnative.quantize_q8(p, 9_000, 4_000, pow2=pow2)
    jq, jn, js = jnative.quantize_q8(p, 9_000, 4_000, pow2=pow2)
    assert tn == jn == 1_000 and ts == js
    np.testing.assert_array_equal(tq, jq)
    assert tnative.quantize_q8(p, 20_000, 10, pow2=pow2)[1:] == (0, 1.0)  # empty
    for start, decim, sel in ((0, 25, -1), (40, 7, -1), (13, 5, 1)):
        t = tnative.quantize_q8(p, start, 10_000 - start, select=sel, pow2=pow2, decim=decim)
        j = jnative.quantize_q8(p, start, 10_000 - start, select=sel, pow2=pow2, decim=decim)
        cols = raw if sel < 0 else raw[:, 2 * sel : 2 * sel + 2]
        np.testing.assert_array_equal(t[3], cols[start::decim].astype(np.float32))
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)


def test_raw16_matches_jax_memmap_and_out(q8_file):
    p, raw, L, n = q8_file
    for start, count, sel in ((2 * L, 2 * L, -1), (0, L, 1), (0, L, 0),
                              (n * L - 10, 100, -1), (n * L + 5, 10, -1)):
        t, tn = tnative.read_raw16(p, start, count, channels=2, select=sel)
        j, jn = jnative.read_raw16(p, start, count, channels=2, select=sel)
        assert tn == jn == max(0, min(count, n * L - start))
        np.testing.assert_array_equal(t, j)
        cols = raw if sel < 0 else raw[:, 2 * sel : 2 * sel + 2]
        np.testing.assert_array_equal(t, cols[start : start + tn])
    out = np.full((2 * L, 4), 7, np.int16)
    a, m = tnative.read_raw16(p, 3, 2 * L, channels=2, out=out)
    assert m == 2 * L and np.shares_memory(a, out)
    np.testing.assert_array_equal(out, raw[3 : 3 + 2 * L])
    with pytest.raises(ValueError, match="C-contiguous"):
        tnative.read_raw16(p, 0, L, channels=2, out=np.empty((L, 8), np.int16)[:, ::2])
    with pytest.raises(ValueError, match="shape"):
        tnative.read_raw16(p, 0, L, channels=2, out=np.empty((L - 1, 4), np.int16))
    with pytest.raises(ValueError):
        tnative.quantize_q8(p, 0, L, out=np.empty((L, 4), np.int16))


@pytest.mark.parametrize("native_env", ["0", "1"])
@pytest.mark.parametrize("pow2_env", ["0", "1"])
def test_q8_reader_matches_jax_under_both_switches(q8_file, monkeypatch,
                                                   native_env, pow2_env):
    """``read_sc16_epochs_q8`` of both packages under the JAX package's
    switches (``TWSTFT_Q8_NATIVE`` chooses only the JAX reader's path; the
    port always quantizes natively): the same arrays and scales (select,
    ``out``, a short tail, a start past the end), and the native JAX
    reader's timing keys."""
    p, raw, L, n = q8_file
    monkeypatch.setenv("TWSTFT_Q8_NATIVE", native_env)
    monkeypatch.setenv("TWSTFT_Q8_POW2", pow2_env)
    for start, n_ep in ((0, n), (L + 5, 3), ((n - 1) * L + 3, 5), (n * L, 2)):
        for sel in (None, 0, 1):
            tt, jt = {}, {}
            tq, tn, ts = tio.read_sc16_epochs_q8(p, start, n_ep, L, timers=tt, select=sel)
            jq, jn, js = jio.read_sc16_epochs_q8(p, start, n_ep, L, timers=jt, select=sel)
            assert (tn, ts) == (jn, js) and tq.dtype == jq.dtype and tq.shape == jq.shape
            np.testing.assert_array_equal(tq, jq)
            if tn:
                assert tt["bytes_read"] == jt["bytes_read"]
                assert "disk_s" not in tt and tt["native_q8_s"] == tt["convert_s"]
                if native_env == "1":
                    assert set(tt) == set(jt)
    out = np.zeros((n + 1, L, 4), np.int8)
    tq, tn, ts = tio.read_sc16_epochs_q8(p, 0, n, L, out=out)
    assert np.shares_memory(tq, out)
    np.testing.assert_array_equal(out[:n], jio.read_sc16_epochs_q8(p, 0, n, L)[0])
    with pytest.raises(ValueError, match="C-contiguous"):
        tio.read_sc16_epochs_q8(p, 0, 2, L, out=np.zeros((2, L, 8), np.int8)[..., :4])


def test_raw16_readers_go_through_the_library(q8_file, monkeypatch):
    """``read_sc16_epochs_raw16`` and ``read_raw16`` (claudio's block
    reads) call the native copy and return the JAX readers' arrays."""
    p, raw, L, n = q8_file
    calls = []
    orig = tnative.read_raw16
    monkeypatch.setattr(tnative, "read_raw16",
                        lambda *a, **k: calls.append(a[1:3]) or orig(*a, **k))
    t, tn = tio.read_sc16_epochs_raw16(p, L + 1, 3, L, select=1)
    j, jn = jio.read_sc16_epochs_raw16(p, L + 1, 3, L, select=1)
    assert tn == jn == 3
    np.testing.assert_array_equal(t, j)
    p1 = p + ".single"
    raw.reshape(-1, 2).tofile(p1)
    out = np.zeros((1000, 2), np.int16)
    a, m = tio.read_raw16(p1, 5, 1000, out=out)
    assert m == 1000 and np.shares_memory(a, out)
    np.testing.assert_array_equal(a, jnative.read_raw16(p1, 5, 1000, channels=1)[0])
    a, m = tio.read_raw16(p1, 2 * n * L - 10, 1000)
    assert m == 10
    np.testing.assert_array_equal(a, raw.reshape(-1, 2)[-10:])
    assert calls == [(L + 1, 3 * L), (5, 1000), (2 * n * L - 10, 1000)]


def test_float_and_decimated_readers_read_no_memmap(q8_file, tmp_path, monkeypatch):
    """``decimate_sc16``, ``read_sc16_epochs_ri`` and
    ``read_sc16_epochs_packed`` return the JAX readers' arrays with
    ``open_sc16`` and ``np.memmap`` made to raise: every sample comes
    through the native library."""
    p, raw, L, n = q8_file
    p6 = str(tmp_path / "six.bin")
    open(p6, "wb").write(b"\0" * 6)
    C128 = np.complex128
    dec = [((p, 5), {}), ((p, 5), {"max_out": 1000}), ((p, 7), {"dtype": C128}),
           ((p, 3), {"max_out": 10 ** 9, "dtype": C128}), ((p6, 5), {}), ((p, 1), {"channels": 1})]
    ri = [((p, s, k, L), {"select": sel, "dtype": dt})
          for s, k in ((L + 5, 3), ((n - 1) * L + 3, 5), (n * L, 2))
          for sel in (None, 0, 1) for dt in (np.float32, np.float16)]
    packed = [((p, s, k, L), {"dtype": dt})
              for s, k in ((0, n), ((n - 1) * L + 3, 5)) for dt in (np.float32, np.float16)]
    cases = ([(tio.decimate_sc16, jio.decimate_sc16, a, k) for a, k in dec]
             + [(tio.read_sc16_epochs_ri, jio.read_sc16_epochs_ri, a, k) for a, k in ri]
             + [(tio.read_sc16_epochs_packed, jio.read_sc16_epochs_packed, a, k)
                for a, k in packed])
    want = [j(*a, **k) for _, j, a, k in cases]
    want_out = [jio.read_sc16_epochs_ri(p, 2, 4, L, dtype=dt, select=sel)[0]
                for dt in (np.float32, np.float16) for sel in (None, 1)]

    def no_memmap(*a, **k):
        raise AssertionError("a reader mapped the file with numpy")

    monkeypatch.setattr(tio, "open_sc16", no_memmap)
    monkeypatch.setattr(np, "memmap", no_memmap)
    for (t, _, a, k), w in zip(cases, want):
        got = t(*a, **k)
        g, w = (got, w) if t is tio.decimate_sc16 else (got[0], w[0])
        assert g.dtype == w.dtype and g.shape == w.shape, (t.__name__, a, k)
        np.testing.assert_array_equal(g, w)
    assert tio.decimate_sc16(p6, 5).shape == (2, 0)
    outs = [(dt, sel) for dt in (np.float32, np.float16) for sel in (None, 1)]
    for (dt, sel), w in zip(outs, want_out):
        out = np.full((2 if sel is None else 1, 6, L, 2), 99, dt)
        got, k = tio.read_sc16_epochs_ri(p, 2, 4, L, dtype=dt, select=sel, out=out)
        assert k == 4 and np.shares_memory(got, out) and not (out[:, 4:] != 99).any()
        np.testing.assert_array_equal(out[:, :4], w)


def test_save_mat_matches_jax_and_loads(tmp_path):
    """The MAT writer's files equal the JAX writer's byte for byte and load
    through scipy and both ``matio.load_result`` with the same fields."""
    rng = np.random.default_rng(8)
    fields = {
        "correction1": rng.normal(0, 1, 100),
        "SNR1": rng.normal(10, 1, 100),
        "df1": np.full(100, 100.0),
        "xval1": rng.normal(0, 1, 100) + 1j * rng.normal(0, 1, 100),
    }
    pt, pj = str(tmp_path / "tC.mat"), str(tmp_path / "jC.mat")
    tnative.save_mat(pt, fields)
    jnative.save_mat(pj, fields)
    with open(pt, "rb") as a, open(pj, "rb") as b:
        assert a.read() == b.read()
    mt, mj = sio.loadmat(pt), sio.loadmat(pj)
    assert sorted(k for k in mt if not k.startswith("__")) == sorted(fields)
    for k, v in fields.items():
        assert mt[k].shape == (np.asarray(v).size, 1)
        np.testing.assert_array_equal(mt[k].ravel(), np.asarray(v).ravel())
        np.testing.assert_array_equal(mt[k], mj[k])
    lt, lj = tmat.load_result(pt), jmat.load_result(pj)
    assert sorted(lt) == sorted(lj)
    for k in set(lt) - {"raw"}:
        np.testing.assert_array_equal(lt[k], lj[k])
    # the C convention: the solution is the correction field itself
    np.testing.assert_array_equal(lt["solution1"], fields["correction1"])
    np.testing.assert_allclose(lt["snr1_db"], fields["SNR1"])


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch, q8_file):
    """A failed g++ build raises RuntimeError naming the compiler's
    failure; no reader falls back to a plain path."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_SO", str(tmp_path / "lib" / "libtwstft_native.so"))
    monkeypatch.setattr(tnative, "_CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="(?s)native library build failed.*no-such-g"):
        tnative.load()
    p, _, L, _ = q8_file
    monkeypatch.setenv("TWSTFT_Q8_NATIVE", "0")  # the JAX package's switch only
    with pytest.raises(RuntimeError, match="build failed"):
        tio.read_sc16_epochs_q8(p, 0, 2, L)
    with pytest.raises(RuntimeError, match="build failed"):
        tio.read_sc16_epochs_raw16(p, 0, 2, L)
    for read in (tio.read_sc16_epochs_ri, tio.read_sc16_epochs_packed):
        with pytest.raises(RuntimeError, match="build failed"):
            read(p, 0, 2, L)
    with pytest.raises(RuntimeError, match="build failed"):
        tio.decimate_sc16(p, 5)
    with pytest.raises(RuntimeError, match="build failed"):
        tlfsr.find_mseq_taps(10, 2)
    assert not os.listdir(tmp_path / "lib")  # no partial library left


def test_failed_build_reports_the_compiler_errors(tmp_path, monkeypatch):
    """With a real compiler and a broken source, the message carries g++'s
    own diagnostics for both flag sets."""
    src = tmp_path / "src"
    src.mkdir()
    for s in tnative._SOURCES:
        (src / s).write_text("int broken(\n")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_HERE", str(src))
    monkeypatch.setattr(tnative, "_SO", str(tmp_path / "lib" / "libtwstft_native.so"))
    with pytest.raises(RuntimeError) as e:
        tnative.build()
    msg = str(e.value)
    assert msg.count("exit 1") == 2 and "-march=native" in msg and "error" in msg
