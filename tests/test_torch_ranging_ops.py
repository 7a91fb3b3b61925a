"""The port's GoRanging ops against the JAX package's, on the CPU at the
``small_cfg`` geometry (L = 2000): the sparse zoomed IFFT, the correlator
(fast and full paths), the df estimators and the batched ranging step.

Inputs are made from a seed with NumPy and fed to both packages with
explicit dtypes (the test harness runs JAX with x64 enabled).  Unless a
test says otherwise the tolerances are:

| Field | complex64 | complex128 |
| --- | --- | --- |
| indice | identical | identical |
| correction | 1e-4 sample | 1e-9 sample |
| df | equal float32 values | equal float32 values |
| snr_r / snr_i | 1e-3 of snr_r + snr_i | 1e-3 of snr_r + snr_i |
| puissance* | 1e-5 relative | 1e-5 relative |
| xval* | 1e-4 of abs(xval) | 1e-4 of abs(xval) |
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amaranth_twstft_tpu.models import emitter as jem
from amaranth_twstft_tpu.ops import boundary as jb
from amaranth_twstft_tpu.ops import correlator as jc
from amaranth_twstft_tpu.ops import doppler as jdop
from amaranth_twstft_tpu.ops import zoomdft as jz
from amaranth_twstft_tpu.ops.lfsr import prn_chips
from amaranth_twstft_tpu.ops.prn import chips_to_pm1, code_spectrum, interp_code, upsample_zoh
from amaranth_twstft_tpu.utils import io as jio
from amaranth_twstft_tpu_torch.ops import boundary as tb
from amaranth_twstft_tpu_torch.ops import correlator as tc
from amaranth_twstft_tpu_torch.ops import doppler as tdop
from amaranth_twstft_tpu_torch.ops import fftutils as tfft
from amaranth_twstft_tpu_torch.ops import zoomdft as tz
from tests.oracle_numpy import processing_oracle

C64, C128 = np.complex64, np.complex128
CORR_TOL = {C64: 1e-4, C128: 1e-9}


def _real(c):
    return np.float32 if c == C64 else np.float64


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def capture(small_cfg):
    """8 epochs of each of two channels (delays 431.4 and 12.75 samples,
    Dopplers 130 and 5 Hz, noise), the code and its spectra."""
    streams = jem.synthesize_capture(
        small_cfg,
        [jem.ChannelSim(431.4, 130.0, amplitude=900, noise_sigma=250),
         jem.ChannelSim(12.75, 5.0, amplitude=2000, noise_sigma=100)],
        n_seconds=1, seed=5,
    )
    L = small_cfg.samples_per_code
    code = chips_to_pm1(upsample_zoh(
        prn_chips(small_cfg.bit_len, small_cfg.taps, small_cfg.code_len), 2))
    return {
        "d": streams[0][: 8 * L].reshape(8, L),
        "streams": streams,
        "code": code,
        "fcode": code_spectrum(code, conj=True),
        "fcode_claudio": code_spectrum(code, conj=False),
        "code_interp": {n: interp_code(code, 2 * n + 1) for n in (1, 4)},
    }


def _close_result(got, ref, cdtype, xfields=("xval", "xvalm1", "xvalp1")):
    """``got`` (port) against ``ref`` (JAX or the oracle) within the
    module's table."""
    np.testing.assert_array_equal(_np(got.indice), _np(ref.indice))
    np.testing.assert_allclose(_np(got.correction), _np(ref.correction),
                               rtol=0, atol=CORR_TOL[cdtype])
    snr = _np(ref.snr_r) + _np(ref.snr_i)
    for f in ("snr_r", "snr_i"):
        assert np.all(np.abs(_np(getattr(got, f)) - _np(getattr(ref, f))) <= 1e-3 * snr), f
    for f in ("puissance", "puissance_code", "puissance_noise"):
        np.testing.assert_allclose(_np(getattr(got, f)), _np(getattr(ref, f)),
                                   rtol=1e-5, err_msg=f)
    for f in xfields:
        r = _np(getattr(ref, f))
        assert np.all(np.abs(_np(getattr(got, f)) - r) <= 1e-4 * np.abs(r)), f


@pytest.mark.parametrize("cdtype", [C64, C128])
@pytest.mark.parametrize("nint", [1, 4])
def test_zoom_point_and_fine_window_match(cdtype, nint):
    """zoom_point and fine_window within 1e-5 (complex64) / 1e-12
    (complex128) of their largest output, fine_window's base equal; both
    equal the samples of the full zoomed IFFT they stand for."""
    rng = np.random.default_rng(nint)
    L = 2000
    M = (2 * nint + 1) * L
    tol = 1e-5 if cdtype == C64 else 1e-12
    ffty = (rng.normal(size=(3, L)) + 1j * rng.normal(size=(3, L))).astype(cdtype)
    g = (rng.normal(size=L) + 1j * rng.normal(size=L)).astype(cdtype)
    s = np.array([0, 7, M - 1], np.int32)
    ref = np.asarray(jz.zoom_point(jnp.asarray(ffty), jnp.asarray(g), jnp.asarray(s), nint))
    got = _np(tz.zoom_point(_t(ffty), _t(g), _t(s), nint))
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()
    g_full = np.zeros(M, C128)
    g_full[tz.zoom_positions(L, nint)] = g
    full = np.fft.ifft(_np(tfft.spectral_zoom(_t(ffty.astype(C128)), nint)) * g_full)
    assert np.abs(got - full[np.arange(3), s]).max() <= tol * np.abs(ref).max()

    e = jz.fine_window_matrix(L, nint, 32)
    np.testing.assert_array_equal(tz.fine_window_matrix(L, nint, 32), e)
    ci = np.array([0, 1234, L - 1], np.int32)
    e_ri = np.stack([e.real, e.imag], axis=-1).astype(_real(cdtype))
    v_ref, b_ref = jz.fine_window(jnp.asarray(ffty), jnp.asarray(ci), jnp.asarray(e_ri), nint)
    v_got, b_got = tz.fine_window(_t(ffty), _t(ci), _t(e.astype(cdtype)), nint)
    np.testing.assert_array_equal(_np(b_got), np.asarray(b_ref))
    v_ref = np.asarray(v_ref)
    assert np.abs(_np(v_got) - v_ref).max() <= tol * np.abs(v_ref).max()
    zoomed = np.fft.ifft(_np(tfft.spectral_zoom(_t(ffty.astype(C128)), nint)))
    idx = (_np(b_got)[:, None] + np.arange(32)[None]) % M
    assert np.abs(_np(v_got) - np.take_along_axis(zoomed, idx, -1)).max() \
        <= tol * np.abs(v_ref).max()


# (fast, nint, conjugate_data, per-epoch df, dtype, fcode_interp given as)
CORR_CASES = [
    (False, 1, False, False, C64, None),
    (True, 1, False, True, C64, "gathered"),
    (False, 4, True, True, C128, "full"),
    (True, 4, True, False, C128, "gathered"),
    (True, 1, True, True, C128, None),
    (False, 1, False, True, C128, "full"),
    (True, 4, False, False, C64, "full"),
    (False, 4, True, False, C64, "gathered"),
]


@pytest.mark.parametrize("fast,nint,conj,per_epoch,cdtype,g_form", CORR_CASES)
def test_correlate_epochs_matches_jax(capture, small_cfg, fast, nint, conj,
                                      per_epoch, cdtype, g_form):
    """correlate_epochs, fast and full paths, nint 1 and 4, both
    conjugation conventions, fixed and per-epoch df, complex64 and
    complex128, the SNR spectrum derived, at full length M or gathered
    to (L,): the module's tolerances."""
    L = small_cfg.samples_per_code
    d = capture["d"].astype(cdtype)
    fcode = (capture["fcode_claudio"] if conj else capture["fcode"]).astype(cdtype)
    code3 = capture["code_interp"][nint].astype(_real(cdtype))
    if per_epoch:
        df = (130.0 + np.linspace(-3.0, 3.0, len(d))).astype(_real(cdtype))
    else:
        df = np.asarray(130.25, _real(cdtype))
    g = None
    if g_form is not None:
        g = np.conj(np.fft.fft(code3.astype(np.float64))).astype(cdtype)
        if g_form == "gathered":
            g = jz.zoom_gather(g, L, nint)
    kw = dict(nint=nint, conjugate_data=conj, fast=fast)
    ref = jc.correlate_epochs(
        jnp.asarray(d), jnp.asarray(fcode), jnp.asarray(df), jnp.asarray(code3),
        small_cfg.fs, fcode_interp=None if g is None else jnp.asarray(g), **kw)
    got = tc.correlate_epochs(
        _t(d), _t(fcode), _t(df), _t(code3), small_cfg.fs,
        fcode_interp=None if g is None else _t(g), **kw)
    assert got.indice.dtype == torch.int32
    _close_result(got, ref, cdtype)
    if not conj:
        delays = _np(tc.delay_seconds(got, small_cfg.fs, 2 * nint + 1)) * small_cfg.fs
        assert np.all(np.abs(delays - 431.4) < 0.1)


class _Oracle:
    def __init__(self, rows):
        for k in rows[0]:
            setattr(self, k, np.asarray([r[k] for r in rows]))


@pytest.mark.parametrize("nint", [1, 4])
def test_correlate_epochs_matches_numpy_oracle(capture, small_cfg, nint):
    """The port's per-epoch godual chain (squaring df, then the full
    zoom-IFFT correlator) in complex128 against the float64 NumPy oracle
    of the reference (``tests/oracle_numpy.processing_oracle``): the
    module's complex128 tolerances, df exactly."""
    L = small_cfg.samples_per_code
    fs = small_cfg.fs
    d = capture["d"].astype(C128)
    freq = tfft.fftfreq_shifted(L, fs)
    mask = tdop.window_mask(L, fs, -20e3, 20e3)
    code3 = capture["code_interp"][nint]
    ref = _Oracle([processing_oracle(row, fs, capture["fcode"], code3, freq, mask,
                                     nint=nint) for row in d])
    dt = _t(d)
    df, _ = tdop.squaring_df(dt - dt.mean(-1, keepdim=True), fs, mask)
    np.testing.assert_array_equal(_np(df), ref.df)
    got = tc.correlate_epochs(dt, _t(capture["fcode"]), df, _t(code3), fs, nint=nint)
    _close_result(got, ref, C128, xfields=("xval",))


@pytest.mark.parametrize("cdtype", [C64, C128])
def test_squaring_df_matches_jax(capture, small_cfg, cdtype):
    """Per-epoch df: the same bins and the same float32/float64 values,
    for the local and a remote window."""
    L = small_cfg.samples_per_code
    d = capture["d"].astype(cdtype)
    for lo, hi in ((-20e3, 20e3), (-120e3, 30e3)):
        mask = jdop.window_mask(L, small_cfg.fs, lo, hi)
        np.testing.assert_array_equal(tdop.window_mask(L, small_cfg.fs, lo, hi), mask)
        df_j, idx_j = jdop.squaring_df(jnp.asarray(d), small_cfg.fs, mask)
        df_t, idx_t = tdop.squaring_df(_t(d), small_cfg.fs, mask)
        np.testing.assert_array_equal(_np(idx_t), np.asarray(idx_j))
        assert _np(df_t).dtype == np.asarray(df_j).dtype
        np.testing.assert_array_equal(_np(df_t), np.asarray(df_j))
    np.testing.assert_allclose(
        _np(tdop.squaring_spectrum(_t(d))),
        np.asarray(jdop.squaring_spectrum(jnp.asarray(d))),
        rtol=1e-4 if cdtype == C64 else 1e-10,
        atol=(1e-4 if cdtype == C64 else 1e-10) * float(np.abs(d).max()) ** 2 * L)


@pytest.fixture(scope="module")
def decimated(capture, tmp_path_factory):
    """The decimate-by-5 pre-pass stream of both channels of a 1 s
    capture, read by the JAX package's reader."""
    path = str(tmp_path_factory.mktemp("dec") / "cap.bin")
    jio.write_sc16(path, *capture["streams"])
    return jio.decimate_sc16(path, 5, channels=2)


@pytest.mark.parametrize("form", ["complex64", "float32", "float16", "int16", "int8"])
def test_per_file_df_matches_jax(decimated, small_cfg, form):
    """per_file_df (complex64) and per_file_df_ri (float32, float16,
    int16, int8 re/im, int formats without a scale): equal float32 df,
    windowed and over the whole spectrum, with and without foffset."""
    from amaranth_twstft_tpu.pipeline import _pack_prepass as j_pack
    from amaranth_twstft_tpu_torch.pipeline import _pack_prepass as t_pack

    for x in decimated:
        for windowed, foff in ((True, 0.0), (False, 0.0), (True, 40.0)):
            kw = dict(foffset_hz=foff, windowed=windowed)
            if form == "complex64":
                ref = jdop.per_file_df(jnp.asarray(x), small_cfg.fs, 5, **kw)
                got = tdop.per_file_df(_t(x), small_cfg.fs, 5, **kw)
            else:
                ri = j_pack(x, np.dtype(form))
                np.testing.assert_array_equal(t_pack(x, np.dtype(form)), ri)
                ref = jdop.per_file_df_ri(jnp.asarray(ri), small_cfg.fs, 5, **kw)
                got = tdop.per_file_df_ri(_t(ri), small_cfg.fs, 5, **kw)
            assert _np(got).dtype == np.float32 == np.asarray(ref).dtype
            assert float(got) == float(ref), (form, windowed, foff)
    assert abs(float(got) - 5.0) < 5.0


def test_bound_prepass_window_matches():
    for n in (1000, (1 << 18) + 5, 3_000_000):
        x = np.arange(2 * n, dtype=np.float32).reshape(2, n)
        np.testing.assert_array_equal(tdop.bound_prepass_window(x),
                                      jdop.bound_prepass_window(x))
    assert tdop.PREPASS_MAX_SAMPLES == jdop.PREPASS_MAX_SAMPLES


def test_fine_df_phase_drift_matches(capture, small_cfg):
    """The phase-drift fine df of a mixed signal: within 1e-9 Hz
    (complex128) and 1e-3 Hz (complex64) of the JAX estimate."""
    L = small_cfg.samples_per_code
    t = np.arange(L) / small_cfg.fs
    y = capture["d"] * np.exp(-2j * np.pi * 129.0 * t)
    for cdtype, tol in ((C128, 1e-9), (C64, 1e-3)):
        ref = jdop.fine_df_phase_drift(jnp.asarray(y.astype(cdtype)), small_cfg.fs)
        got = tdop.fine_df_phase_drift(_t(y.astype(cdtype)), small_cfg.fs)
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=0, atol=tol)


def _packed_close(got, ref):
    """Packed rows: indice and df columns equal, the rest by the table
    (complex64)."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.shape[-1] == tb.PACKED_WIDTH
    _close_result(tb.to_epoch_result(tb.unpack_outputs(got)),
                  jb.to_epoch_result(jb.unpack_outputs(ref)), C64)
    np.testing.assert_array_equal(got[:, 2], ref[:, 2])


@pytest.mark.parametrize("form", ["int16", "int8", "float16"])
@pytest.mark.parametrize("per_epoch", [False, True])
def test_ranging_step_packed_matches_jax(capture, small_cfg, form, per_epoch):
    """The bound packed step on the interleaved dual-channel (n, L, 4)
    int16, int8 + scale and float16 ingest forms, with the fixed
    per-epoch df vector or the masked per-epoch df: rows equal to the
    JAX package's within the module's complex64 tolerances."""
    L = small_cfg.samples_per_code
    n = 4
    frames = np.stack([np.stack([s[: n * L].real, s[: n * L].imag], -1)
                       for s in capture["streams"]], 1).reshape(n, L, 4)
    frames = np.clip(np.round(frames), -32768, 32767)
    scale = None
    if form == "int8":
        scale = float(np.abs(frames).max()) / 127.0
        iq = np.clip(np.round(frames / scale), -127, 127).astype(np.int8)
    else:
        iq = frames.astype(form)
    mask = jdop.window_mask(L, small_cfg.fs, -20e3, 20e3)
    args = (capture["fcode"].astype(C64), capture["code_interp"][1], mask, small_cfg.fs)
    j_step = jb.make_ranging_step(*args, packed=True, mxu_fft=False)
    t_step = tb.make_ranging_step(*args, packed=True, device="cpu")
    df = np.repeat(np.asarray([130.25, 5.5], np.float32), n) if not per_epoch else None
    ref = j_step(jnp.asarray(iq), df_fixed=None if df is None else jnp.asarray(df),
                 scale=scale)
    got = t_step(_t(iq), df_fixed=None if df is None else _t(df), scale=scale)
    _packed_close(got, ref)
    dl = tb.unpack_outputs(_np(got)).delay_samples()
    assert np.all(np.abs(dl[:n] - 431.4) < 0.1) and np.all(np.abs(dl[n:] - 12.75) < 0.1)


def test_ranging_step_channel_rows_and_guards(capture, small_cfg):
    """A (B, L, 2) float32 batch of one channel equals its rows of the
    interleaved batch; int8 without a scale raises; the packed step
    refuses (2*nint+1)*L >= 2^24 (float32 indice) as the JAX one does."""
    L = small_cfg.samples_per_code
    n = 3
    iq2 = np.stack([capture["streams"][1][: n * L].real,
                    capture["streams"][1][: n * L].imag], -1).reshape(n, L, 2)
    iq4 = np.concatenate([iq2, iq2], axis=-1).astype(np.float32)
    mask = np.ones(L, bool)
    step = tb.make_ranging_step(capture["fcode"], capture["code_interp"][1], mask,
                                small_cfg.fs, packed=True, device="cpu")
    one = step(_t(iq2.astype(np.float32)), df_fixed=_t(np.full(n, 5.0, np.float32)))
    both = step(_t(iq4), df_fixed=_t(np.full(2 * n, 5.0, np.float32)))
    assert torch.equal(both[:n], one) and torch.equal(both[n:], one)
    with pytest.raises(ValueError, match="scale"):
        tb.ranging_step(_t(iq4.astype(np.int8)), _t(capture["fcode"]), None, None,
                        None, small_cfg.fs, scale=None)
    big = np.broadcast_to(np.complex64(0), (3_400_000,))
    with pytest.raises(ValueError, match="2\\*\\*24"):
        tb.make_ranging_step(big, big.real, big.real, 1e5, nint=2, packed=True,
                             device="cpu")
    with pytest.raises(ValueError, match="2\\*\\*24"):
        jb.make_ranging_step(big, big.real, big.real, 1e5, nint=2, packed=True,
                             mxu_fft=False)
