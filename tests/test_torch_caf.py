"""The port's dense CAF (``ops/caf.py``) against the JAX package's on the
CPU, at the small_cfg geometry (L = 2000, 50 Hz bins).

Tolerances, complex128 (the float64 the test harness turns on):
- ``doppler_bins``: identical shifts and frequencies;
- ``caf_peaks``: index identical, power within 1e-9 relative;
- ``caf_search``: df and df_coarse within 1e-9 Hz, indice identical,
  correction within 1e-9 sample, snr within 1e-9 relative;
- ``caf_surface``: within 1e-9 of the surface's maximum.
Complex64 (pocketfft in torch and in XLA sum in other orders): index and
indice identical, power within 1e-4 relative, df within 1e-3 Hz,
correction within 1e-4 sample.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amaranth_twstft_tpu.models.emitter import ChannelSim, synthesize_capture
from amaranth_twstft_tpu.ops import caf as jcaf
from amaranth_twstft_tpu.ops.lfsr import prn_chips
from amaranth_twstft_tpu.ops.prn import (
    chips_to_pm1,
    code_spectrum,
    interp_code,
    upsample_zoh,
)
from amaranth_twstft_tpu_torch.ops import caf as tcaf


def _replica(cfg):
    code = chips_to_pm1(upsample_zoh(prn_chips(cfg.bit_len, cfg.taps, cfg.code_len),
                                     cfg.samples_per_chip))
    return code, code_spectrum(code), interp_code(code, 3)


@pytest.fixture(scope="module")
def epochs(small_cfg):
    (stream,) = synthesize_capture(
        small_cfg,
        [ChannelSim(delay_samples=123.4, doppler_hz=163.0, amplitude=800,
                    noise_sigma=150)],
        n_seconds=1, seed=6,
    )
    L = small_cfg.samples_per_code
    return stream[: 6 * L].reshape(6, L)


@pytest.mark.parametrize("lo,hi,step", [(-500.0, 500.0, 100.0), (-310.0, 290.0, 60.0),
                                        (0.0, 0.0, 50.0), (-1000.0, 1000.0, 10.0)])
def test_doppler_bins_identical(small_cfg, lo, hi, step):
    L = small_cfg.samples_per_code
    sh_j, fr_j = jcaf.doppler_bins(small_cfg.fs, L, lo, hi, step)
    sh_t, fr_t = tcaf.doppler_bins(small_cfg.fs, L, lo, hi, step)
    assert sh_t.dtype == np.int32 and fr_t.dtype == np.float64
    np.testing.assert_array_equal(sh_t, np.asarray(sh_j))
    np.testing.assert_array_equal(fr_t, fr_j)


@pytest.mark.parametrize("chunk", [8, 4, 7])
def test_caf_peaks_matches_jax(small_cfg, epochs, chunk):
    """H = 21 hypotheses: chunks of 8 and 4 do not divide it, so the
    padding hypotheses must be sliced off before anything reads them; 7
    does."""
    _, fcode, _ = _replica(small_cfg)
    L = small_cfg.samples_per_code
    shifts, _ = tcaf.doppler_bins(small_cfg.fs, L, -500.0, 500.0, 50.0)
    assert len(shifts) == 21
    ref = jcaf.caf_peaks(jnp.asarray(epochs), jnp.asarray(fcode),
                         jnp.asarray(shifts), chunk=chunk)
    got = tcaf.caf_peaks(torch.from_numpy(epochs), torch.from_numpy(fcode), shifts,
                         chunk=chunk)
    assert got.power.shape == got.index.shape == (6, 21)
    assert got.index.dtype == torch.int32
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(ref.index))
    np.testing.assert_allclose(got.power.numpy(), np.asarray(ref.power), rtol=1e-9)


def _search_both(small_cfg, d, fcode, code3, dtype_np, dtype_t, **kw):
    args = (small_cfg.fs, -500.0, 500.0, 50.0)
    ref = jcaf.caf_search(jnp.asarray(d.astype(dtype_np)), jnp.asarray(fcode),
                          jnp.asarray(code3), *args, **kw)
    got = tcaf.caf_search(torch.from_numpy(d.astype(dtype_np)),
                          torch.from_numpy(fcode), torch.from_numpy(code3), *args, **kw)
    return ref, got


@pytest.mark.parametrize("refine,nint", [(True, 1), (False, 1), (True, 2)])
def test_caf_search_matches_jax(small_cfg, epochs, refine, nint):
    code, fcode, _ = _replica(small_cfg)
    code3 = interp_code(code, 2 * nint + 1)
    ref, got = _search_both(small_cfg, epochs, fcode, code3, np.complex128,
                            torch.complex128, refine=refine, nint=nint)
    np.testing.assert_allclose(got.df_hz.numpy(), np.asarray(ref.df_hz), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.df_coarse_hz.numpy(), np.asarray(ref.df_coarse_hz),
                               rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got.epoch.indice.numpy(), np.asarray(ref.epoch.indice))
    np.testing.assert_allclose(got.epoch.correction.numpy(),
                               np.asarray(ref.epoch.correction), rtol=0, atol=1e-9)
    for f in ("snr_r", "snr_i", "puissance"):
        np.testing.assert_allclose(getattr(got.epoch, f).numpy(),
                                   np.asarray(getattr(ref.epoch, f)), rtol=1e-9)
    np.testing.assert_allclose(got.epoch.xval.numpy(), np.asarray(ref.epoch.xval),
                               rtol=1e-9)
    if refine:
        delay = (got.epoch.indice.numpy() + got.epoch.correction.numpy()) / (2 * nint + 1)
        assert np.all(np.abs(delay - 123.4) < 0.1)
        assert np.all(np.abs(got.df_hz.numpy() - 163.0) < 10.0)


def test_caf_search_complex64_matches_jax(small_cfg, epochs):
    _, fcode, code3 = _replica(small_cfg)
    ref, got = _search_both(small_cfg, epochs, fcode, code3, np.complex64,
                            torch.complex64)
    assert got.epoch.correction.dtype == torch.float32
    np.testing.assert_array_equal(got.epoch.indice.numpy(), np.asarray(ref.epoch.indice))
    np.testing.assert_allclose(got.df_hz.numpy(), np.asarray(ref.df_hz), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got.df_coarse_hz.numpy(), np.asarray(ref.df_coarse_hz))
    np.testing.assert_allclose(got.epoch.correction.numpy(),
                               np.asarray(ref.epoch.correction), rtol=0, atol=1e-4)
    shifts, _ = tcaf.doppler_bins(small_cfg.fs, small_cfg.samples_per_code,
                                  -500.0, 500.0, 50.0)
    pj = jcaf.caf_peaks(jnp.asarray(epochs.astype(np.complex64)),
                        jnp.asarray(fcode.astype(np.complex64)), jnp.asarray(shifts))
    pt = tcaf.caf_peaks(torch.from_numpy(epochs.astype(np.complex64)),
                        torch.from_numpy(fcode), shifts)
    assert pt.power.dtype == torch.float32
    np.testing.assert_array_equal(pt.index.numpy(), np.asarray(pj.index))
    np.testing.assert_allclose(pt.power.numpy(), np.asarray(pj.power), rtol=1e-4)


def test_caf_surface_matches_jax(small_cfg, epochs):
    _, fcode, _ = _replica(small_cfg)
    shifts, _ = tcaf.doppler_bins(small_cfg.fs, small_cfg.samples_per_code,
                                  -200.0, 200.0, 50.0)
    ref = np.asarray(jcaf.caf_surface(jnp.asarray(epochs[:2]), jnp.asarray(fcode),
                                      jnp.asarray(shifts)))
    got = tcaf.caf_surface(torch.from_numpy(epochs[:2]), torch.from_numpy(fcode),
                           shifts).numpy()
    assert got.shape == ref.shape == (2, len(shifts), small_cfg.samples_per_code)
    assert np.abs(got - ref).max() < 1e-9 * ref.max()
    # the surface's per-hypothesis maxima are caf_peaks' powers
    peaks = tcaf.caf_peaks(torch.from_numpy(epochs[:2]), torch.from_numpy(fcode), shifts)
    np.testing.assert_allclose(got.max(-1) ** 2, peaks.power.numpy(), rtol=1e-9)
