"""The port's peak/statistics ops, LO phasor and trial-correlation SNR
against the JAX package's (CPU, same numpy inputs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amaranth_twstft_tpu.ops import correlator as jcorr
from amaranth_twstft_tpu.ops import fftutils as jfft
from amaranth_twstft_tpu.ops import peaks as jpeaks
from amaranth_twstft_tpu_torch.ops import correlator as tcorr
from amaranth_twstft_tpu_torch.ops import fftutils as tfft
from amaranth_twstft_tpu_torch.ops import peaks as tpeaks

# float32 elementwise arithmetic in the same order: a few ulps
F32_RTOL = 1e-5


def test_hrc_correction_matches_jax():
    rng = np.random.default_rng(0)
    power = rng.random((5, 24, 17)).astype(np.float32)
    pk = rng.integers(0, 17, size=(5, 24))
    pk[0, :3] = [0, 1, 16]  # circular edges
    power[1, 2, :] = 1.0  # flat row: zero denominators
    got = tpeaks.hrc_correction(torch.from_numpy(power), torch.from_numpy(pk))
    ref = jpeaks.hrc_correction(jnp.asarray(power), jnp.asarray(pk))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=F32_RTOL, atol=1e-6)


@pytest.mark.parametrize("n_valid", [24, 23, 12, 2, 1, 0])
def test_median_iqr_sigma_masked_matches_jax(n_valid):
    """Even counts of valid entries (24, 12, 2) pin the median trap: the
    JAX median averages the two middle values, torch.median does not."""
    rng = np.random.default_rng(n_valid)
    x = rng.normal(size=(3, 24)).astype(np.float32)
    w = np.zeros((3, 24), np.float32)
    for r in range(3):
        w[r, rng.permutation(24)[:n_valid]] = 1.0
    med, sig = tpeaks.median_iqr_sigma(torch.from_numpy(x), torch.from_numpy(w))
    med_j, sig_j = jpeaks.median_iqr_sigma(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(med.numpy(), np.asarray(med_j), rtol=F32_RTOL, atol=1e-7)
    np.testing.assert_allclose(sig.numpy(), np.asarray(sig_j), rtol=F32_RTOL, atol=1e-7)
    if n_valid == 24:
        lower_middle = torch.median(torch.from_numpy(x), dim=-1).values
        assert not np.allclose(lower_middle.numpy(), med.numpy())


def test_median_iqr_sigma_unmasked_matches_jax():
    x = np.random.default_rng(3).normal(size=(4, 24)).astype(np.float32)
    med, sig = tpeaks.median_iqr_sigma(torch.from_numpy(x))
    med_j, sig_j = jpeaks.median_iqr_sigma(jnp.asarray(x))
    np.testing.assert_allclose(med.numpy(), np.asarray(med_j), rtol=F32_RTOL)
    np.testing.assert_allclose(sig.numpy(), np.asarray(sig_j), rtol=F32_RTOL)


def test_weighted_linear_fit_matches_jax():
    rng = np.random.default_rng(7)
    t = (np.arange(24) * 0.04).astype(np.float32)
    y = (3.0 + 1.5 * t + rng.normal(0, 0.01, (4, 24))).astype(np.float32)
    w = (rng.random((4, 24)) > 0.3).astype(np.float32)
    w[2] = 0.0  # degenerate row -> zeros
    w[3] = 0.0
    w[3, 5] = 1.0  # one point: zero spread -> slope 0
    got = tpeaks.weighted_linear_fit(
        torch.from_numpy(t), torch.from_numpy(y), torch.from_numpy(w)
    )
    ref = jpeaks.weighted_linear_fit(jnp.asarray(t), jnp.asarray(y), jnp.asarray(w))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)


def test_mix_phasor_matches_jax():
    """The exact 2048-split f32 phase: cos/sin of the same angles."""
    df = np.array([123.456, -2999.9, 0.0], np.float32)
    got = tfft.mix_phasor(600_000, torch.from_numpy(df), 5e6)
    ref = np.asarray(jfft.mix_phasor(600_000, jnp.asarray(df), 5e6))
    assert got.dtype == torch.complex64
    assert np.abs(got.numpy() - ref).max() < 1e-6


def test_quick_xcorr_snr_matches_jax():
    rng = np.random.default_rng(11)
    L = 2000
    code = np.sign(rng.normal(size=L))
    fcode = np.fft.fft(code).astype(np.complex64)
    n = np.arange(L)
    d = (3.0 * np.roll(code, 137) * np.exp(2j * np.pi * 40.0 * n / 1e5)
         + rng.normal(size=L) + 1j * rng.normal(size=L)).astype(np.complex64)
    d = np.stack([d, rng.normal(size=L).astype(np.complex64)])
    df = np.array([40.0, 0.0], np.float32)
    got = tcorr.quick_xcorr_snr(
        torch.from_numpy(d), torch.from_numpy(fcode), torch.from_numpy(df), 1e5
    )
    ref = jcorr.quick_xcorr_snr(jnp.asarray(d), jnp.asarray(fcode), jnp.asarray(df), 1e5)
    # FFTs of the same complex64 data by two libraries: 1e-4 relative
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4)
    assert got[0] > 100 * got[1]
