"""The port's staged matmul FFT (``ops/mxufft``) against the JAX
package's and NumPy's, on the CPU.

- ``good_factors`` equals the JAX package's for every n in 2..5000 and
  the production lengths, ``ValueError`` included;
- complex128: within 1e-10 of the maximum of JAX's and NumPy's output;
- complex64 at L = 200 000: within 5e-5 of the float64 transform and
  1e-5 of JAX's output (relative to the maximum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amaranth_twstft_tpu.ops import mxufft as jmx
from amaranth_twstft_tpu_torch.ops import mxufft as tmx


def _factors(mod, n):
    try:
        return mod.good_factors(n)
    except ValueError as e:
        return ("ValueError", str(e).split(";")[0])


@pytest.mark.parametrize("lo", range(2, 5001, 1000))
def test_good_factors_match_jax(lo):
    for n in range(lo, min(lo + 1000, 5001)):
        assert _factors(tmx, n) == _factors(jmx, n), n
    with pytest.raises(ValueError):
        tmx.good_factors(2 * 131)


@pytest.mark.parametrize("n", [200_000, 600_000, 10**7])
def test_good_factors_production_lengths(n):
    f = tmx.good_factors(n)
    assert f == jmx.good_factors(n)
    assert np.prod(f) == n and max(f) <= 128


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [2000, 6000, 4096, 350, 1875])
def test_complex128_matches_jax_and_numpy(n, inverse):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))
    got = tmx.fft_factored(torch.from_numpy(x), inverse=inverse)
    assert got.dtype == torch.complex128
    got = got.numpy()
    jax_out = np.asarray(jmx.fft_factored(jnp.asarray(x), inverse=inverse))
    want = np.fft.ifft(x, axis=-1) if inverse else np.fft.fft(x, axis=-1)
    scale = np.max(np.abs(want))
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got / scale, jax_out / scale, rtol=0, atol=1e-10)
    if inverse:
        back = tmx.ifft_factored(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(back, got)


def test_complex64_production_length():
    """fp32 accuracy at L = 200 000: forward within 5e-5 of the float64
    truth and 1e-5 of JAX's output, the round trip within 1e-4."""
    rng = np.random.default_rng(0)
    n = 200_000
    x = (rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))).astype(np.complex64)
    y = tmx.fft_factored(torch.from_numpy(x))
    assert y.dtype == torch.complex64
    y = y.numpy()
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    scale = np.max(np.abs(want))
    assert np.max(np.abs(y - want)) / scale < 5e-5
    jy = np.asarray(jmx.fft_factored(jnp.asarray(x)))
    assert np.max(np.abs(y - jy)) / scale < 1e-5
    back = tmx.ifft_factored(torch.from_numpy(y)).numpy()
    assert np.max(np.abs(back - x)) / np.max(np.abs(x)) < 1e-4
    jback = np.asarray(jmx.fft_factored(jnp.asarray(jy), inverse=True))
    assert np.max(np.abs(back - jback)) / np.max(np.abs(x)) < 1e-5


def test_stage_constants_are_cached_per_dtype_and_device():
    a = tmx._dft_matrix(25, False, torch.complex64, torch.device("cpu"))
    assert a is tmx._dft_matrix(25, False, torch.complex64, torch.device("cpu"))
    b = tmx._dft_matrix(25, False, torch.complex128, torch.device("cpu"))
    assert b.dtype == torch.complex128 and a.dtype == torch.complex64
    k = np.arange(25)
    # angles up to 2*pi*576/25 rad: a few ulps of 150 apart between libms
    np.testing.assert_allclose(b.numpy(), np.exp(-2j * np.pi * np.outer(k, k) / 25),
                               rtol=0, atol=1e-13)
    tw = tmx._twiddle(8, 5, True, torch.complex128, torch.device("cpu"))
    np.testing.assert_allclose(
        tw.numpy(), np.exp(2j * np.pi * np.outer(np.arange(8), np.arange(5)) / 40),
        rtol=0, atol=1e-13)
