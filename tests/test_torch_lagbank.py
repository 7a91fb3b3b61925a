"""The port's lag bank (plain version, CPU) against the JAX package's
XLA dots and its Pallas kernel in interpret mode."""

import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amaranth_twstft_tpu.ops.lagbank import _lag_bank_jnp, lag_bank_pallas
from amaranth_twstft_tpu_torch.ops import lagbank as tlb
from amaranth_twstft_tpu_torch.utils import cuda_build

# float32 sums over K ~ 3e3 terms in different orders: power rtol 2e-4
# (as tests/test_lagbank.py holds Pallas against the dots), phase atol
# 1e-5 cycles
POWER_RTOL = 2e-4
PHASE_ATOL = 1e-5


def _phase_diff(a, b):
    return np.abs(np.mod(np.asarray(a) - np.asarray(b) + 0.5, 1.0) - 0.5)


@pytest.mark.parametrize("c,k,nl", [(6, 3000, 11), (24, 2000, 17), (5, 257, 57)])
def test_plain_matches_jax_dots_and_pallas(c, k, nl):
    rng = np.random.default_rng(c * 1000 + nl)
    obs = rng.normal(size=(2, c, k)).astype(np.float32)
    wav = rng.normal(size=(k, nl)).astype(np.float32)
    pw, ph = tlb.lag_bank_correlate(torch.from_numpy(obs), torch.from_numpy(wav))
    pw_j, ph_j = _lag_bank_jnp(jnp.asarray(obs), jnp.asarray(wav))
    pw_p, ph_p = lag_bank_pallas(
        jnp.asarray(obs), jnp.asarray(wav), interpret=True, k_chunk=1024
    )
    for ref_pw, ref_ph in ((pw_j, ph_j), (pw_p, ph_p)):
        np.testing.assert_allclose(pw.numpy(), np.asarray(ref_pw), rtol=POWER_RTOL)
        assert _phase_diff(ph.numpy(), ref_ph).max() < PHASE_ATOL


@pytest.mark.parametrize("g,p,k,nlag", [(3, 7, 1000, 8), (2, 24, 2000, 28)])
def test_windows_match_rolled_lag_matrix(g, p, k, nlag):
    """The bank's shifted-window form equals the explicit np.roll lag
    matrix of the host receiver (dllpll.py:539-545) — lag l is
    roll(wav, l - nlag) — and its re/im are the products' parts."""
    rng = np.random.default_rng(g * 10 + p)
    obs = rng.normal(size=(g, 2, p, k)).astype(np.float32)
    wav = rng.normal(size=(g, k)).astype(np.float32)
    wav_ext = np.concatenate([wav[:, -nlag:], wav, wav[:, :nlag]], axis=1)
    power, phase, re, im = tlb.lag_bank_windows(
        torch.from_numpy(obs), torch.from_numpy(wav_ext), nlag, power_scale=0.5
    )
    assert power.shape == (g, p, 2 * nlag + 1)
    for i in range(g):
        lags = np.arange(-nlag, nlag + 1)
        W = np.stack([np.roll(wav[i], lag) for lag in lags], axis=1)
        pw_j, ph_j = _lag_bank_jnp(jnp.asarray(obs[i]), jnp.asarray(W))
        np.testing.assert_allclose(power[i].numpy(), np.asarray(pw_j), rtol=POWER_RTOL)
        assert _phase_diff(phase[i].numpy(), ph_j).max() < PHASE_ATOL
        re64 = obs[i, 0].astype(np.float64) @ W
        im64 = obs[i, 1].astype(np.float64) @ W
        scale = np.abs(re64).max() + np.abs(im64).max()
        assert np.abs(re[i].numpy() - re64).max() < 1e-5 * scale
        assert np.abs(im[i].numpy() - im64).max() < 1e-5 * scale


def test_power_scale_and_shape_checks():
    rng = np.random.default_rng(5)
    obs = torch.from_numpy(rng.normal(size=(1, 2, 3, 64)).astype(np.float32))
    wav_ext = torch.from_numpy(rng.normal(size=(1, 64 + 4)).astype(np.float32))
    p1, _, re, im = tlb.lag_bank_windows(obs, wav_ext, 2, power_scale=0.5)
    p2, _, _, _ = tlb.lag_bank_windows(obs, wav_ext, 2, power_scale=2.0)
    np.testing.assert_allclose(p2.numpy(), 4.0 * p1.numpy(), rtol=1e-6)
    np.testing.assert_allclose(
        p1.numpy(), 0.5 * (re.numpy() ** 2 + im.numpy() ** 2), rtol=1e-6
    )
    with pytest.raises(ValueError):
        tlb.lag_bank_windows(obs, wav_ext[:, :-1], 2)
    with pytest.raises(TypeError):
        tlb.lag_bank_windows(obs.double(), wav_ext.double(), 2)
    with pytest.raises(ValueError):
        tlb.lag_bank_correlate(obs[0], torch.zeros(63, 5))


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel entry takes CUDA tensors only; CPU tensors reach the
    plain version through the public wrappers, never the kernel."""
    before = tlb.lag_bank_kernel.launches
    obs = torch.zeros(1, 2, 4, 256)
    wav_ext = torch.zeros(1, 256 + 4)
    with pytest.raises(ValueError):
        tlb.lag_bank_kernel(
            obs, wav_ext, G=1, P=4, K=256, NL=5,
            obs_strides=(2 * 4 * 256, 4 * 256, 256),
            w_layout=(260, 1, -1, 4, 260), power_scale=0.5,
        )
    tlb.lag_bank_windows(obs, wav_ext, 2)
    assert tlb.lag_bank_kernel.launches == before


# -- the window kernel's compensated 3xTF32 arithmetic, emulated ------------
def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest tf32 value (ties away from zero, as
    ``cvt.rna.tf32.f32``): add half of the 13 dropped bits, clear them."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _split_tf32(x: torch.Tensor):
    big = _tf32(x)
    return big, _tf32(x - big)


def _lag_bank_tf32(obs, wav_ext, nlag, passes):
    """The window kernel's products in plain torch: both operands split
    into tf32 parts, products of tf32 values (exact in float32) summed in
    float32 — ``small*big + big*small + big*big`` with ``passes=3``, only
    ``big*big`` (one TF32 pass) with ``passes=1``.  Returns power (scale
    0.5) and phase as ``lag_bank_windows`` does."""
    K = obs.shape[-1]
    win = wav_ext.unfold(-1, K, 1)  # (G, NL, K): lag 2*nlag - s
    ob, osm = _split_tf32(obs)
    wb, wsm = _split_tf32(win)
    terms = [(ob, wb)] if passes == 1 else [(osm, wb), (ob, wsm), (ob, wb)]
    re = sum(torch.einsum("gpn,gsn->gps", o[:, 0], w) for o, w in terms).flip(-1)
    im = sum(torch.einsum("gpn,gsn->gps", o[:, 1], w) for o, w in terms).flip(-1)
    return 0.5 * (re * re + im * im), torch.atan2(-im, re) / (2 * np.pi)


def test_tf32_split_parts():
    """tf32 parts have 13 zero low bits, round to nearest, and big + small
    carries x to about 2^-22 of |x| (a one-part tf32 keeps 2^-11)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(
        (rng.normal(size=4096) * 10.0 ** rng.uniform(-6, 6, 4096)).astype(np.float32)
    )
    big, small = _split_tf32(x)
    for part in (big, small):
        assert bool(((part.view(torch.int32) & 0x1FFF) == 0).all())
    x64 = x.double()
    assert float(((x64 - big.double()).abs() / x64.abs()).max()) <= 2.0 ** -11
    err = (x64 - big.double() - small.double()).abs() / x64.abs()
    assert float(err.max()) <= 2.0 ** -21


@pytest.mark.parametrize("g,p,k,nlag", [(1, 5, 257, 2), (3, 7, 1000, 8), (2, 24, 2000, 28)])
def test_tf32x3_split_holds_fp32_tolerances(g, p, k, nlag):
    """The 3xTF32 split against float64, the float32 plain version and the
    JAX package's dots, within this file's tolerances; one TF32 pass
    fails the same bar (PARITY deviation 12)."""
    rng = np.random.default_rng(k + nlag)
    obs = rng.normal(size=(g, 2, p, k)).astype(np.float32)
    wav_ext = rng.normal(size=(g, k + 2 * nlag)).astype(np.float32)
    obs_t, wav_t = torch.from_numpy(obs), torch.from_numpy(wav_ext)
    pw3, ph3 = _lag_bank_tf32(obs_t, wav_t, nlag, passes=3)
    pw1, ph1 = _lag_bank_tf32(obs_t, wav_t, nlag, passes=1)
    pw32, ph32, _, _ = tlb.lag_bank_windows(obs_t, wav_t, nlag)
    # float64 and the JAX package's dots on the explicit lag matrix
    # W[n, l] = wav_ext[2*nlag - l + n]
    idx = 2 * nlag - np.arange(2 * nlag + 1)[None, :] + np.arange(k)[:, None]
    W = wav_ext[:, idx]  # (g, K, NL)
    re64 = np.einsum("gpn,gnl->gpl", obs[:, 0].astype(np.float64), W)
    im64 = np.einsum("gpn,gnl->gpl", obs[:, 1].astype(np.float64), W)
    jax_out = [_lag_bank_jnp(jnp.asarray(obs[i]), jnp.asarray(W[i])) for i in range(g)]
    refs = {
        "float64": (0.5 * (re64**2 + im64**2), np.arctan2(-im64, re64) / (2 * np.pi)),
        "float32 plain": (pw32.numpy(), ph32.numpy()),
        "jax": tuple(np.stack([np.asarray(o[j]) for o in jax_out]) for j in (0, 1)),
    }
    for name, (ref_pw, ref_ph) in refs.items():
        np.testing.assert_allclose(pw3.numpy(), ref_pw, rtol=POWER_RTOL, err_msg=name)
        assert _phase_diff(ph3.numpy(), ref_ph).max() < PHASE_ATOL, name
    ref_pw, ref_ph = refs["float64"]
    one_pass_err = np.abs(pw1.numpy() / ref_pw - 1).max()
    assert one_pass_err > 2 * POWER_RTOL or _phase_diff(ph1.numpy(), ref_ph).max() > PHASE_ATOL


# -- the explicit form's split of K (pure Python; the kernel's launcher
#    picks its ring and shared memory, tested on the card) ---------------
@pytest.mark.parametrize("g,k,n_sm", [
    (1, 200_000, 132),  # the host receiver's shape on an H100 SXM
    (1, 200_000, 114),  # an H100 PCIe
    (1, 257, 132),
    (1, 4099, 132),
    (3, 2000, 132),
    (8, 200_000, 132),  # a group of 8 channels, as the sharded step batches them
])
def test_explicit_chunk_covers_k_and_fills_the_card(g, k, n_sm):
    chunk = tlb.explicit_chunk(g, k, n_sm)
    nchunk = -(-k // chunk)
    # the chunks cover K exactly, and each starts on a 16-byte-aligned row
    assert (nchunk - 1) * chunk < k <= nchunk * chunk
    assert chunk % 4 == 0
    # two blocks per SM, unless K is too short for that many chunks
    assert g * nchunk >= 2 * n_sm or chunk == 64
    if (g, k, n_sm) == (1, 200_000, 132):
        assert (chunk, nchunk) == (760, 264)


def test_argtypes_match_the_c_entry():
    """The ctypes binding of ``lagbank_launch`` has the C declaration's
    arguments, type for type (a mismatch would only show on the card)."""
    with open(os.path.join(cuda_build.CSRC, "lagbank.cu")) as f:
        src = f.read()
    decl = re.search(r'extern "C" int lagbank_launch\((.*?)\)', src, re.S).group(1)
    kinds = {"long long": ctypes.c_longlong, "int": ctypes.c_int,
             "float": ctypes.c_float}
    want = []
    for arg in decl.split(","):
        ctype = arg.strip().rsplit(" ", 1)[0].removeprefix("const ")
        want.append(ctypes.c_void_p if ctype.endswith("*") else kinds[ctype])
    assert want == list(tlb._ARGTYPES)
