"""Lag-bank correlation of the DLL/PLL loop: the hand-written Hopper
kernel (``csrc/lagbank.cu``) and its plain PyTorch version.

Replaces the JAX package's Pallas kernel ``ops/lagbank.py:lag_bank_pallas``
(``pl.pallas_call`` at ``lagbank.py:96``) and the bank's inline einsum
(``models/tracker.py:237-240``).  The reference receiver correlates each
channel's (codes, nobs) observations against 2*nlag+1 shifted replicas
with one DGEMM per channel per second (``rxcomplex.cpp:605``), then takes
power and phase (``rxcomplex.cpp:628-663``).

Two inputs, one kernel:

- :func:`lag_bank_correlate` — the JAX contract: ``obs_ri`` (2, C, K) and
  an explicit ``wav_lags`` (K, NL) -> power = 0.5(re^2+im^2),
  phase = atan2(-im, re)/2pi, both (C, NL);
- :func:`lag_bank_windows` — the bank's form: ``obs`` (G, 2, P, K) and the
  circular replica extension ``wav_ext`` (G, K + 2*nlag), whose lag l is
  the window ``wav_ext[g, 2*nlag - l : 2*nlag - l + K]`` -> power (with a
  caller-chosen scale), phase, re and im, each (G, P, NL).

On a CPU tensor each wrapper computes the plain version (einsum + atan2);
on a CUDA tensor it launches the kernel or raises — there is no fallback.
``lag_bank_kernel.launches`` counts kernel launches of both forms,
``lag_bank_correlate.launches`` those of the explicit form (the host
receiver's, ``models/dllpll.Receiver``).

Bound on the card (see the source note in ``csrc/lagbank.cu``): the
window form runs on the tensor cores as compensated 3xTF32 products
(``mma.sync`` m16n8k8, each operand split into two tf32 parts, each
stage's partial added to an IEEE fp32 sum: fp32-class error, so PARITY
deviation 12 holds), fed by ``cp.async.bulk`` copies of obs through a
shared-memory ring.  Its floor is reading obs once from device memory,
but on the H100 the products alone take longer than the copies alone
(``tools/gpu_lagbank_probe.py``): ``mma.sync``'s rate bounds it, and
``wgmma`` is the next step.  The bulk copies need 16-byte-aligned rows:
:func:`lag_bank_windows` pads obs with zeros to a K that is a multiple of
4 where it is not.  The explicit (K, NL) form stays on fp32 FFMA.
torch's own TF32 stays off (``check_no_tf32``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from amaranth_twstft_tpu_torch.utils import cuda_build
from amaranth_twstft_tpu_torch.utils.platform import check_no_tf32

__all__ = [
    "lag_bank_correlate",
    "lag_bank_windows",
    "lag_bank_plain",
    "lag_bank_windows_plain",
    "lag_bank_errors",
    "lag_bank_kernel",
    "K_BLOCK",
]

#: samples of K per thread block (a multiple of the kernel's 128-sample
#: staging step); the second pass sums ceil(K / K_BLOCK) partials
K_BLOCK = 2048

_TWO_PI = 2.0 * math.pi

_c_ll = ctypes.c_longlong
_c_int = ctypes.c_int
_c_ptr = ctypes.c_void_p
_ARGTYPES = (
    [_c_ptr, _c_ll, _c_ll, _c_ll]  # obs, strides g/c/p
    + [_c_ptr, _c_ll, _c_ll, _c_ll, _c_ll, _c_ll]  # w, g/n/l strides, off, len
    + [_c_int] * 5  # G, P, K, NL, kb
    + [ctypes.c_float]  # power scale
    + [_c_ptr] * 5  # part, power, phase, re, im
    + [_c_ptr]  # stream
)


def _lib_fn():
    lib = cuda_build.load("lagbank")
    fn = lib.lagbank_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(*ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"lag bank takes float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError("lag bank inputs lie on different devices")


def lag_bank_kernel(
    obs: torch.Tensor,
    w: torch.Tensor,
    *,
    G: int,
    P: int,
    K: int,
    NL: int,
    obs_strides: tuple[int, int, int],
    w_layout: tuple[int, int, int, int, int],
    power_scale: float,
):
    """Launch ``csrc/lagbank.cu`` on CUDA tensors (no synchronisation).

    ``obs``: float32 with unit stride along n and element strides
    ``obs_strides = (channel, re/im, code)``; ``w``: float32 with
    ``W_g[n,l] = w.flat[g*ws_g + off + n*ws_n + l*ws_l]`` for
    ``w_layout = (ws_g, ws_n, ws_l, off, extent)`` (reads outside
    ``[0, extent)`` of a channel's row count as zero).  The window layout
    ``ws_n = 1, ws_l = -1`` takes the tensor-core kernel, which needs a
    16-byte-aligned ``obs`` and strides and K that are multiples of 4 (the
    launch fails otherwise).  Returns power, phase, re, im, each
    (G, P, NL) float32.
    """
    if obs.device.type != "cuda" or w.device.type != "cuda":
        raise ValueError("lag_bank_kernel needs CUDA tensors")
    check_no_tf32()
    fn = _lib_fn()
    dev = obs.device
    nchunk = -(-K // K_BLOCK)
    part = torch.empty(G * nchunk * 2 * P * NL, dtype=torch.float32, device=dev)
    outs = [torch.empty((G, P, NL), dtype=torch.float32, device=dev)
            for _ in range(4)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            obs.data_ptr(), *obs_strides,
            w.data_ptr(), *w_layout,
            G, P, K, NL, K_BLOCK, power_scale,
            part.data_ptr(), *(o.data_ptr() for o in outs),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"lagbank kernel launch failed (cudaError {err})")
    lag_bank_kernel.launches += 1
    return tuple(outs)


lag_bank_kernel.launches = 0


def _epilogue(re, im, power_scale):
    power = power_scale * (re * re + im * im)
    phase = torch.atan2(-im, re) / _TWO_PI
    return power, phase


def lag_bank_plain(obs_ri: torch.Tensor, wav_lags: torch.Tensor):
    """Plain version of :func:`lag_bank_correlate`: two fp32 products."""
    if obs_ri.device.type == "cuda":
        check_no_tf32()
    re = obs_ri[0] @ wav_lags
    im = obs_ri[1] @ wav_lags
    return _epilogue(re, im, 0.5)


def lag_bank_correlate(obs_ri: torch.Tensor, wav_lags: torch.Tensor):
    """Power/phase lag bank, ``obs_ri`` (2, C, K) x ``wav_lags`` (K, NL)
    -> power, phase (C, NL).

    SIGN CONVENTION: ``phase`` is ``atan2(-im, re)`` — the reference
    DGEMM epilogue's convention (``rxcomplex.cpp:1070``), the CONJUGATE of
    the residual carrier phase under an ``exp(-j2pi ft)`` downconversion
    (PARITY.md deviation 8).
    """
    _check_inputs(obs_ri, wav_lags)
    if obs_ri.dim() != 3 or obs_ri.shape[0] != 2 or wav_lags.dim() != 2:
        raise ValueError("expected obs_ri (2, C, K) and wav_lags (K, NL)")
    _, C, K = obs_ri.shape
    if wav_lags.shape[0] != K:
        raise ValueError(f"K mismatch: {K} vs {wav_lags.shape[0]}")
    NL = wav_lags.shape[1]
    if obs_ri.device.type == "cpu":
        return lag_bank_plain(obs_ri, wav_lags)
    obs = obs_ri.contiguous()
    w = wav_lags.contiguous()
    power, phase, _, _ = lag_bank_kernel(
        obs, w, G=1, P=C, K=K, NL=NL,
        obs_strides=(0, C * K, K),
        w_layout=(0, NL, 1, 0, K * NL),
        power_scale=0.5,
    )
    lag_bank_correlate.launches += 1
    return power[0], phase[0]


lag_bank_correlate.launches = 0


def lag_bank_windows_plain(
    obs: torch.Tensor, wav_ext: torch.Tensor, nlag: int,
    power_scale: float = 0.5,
):
    """Plain version of :func:`lag_bank_windows`: einsum over the
    replica's sliding windows, lags flipped back to ``l = 2*nlag - s``."""
    if obs.device.type == "cuda":
        check_no_tf32()
    K = obs.shape[-1]
    win = wav_ext.unfold(-1, K, 1)  # (G, NL, K): win[g, s] = wav_ext[g, s:s+K]
    re = torch.einsum("gpn,gsn->gps", obs[:, 0], win).flip(-1)
    im = torch.einsum("gpn,gsn->gps", obs[:, 1], win).flip(-1)
    power, phase = _epilogue(re, im, power_scale)
    return power, phase, re, im


def lag_bank_errors(out, ref) -> tuple[float, float]:
    """Errors of a lag bank's ``(power, phase, ...)`` against a reference
    result, in float64: the largest power error over its row's maximum,
    and the largest phase error in cycles wherever the reference power is
    at least 1e-3 x the row maximum."""
    pk, phk = out[0].double(), out[1].double()
    pp, php = ref[0].double(), ref[1].double()
    rowmax = pp.amax(-1, keepdim=True)
    dph = (torch.remainder(phk - php + 0.5, 1.0) - 0.5).abs()
    return (float(((pk - pp).abs() / rowmax).max()),
            float(dph[pp >= 1e-3 * rowmax].max()))


def lag_bank_windows(
    obs: torch.Tensor, wav_ext: torch.Tensor, nlag: int,
    power_scale: float = 0.5,
):
    """The bank's lag bank: ``obs`` (G, 2, P, K) against lag l of channel
    g = ``wav_ext[g, 2*nlag - l + n]`` (the circular extension, so lag l is
    ``roll(wav, l - nlag)``) -> power = power_scale*(re^2+im^2), phase =
    atan2(-im, re)/2pi, re, im, each (G, P, 2*nlag+1)."""
    _check_inputs(obs, wav_ext)
    if obs.dim() != 4 or obs.shape[1] != 2 or wav_ext.dim() != 2:
        raise ValueError("expected obs (G, 2, P, K) and wav_ext (G, E)")
    G, _, P, K = obs.shape
    E = wav_ext.shape[1]
    if wav_ext.shape[0] != G or E != K + 2 * nlag:
        raise ValueError(
            f"wav_ext {tuple(wav_ext.shape)} does not extend K={K} by "
            f"2*nlag={2 * nlag} for {G} channels"
        )
    if obs.device.type == "cpu":
        return lag_bank_windows_plain(obs, wav_ext, nlag, power_scale)
    obs = obs.contiguous()
    pad = -K % 4
    if pad or obs.data_ptr() % 16:
        # the kernel's bulk copies take whole, 16-byte-aligned float4 rows;
        # zero samples past K add nothing to the sums
        obs = torch.nn.functional.pad(obs, (0, pad)) if pad else obs.clone()
    K4 = K + pad
    w = wav_ext.contiguous()
    return lag_bank_kernel(
        obs, w, G=G, P=P, K=K4, NL=2 * nlag + 1,
        obs_strides=(2 * P * K4, P * K4, K4),
        w_layout=(E, 1, -1, 2 * nlag, E),
        power_scale=power_scale,
    )
