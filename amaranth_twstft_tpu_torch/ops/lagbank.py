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

Bound on the card (see the source note in ``csrc/lagbank.cu``): both
forms run on the tensor cores as compensated 3xTF32 products (``mma.sync``
m16n8k8, each operand split into two tf32 parts, each stage's partial
added to an IEEE fp32 sum: fp32-class error, so PARITY deviation 12
holds), fed by ``cp.async.bulk`` copies through a shared-memory ring.
The window form's floor is reading obs once, but on the H100 its
products alone take longer than its copies alone
(``tools/gpu_lagbank_probe.py``): ``mma.sync``'s rate bounds it, and
``wgmma`` is the next step.  The explicit (K, NL) form streams both obs
and the lag matrix (one bulk copy per obs row and one per stage of matrix
rows) over a split-K grid of two resident blocks per SM
(:func:`explicit_chunk`); its floor is reading both once (0.0251 ms
at the host receiver's (2, 24, 200 000) x (200 000, 57)), with the
products (0.0066 ms at the TF32 peak) under the copies.  The bulk copies
need 16-byte-aligned rows: the wrappers pad obs with zeros to a K that is
a multiple of 4 where it is not, and copy a lag matrix only when its data
is not 16-byte aligned.  torch's own TF32 stays off (``check_no_tf32``).
"""

from __future__ import annotations

import ctypes
import functools
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
    "explicit_chunk",
    "K_BLOCK",
]

#: samples of K per thread block (a multiple of the kernel's 128-sample
#: staging step); the second pass sums ceil(K / K_BLOCK) partials
K_BLOCK = 2048

#: K-chunks per SM and channel that the explicit form's split aims at:
#: its launcher keeps two blocks resident per SM
_CHUNKS_PER_SM = 2
#: the explicit form's shortest chunk, samples: a block's set-up and the
#: write of its partial stay small against the samples it reads
_MIN_CHUNK = 64

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
    + [_c_int, _c_ptr]  # device, stream
)


@functools.cache
def _lib_fn():
    lib = cuda_build.load("lagbank")
    fn = lib.lagbank_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_inputs(*ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"lag bank takes float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError("lag bank inputs lie on different devices")


def explicit_chunk(G: int, K: int, n_sm: int) -> int:
    """Samples of K per block of the explicit form: a multiple of 4, so
    that every chunk's rows start 16-byte aligned, that splits each of
    the G channels' K into enough chunks for two blocks on each of
    ``n_sm`` SMs (264 chunks of 760 at K = 200 000, G = 1 on an H100's
    132 SMs), and at least ``_MIN_CHUNK``.  The second pass sums
    ceil(K / chunk) partials; the kernel's launcher picks its ring and
    shared memory."""
    want = -(-_CHUNKS_PER_SM * n_sm // G)
    return max(_MIN_CHUNK, 4 * -(-K // (4 * want)))


def _launch(obs, w, G, P, K, NL, obs_strides, w_layout, power_scale) -> torch.Tensor:
    """One launch of the kernel (see :func:`lag_bank_kernel`); returns
    power, phase, re and im stacked, (4, G, P, NL).  Host time per call
    matters here: at the host shape the kernels take ~0.04 ms."""
    if obs.device.type != "cuda" or w.device.type != "cuda":
        raise ValueError("lag_bank_kernel needs CUDA tensors")
    check_no_tf32()
    dev = obs.device
    kb = explicit_chunk(G, K, _sm_count(dev.index)) if w_layout[2] == 1 else K_BLOCK
    nchunk = -(-K // kb)
    part = torch.empty(G * nchunk * 2 * P * NL, dtype=torch.float32, device=dev)
    out = torch.empty((4, G, P, NL), dtype=torch.float32, device=dev)
    base, n = out.data_ptr(), 4 * G * P * NL  # bytes of one output
    err = _lib_fn()(
        obs.data_ptr(), *obs_strides,
        w.data_ptr(), *w_layout,
        G, P, K, NL, kb, power_scale,
        part.data_ptr(), base, base + n, base + 2 * n, base + 3 * n,
        dev.index, torch._C._cuda_getCurrentRawStream(dev.index),
    )
    if err != 0:
        raise RuntimeError(f"lagbank kernel launch failed (cudaError {err})")
    lag_bank_kernel.launches += 1
    return out


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
    """Launch ``csrc/lagbank.cu`` on CUDA tensors, on the current stream
    of their device (no synchronisation).

    ``obs``: float32 with unit stride along n and element strides
    ``obs_strides = (channel, re/im, code)``; ``w``: float32 with
    ``W_g[n,l] = w.flat[g*ws_g + off + n*ws_n + l*ws_l]`` for
    ``w_layout = (ws_g, ws_n, ws_l, off, extent)``.  Two layouts:

    - the window layout ``ws_n = 1, ws_l = -1`` (reads outside
      ``[0, extent)`` of a channel's row count as zero) needs a
      16-byte-aligned ``obs`` and strides and K that are multiples of 4;
    - the row-major layout ``ws_l = 1, ws_n >= NL`` (the explicit form,
      split by :func:`explicit_chunk`) needs a 16-byte-aligned ``obs``
      with strides that are multiples of 4 and rows that hold K rounded
      up to 4 floats, ``w``'s data plus ``off`` 16-byte aligned, ``ws_g``
      a multiple of 4, every read inside ``[0, extent)``, and a pitch
      ``ws_n`` for which the kernel's two-stage ring fits one block's
      shared memory.

    The launch fails on any other layout or alignment.  Returns power,
    phase, re, im, each (G, P, NL) float32.
    """
    return _launch(obs, w, G, P, K, NL, obs_strides, w_layout, power_scale).unbind(0)


lag_bank_kernel.launches = 0


def _aligned_obs(obs: torch.Tensor) -> torch.Tensor:
    """``obs`` contiguous, 16-byte aligned and padded with zeros to a
    multiple of 4 samples, as the kernels' bulk copies take its rows (zero
    samples past K add nothing to the sums)."""
    obs = obs.contiguous()
    pad = -obs.shape[-1] % 4
    if pad:
        return torch.nn.functional.pad(obs, (0, pad))
    return obs.clone() if obs.data_ptr() % 16 else obs


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
    obs = _aligned_obs(obs_ri)
    K4 = obs.shape[-1]
    # the receiver's cached matrix is aligned: no per-call copy of it
    w = wav_lags.contiguous()
    if w.data_ptr() % 16:
        w = w.clone()
    out = _launch(obs, w, 1, C, K, NL, (0, C * K4, K4), (0, NL, 1, 0, K * NL), 0.5)
    lag_bank_correlate.launches += 1
    return out[0, 0], out[1, 0]


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
    obs = _aligned_obs(obs)
    K4 = obs.shape[-1]
    w = wav_ext.contiguous()
    return lag_bank_kernel(
        obs, w, G=G, P=P, K=K4, NL=2 * nlag + 1,
        obs_strides=(2 * P * K4, P * K4, K4),
        w_layout=(E, 1, -1, 2 * nlag, E),
        power_scale=power_scale,
    )
