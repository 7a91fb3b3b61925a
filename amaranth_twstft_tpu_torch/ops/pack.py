"""The banked receiver's pack of a second on the device: the hand-written
Hopper kernel (``csrc/pack.cu``) and its plain PyTorch version.

Replaces no Pallas kernel: the JAX package packs each second on the host
(``models/tracker.BankedReceiver._pack_second``), as the port's CPU path
still does.  On the card the receiver uploads the read's samples as
float32 re/im rows and :func:`pack_rows` makes, in one pass over them, the
float16 rows the tracking and acquisition steps read (the host pack's
``astype(np.float16)``, round to nearest even, so the same bits) and the
statistics the host pack took: each row's noise power (its mean of
re^2 + im^2 over the second's first ``nsum`` samples, in float64) and the
peak ``max |x|`` of ``transfer="auto"``'s range check.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor
it launches the kernel or raises (no fallback).  ``pack_rows.launches``
counts kernel launches.  Bytes bind the kernel: 124.8 MB read and written
at the receiver's (2, 5 200 000) rows, 0.037 ms at 3.35 TB/s (see the note
in ``csrc/pack.cu``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from amaranth_twstft_tpu_torch.utils import cuda_build

__all__ = ["pack_rows", "pack_rows_plain"]

_c_ll = ctypes.c_longlong
_c_int = ctypes.c_int
_c_ptr = ctypes.c_void_p

_ARGTYPES = [_c_ptr, _c_int, _c_ll, _c_ll, _c_ptr, _c_ptr, _c_ll, _c_ptr, _c_int, _c_ptr]

#: each (device, stream)'s workspace of per-block partials, grown when a
#: launch needs more, never per call
_WORKSPACES: dict[tuple[int, int], torch.Tensor] = {}


@functools.cache
def _lib():
    lib = cuda_build.load("pack")
    lib.pack_rows_launch.argtypes = _ARGTYPES
    lib.pack_rows_launch.restype = ctypes.c_int
    lib.pack_rows_workspace_bytes.argtypes = [_c_int, _c_ll]
    lib.pack_rows_workspace_bytes.restype = _c_ll
    return lib


def pack_rows_plain(x: torch.Tensor, nsum: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`pack_rows`: ``x`` (R, S, 2) float32 ->
    (``x`` as float16, the (R + 1,) float64 statistics)."""
    px = (x[:, :nsum].double() ** 2).sum(dim=(1, 2)) / nsum
    peak = x.abs().amax().double().reshape(1)
    return x.to(torch.float16), torch.cat([px, peak])


def _check(x: torch.Tensor, nsum: int, half: torch.Tensor | None,
           stats: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() != 3 or x.shape[2] != 2 or not x.is_contiguous():
        raise ValueError("pack_rows takes contiguous (R, S, 2) float32 rows")
    if not 0 < nsum <= x.shape[1]:
        raise ValueError(f"nsum {nsum} is outside the rows' {x.shape[1]} samples")
    if half is not None and (half.dtype != torch.float16 or half.shape != x.shape
                             or not half.is_contiguous() or half.device != x.device):
        raise ValueError("half must be a contiguous float16 tensor shaped as x, beside it")
    if (stats.dtype != torch.float64 or stats.shape != (x.shape[0] + 1,)
            or not stats.is_contiguous() or stats.device != x.device):
        raise ValueError("stats must be (R + 1,) contiguous float64 beside x")


def pack_rows(x: torch.Tensor, nsum: int, half: torch.Tensor | None,
              stats: torch.Tensor) -> None:
    """Write ``x`` (R, S, 2) float32 rounded to float16 into ``half`` (none
    where ``half`` is None), and into ``stats`` (R + 1,) float64 each row's
    mean of re^2 + im^2 over its first ``nsum`` samples, then ``max |x|``
    over all of ``x``.

    On the card: one launch of ``csrc/pack.cu`` (two kernels) on the
    current stream, no synchronisation; the sums are taken in a fixed
    order, so two launches give the same bits.  The plain version sums in
    torch's order: the statistics agree to float64 rounding.
    """
    _check(x, nsum, half, stats)
    if x.device.type == "cpu":
        h, s = pack_rows_plain(x, nsum)
        if half is not None:
            half.copy_(h)
        stats.copy_(s)
        return
    if x.device.type != "cuda":
        raise ValueError(f"pack_rows runs on the CPU or a CUDA device, not {x.device}")
    lib = _lib()
    dev = x.device
    rows, row_floats = x.shape[0], 2 * x.shape[1]
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    need = lib.pack_rows_workspace_bytes(rows, row_floats)
    work = _WORKSPACES.get((dev.index, stream))
    if work is None or work.numel() < need:
        work = torch.empty(need, dtype=torch.uint8, device=dev)
        _WORKSPACES[(dev.index, stream)] = work
    err = lib.pack_rows_launch(x.data_ptr(), rows, row_floats, nsum,
                               None if half is None else half.data_ptr(),
                               work.data_ptr(), work.numel(), stats.data_ptr(),
                               dev.index, stream)
    if err != 0:
        raise RuntimeError(f"pack kernel launch failed (cudaError {err})")
    pack_rows.launches += 1


pack_rows.launches = 0
