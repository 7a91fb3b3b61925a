"""The production C++ batch chain (``processing/CPP/main.cpp``
"GoRanging"), in torch.

The port's counterpart of the JAX package's ``models/goranging.py``.
Differences from the archived Octave chain (:mod:`.godual`), each a
reference behaviour:

- **fixed per-file df**: one decimated pre-pass fixes df1/df2 for every
  epoch (``main.cpp:363-450``),
- channel 2's pre-pass argmax searches the whole decimated spectrum
  (``main.cpp:442`` quirk, kept),
- the code spectrum is Hamming-windowed in natural order
  (``main.cpp:717-719``),
- output convention: ``correction1`` = indice + correction, ``SNR1`` in
  dB, complex ``xval*``; output name ``<stem>C.mat`` with a ``remote``
  prefix when remote (``main.cpp:540-651,786-798``).

On the card in complex64 the epochs go through the bound ranging step
(fast fine-window path, fixed df), as in the JAX package's accelerator
branch; on the CPU, and in complex128 on either device, through the full
zoom-IFFT correlator, as in its host branch.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from amaranth_twstft_tpu_torch.config import ProcessingConfig, SignalConfig
from amaranth_twstft_tpu_torch.models.godual import (
    _NP_COMPLEX,
    ChannelArrays,
    build_replica,
)
from amaranth_twstft_tpu_torch.ops import boundary
from amaranth_twstft_tpu_torch.ops.correlator import correlate_epochs
from amaranth_twstft_tpu_torch.ops.doppler import (
    PREPASS_MAX_SAMPLES,
    bound_prepass_window,
    per_file_df,
)
from amaranth_twstft_tpu_torch.utils import io, matio
from amaranth_twstft_tpu_torch.utils.platform import resolve_device

__all__ = ["process_file", "default_mat_name"]


def default_mat_name(capture_path: str, remote: bool) -> str:
    """``data.bin -> dataC.mat`` (+ ``remote`` prefix), ``main.cpp:786-798``."""
    d = os.path.dirname(capture_path) or "."
    stem = os.path.basename(capture_path)
    if stem.endswith(".bin"):
        stem = stem[: -len(".bin")]
    prefix = "remote" if remote else ""
    return os.path.join(d, prefix + stem + "C.mat")


def process_file(
    capture_path: str,
    code_path: str,
    signal: SignalConfig,
    proc: ProcessingConfig | None = None,
    remote: bool = False,
    foffset_hz: float = 0.0,
    batch_epochs: int = 25,
    out_mat: str | None = None,
    dtype=torch.complex64,
    device=None,
) -> dict:
    """Run the GoRanging chain over one capture file on ``device``
    (default ``cuda``); the code spectrum is always Hamming-windowed."""
    dev = resolve_device(device)
    proc = proc or ProcessingConfig(hamming_window=True)
    if not proc.hamming_window:
        proc = dataclasses.replace(proc, hamming_window=True)
    rep = build_replica(code_path, signal, proc, conjugate=True, dtype=dtype)
    L = rep.samples_per_code
    np_dtype = _NP_COMPLEX[dtype]

    # --- per-file df pre-pass (decimated squaring FFT) -----------------
    dec = bound_prepass_window(io.decimate_sc16(
        capture_path, proc.df_decimation, channels=2, dtype=np_dtype,
        max_out=PREPASS_MAX_SAMPLES,
    ))

    def _pfd(x, windowed):
        return float(per_file_df(
            torch.as_tensor(x).to(dev), signal.fs, proc.df_decimation,
            foffset_hz=foffset_hz, windowed=windowed,
        ))

    dfs = [_pfd(dec[0], True)]
    if not remote:
        dfs.append(_pfd(dec[1], False))  # main.cpp:442 searches it all

    # --- epoch loop with fixed df --------------------------------------
    n_chan = 1 if remote else 2
    chans = [ChannelArrays() for _ in range(n_chan)]
    use_step = dev.type == "cuda" and dtype == torch.complex64
    if use_step:
        step = boundary.make_ranging_step(
            rep.fcode, rep.code_interp, np.ones(L, bool), signal.fs,
            nint=proc.nint, device=dev,
        )
    else:
        fcode = torch.as_tensor(rep.fcode, device=dev)
        code3 = torch.as_tensor(rep.code_interp, device=dev)
        fcode3 = torch.as_tensor(rep.fcode_interp, device=dev)
    start = 0
    while True:
        d, n = io.read_sc16_epochs(capture_path, start, batch_epochs, L,
                                   channels=2, dtype=np_dtype)
        if n == 0:
            break
        start += n * L
        for c in range(n_chan):
            dc = torch.as_tensor(d[c, :n]).to(dev)
            if use_step:
                res = boundary.to_epoch_result(
                    step(torch.view_as_real(dc), df_fixed=dfs[c]))
                df_vec = np.full((n,), dfs[c])
            else:
                df_vec = torch.full((n,), dfs[c], dtype=code3.dtype, device=dev)
                res = correlate_epochs(
                    dc, fcode, df_vec, code3, signal.fs,
                    nint=proc.nint, fcode_interp=fcode3,
                )
            chans[c].extend(res, df_vec)
        if n < batch_epochs:
            break

    out = {
        "ch1": chans[0].asdict(),
        "ch2": chans[1].asdict() if n_chan == 2 else None,
        "df": dfs,
    }
    out_mat = out_mat or default_mat_name(capture_path, remote)
    matio.save_c_style(out_mat, out["ch1"], out["ch2"])
    out["mat_path"] = out_mat
    return out
