"""The archived dual-channel ranging chain (Octave ``godual_ranging.m``),
in torch.

The port's counterpart of the JAX package's ``models/godual.py``.
File-level behaviour (``processing/Octave/godual_ranging.m:57-133``):

- the capture is consumed one code period at a time; a short final read
  ends the loop (``godual_ranging.m:75-102``),
- channel 1 (measurement) and channel 2 (loopback reference) are both
  processed when local, only channel 1 when remote
  (``godual_ranging.m:79-99``),
- the df search window is +/-20 kHz local, 80..120 kHz remote with an
  OP-dependent sign (``godual_ranging.m:83-90``),
- outputs are saved as ``.mat`` in the Octave field convention, remote
  outputs prefixed ``remote`` (``godual_ranging.m:126-131``).

On the card (complex64) each channel's batch goes through the bound
ranging step (:func:`ops.boundary.make_ranging_step`, the fast
fine-window path with the per-epoch masked df), as the JAX package's
accelerator branch does; on the CPU, and in complex128 on either device,
the chain calls the per-epoch df and the full zoom-IFFT correlator
directly, as its host branch does.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from amaranth_twstft_tpu_torch.config import (
    ProcessingConfig,
    SignalConfig,
    StationConfig,
)
from amaranth_twstft_tpu_torch.ops import boundary, doppler
from amaranth_twstft_tpu_torch.ops.correlator import EpochResult, correlate_epochs
from amaranth_twstft_tpu_torch.ops.lfsr import read_prn_file
from amaranth_twstft_tpu_torch.ops.prn import (
    chips_to_pm1,
    code_spectrum,
    interp_code,
    upsample_zoh,
)
from amaranth_twstft_tpu_torch.utils import io, matio
from amaranth_twstft_tpu_torch.utils.platform import resolve_device

__all__ = ["Replica", "build_replica", "df_window", "ChannelArrays", "process_file"]

_NP_COMPLEX = {torch.complex64: np.complex64, torch.complex128: np.complex128}


@dataclass(frozen=True)
class Replica:
    """Everything derived from the PRN code file (host NumPy arrays)."""

    code: np.ndarray  # +/-1 at fs (L,)
    fcode: np.ndarray  # replica spectrum (conjugated unless claudio)
    code_interp: np.ndarray  # +/-1 on the (2*nint+1) grid
    fcode_interp: np.ndarray  # conj FFT of code_interp (SNR identity)
    samples_per_code: int


def build_replica(
    code_path: str,
    signal: SignalConfig,
    proc: ProcessingConfig,
    conjugate: bool = True,
    dtype=torch.complex64,
) -> Replica:
    """Code file -> x2 ZOH -> +/-1 -> (conj) FFT [-> Hamming]
    (``godual_ranging.m:63-66``, ``main.cpp:658-732``)."""
    np_c = _NP_COMPLEX[dtype]
    real = np.float32 if dtype == torch.complex64 else np.float64
    code = chips_to_pm1(upsample_zoh(read_prn_file(code_path),
                                     signal.samples_per_chip))
    fcode = code_spectrum(
        code, conj=conjugate, hamming_window=proc.hamming_window
    ).astype(np_c)
    code3_np = interp_code(code, proc.interp_factor)
    return Replica(
        code=code,
        fcode=fcode,
        code_interp=code3_np.astype(real),
        fcode_interp=np.conj(np.fft.fft(code3_np)).astype(np_c),
        samples_per_code=len(code),
    )


def df_window(station: StationConfig, remote: bool) -> tuple[float, float]:
    """The squaring-FFT search window on the doubled-frequency axis:
    local +/-20 kHz; remote (-120,-80) kHz at OP, (80,120) kHz at LTFB
    (``godual_ranging.m:83-90``)."""
    if not remote:
        return (-20e3, 20e3)
    if station.op:
        return (-120e3, -80e3)
    return (80e3, 120e3)


_FIELDS = ("indice", "correction", "snr_r", "snr_i", "df", "puissance",
           "puissance_code", "puissance_noise", "xval", "xvalm1", "xvalp1")


@dataclass
class ChannelArrays:
    """Accumulated per-epoch arrays of one channel (host side)."""

    indice: list = field(default_factory=list)
    correction: list = field(default_factory=list)
    snr_r: list = field(default_factory=list)
    snr_i: list = field(default_factory=list)
    df: list = field(default_factory=list)
    puissance: list = field(default_factory=list)
    puissance_code: list = field(default_factory=list)
    puissance_noise: list = field(default_factory=list)
    xval: list = field(default_factory=list)
    xvalm1: list = field(default_factory=list)
    xvalp1: list = field(default_factory=list)

    def extend(self, res: EpochResult, df) -> None:
        res = res.to_host()
        for k in _FIELDS:
            if k != "df":
                getattr(self, k).append(getattr(res, k))
        if isinstance(df, torch.Tensor):
            df = df.cpu().numpy()
        self.df.append(np.broadcast_to(np.asarray(df), res.indice.shape))

    def asdict(self) -> dict:
        return {
            k: np.concatenate(getattr(self, k)) if getattr(self, k) else np.array([])
            for k in _FIELDS
        }


def process_file(
    capture_path: str,
    code_path: str,
    signal: SignalConfig,
    proc: ProcessingConfig,
    station: StationConfig | None = None,
    remote: bool = False,
    batch_epochs: int = 25,
    out_mat: str | None = None,
    dtype=torch.complex64,
    verbose: bool = False,
    df_window_hz: tuple[float, float] | None = None,
    device=None,
) -> dict:
    """Run the godual chain over one capture file on ``device`` (default
    ``cuda``).

    Returns ``{"ch1": arrays, "ch2": arrays | None}`` and writes the
    Octave-convention ``.mat`` when ``out_mat`` is given or the capture
    ends in ``.bin`` (``godual_ranging.m:126-131``).  ``df_window_hz``
    overrides the station/remote presets of :func:`df_window`.
    """
    dev = resolve_device(device)
    station = station or StationConfig()
    rep = build_replica(code_path, signal, proc, conjugate=True, dtype=dtype)
    L = rep.samples_per_code
    lo_hz, hi_hz = df_window_hz or df_window(station, remote)
    mask = doppler.window_mask(L, signal.fs, lo_hz, hi_hz)
    n_chan = 1 if remote else 2
    chans = [ChannelArrays() for _ in range(n_chan)]

    use_step = dev.type == "cuda" and dtype == torch.complex64
    if use_step:
        step = boundary.make_ranging_step(
            rep.fcode, rep.code_interp, mask, signal.fs, nint=proc.nint,
            fine_freq=proc.fine_freq, device=dev,
        )
    else:
        fcode = torch.as_tensor(rep.fcode, device=dev)
        code3 = torch.as_tensor(rep.code_interp, device=dev)
        fcode3 = torch.as_tensor(rep.fcode_interp, device=dev)
        mask_t = torch.as_tensor(mask, device=dev)

    start = 0
    while True:
        d, n = io.read_sc16_epochs(capture_path, start, batch_epochs, L,
                                   channels=2, dtype=_NP_COMPLEX[dtype])
        if n == 0:
            break
        start += n * L
        for c in range(n_chan):
            dc = torch.as_tensor(d[c, :n]).to(dev)
            if use_step:
                outs = step(torch.view_as_real(dc))
                df = outs.df
                res = boundary.to_epoch_result(outs)
            else:
                df, _ = doppler.squaring_df(dc, signal.fs, mask_t)
                if proc.fine_freq:
                    # pyFFTW-chain refinement: mix by the coarse df, fit
                    # the residual phase drift, correlate at the refined
                    # frequency (godual_ranging_fftw.py:35-39)
                    t = torch.arange(L, dtype=torch.float64, device=dev) / signal.fs
                    y = dc * torch.exp(-2j * np.pi * df[:, None] * t)
                    df = df + doppler.fine_df_phase_drift(y, signal.fs)
                res = correlate_epochs(
                    dc, fcode, df.to(code3.dtype), code3, signal.fs,
                    nint=proc.nint, fcode_interp=fcode3,
                )
            chans[c].extend(res, df)
            if verbose:
                h = res.to_host()
                delays = (h.indice + h.correction) / signal.fs / proc.interp_factor
                dfh = df.cpu().numpy()
                for i in range(n):
                    print(
                        f"{len(chans[c].indice)}\t{delays[i]:.12f}\t"
                        f"{float(dfh[i]):.3f}\t"
                        f"{10 * np.log10(float(h.puissance[i])):.1f}\t"
                        f"{float(h.snr_db[i]):.1f}"
                    )
        if n < batch_epochs:
            break

    out = {"ch1": chans[0].asdict(), "ch2": chans[1].asdict() if n_chan == 2 else None}
    if out_mat is None and capture_path.endswith(".bin"):
        base = os.path.basename(capture_path).replace(".bin", ".mat")
        prefix = "remote" if remote else ""
        out_mat = os.path.join(os.path.dirname(capture_path) or ".", prefix + base)
    if out_mat:
        matio.save_octave_style(out_mat, out["ch1"], out["ch2"], rep.code)
        out["mat_path"] = out_mat
    return out
