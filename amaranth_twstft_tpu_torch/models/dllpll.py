"""Multi-channel DLL/PLL tracking receiver (NumPy + torch).

The port's counterpart of the JAX package's ``models/dllpll.py``: channel
configuration and ``sdr.param`` parsing, the replica bank build (with the
same ``TWSTFT_BANK_CACHE`` disk cache), the per-channel tracking state,
the reference's output rows and log lines, the BPSK half-cycle phase
unwrap, and the host-sequential :class:`Receiver` (``dllpll --host``, the
oracle of the banked receiver): acquisition by the dense CAF
(:mod:`amaranth_twstft_tpu_torch.ops.caf`), tracking through the explicit
(K, NL) form of the lag-bank kernel.  Behavioral spec:
``experiments/231001_DLL_PLL/rxcomplex.cpp`` (see the JAX module's
docstring for the line map).

The device-batched bank that uses these parts is
:mod:`amaranth_twstft_tpu_torch.models.tracker`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from amaranth_twstft_tpu_torch.ops.caf import caf_search
from amaranth_twstft_tpu_torch.ops.correlator import quick_xcorr_snr
from amaranth_twstft_tpu_torch.ops.doppler import squaring_df, window_mask
from amaranth_twstft_tpu_torch.ops.lagbank import lag_bank_correlate
from amaranth_twstft_tpu_torch.ops.lfsr import prn_chips, prn_chips_batch
from amaranth_twstft_tpu_torch.ops.peaks import (
    hrc_correction,
    median_iqr_sigma,
    weighted_linear_fit,
)
from amaranth_twstft_tpu_torch.ops.prn import (
    chips_to_pm1,
    lowpass_spectrum_mask,
    upsample_zoh,
)
from amaranth_twstft_tpu_torch.utils.platform import resolve_device

__all__ = [
    "ChannelConfig",
    "Channel",
    "build_channel",
    "build_channels_batch",
    "TrackState",
    "Receiver",
    "SecondReport",
    "parse_sdr_param",
    "dat_filename",
    "log_line",
]


@dataclass(frozen=True)
class ChannelConfig:
    """One receiver channel (one ``sdr.param`` row, ``rxcomplex.cpp:272-285``)."""

    physical: str = "A"  # "A" or "B"
    is_sic: bool = False  # successive-interference-cancellation channel
    prn_id: int = 100  # >=100 => 100 kchip SDR code (rxcomplex.cpp:305-310)
    bit_len: int = 17
    taps: int = 9
    fc_init_hz: float = 0.0
    chip_rate: float = 2.5e6
    code_len: int = 100_000
    filter_hz: float = 2.5e6  # low-pass cut-off (= chip rate, :362)
    acq_range_hz: float = 4000.0
    acq_step_hz: float = 100.0
    snr_min_db: float = 7.0
    nlag: int = 28  # :310

    @property
    def codes_per_second(self) -> int:
        return int(self.chip_rate // self.code_len)


def parse_sdr_param(text: str) -> list[ChannelConfig]:
    """Parse the reference's ``sdr.param`` format: lines
    ``<ch> <N|S> <prn> <fc> <kcps> <fltkhz> <frange> <fstep> <snrmin>``
    (``rxcomplex.cpp:271-278``); '#' comments skipped."""
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) != 9:
            continue
        ch, sic, prn, fc, kcps, fltkhz, frange, fstep, snrmin = parts
        out.append(
            ChannelConfig(
                physical=ch,
                is_sic=sic.upper() in ("S", "1", "Y"),
                prn_id=int(prn),
                fc_init_hz=float(fc),
                chip_rate=float(kcps) * 1e3,
                filter_hz=float(fltkhz) * 1e3,
                acq_range_hz=float(frange),
                acq_step_hz=float(fstep),
                snr_min_db=float(snrmin),
            )
        )
    return out


def _merge_param_row(base: ChannelConfig, row: ChannelConfig) -> ChannelConfig:
    """Apply a changed ``sdr.param`` row onto a known channel config.

    The reference derives code geometry (length, bit depth, lag span)
    from its internal PRN table keyed by the row's id
    (``rxcomplex.cpp:298-320``); here the receiver's existing config for
    that PRN plays the table's role — the row only carries the runtime
    knobs (channel, SIC, fc, rate, filter, acquisition window, SNR gate).
    """
    import dataclasses

    return dataclasses.replace(
        base,
        physical=row.physical,
        is_sic=row.is_sic,
        prn_id=row.prn_id,
        fc_init_hz=row.fc_init_hz,
        chip_rate=row.chip_rate,
        filter_hz=row.filter_hz,
        acq_range_hz=row.acq_range_hz,
        acq_step_hz=row.acq_step_hz,
        snr_min_db=row.snr_min_db,
    )


def _param_matches(cur: ChannelConfig, new: ChannelConfig) -> bool:
    """The reference's "row unchanged" test (``rxcomplex.cpp:273``): exact
    on channel/SIC/PRN/fc/chip-rate, factor-2 band on the acquisition
    range and step, 10% linear-power band on the SNR gate."""
    cur_snr = 10.0 ** (cur.snr_min_db / 10.0)
    new_snr = 10.0 ** (new.snr_min_db / 10.0)
    return (
        cur.physical == new.physical
        and cur.is_sic == new.is_sic
        and cur.prn_id == new.prn_id
        and cur.fc_init_hz == new.fc_init_hz
        and cur.chip_rate == new.chip_rate
        and new.acq_range_hz <= cur.acq_range_hz < 2.0 * new.acq_range_hz
        and new.acq_step_hz <= cur.acq_step_hz < 2.0 * new.acq_step_hz
        and abs(cur_snr - new_snr) < 0.1 * cur_snr
    )


@dataclass
class Channel:
    """Replica arrays + config, built once per channel."""

    cfg: ChannelConfig
    nobs: int  # samples per code period
    wav: np.ndarray  # filtered replica, real f32 (nobs,)
    fcode: np.ndarray  # conj FFT of the replica (for acquisition CAF)
    psbb: float  # replica baseband power (rxcomplex.cpp:437-438)
    chips: np.ndarray | None = None  # raw 0/1 chips (code_len,) int8
    sps_per_chip: int = 1
    _code_interp: np.ndarray | None = None

    @property
    def code_interp(self) -> np.ndarray:
        """3x-interpolated unfiltered code, built on first use (only the
        host acquisition path needs it; the 120-channel bank never
        materializes 120 x 3 x nobs floats)."""
        if self._code_interp is None:
            code = chips_to_pm1(
                upsample_zoh(self.chips, self.sps_per_chip), np.float64
            )
            self._code_interp = np.repeat(code, 3).astype(np.float32)
        return self._code_interp


def build_channel(cfg: ChannelConfig, fs: float) -> Channel:
    sps_per_chip = int(round(fs / cfg.chip_rate))
    chips = prn_chips(cfg.bit_len, cfg.taps, cfg.code_len)
    code = chips_to_pm1(upsample_zoh(chips, sps_per_chip), np.float64)
    nobs = len(code)
    # brick-wall low-pass of the replica in the frequency domain
    # (rxcomplex.cpp:416-433); cut-off +/- filter_hz
    spec = np.fft.fft(code)
    mask = lowpass_spectrum_mask(nobs, fs / nobs, cfg.filter_hz, -cfg.filter_hz)
    wav = np.real(np.fft.ifft(spec * mask))
    psbb = float(np.mean(wav**2))
    fcode = np.conj(np.fft.fft(wav))
    return Channel(
        cfg=cfg,
        nobs=nobs,
        wav=wav.astype(np.float32),
        fcode=fcode,
        psbb=psbb,
        chips=chips,
        sps_per_chip=sps_per_chip,
    )


#: Bump when the replica math changes — invalidates the disk bank cache.
_BANK_CACHE_VERSION = 1


def _bank_cache_key(cfgs: list[ChannelConfig], fs: float) -> str:
    import hashlib

    h = hashlib.sha256()
    h.update(f"v{_BANK_CACHE_VERSION}|fs={fs!r}".encode())
    for c in cfgs:
        h.update(
            f"|{c.bit_len},{c.code_len},{c.chip_rate!r},{int(c.taps)},"
            f"{c.filter_hz!r}".encode()
        )
    return h.hexdigest()[:24]


def _bank_cache_dir() -> str | None:
    """Disk cache location for built replica banks; '' disables.

    The reference rebuilds its (up to) 120 channels from sdr.param at
    every startup (``rxcomplex.cpp:257-455``) — under the cron schedule
    (every 2 h, ``acquisition/crontab``) that cost recurs forever.  The
    replica arrays are a pure function of (geometry, taps, filter, fs),
    so they cache across processes."""
    import os as _os

    d = _os.environ.get("TWSTFT_BANK_CACHE")
    if d == "":
        return None
    return d or _os.path.expanduser("~/.cache/twstft_banks")


def build_channels_batch(cfgs: list[ChannelConfig], fs: float) -> list[Channel]:
    """Vectorized :func:`build_channel` for a whole receiver bank.

    The reference builds its (up to) 120 channels serially at startup
    (``rxcomplex.cpp:257-455``: per-channel ``SDRcode``/``PRN_sampling``/
    low-pass); a Python loop over :func:`build_channel` costs ~20 s at
    the production geometry.  Here channels are grouped by code geometry
    and built with batched operations:

    - one lockstep LFSR walk generates every unique code's chips
      (:func:`amaranth_twstft_tpu_torch.ops.lfsr.prn_chips_batch`),
    - one batched FFT of all codes; per-channel low-pass masks applied
      as one multiply; one batched IFFT for the filtered replicas,
    - the replica spectrum needed by acquisition is the Hermitian part
      of the masked spectrum (``fft(real(ifft(M))) == (M + conj(M[-k]))/2``
      exactly), so no third transform is needed.

    Single-precision FFTs via torch on the host (~10x numpy's c64 path
    at mixed-radix lengths, and the same transforms the JAX package's
    bank build uses); the bank consumes f32 anyway.  Results match :func:`build_channel` to f32
    roundoff (tested).
    """
    out: list[Channel | None] = [None] * len(cfgs)
    groups: dict[tuple, list[int]] = {}
    for i, cfg in enumerate(cfgs):
        sps = int(round(fs / cfg.chip_rate))
        groups.setdefault((cfg.bit_len, cfg.code_len, sps), []).append(i)

    # disk cache (homogeneous-geometry banks only — the 120-channel
    # production case): loading ~300 MB of arrays beats ~6 s of LFSR
    # walks + batched FFTs on the 2-core acquisition host
    cache_path = None
    if len(groups) == 1 and len(cfgs) >= 8:
        cdir = _bank_cache_dir()
        if cdir:
            import os as _os

            _os.makedirs(cdir, exist_ok=True)
            cache_path = _os.path.join(
                cdir, _bank_cache_key(cfgs, fs) + ".npz"
            )
            try:
                with np.load(cache_path) as z:
                    wav_all = z["wav"]
                    fc_ri = z["fcode_ri"]
                    psbb_all = z["psbb"]
                    chips_all = z["chips"]
                    sps_c = int(z["sps"])
                return [
                    Channel(
                        cfg=cfgs[i],
                        nobs=wav_all.shape[1],
                        wav=wav_all[i],
                        fcode=(fc_ri[i, :, 0] + 1j * fc_ri[i, :, 1]).astype(
                            np.complex64
                        ),
                        psbb=float(psbb_all[i]),
                        chips=chips_all[i],
                        sps_per_chip=sps_c,
                    )
                    for i in range(len(cfgs))
                ]
            except (OSError, KeyError, ValueError):
                pass  # miss or corrupt entry: rebuild (and overwrite)
    for (bit_len, code_len, sps), idxs in groups.items():
        taps_arr = np.array([cfgs[i].taps for i in idxs], dtype=np.uint64)
        uniq, inv = np.unique(taps_arr, return_inverse=True)
        chips_u = _chips_cached(bit_len, uniq, code_len)
        # ZOH upsample by strided stores (repeat() copies twice)
        nobs = code_len * sps
        pm1 = chips_to_pm1(chips_u, np.float32)
        codes_u = np.empty((len(uniq), nobs), np.float32)
        for s in range(sps):
            codes_u[:, s::sps] = pm1
        spec_u = _batch_fft(codes_u.astype(np.complex64))
        # group rows by filter cut-off: one 1-D float mask per unique
        # filter (a (C, nobs) bool broadcast costs ~10x more)
        by_filter: dict[float, list[int]] = {}
        for row, i in enumerate(idxs):
            by_filter.setdefault(cfgs[i].filter_hz, []).append(row)
        M = spec_u[inv]  # one gather; masks applied in place per row
        rev = (-np.arange(nobs)) % nobs
        hermitian = True
        for fhz, rows in by_filter.items():
            mask32 = lowpass_spectrum_mask(
                nobs, fs / nobs, fhz, -fhz
            ).astype(np.float32)
            for r in rows:
                M[r] *= mask32
            hermitian &= bool(
                np.array_equal(mask32, mask32[rev])
            )
        wav = np.real(_batch_ifft(M))
        if hermitian:
            # symmetric mask keeps the spectrum Hermitian, so
            # fft(real(ifft(M))) == M exactly — no transform needed
            H = M
        else:
            Mr = np.conj(
                np.concatenate([M[:, :1], M[:, :0:-1]], axis=1)
            )
            H = 0.5 * (M + Mr)
        psbb = np.mean(np.square(wav, dtype=np.float32), axis=1, dtype=np.float64)
        for row, i in enumerate(idxs):
            out[i] = Channel(
                cfg=cfgs[i],
                nobs=nobs,
                wav=wav[row].astype(np.float32),
                fcode=np.conj(H[row]),
                psbb=float(psbb[row]),
                chips=chips_u[inv[row]],
                sps_per_chip=sps,
            )
    if cache_path is not None:
        try:
            import os as _os

            built = [c for c in out if c is not None]
            fc = np.stack([c.fcode for c in built])
            tmp = cache_path + f".tmp{_os.getpid()}"
            np.savez(
                tmp,
                wav=np.stack([c.wav for c in built]),
                fcode_ri=np.stack([fc.real, fc.imag], axis=-1).astype(
                    np.float32
                ),
                psbb=np.array([c.psbb for c in built]),
                chips=np.stack([c.chips for c in built]),
                sps=built[0].sps_per_chip,
            )
            _os.replace(tmp + ".npz", cache_path)
            # keep the cache bounded (entries are ~300 MB at production
            # geometry): evict oldest beyond 4
            d = _os.path.dirname(cache_path)
            ent = sorted(
                (p for p in _os.listdir(d) if p.endswith(".npz")),
                key=lambda p: _os.path.getmtime(_os.path.join(d, p)),
            )
            for p in ent[:-4]:
                _os.remove(_os.path.join(d, p))
        except OSError:
            pass  # cache write is best-effort
    return out  # type: ignore[return-value]


_CHIPS_CACHE: dict[tuple, np.ndarray] = {}


def _chips_cached(bit_len: int, uniq: np.ndarray, code_len: int) -> np.ndarray:
    """Per-taps chip cache: a reload_params that touches one row of 120
    must not re-walk every LFSR (the walk is the dominant build cost)."""
    missing = [
        int(t) for t in uniq if (bit_len, int(t), code_len) not in _CHIPS_CACHE
    ]
    if missing:
        fresh = prn_chips_batch(
            bit_len, np.asarray(missing, np.uint64), code_len
        )
        for t, row in zip(missing, fresh):
            _CHIPS_CACHE[(bit_len, t, code_len)] = row
    return np.stack(
        [_CHIPS_CACHE[(bit_len, int(t), code_len)] for t in uniq]
    )


def _batch_fft(z: np.ndarray) -> np.ndarray:
    return torch.fft.fft(torch.from_numpy(z), dim=-1).numpy()


def _batch_ifft(z: np.ndarray) -> np.ndarray:
    return torch.fft.ifft(torch.from_numpy(np.ascontiguousarray(z)),
                          dim=-1).numpy()


@dataclass
class TrackState:
    """Per-channel tracking state (mutable across seconds)."""

    is_trk: bool = False
    is_first: bool = False
    fc: float = 0.0  # carrier frequency (Hz)
    df: float = 0.0  # sub-Hz remainder
    pt: int = 0  # code head position (samples)
    pt_prev: int = 0
    last_phi: float = 0.0
    gd: float = 0.0  # code phase (ns)
    dg: float = 0.0  # code phase rate (ns/s)
    sdgd: float = 0.0
    phi: float = 0.0
    pk: float = 0.0
    lock_seconds: int = 0


@dataclass
class SecondReport:
    """One output row (``rxcomplex.cpp:736-753``)."""

    fc_hz: float
    phi_cycles: float
    cnt: int
    gd_ns: float
    dg_ns_per_s: float
    sdgd_ns: float
    pk_dbm: float
    pnoise_dbm: float
    locked: bool
    ib: int = 0  # first-code index of the data bit; always 0 for SDR codes
    #             (``rxcomplex.cpp:673``; nonzero only for SATRE bit framing)

    def row(self, duration_s: float) -> str:
        """The reference's per-second text row, byte-for-byte
        (``rxcomplex.cpp:736-753``): ``fc+df phi cnt ib*duration gd dg
        sdgd Pk_dBm Pnoise_dBm`` with the exact printf widths."""
        return (
            f"{self.fc_hz:14.6f} {self.phi_cycles:11.8f} "
            f"{self.cnt:3d} {self.ib * duration_s:5.3f} {self.gd_ns:14.6f} "
            f"{self.dg_ns_per_s:11.6f} {self.sdgd_ns:8.4f} "
            f"{self.pk_dbm:7.3f} {self.pnoise_dbm:7.3f}"
        )


def dat_filename(cfg: ChannelConfig) -> str:
    """Per-channel output file name (``rxcomplex.cpp:724``):
    ``ch<A|B>.pn<id>.<kcps>kcps.dat``; SIC channels report id+50."""
    pid = cfg.prn_id + 50 if cfg.is_sic else cfg.prn_id
    return f"ch{cfg.physical}.pn{pid:02d}.{int(cfg.chip_rate // 1000)}kcps.dat"


def log_line(event: str, cfg: ChannelConfig, cnt: int, bps: int) -> str:
    """One ``rxcomplex.log`` event line (``rxcomplex.cpp:760-790``):
    ``<event> : Ch. <ch>, PRN#<id>, count = <cnt> / <bps>``."""
    pid = cfg.prn_id + 50 if cfg.is_sic else cfg.prn_id
    return f"{event}: Ch. {cfg.physical}, PRN#{pid:2d}, count = {cnt} / {bps}"


def _v2_to_dbm(v2: float) -> float:
    """<V^2> into a 50-ohm load -> dBm (reference's v2todBm)."""
    return 10.0 * np.log10(max(v2, 1e-30) / 50.0 * 1000.0)


def _phase_unwrap_scan(
    res_phi: torch.Tensor, w: torch.Tensor, last_phi0: torch.Tensor
) -> torch.Tensor:
    """Sequential BPSK half-cycle unwrap (``rxcomplex.cpp:702-720``),
    vectorised over channels: along the last (code) axis each valid phase
    is folded by 0.5-cycle steps to within 0.25 of the previous accepted
    one; invalid entries pass through and do not move the reference."""
    last = last_phi0
    out = torch.empty_like(res_phi)
    for p in range(res_phi.shape[-1]):
        phi = res_phi[..., p]
        folded = phi - 0.5 * torch.round((phi - last) * 2.0)
        keep = w[..., p] > 0
        out[..., p] = torch.where(keep, folded, phi)
        last = torch.where(keep, folded, last)
    return out


def _lag_bank_correlate(obs_ri: torch.Tensor, wav_lags: torch.Tensor):
    """The lag-bank correlation of one channel's second: ``obs_ri`` (2,
    codes, nobs) float32 (re, im) against ``wav_lags`` (nobs, nlags)
    float32 -> power and phase (codes, nlags).  The reference performs the
    same contraction with one DGEMM over an interleaved re/im observation
    matrix (``rxcomplex.cpp:605``); on a CUDA tensor this is the explicit
    (K, NL) form of the hand-written kernel (``csrc/lagbank.cu``), on a CPU
    tensor its plain version."""
    return lag_bank_correlate(obs_ri, wav_lags)


def _complex(x: np.ndarray) -> np.ndarray:
    """Real samples (``rx.cpp`` mode) as complex of the same precision."""
    if np.iscomplexobj(x):
        return x
    return x.astype(np.complex64 if x.dtype == np.float32 else np.complex128)


def _channel_from(c: dict) -> Channel:
    """A :class:`Channel` from another receiver's channel replica: a dict
    of the :class:`Channel` fields as numpy, ``cfg`` as a dict of the
    :class:`ChannelConfig` fields."""
    return Channel(
        cfg=ChannelConfig(**c["cfg"]),
        nobs=int(c["nobs"]),
        wav=np.asarray(c["wav"], np.float32),
        fcode=np.asarray(c["fcode"]),
        psbb=float(c["psbb"]),
        chips=np.asarray(c["chips"]),
        sps_per_chip=int(c["sps_per_chip"]),
    )


class Receiver:
    """File-level multi-channel receiver (one second of IQ at a time): the
    host-sequential oracle that the banked receiver is checked against
    (``dllpll --host``).

    Per channel per second: the acquisition (dense CAF, the trial-
    correlation SNR gate, the whole-second squaring-FFT fine frequency)
    or the tracking (float64 host LO, the lag bank, peak-quality and
    3-sigma gates, HRC, BPSK unwrap, the two weighted fits).  The CAF, the
    squaring FFT and the lag bank run on ``device`` (default ``cuda``; the
    lag bank launches the kernel there or raises), in the dtype of the
    samples the caller passes; the LO stays float64 on the host, and the
    gates, fits and unwrap run on the host as the JAX package's do.
    """

    def __init__(self, channels: list[ChannelConfig], fs: float = 5e6, *,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.fs = fs
        self.channels = [build_channel(c, fs) for c in channels]
        self.states = [TrackState(fc=c.fc_init_hz) for c in channels]
        self._wav_lags: dict[int, torch.Tensor] = {}
        self.log: list[str] = []
        self._sic_snapshot = [(s.pt, s.fc, s.df) for s in self.states]
        self._acq_attempt = 0  # probe-epoch diversity counter

    @classmethod
    def from_reference(
        cls,
        channels: list[dict],
        states: list[dict],
        acq_attempt: int,
        fs: float = 5e6,
        *,
        device: str | torch.device | None = None,
    ) -> "Receiver":
        """A receiver holding exactly another receiver's replicas and
        state: ``channels`` one dict of :class:`Channel` fields per channel
        (numpy arrays), ``states`` one dict of :class:`TrackState` fields,
        ``acq_attempt`` the probe-epoch counter.  Used to start the port
        and the JAX package from identical state mid-track."""
        if len(channels) != len(states):
            raise ValueError("channels and states disagree on the count")
        rx = cls.__new__(cls)
        rx.device = resolve_device(device)
        rx.fs = fs
        rx.channels = [_channel_from(c) for c in channels]
        rx.states = [TrackState(**s) for s in states]
        rx._wav_lags = {}
        rx.log = []
        rx._sic_snapshot = [(s.pt, s.fc, s.df) for s in rx.states]
        rx._acq_attempt = int(acq_attempt)
        return rx

    def _lag_matrix(self, i: int) -> torch.Tensor:
        """(nobs, 2*nlag+1) float32 shifted replicas of channel ``i`` on
        the receiver's device, built once (45.6 MB at production)."""
        if i not in self._wav_lags:
            ch = self.channels[i]
            lags = np.arange(-ch.cfg.nlag, ch.cfg.nlag + 1)
            w = np.stack([np.roll(ch.wav, lag) for lag in lags], axis=1)
            self._wav_lags[i] = torch.from_numpy(w).to(self.device)
        return self._wav_lags[i]

    # ------------------------------------------------------------------
    def process_second(self, iq_by_phys: dict[str, np.ndarray]) -> list[SecondReport | None]:
        """Process one second of samples for every channel.

        ``iq_by_phys``: physical channel name -> complex array of at least
        fs samples (+ one code period of lookahead recommended).
        """
        # second-start snapshot of every channel's code head / carrier —
        # the reference's ``pt_prev`` semantics (``rxcomplex.cpp:513``):
        # SIC reconstruction must use the alignment the interferer had for
        # THIS second's samples
        self._sic_snapshot = [(s.pt, s.fc, s.df) for s in self.states]
        # probe-epoch diversity (rxcomplex.cpp:529 picks a random epoch):
        # one shared probe epoch per second for all cold channels,
        # advanced by a stride coprime to the codes-per-second count
        if any(
            not st.is_trk and iq_by_phys.get(ch.cfg.physical) is not None
            for ch, st in zip(self.channels, self.states)
        ):
            self._acq_attempt += 1
        reports: list[SecondReport | None] = []
        for i, (ch, st) in enumerate(zip(self.channels, self.states)):
            smp = iq_by_phys.get(ch.cfg.physical)
            if smp is None:
                reports.append(None)
                continue
            if ch.cfg.is_sic:
                smp = self._mai_free(i, smp)
            if not st.is_trk:
                reports.append(self._acquire(i, smp))
            else:
                reports.append(self._track(i, smp))
        return reports

    # ------------------------------------------------------------------
    def reload_params(self, text: str) -> list[int]:
        """Hot-reload ``sdr.param`` with the reference's per-second change
        detection (``rxcomplex.cpp:257-285``): a row that still matches its
        channel keeps the channel's tracking state; a changed row (or a new
        position) re-initializes that channel, forcing re-acquisition.
        Returns the indices of re-initialized channels.
        """
        known = {c.cfg.prn_id: c.cfg for c in self.channels}
        new_cfgs = parse_sdr_param(text)
        changed: list[int] = []
        for i, cfg in enumerate(new_cfgs):
            if i < len(self.channels) and _param_matches(
                self.channels[i].cfg, cfg
            ):
                continue
            base = known.get(
                cfg.prn_id, self.channels[0].cfg if self.channels else None
            )
            if base is not None:
                cfg = _merge_param_row(base, cfg)
            if i < len(self.channels):
                self.channels[i] = build_channel(cfg, self.fs)
                self.states[i] = TrackState(fc=cfg.fc_init_hz)
                self._wav_lags.pop(i, None)
            else:
                self.channels.append(build_channel(cfg, self.fs))
                self.states.append(TrackState(fc=cfg.fc_init_hz))
            changed.append(i)
        if len(new_cfgs) < len(self.channels):
            changed.extend(range(len(new_cfgs), len(self.channels)))
            del self.channels[len(new_cfgs):]
            del self.states[len(new_cfgs):]
            self._wav_lags = {
                k: v for k, v in self._wav_lags.items() if k < len(new_cfgs)
            }
        self._sic_snapshot = [(s.pt, s.fc, s.df) for s in self.states]
        return changed

    # ------------------------------------------------------------------
    def _mai_free(self, i: int, smp: np.ndarray) -> np.ndarray:
        """Successive interference cancellation for a SIC-flagged channel
        (host NumPy, as the JAX package's).

        The reference scaffolds this as ``MAI_up``/``MAI_out``
        (``rxcomplex.cpp:506-520``, disabled in the shipped build): rebuild
        every *tracked, non-SIC, non-first-second* co-channel signal from
        its current track state and subtract it before processing.  Each
        interferer is reconstructed as ``a_c * code((n - pt) mod nobs) *
        exp(j 2 pi (fc+df) n / fs)`` with one complex amplitude ``a_c`` per
        code period estimated by projection.
        """
        ch_i = self.channels[i]
        out = smp
        for k, (ch, st) in enumerate(zip(self.channels, self.states)):
            if (
                k == i
                or ch.cfg.physical != ch_i.cfg.physical
                or ch.cfg.is_sic
                or not st.is_trk
                or st.is_first
            ):
                continue
            pt_k, fc_k, df_k = self._sic_snapshot[k]
            n = np.arange(len(smp), dtype=np.float64)
            code = ch.wav.astype(np.float64)[
                (np.arange(len(smp)) - pt_k) % ch.nobs
            ]
            f = (fc_k + df_k) / self.fs
            rep = code * np.exp(2j * np.pi * np.mod(f * n, 1.0))
            nblk = len(smp) // ch.nobs
            if nblk == 0:
                # shorter-than-one-code final segment: no per-code
                # amplitude can be estimated — skip this interferer
                continue
            m = nblk * ch.nobs
            rb = rep[:m].reshape(nblk, ch.nobs)
            sb = np.asarray(smp[:m], dtype=np.complex128).reshape(nblk, ch.nobs)
            denom = np.sum(np.abs(rb) ** 2, axis=1)
            a = np.sum(np.conj(rb) * sb, axis=1) / np.maximum(denom, 1e-30)
            if out is smp:
                out = smp.astype(np.complex128, copy=True)
            out[:m] -= (a[:, None] * rb).ravel()
            if m < len(smp):
                out[m:] -= a[-1] * rep[m:]
            self.log.append(
                f"SIC         : Ch. {ch_i.cfg.physical}, PRN#{ch_i.cfg.prn_id:2d} "
                f"- PRN#{ch.cfg.prn_id:2d}, |a| = {float(np.abs(a).mean()):.1f}"
            )
        return out

    # ------------------------------------------------------------------
    def _acquire(self, i: int, smp: np.ndarray) -> SecondReport | None:
        ch, st = self.channels[i], self.states[i]
        cfg = ch.cfg
        dev = self.device
        # one code period somewhere in the second: deterministic rotation
        # of the probe epoch across attempts (the reference picks a
        # random epoch each second, :529)
        bps = max(1, min(len(smp), int(self.fs)) // ch.nobs)
        stride = max(1, bps // 3)
        while math.gcd(stride, bps) != 1:
            stride += 1
        start = ((bps // 2 + (self._acq_attempt - 1) * stride) % bps) * ch.nobs
        d = _complex(smp[start : start + ch.nobs])
        if len(d) < ch.nobs:
            return None
        d_t = torch.from_numpy(np.ascontiguousarray(d[None, :])).to(dev)
        cdt = d_t.dtype
        res = caf_search(
            d_t,
            torch.from_numpy(ch.fcode).to(dev, cdt),
            torch.from_numpy(ch.code_interp).to(dev),
            self.fs,
            cfg.fc_init_hz - cfg.acq_range_hz,
            cfg.fc_init_hz + cfg.acq_range_hz,
            cfg.acq_step_hz,
            refine=True,
        )
        df_caf = float(res.df_hz[0])
        # acquisition gate on the correlation-peak SNR (peak^2 over the
        # correlation-floor variance), the reference's power test (:573)
        # mapped onto claudio's detection statistic
        # (claudio_...separate.m:42); quick_xcorr_snr takes the
        # unconjugated code spectrum, ch.fcode is the conjugated one
        qs = float(quick_xcorr_snr(
            torch.from_numpy((d - d.mean())[None, :]).to(dev),
            torch.from_numpy(np.conj(ch.fcode)).to(dev, cdt),
            torch.tensor(df_caf, dtype=torch.float64, device=dev),
            self.fs,
        ).reshape(-1)[0])
        snr_db = 10.0 * np.log10(max(qs, 1e-12))
        pk = float(torch.abs(res.epoch.xval[0])) ** 2
        if snr_db < cfg.snr_min_db:
            self.log.append(log_line("acq failed  ", cfg, 0, cfg.codes_per_second))
            return None
        ind = int(res.epoch.indice[0]) // 3  # non-interp grid
        st.fc = df_caf
        # fine frequency: squaring-FFT line at 2*fc over the whole second
        # (sub-Hz, like the reference's halving-to-<1 Hz refinement,
        # rxcomplex.cpp:560-568 — dense instead of iterative); required
        # for pull-in: tracking unwraps phase only within 0.25 cycle/code
        nsec = (len(smp) // ch.nobs) * ch.nobs
        span = 2.0 * max(cfg.acq_step_hz, 4.0)
        mask = window_mask(nsec, self.fs, 2 * st.fc - span, 2 * st.fc + span)
        if mask.any():
            sec = _complex(smp[:nsec])
            dsec = sec - sec.mean()
            fine, _ = squaring_df(torch.from_numpy(dsec).to(dev), self.fs,
                                  torch.from_numpy(mask).to(dev))
            st.fc = float(fine)
        st.pt = int((start + ind) % ch.nobs)
        st.gd = st.pt * 1e9 / self.fs
        st.is_trk = True
        st.is_first = True
        st.pk = pk
        self.log.append(
            f"acquisition : Ch. {cfg.physical}, PRN#{cfg.prn_id:2d}, "
            f"fc = {st.fc:.0f}, pt = {st.pt}"
        )
        return None

    # ------------------------------------------------------------------
    def _track(self, i: int, smp: np.ndarray) -> SecondReport | None:
        ch, st = self.channels[i], self.states[i]
        cfg = ch.cfg
        bps = cfg.codes_per_second
        ncodes = bps - 1  # the reference tracks bps-1 codes (:605)
        nlag = cfg.nlag
        need = st.pt + ncodes * ch.nobs
        if need > len(smp):
            st.is_trk = False
            return None

        seg = smp[st.pt : need]
        # carrier-phase-continuous downconversion (:592-600): phase offset
        # phi = frac(pt * fc / fs), float64 on the host
        phi0 = np.mod(st.pt * st.fc / self.fs, 1.0)
        n = np.arange(len(seg), dtype=np.float64)
        lo = np.exp(-2j * np.pi * (np.mod(st.fc / self.fs * n, 1.0) + phi0))
        obs = (seg * lo).reshape(ncodes, ch.nobs)
        obs_ri = np.stack([obs.real, obs.imag]).astype(np.float32)

        power, phase = _lag_bank_correlate(
            torch.from_numpy(obs_ri).to(self.device), self._lag_matrix(i)
        )
        power = power.cpu().numpy() / ch.nobs**2 * 4  # per-sample amplitude scale
        phase = phase.cpu().numpy()

        pk_idx = np.argmax(power, axis=1)
        interior = (pk_idx >= 2) & (pk_idx < 2 * nlag - 1)
        # peak-quality gate: the winning lag must stand well above the
        # lag-bank floor (the reference's per-code power gate is commented
        # out, rxcomplex.cpp:647; without one a pure-noise second keeps
        # "lock")
        floor = np.median(power, axis=1)
        quality = power[np.arange(ncodes), pk_idx] > 10.0 * np.maximum(
            floor, 1e-30
        )
        w = (interior & quality).astype(np.float64)

        hrc = hrc_correction(torch.from_numpy(power),
                             torch.from_numpy(pk_idx)).numpy()
        gd_ns = (st.pt + pk_idx - nlag + hrc) * 1e9 / self.fs
        ps = power[np.arange(ncodes), pk_idx] / max(ch.psbb, 1e-30)
        # the lag bank returns the reference's atan2(-im, re) — the
        # CONJUGATE of the residual carrier phase under the exp(-j2pi fc t)
        # downconversion; negate so the fitted slope is f_true - fc
        res_phi = -phase[np.arange(ncodes), pk_idx]

        # median/IQR 3-sigma gate (:699-700)
        med, sigma = median_iqr_sigma(torch.from_numpy(gd_ns), torch.from_numpy(w))
        med, sigma = float(med), float(sigma)
        ok = np.abs(gd_ns - med) < max(3.0 * sigma, 1e-6)
        w = w * ok

        cnt = int(w.sum())
        if cnt * 2 <= bps:
            # lock lost -> reacquire next second (:775-798)
            st.is_trk = False
            st.last_phi = 0.0
            self.log.append(log_line("lock lost   ", cfg, cnt, bps))
            return None

        # BPSK half-cycle unwrap (:702-720), seeded in float64
        res_phi = _phase_unwrap_scan(
            torch.from_numpy(res_phi.astype(np.float64)),
            torch.from_numpy(w),
            torch.tensor(st.last_phi, dtype=torch.float64),
        ).numpy()
        st.last_phi = float(res_phi[w > 0][-1]) if (w > 0).any() else st.last_phi

        # weighted fits (:728-744)
        ttag_phi = (np.arange(ncodes) * cfg.code_len / cfg.chip_rate) + st.pt / self.fs
        c0p, c1p, _ = weighted_linear_fit(
            torch.from_numpy(ttag_phi), torch.from_numpy(res_phi), torch.from_numpy(w)
        )
        c0p, c1p = float(c0p), float(c1p)
        st.fc += np.round(c1p)
        st.df = c1p - np.round(c1p)
        st.phi = float(np.mod(c0p + 1000.0, 1.0))

        ttag_gd = np.arange(ncodes) * cfg.code_len / cfg.chip_rate
        c0g, c1g, chi2 = weighted_linear_fit(
            torch.from_numpy(ttag_gd), torch.from_numpy(gd_ns), torch.from_numpy(w)
        )
        c0g, c1g = float(c0g), float(c1g)
        st.sdgd = float(np.sqrt(max(float(chi2), 0.0) / max(cnt, 1)))
        st.gd = c0g + 0.5 * c1g
        st.dg = c1g
        st.pt_prev = st.pt
        # the reference writes pt unguarded (rxcomplex.cpp:744); wrap by
        # one code period so a delay near 0 with negative drift cannot
        # make the next second's slice start at -1
        st.pt = int(np.round((c0g + c1g) * self.fs / 1e9)) % ch.nobs
        st.pk = float(np.mean(ps[w > 0])) if (w > 0).any() else 0.0

        first = st.is_first
        st.is_first = False
        if first:
            self.log.append(log_line("code lock   ", cfg, cnt, bps))
            return None
        px = float(np.mean(np.abs(smp[: int(self.fs)]) ** 2))
        return SecondReport(
            fc_hz=st.fc + st.df,
            phi_cycles=st.phi,
            cnt=cnt,
            gd_ns=st.gd,
            dg_ns_per_s=st.dg,
            sdgd_ns=st.sdgd,
            pk_dbm=_v2_to_dbm(st.pk),
            pnoise_dbm=_v2_to_dbm(max(px - st.pk, 1e-30)),
            locked=True,
        )
