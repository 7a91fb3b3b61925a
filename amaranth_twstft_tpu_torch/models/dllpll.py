"""Multi-channel DLL/PLL tracking receiver — host parts (NumPy + torch).

The port's counterpart of the JAX package's ``models/dllpll.py``: channel
configuration and ``sdr.param`` parsing, the replica bank build (with the
same ``TWSTFT_BANK_CACHE`` disk cache), the per-channel tracking state,
the reference's output rows and log lines, and the BPSK half-cycle phase
unwrap.  Behavioral spec: ``experiments/231001_DLL_PLL/rxcomplex.cpp``
(see the JAX module's docstring for the line map).

The device-batched bank that uses these parts is
:mod:`amaranth_twstft_tpu_torch.models.tracker`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from amaranth_twstft_tpu_torch.ops.lfsr import prn_chips, prn_chips_batch
from amaranth_twstft_tpu_torch.ops.prn import (
    chips_to_pm1,
    lowpass_spectrum_mask,
    upsample_zoh,
)

__all__ = [
    "ChannelConfig",
    "Channel",
    "build_channel",
    "build_channels_batch",
    "TrackState",
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
