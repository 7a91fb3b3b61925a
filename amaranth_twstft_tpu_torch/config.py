"""Unified configuration for the TWSTFT framework (PyTorch port).

A stdlib-only copy of the JAX package's ``config.py``: the port keeps its
own copy so that it never imports the JAX package.

The reference spreads configuration over argparse CLIs, environment
variables, an ``sdr.param`` file and edit-in-place script globals (see
SURVEY.md §5 "Config / flag system"; reference
``acquisition/env_variables.sh:1-7``, ``processing/Octave/godual_ranging.m:4-10``,
``experiments/231001_DLL_PLL/rxcomplex.cpp:257-285``).  Here a single set of
frozen dataclasses replaces all three mechanisms.  Every numeric default is
the production value of the 100 kchip campaign (reference
``amaranth_twstft/flashZedBoard.py:229-231``, ``processing/Octave/godual_ranging.m:4-5``).
"""

from __future__ import annotations

import dataclasses
import enum
import json
from dataclasses import dataclass, field
from typing import Any


class DfMode(enum.Enum):
    """How the frequency offset (Doppler + LO offset) is estimated.

    - PER_EPOCH: squaring-FFT argmax inside each 1-code window, the
      archived Octave chain (``processing/Octave/godual_ranging.m:14-15``).
    - PER_FILE: one decimated full-file pre-pass fixing df for every epoch,
      the C++ chain (``processing/CPP/main.cpp:363-450``).
    - TRACKED: spectral-line candidate search validated by trial
      correlation, then a +/-3-bin refresh per 2 s block, the per-code
      aligned chain (``acquisition/claudio_aligned_code_ranging_separate.m:27-47,168-169``).
    """

    PER_EPOCH = "per_epoch"
    PER_FILE = "per_file"
    TRACKED = "tracked"


class Modulation(enum.Enum):
    """Emission modes of the reference gateware (``amaranth_twstft/common.py:149-153``)."""

    OFF = 0
    CARRIER = 1
    BPSK = 2
    QPSK = 3


class TimeCoderMode(enum.Enum):
    """Optional data layer on the PRN (``amaranth_twstft/common.py:144-147``)."""

    OFF = 0
    INVERT_FIRST_CODE = 1
    TIMECODE = 2  # also inverts the first code; 6-bit seconds counter


TIMECODE_SIZE = 6  # bits, reference ``amaranth_twstft/common.py:142``

#: Known-good 17-bit m-sequence taps (reference ``tools/README.md:2-11``).
GOLDEN_TAPS_17 = (9, 15, 33, 45, 51, 63, 65, 85)


@dataclass(frozen=True)
class SignalConfig:
    """Physical-layer constants of one TWSTFT emission.

    Defaults are the production 100 kchip configuration: 2.5 Mchip/s,
    fs = 5 MS/s (2 samples/chip), 100 000-chip (40 ms) code, 25 codes/s
    (reference ``flashZedBoard.py:229-231``, ``godual_ranging.m:4-5``).
    """

    fs: float = 5e6  # IQ sample rate (S/s)
    chip_rate: float = 2.5e6  # chips/s
    code_len: int = 100_000  # chips per code period
    bit_len: int = 17  # LFSR register width
    taps: int = 9  # LFSR feedback taps (integer bitmask)
    taps_b: int | None = None  # second LFSR for QPSK, None => BPSK
    seed: int = 1  # LFSR seed (gateware resets to 1)
    f_carrier: float = 70e6  # IF carrier (informational)
    modulation: Modulation = Modulation.BPSK
    timecoder: TimeCoderMode = TimeCoderMode.OFF

    def __post_init__(self) -> None:
        sps = self.fs / self.chip_rate
        if abs(sps - round(sps)) > 1e-9:
            raise ValueError(f"fs/chip_rate must be integer, got {sps}")

    @property
    def samples_per_chip(self) -> int:
        return int(round(self.fs / self.chip_rate))

    @property
    def samples_per_code(self) -> int:
        """Samples in one code period (the per-epoch FFT length): 200 000."""
        return self.code_len * self.samples_per_chip

    @property
    def codes_per_second(self) -> float:
        """25 codes/s in production."""
        return self.chip_rate / self.code_len

    @property
    def code_duration(self) -> float:
        """40 ms in production."""
        return self.code_len / self.chip_rate


@dataclass(frozen=True)
class ProcessingConfig:
    """Switches selecting between the reference's processing-chain variants.

    The reference has five divergent implementations (Octave, numpy,
    pyFFTW, C++, DLL/PLL); this one kernel set reproduces each via these
    switches (SURVEY.md §7.1).
    """

    nint: int = 1  # zero-pad interpolation: ifft length = (2*nint+1)*n
    # (reference ``godual_ranging.m:5,27``)
    df_mode: DfMode = DfMode.PER_EPOCH
    # Frequency search window in Hz applied to the squaring FFT (which sees
    # 2*df).  The archived chain uses +/-20 kHz local, +/-(80..120) kHz
    # remote with site-dependent sign (``godual_ranging.m:83-90``); the C++
    # chain +/-8 kHz around foffset (``processing/CPP/main.cpp:400-406``).
    df_window_hz: tuple[float, float] = (-20e3, 20e3)
    foffset_hz: float = 0.0  # a-priori frequency offset (C++ argv[4])
    hamming_window: bool = False  # C++ windows the code spectrum
    # (``processing/CPP/main.cpp:717-719``)
    conjugate_data: bool = False  # claudio convention: fcode.*conj(ffty)
    # (``claudio_aligned_code_ranging_separate.m:59``) vs godual's
    # ffty.*conj(fcode) (``godual_ranging.m:25-26``)
    fine_freq: bool = False  # phase-drift fine df refinement
    # (``experiments/221219_twoway/processing/godual_ranging_fftw.py:35-39``)
    df_decimation: int = 25  # C++ per-file df pre-pass decimation
    # (``processing/CPP/main.cpp:776``)
    df_threshold: float = 20.0  # claudio spectral-line gate x median
    # (``claudio_aligned_code_ranging_separate.m:20,31``)
    snr_gate_db: float = -30.0  # claudio slip-detection SNR gate
    # (``claudio_...separate.m:175``)
    block_seconds: float = 2.0  # claudio streaming block length ``ls``
    skip_seconds: float = 30.0  # claudio skips the first 30 s
    # (``claudio_...separate.m:128``)
    dtype: str = "float32"  # compute dtype on TPU ("float64" for CPU parity)

    @property
    def interp_factor(self) -> int:
        """Time-domain oversampling of the correlation peak: 3 in production."""
        return 2 * self.nint + 1


@dataclass(frozen=True)
class CafConfig:
    """Dense cross-ambiguity (delay x Doppler) search grid.

    Replaces the hierarchical frequency-halving acquisition of the DLL/PLL
    receiver (``experiments/231001_DLL_PLL/rxcomplex.cpp:530-568``) with a
    dense batched grid — TPUs prefer dense compute (SURVEY.md §7.2 step 4).
    """

    doppler_min_hz: float = -5e3
    doppler_max_hz: float = 5e3
    doppler_step_hz: float = 100.0
    refine: bool = True  # parabolic refinement along both axes

    @property
    def n_doppler(self) -> int:
        span = self.doppler_max_hz - self.doppler_min_hz
        return int(round(span / self.doppler_step_hz)) + 1


@dataclass(frozen=True)
class StationConfig:
    """One ground station's identity and channel layout.

    ``op`` selects the PRN code parity and the sign of the remote-channel
    frequency window (reference ``godual_ranging.m:60-61,83-90``,
    ``claudio_...separate.m:107,137-141``).
    """

    name: str = "OP"
    op: bool = True  # True => OP (Paris), False => LTFB (Besançon)
    remote_channel: int = 2  # 1 or 2; local channel = 3 - remote_channel
    # (``claudio_...separate.m:25``)


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for the sharded pipeline (SURVEY.md §2.6).

    Axes: ``time`` shards epoch blocks (overlap-save halos exchanged via
    ``lax.ppermute``); ``channel`` shards channels x Doppler hypotheses
    (peak reduction via ``psum``/``argmax`` collectives).
    """

    time_axis: int = 1
    channel_axis: int = 1
    time_axis_name: str = "time"
    channel_axis_name: str = "channel"

    @property
    def n_devices(self) -> int:
        return self.time_axis * self.channel_axis


@dataclass(frozen=True)
class TwstftConfig:
    """Top-level bundle: one object configures the whole pipeline."""

    signal: SignalConfig = field(default_factory=SignalConfig)
    processing: ProcessingConfig = field(default_factory=ProcessingConfig)
    caf: CafConfig = field(default_factory=CafConfig)
    station: StationConfig = field(default_factory=StationConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    # ------------------------------------------------------------------
    # (De)serialization — replaces the reference's env-var site config
    # (``acquisition/env_variables.sh``) with explicit JSON files.
    # ------------------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(_asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "TwstftConfig":
        raw = json.loads(text)
        return cls(
            signal=_fromdict(SignalConfig, raw.get("signal", {})),
            processing=_fromdict(ProcessingConfig, raw.get("processing", {})),
            caf=_fromdict(CafConfig, raw.get("caf", {})),
            station=_fromdict(StationConfig, raw.get("station", {})),
            mesh=_fromdict(MeshConfig, raw.get("mesh", {})),
        )

    def config_hash(self) -> str:
        """Stable short hash keying idempotent resume (SURVEY.md §5
        "Checkpoint / resume": resume contract keyed on (capture-id,
        epoch-range, config-hash))."""
        import hashlib

        return hashlib.sha256(self.to_json().encode()).hexdigest()[:16]


def _asdict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            f.name: _asdict(getattr(obj, f.name)) for f in dataclasses.fields(obj)
        }
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, tuple):
        return list(obj)
    return obj


def _fromdict(cls: type, raw: dict) -> Any:
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in raw:
            continue
        v = raw[f.name]
        t = f.type if isinstance(f.type, type) else None
        if isinstance(v, list):
            v = tuple(v)
        # enum fields round-trip through their .value
        default = f.default
        if isinstance(default, enum.Enum):
            v = type(default)(v)
        kwargs[f.name] = v
    return cls(**kwargs)
