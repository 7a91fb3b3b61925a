"""The per-code aligned tracking chain ("claudio" scripts), in torch.

The port's counterpart of the JAX package's ``models/claudio.py``.
Behaviour (``acquisition/claudio_aligned_code_ranging_separate.m``):

- single-channel files ``*_1.bin`` / ``*_2.bin``, consumed in 2-s blocks
  with a leftover carry ``dold`` between blocks (:148, :167, :196-200),
- the first 30 s are skipped while hunting the Doppler line; once
  ``search_df`` validates a spectral candidate the stream restarts from
  the file beginning (:128, :153-160),
- per block, df is refreshed by an argmax within +/-3 bins of the locked
  line (:168-169), on the fixed-length raw block rather than the
  carry-extended one (a deliberate deviation the JAX package makes too),
- each 40 ms code window is correlated at that df; when the peak wanders
  from the window edge with sufficient SNR, the stream is re-seeked
  ("MOVED") and the window reprocessed (:171-193), as batched correlation
  plus masked re-computation from the first slip on,
- outputs: per-code ``xval1``/``indice1``/``correction1``/SNR/power, the
  per-block ``df`` series and the ``moved`` slip list (:207).

Two paths, picked by ``transfer``:

- the **resident int8 path** (``"auto"`` on the card, ``"int8"`` on either
  device): each raw 2-s block is read by the native library
  (``utils/io.read_raw16``), quantized to int8 on the host and
  uploaded once; a block step assembles carry + block into a float32
  device buffer, refreshes df on the raw block, gathers the windows and
  runs the packed ranging step, so a block costs one result fetch; slip
  re-correlations gather from the same buffer and ship only offsets.  On
  the card the next block's read, quantization and upload (pinned staging
  buffer, copy stream, event) go out before the current block's fetch;
- the **per-call path** (``"auto"`` on the CPU, in ``dtype``; ``"f32"``
  through an unpacked ranging step on float32 pairs): each block is read
  as complex and its windows are correlated as one batch.

Where the JAX package marks a carry trim with a negative entry in
``moved``, the port keeps ``moved`` for slips only and lists trims in
``carry_trimmed`` (in the result and, when non-empty, the ``.mat``).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from amaranth_twstft_tpu_torch.config import (
    ProcessingConfig,
    SignalConfig,
    StationConfig,
)
from amaranth_twstft_tpu_torch.models.godual import build_replica
from amaranth_twstft_tpu_torch.ops import boundary
from amaranth_twstft_tpu_torch.ops.correlator import EpochResult, correlate_epochs
from amaranth_twstft_tpu_torch.ops.doppler import (
    refresh_df,
    refresh_df_ri,
    search_df_candidates,
    search_df_candidates_ri,
    window_mask,
)
from amaranth_twstft_tpu_torch.utils import io, matio
from amaranth_twstft_tpu_torch.utils.platform import resolve_device

__all__ = ["claudio_df_window", "process_file", "output_name"]

_NP_COMPLEX = {torch.complex64: np.complex64, torch.complex128: np.complex128}

# the resident path issues the next block's read, quantize and upload
# before the current block's fetch; off, each upload goes out when its
# block is due (the results do not depend on it)
_PREFETCH = True


def claudio_df_window(station: StationConfig, ranging: bool) -> tuple[float, float]:
    """Search window on the doubled-frequency axis: +/-8 kHz for the
    loopback/ranging channel, 92..108 kHz (OP-signed) for remote
    (``claudio_...separate.m:135-141``)."""
    if ranging:
        return (-8e3, 8e3)
    if station.op:
        return (-108e3, -92e3)
    return (92e3, 108e3)


def output_name(capture_name: str, remote: bool, ranging: bool) -> str:
    """``remoteclaudio<name>.mat`` / ``rangingclaudio`` / ``localclaudio``
    (``claudio_...separate.m:110-117``)."""
    stem = os.path.basename(capture_name).replace(".bin", ".mat")
    if remote:
        return "remoteclaudio" + stem
    if ranging:
        return "rangingclaudio" + stem
    return "localclaudio" + stem


@dataclass
class _Acc:
    xval: list = field(default_factory=list)
    indice: list = field(default_factory=list)  # non-interpolated grid, float
    correction: list = field(default_factory=list)
    snr_r: list = field(default_factory=list)
    snr_i: list = field(default_factory=list)
    puissance: list = field(default_factory=list)
    df_per_code: list = field(default_factory=list)
    moved: list = field(default_factory=list)  # 1-based slip epochs
    carry_trimmed: list = field(default_factory=list)  # 1-based epochs


def _quantize_q8(a16: np.ndarray, out: np.ndarray | None = None):
    """Chunked int16 -> int8 quantization (``q = round(x/scale)``,
    ``scale = max|x|/127``), the JAX package's ``_quantize_q8``
    (``claudio.py:84-101``) with an optional ``out`` array (for example a
    pinned staging buffer) of ``a16``'s shape.  Returns (q, scale)."""
    CH = 1 << 21
    flat = a16.reshape(-1)
    m = 0
    for i in range(0, flat.size, CH):
        c = flat[i : i + CH]
        m = max(m, int(c.max(initial=0)), -int(c.min(initial=0)))
    scale = m / 127.0 if m else 1.0
    if out is None:
        out = np.empty(a16.shape, np.int8)
    oflat = out.reshape(-1)
    inv = np.float32(1.0 / scale)
    for i in range(0, flat.size, CH):
        q = np.round(flat[i : i + CH] * inv)
        np.clip(q, -127, 127, out=q)
        oflat[i : i + CH] = q.astype(np.int8)
    return out, scale


class _Resident:
    """The bound steps of the resident path for one replica geometry.

    Buffer geometry (``claudio.py:138-147``): the valid prefix of a block
    buffer is ``dold_len + block`` samples; the carry is the previous
    buffer's slice from ``tail``, of which only its first ``dold_len <=
    CARRY = 4L`` samples are ever addressed (window offsets stop at
    ``dold_len + block - L``, the refresh starts at ``dold_len``), and
    ``CAP = block + 2*CARRY`` leaves the slack the JAX package's clamping
    slices rely on.  torch slices do not clamp, so every start and every
    window is checked against the buffer on the host."""

    def __init__(self, rep, L: int, block: int, fs: float, nint: int, dev):
        self.step_packed = boundary.make_ranging_step(
            rep.fcode, rep.code_interp, np.ones(L, bool), fs, nint=nint,
            conjugate_data=True, packed=True, device=dev,
        )
        self.L, self.block, self.fs, self.dev = L, block, float(fs), dev
        self.carry = 4 * L
        self.cap = block + 2 * self.carry
        self.pad_to = (block + self.carry) // L  # windows of dold + block
        self.lane = torch.arange(L, device=dev)

    def new_buffer(self) -> torch.Tensor:
        return torch.zeros((self.cap, 2), dtype=torch.float32, device=self.dev)

    def windows(self, x: torch.Tensor, offsets: np.ndarray, valid: int):
        """(pad_to, L, 2) windows of ``x`` at ``offsets`` (zero-padded to
        ``pad_to``), as one index gather ``offsets[:, None] + arange(L)``."""
        n = len(offsets)
        if n and (offsets.min() < 0 or offsets.max() + self.L > valid):
            raise IndexError(
                f"claudio window out of the buffer's {valid} valid samples: "
                f"offsets {offsets.min()}..{offsets.max()} with L={self.L}")
        o = torch.zeros(self.pad_to, dtype=torch.int64)
        o[:n] = torch.from_numpy(offsets)
        if self.dev.type == "cuda":
            # from pinned memory: a pageable copy would wait for the
            # stream to drain first
            o = o.pin_memory().to(self.dev, non_blocking=True)
        return x[o[:, None] + self.lane]

    def assemble(self, x, prev, tail: int, dold_len: int, q8, scale: float):
        """Carry slice of ``prev`` to the front of ``x``, then the
        dequantized block at ``dold_len``."""
        if dold_len > self.carry or tail + dold_len > self.cap:
            raise IndexError(f"carry [{tail}, {tail + dold_len}) outside the buffer")
        if dold_len:
            x[:dold_len] = prev[tail : tail + dold_len]
        x[dold_len : dold_len + self.block] = q8.to(torch.float32) * scale

    def block_step(self, x, prev, tail, dold_len, q8, scale, kbon, offsets):
        """Assemble, refresh df on the raw block, correlate the windows.
        Returns (df, packed (pad_to, 14)) as device tensors."""
        self.assemble(x, prev, tail, dold_len, q8, scale)
        raw = x[dold_len : dold_len + self.block]
        df, _ = refresh_df_ri(raw, self.fs, kbon)
        packed = self.step_packed(
            self.windows(x, offsets, dold_len + self.block),
            df_fixed=df.to(torch.float32))
        return df, packed

    def slip_step(self, x, offsets, valid: int, df):
        return self.step_packed(self.windows(x, offsets, valid), df_fixed=df)


#: (code path, L, block, nint, fs, hamming, replica dtype, device) ->
#: :class:`_Resident`: the bound steps (replica spectrum, window matrix)
#: survive across ``process_file`` calls, so a session's files with the
#: same code build them once.  ``interp_factor`` is ``2*nint + 1``, so
#: ``nint`` covers it.
_RESIDENT_CACHE: dict = {}


def _resident_key(code_path, L, block, proc, fs, rep, dev) -> tuple:
    return (os.path.abspath(code_path), L, block, proc.nint, float(fs),
            bool(proc.hamming_window), str(rep.fcode.dtype), str(dev))


def _slice_result(res: EpochResult, n: int) -> EpochResult:
    return EpochResult(**{f: getattr(res, f)[:n]
                          for f in res.__dataclass_fields__})


def _decode_packed(packed_np: np.ndarray, n: int) -> EpochResult:
    """Packed (pad_to, 14) rows -> NumPy-backed EpochResult[:n]."""
    full = boundary.to_epoch_result(boundary.unpack_outputs(packed_np))
    return _slice_result(full, n)


def _correlate_windows(d_block, offsets, rep, proc, df, fs, dev, step=None,
                       pad_to=0) -> EpochResult:
    """Correlate windows of the host array ``d_block`` at ``offsets``.

    With ``step`` (a bound unpacked ranging step) the windows go as
    float32 pairs, zero-padded to the fixed batch ``pad_to``; without, in
    the block's own complex dtype through the full correlator."""
    L = rep.samples_per_code
    wins = np.stack([d_block[o : o + L] for o in offsets])
    n = len(offsets)
    if step is not None:
        if pad_to > n:
            wins = np.concatenate([wins, np.zeros((pad_to - n, L), wins.dtype)])
        outs = step(torch.from_numpy(boundary.pack_complex(wins)).to(dev),
                    df_fixed=df)
        return _slice_result(boundary.to_epoch_result(outs), n)
    real = torch.float64 if wins.dtype == np.complex128 else torch.float32
    res = correlate_epochs(
        torch.from_numpy(wins).to(dev),
        torch.as_tensor(rep.fcode, device=dev),
        torch.full((n,), df, dtype=real, device=dev),
        torch.as_tensor(rep.code_interp, device=dev),
        fs,
        nint=proc.nint,
        conjugate_data=True,
        fcode_interp=torch.as_tensor(rep.fcode_interp, device=dev),
    )
    return res.to_host()


class _Uploader:
    """Reads, quantizes and uploads raw blocks for the resident path.

    On the card each block is quantized into one of two pinned staging
    buffers, copied ``non_blocking`` on a copy stream, and an event orders
    the compute stream after the copy; a staging buffer is refilled only
    after its previous copy's event.  On the CPU the staging buffers are
    handed to the step as they are (it has consumed a buffer before the
    one after next is filled)."""

    def __init__(self, path: str, block: int, dev, timing: dict):
        self.path, self.block, self.dev, self.t = path, block, dev, timing
        self.card = dev.type == "cuda"
        self.raw = np.empty((block, 2), np.int16)
        self.staging = [torch.empty((block, 2), dtype=torch.int8,
                                    pin_memory=self.card) for _ in range(2)]
        self.events = [None, None]
        self.k = 0
        if self.card:
            self.copy_stream = torch.cuda.Stream(device=dev)
            self.compute = torch.cuda.current_stream(dev)

    def get(self, pos: int):
        """The block at ``pos`` as ``(q8 tensor, scale, copied event)``,
        or None when fewer than ``block`` samples remain."""
        t0 = time.perf_counter()
        _, nf = io.read_raw16(self.path, pos, self.block, out=self.raw)
        t1 = time.perf_counter()
        self.t["read_s"] += t1 - t0
        if nf < self.block:
            return None
        k = self.k
        self.k ^= 1
        if self.events[k] is not None:
            self.events[k].synchronize()  # its previous copy has read it
        t2 = time.perf_counter()
        _, scale = _quantize_q8(self.raw, out=self.staging[k].numpy())
        t3 = time.perf_counter()
        self.t["quantize_s"] += t3 - t2
        if not self.card:
            return self.staging[k], scale, None
        with torch.cuda.stream(self.copy_stream):
            q8 = self.staging[k].to(self.dev, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.copy_stream)
        self.events[k] = ev
        self.t["h2d_enqueue_s"] += time.perf_counter() - t3
        self.t["bytes_shipped"] += self.block * 2
        return q8, scale, ev

    def ready(self, q8, ev) -> None:
        """Order the compute stream after ``q8``'s copy."""
        if ev is not None:
            self.compute.wait_event(ev)
            q8.record_stream(self.compute)


def _hunt(capture_path, rep, proc, fs, block, lo_hz, hi_hz, dev, resident,
          step, np_dtype) -> int:
    """Scan blocks from ``skip_seconds`` on until a Doppler line
    validates; returns its shifted-spectrum bin or -1
    (``claudio.py:319-395``).  The resident hunt takes the int8 block as
    ``d`` and the unquantized first code period, minus its mean, as
    ``dcode``; the replica spectrum and the mask are uploaded once and
    released on return."""
    L = rep.samples_per_code
    n_total = io.n_samples_sc16(capture_path, channels=1)
    mask = window_mask(block, fs, lo_hz, hi_hz)
    pos = int(proc.skip_seconds * fs)
    kw = dict(threshold=proc.df_threshold)
    ri = resident or step is not None
    if ri and pos + block <= n_total:
        dev_fcode = torch.from_numpy(boundary.pack_complex(rep.fcode)).to(dev)
        dev_mask = torch.from_numpy(mask).to(dev)
    while pos + block <= n_total:
        if resident:
            blk16, nf = io.read_raw16(capture_path, pos, block)
            if nf < block:
                break
            q8, _ = _quantize_q8(blk16)
            dc = blk16[:L].astype(np.float32)
            dc -= dc.mean(axis=0, keepdims=True)
            kb, _ = search_df_candidates_ri(
                torch.from_numpy(q8).to(dev), torch.from_numpy(dc).to(dev),
                dev_fcode, fs, dev_mask, **kw)
            kbon = int(kb)
        else:
            d, n = io.read_sc16_epochs(capture_path, pos, 1, block, channels=1,
                                       dtype=np_dtype)
            if n == 0:
                break
            dblk = d[0, 0]
            dcode = dblk[:L] - dblk[:L].mean()
            if ri:
                pc = lambda z: torch.from_numpy(boundary.pack_complex(z)).to(dev)  # noqa: E731
                kb, _ = search_df_candidates_ri(pc(dblk), pc(dcode), dev_fcode,
                                                fs, dev_mask, **kw)
                kbon = int(kb)
            else:
                kbon, _ = search_df_candidates(
                    torch.from_numpy(dblk).to(dev), torch.from_numpy(dcode).to(dev),
                    torch.as_tensor(rep.fcode, device=dev), fs, mask, **kw)
        if kbon >= 0:
            return kbon
        pos += block
    return -1


def process_file(
    capture_path: str,
    code_path: str,
    signal: SignalConfig,
    proc: ProcessingConfig | None = None,
    station: StationConfig | None = None,
    remote: bool = False,
    ranging: bool = True,
    out_dir: str | None = None,
    dtype=torch.complex128,
    max_slip_passes: int = 4,
    verbose: bool = False,
    transfer: str = "auto",
    df_window_hz: tuple[float, float] | None = None,
    device=None,
) -> dict | None:
    """Run the claudio chain over one single-channel capture file on
    ``device`` (default ``cuda``).

    ``transfer``: ``"auto"`` takes the resident int8 path on the card and
    the per-call ``dtype`` path on the CPU; ``"int8"`` forces the resident
    path on either device; ``"f32"`` the per-call path through an
    unpacked ranging step on float32 pairs.  ``max_slip_passes`` bounds
    the masked slip re-correlations of each block.

    Returns the result dict — ``found``, the per-code arrays, ``moved``,
    ``carry_trimmed``, ``mat_path`` and a ``timing`` dict of wall seconds
    per layer — or None if the output already exists (the reference's
    idempotent resume, ``claudio_...separate.m:119``).
    """
    if transfer not in ("auto", "int8", "f32"):
        raise ValueError(f"transfer must be auto, int8 or f32, not {transfer!r}")
    dev = resolve_device(device)
    proc = proc or ProcessingConfig(df_window_hz=(-8e3, 8e3), conjugate_data=True)
    station = station or StationConfig()
    out_dir = out_dir or (os.path.dirname(capture_path) or ".")
    out_mat = os.path.join(
        out_dir, output_name(os.path.basename(capture_path), remote, ranging))
    if io.already_done(out_mat):
        return None

    t_all = time.perf_counter()
    timing = {"setup_s": 0.0, "hunt_s": 0.0, "read_s": 0.0, "quantize_s": 0.0,
              "h2d_enqueue_s": 0.0, "bytes_shipped": 0, "block_step_ms": [],
              "fetch_wait_s": 0.0, "slip_ms": [], "mat_write_s": 0.0,
              "cache_hit": None}
    # claudio builds the replica *without* conjugating the code spectrum;
    # the data is conjugated instead (fcode=fft(code), :124)
    rep = build_replica(code_path, signal, proc, conjugate=False, dtype=dtype)
    L = rep.samples_per_code
    fs = signal.fs
    block = int(fs * proc.block_seconds)  # complex samples per block
    # df hunt window: the production Hz constants by default
    # (claudio_...separate.m:135-141); an explicit override supports
    # non-production sample rates (scaled test geometries)
    lo_hz, hi_hz = (df_window_hz if df_window_hz is not None
                    else claudio_df_window(station, ranging))
    np_dtype = _NP_COMPLEX[dtype]
    resident = transfer == "int8" or (transfer == "auto" and dev.type == "cuda")
    step = res_steps = None
    pad_to = 0
    if transfer == "f32":
        step = boundary.make_ranging_step(
            rep.fcode, rep.code_interp, np.ones(L, bool), fs, nint=proc.nint,
            conjugate_data=True, device=dev)
        pad_to = block // L + 2  # max windows in a carry-extended block
    if resident:
        rk = _resident_key(code_path, L, block, proc, fs, rep, dev)
        timing["cache_hit"] = rk in _RESIDENT_CACHE
        if rk not in _RESIDENT_CACHE:
            _RESIDENT_CACHE[rk] = _Resident(rep, L, block, fs, proc.nint, dev)
        res_steps = _RESIDENT_CACHE[rk]
    timing["setup_s"] = time.perf_counter() - t_all

    acc = _Acc()
    t0 = time.perf_counter()
    kbon = _hunt(capture_path, rep, proc, fs, block, lo_hz, hi_hz, dev,
                 resident, step, np_dtype)
    timing["hunt_s"] = time.perf_counter() - t0
    if kbon < 0:
        # no signal found in the whole file
        t0 = time.perf_counter()
        matio.save_claudio_style(out_mat, _acc_asdict(acc), code=rep.code)
        timing["mat_write_s"] = time.perf_counter() - t0
        timing["total_s"] = time.perf_counter() - t_all
        return {"mat_path": out_mat, "found": False, "timing": timing}

    # ---- main loop from the file start (the reference rewinds) ----------
    pos = 0
    dold = np.zeros(0, dtype=np_dtype)
    p = 1  # 1-based epoch counter like the reference printouts
    card = dev.type == "cuda"
    if resident:
        up = _Uploader(capture_path, block, dev, timing)
        bufs = [res_steps.new_buffer(), res_steps.new_buffer()]
        k_buf = 0
        tail16 = 0  # carry start within the previous buffer
        dold_len = 0
        pending = None  # (q8, scale, event): next raw block, upload issued
        at_eof = False  # the prefetch already saw the short tail
        events = []  # (start, end) CUDA events of each block step
    while True:
        if resident:
            if pending is None:
                if at_eof:
                    break  # the reference drops the final partial block
                pending = up.get(pos)
                if pending is None:
                    break  # the reference drops the final partial block
                pos += block
            q8, scale, ev = pending
            pending = None
            n = 1
            if dold_len > res_steps.carry:  # pathological slip pile-up
                acc.carry_trimmed.append(p)
                tail16 += dold_len - res_steps.carry
                dold_len = res_steps.carry
            dcat_len = dold_len + block
            offsets = np.arange(0, dcat_len - L + 1, L, dtype=np.int64)
            n_win = len(offsets)
            x, prev = bufs[k_buf], bufs[k_buf ^ 1]
            k_buf ^= 1
            up.ready(q8, ev)
            tb = time.perf_counter()
            if card:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
            # carry assembly + df refresh + window batch in one step
            df_dev, packed_dev = res_steps.block_step(
                x, prev, tail16, dold_len, q8, float(np.float32(scale)), kbon,
                offsets)
            if card:
                e1.record()
                events.append((e0, e1))
            else:
                timing["block_step_ms"].append(1e3 * (time.perf_counter() - tb))
            if _PREFETCH:
                # the next raw block's read + quantize + upload go out
                # while this block computes
                pending = up.get(pos)
                if pending is None:
                    at_eof = True  # don't re-read the short tail
                else:
                    pos += block
            tf = time.perf_counter()
            packed = packed_dev.cpu().numpy()  # one result fetch per block
            timing["fetch_wait_s"] += time.perf_counter() - tf
            # the rows carry the block's float32 df in their df column, so
            # the fetch above is the block's only one
            df_val = float(packed[0, boundary.PACKED_FIELDS.index("df")])
            df_dev = df_dev.to(torch.float32)
            res = _decode_packed(packed, n_win)
        else:
            tr = time.perf_counter()
            d, n = io.read_sc16_epochs(capture_path, pos, 1, block, channels=1,
                                       dtype=np_dtype)
            timing["read_s"] += time.perf_counter() - tr
            if n == 0:
                break
            pos += block
            dcat = np.concatenate([dold, d[0, 0]])
            dcat_len = len(dcat)
            # df refresh within +/-3 bins of the locked line (:168-169),
            # on the fixed-length raw block
            tb = time.perf_counter()
            if step is not None:
                df_val = float(refresh_df_ri(
                    torch.from_numpy(boundary.pack_complex(d[0, 0])).to(dev),
                    fs, kbon)[0])
            else:
                df_val = float(refresh_df(torch.from_numpy(d[0, 0]).to(dev),
                                          fs, kbon)[0])
            offsets = np.arange(0, dcat_len - L + 1, L, dtype=np.int64)
            if len(offsets) == 0:
                dold = dcat
                continue
            n_win = len(offsets)

        # ---- masked slip recompute ----------------------------------------
        def corr(offs):
            if resident:
                # the buffer is already on the device: only offsets ship
                ts = time.perf_counter()
                pk = res_steps.slip_step(x, offs, dcat_len, df_dev).cpu().numpy()
                timing["slip_ms"].append(1e3 * (time.perf_counter() - ts))
                return _decode_packed(pk, len(offs))
            return _correlate_windows(dcat, offs, rep, proc, df_val, fs, dev,
                                      step=step, pad_to=pad_to)

        if not resident:
            res = corr(offsets)
            timing["block_step_ms"].append(1e3 * (time.perf_counter() - tb))

        for _pass in range(max_slip_passes):
            ind3 = np.asarray(res.indice, dtype=np.float64)
            indice_ni = ind3 / proc.interp_factor  # non-interp grid (0-based)
            snr_db = 10.0 * np.log10(np.maximum(
                np.asarray(res.snr_r) + np.asarray(res.snr_i), 1e-30
            ))
            # slip: peak away from either window edge with usable SNR
            # (:175-186; indices there are 1-based -> >43 & <len/2 etc.)
            slipped = (snr_db > proc.snr_gate_db) & (
                ((indice_ni > 42) & (indice_ni < L / 2))
                | ((indice_ni < L - 3) & (indice_ni >= L / 2))
            )
            first = int(np.argmax(slipped)) if slipped.any() else -1
            if first < 0:
                break
            # re-seek: dindex -= indice - 21 (+L if it would go negative)
            shift = int(round(indice_ni[first])) - 21
            offsets = offsets.copy()
            offsets[first:] = offsets[first:] - shift
            if offsets[first] < 0:
                offsets[first:] += L
            # drop windows that no longer fit
            keep = offsets + L <= dcat_len
            offsets = offsets[keep]
            n_win = len(offsets)
            if n_win == 0:
                break
            acc.moved.append(p + first)
            res = corr(offsets)

        if n_win:
            ind3 = np.asarray(res.indice, dtype=np.float64)
            acc.indice.extend((ind3 / proc.interp_factor).tolist())
            acc.correction.extend(np.asarray(res.correction).tolist())
            acc.xval.extend(np.asarray(res.xval).tolist())
            acc.snr_r.extend(np.asarray(res.snr_r).tolist())
            acc.snr_i.extend(np.asarray(res.snr_i).tolist())
            acc.puissance.extend(np.asarray(res.puissance).tolist())
            acc.df_per_code.extend([df_val] * n_win)
            if verbose:
                corr_np = np.asarray(res.correction)
                vdb = 10.0 * np.log10(np.maximum(
                    np.asarray(res.snr_r) + np.asarray(res.snr_i), 1e-30
                ))
                for i in range(n_win):
                    print(
                        f"{p+i}\t{(ind3[i]+corr_np[i])/fs/proc.interp_factor:.12f}"
                        f"\t{df_val:.3f}\t{float(vdb[i]):.1f}"
                    )
            p += n_win
            tail = offsets[-1] + L
        else:
            tail = 0
        if resident:
            tail16 = int(tail)  # carry start within this buffer
            dold_len = dcat_len - tail16
        else:
            dold = dcat[tail:]
        if n < 1:
            # like the reference, the final PARTIAL block (and its carry)
            # is dropped: its fread loop exits on any short read
            # (claudio_...separate.m:147,205)
            break

    if resident and card:
        torch.cuda.synchronize(dev)
        timing["block_step_ms"] = [a.elapsed_time(b) for a, b in events]
    t0 = time.perf_counter()
    matio.save_claudio_style(out_mat, _acc_asdict(acc), code=rep.code,
                             moved=acc.moved, carry_trimmed=acc.carry_trimmed)
    timing["mat_write_s"] = time.perf_counter() - t0
    timing["total_s"] = time.perf_counter() - t_all
    return {
        "mat_path": out_mat,
        "found": True,
        "indice": np.asarray(acc.indice),
        "correction": np.asarray(acc.correction),
        "xval": np.asarray(acc.xval),
        "snr_r": np.asarray(acc.snr_r),
        "snr_i": np.asarray(acc.snr_i),
        "df": np.asarray(acc.df_per_code),
        "moved": acc.moved,
        "carry_trimmed": acc.carry_trimmed,
        "timing": timing,
    }


def _acc_asdict(acc: _Acc) -> dict:
    return {
        "indice": np.asarray(acc.indice),
        "correction": np.asarray(acc.correction),
        "snr_r": np.asarray(acc.snr_r),
        "snr_i": np.asarray(acc.snr_i),
        "df": np.asarray(acc.df_per_code),
        "puissance": np.asarray(acc.puissance),
        "xval": np.asarray(acc.xval),
    }
