"""ctypes bindings for the port's native C++ host library.

The port's copy of the JAX package's ``native/``: the same three sources
(``ingest.cpp``, ``matwriter.cpp``, ``mseq.cpp``, beside this file) and
the same public functions:

- :func:`ingest_epochs` / :func:`ingest_decimated` / :func:`write_sc16` —
  mmap + threaded sc16 ingest producing the float32 (..., 2) boundary
  layout directly,
- :func:`ingest_into` — the same threaded ingest into the caller's
  float32 arrays (the float32 views of ``utils/io.read_sc16_epochs``'
  complex64 rows),
- :func:`quantize_q8` / :func:`read_raw16` — the threaded int8 quantizer
  and the raw int16 frame copy behind ``utils/io``'s int8 and raw16
  readers and claudio's raw-block reads; both write into the caller's
  buffer when given ``out``,
- :func:`file_frames` / :func:`file_mtime` — capture sizing and the
  ``stat.c`` end-of-capture timestamp recovery,
- :func:`save_mat` — dependency-free MAT v5 writer (GoRanging::save
  field conventions),
- :func:`is_mseq` / :func:`find_mseq` / :func:`prn_chips` — the fast
  LFSR engine.

``g++`` builds ``libtwstft_native.so`` into the git-ignored
``amaranth_twstft_tpu_torch/build/`` at first use, and again when a
source is newer (:func:`build` does it ahead of time).  There is no
fallback: a failed build raises with the compiler's output.  Every read
of sc16 sample bytes in the port is one call into this library; the
plain versions are private references the tests hold it to
(``utils/io._quantize_q8_plain``, ``ops/lfsr._is_mseq_py`` and
``_find_mseq_taps_np``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time

import numpy as np

from amaranth_twstft_tpu_torch.utils.cuda_build import BUILD_DIR

__all__ = [
    "build",
    "load",
    "file_frames",
    "file_mtime",
    "ingest_epochs",
    "ingest_decimated",
    "ingest_into",
    "quantize_q8",
    "read_raw16",
    "write_sc16",
    "save_mat",
    "is_mseq",
    "find_mseq",
    "prn_chips",
]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ["ingest.cpp", "matwriter.cpp", "mseq.cpp"]
_SO = os.path.join(BUILD_DIR, "libtwstft_native.so")
_CXX = "g++"
# -march=native first: the quantize/deinterleave loops vectorize to
# AVX2/AVX-512 where available (-fno-math-errno lets lrintf lower to
# cvtps2dq); plain -O3 where the compiler refuses it
_FLAG_SETS = (["-march=native"], [])

_lock = threading.Lock()
_lib = None


def _stale() -> bool:
    if not os.path.exists(_SO):
        return True
    t = os.path.getmtime(_SO)
    return any(os.path.getmtime(os.path.join(_HERE, s)) > t for s in _SOURCES)


def build(force: bool = False) -> dict:
    """Compile the library with ``g++`` unless it is up to date.

    Returns ``{"built", "seconds", "flags"}``; raises RuntimeError with
    the compiler's output when every flag set fails.  The library is
    written to a temporary file and renamed into place, so processes
    that build at once never load a partial file."""
    with _lock:
        return _build_locked(force)


def _build_locked(force: bool) -> dict:
    if not (force or _stale()):
        return {"built": False, "seconds": 0.0, "flags": None}
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    srcs = [os.path.join(_HERE, s) for s in _SOURCES]
    tmp = f"{_SO}.tmp{os.getpid()}.{threading.get_ident()}"
    t0 = time.perf_counter()
    errors = []
    for extra in _FLAG_SETS:
        flags = ["-O3", *extra, "-fno-math-errno", "-shared", "-fPIC",
                 "-pthread", "-std=c++17"]
        cmd = [_CXX, *flags, "-o", tmp, *srcs]
        try:
            p = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            errors.append(f"{' '.join(cmd)}: {e}")
            continue
        if p.returncode == 0:
            os.replace(tmp, _SO)
            return {"built": True, "seconds": time.perf_counter() - t0,
                    "flags": " ".join(flags)}
        errors.append(f"{' '.join(cmd)}: exit {p.returncode}\n{p.stdout}{p.stderr}")
    if os.path.exists(tmp):
        os.remove(tmp)
    raise RuntimeError("native library build failed:\n" + "\n".join(errors))


def load() -> ctypes.CDLL:
    """The ctypes handle of the library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        _build_locked(False)
        lib = ctypes.CDLL(_SO)
        lib.twstft_file_frames.restype = ctypes.c_int64
        lib.twstft_file_frames.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.twstft_file_mtime.restype = ctypes.c_double
        lib.twstft_file_mtime.argtypes = [ctypes.c_char_p]
        lib.twstft_ingest_file.restype = ctypes.c_int64
        lib.twstft_ingest_file.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.twstft_ingest_decimated.restype = ctypes.c_int64
        lib.twstft_ingest_decimated.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ]
        lib.twstft_quantize_q8.restype = ctypes.c_int64
        lib.twstft_quantize_q8.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int8),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.twstft_read_raw16.restype = ctypes.c_int64
        lib.twstft_read_raw16.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int16), ctypes.c_int,
        ]
        lib.twstft_write_sc16.restype = ctypes.c_int64
        lib.twstft_write_sc16.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)), ctypes.c_int64,
        ]
        lib.twstft_mat_open.restype = ctypes.c_void_p
        lib.twstft_mat_open.argtypes = [ctypes.c_char_p]
        lib.twstft_mat_write_real.restype = ctypes.c_int
        lib.twstft_mat_write_real.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ]
        lib.twstft_mat_write_complex.restype = ctypes.c_int
        lib.twstft_mat_write_complex.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
        ]
        lib.twstft_mat_close.restype = ctypes.c_int
        lib.twstft_mat_close.argtypes = [ctypes.c_void_p]
        lib.twstft_is_mseq.restype = ctypes.c_int
        lib.twstft_is_mseq.argtypes = [
            ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64
        ]
        lib.twstft_find_mseq.restype = ctypes.c_int
        lib.twstft_find_mseq.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int
        ]
        lib.twstft_prn_chips.restype = None
        lib.twstft_prn_chips.argtypes = [
            ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        _lib = lib
        return lib


def _chan_ptrs(arrs):
    ptrs = (ctypes.POINTER(ctypes.c_float) * len(arrs))()
    for i, a in enumerate(arrs):
        ptrs[i] = a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    return ptrs


def _n_threads(n_threads: int) -> int:
    return n_threads if n_threads > 0 else min(os.cpu_count() or 2, 8)


def _dest(out, n_frames: int, width: int, dtype) -> np.ndarray:
    """``out`` checked as the C-contiguous (n_frames, width) array of
    ``dtype`` the library writes into, or a new one."""
    if out is None:
        return np.empty((n_frames, width), dtype=dtype)
    if (out.dtype != dtype or out.shape != (n_frames, width)
            or not out.flags.c_contiguous or not out.flags.writeable):
        raise ValueError(
            f"out must be a writable C-contiguous {np.dtype(dtype)} array of "
            f"shape {(n_frames, width)}, got {out.dtype} {out.shape}")
    return out


def file_frames(path: str, channels: int = 2) -> int:
    return int(load().twstft_file_frames(path.encode(), channels))


def file_mtime(path: str) -> float:
    return float(load().twstft_file_mtime(path.encode()))


def ingest_epochs(
    path: str,
    start_sample: int,
    n_epochs: int,
    samples_per_epoch: int,
    channels: int = 2,
    n_threads: int = 4,
):
    """Read the whole epochs from ``start_sample`` as float32 (channels,
    n, L, 2) through an mmap and a threaded deinterleave
    (:func:`ingest_into`, one row a channel).  Returns (array, n_read)."""
    L = samples_per_epoch
    n = min(n_epochs, max(0, (file_frames(path, channels) - start_sample) // L))
    out = np.empty((channels, n, L, 2), dtype=np.float32)
    ingest_into(path, start_sample, n * L,
                [out[c].reshape(-1) for c in range(channels)], n_threads)
    return out, n


def ingest_into(path: str, start_frame: int, n_frames: int, outs,
                n_threads: int = 0) -> int:
    """Deinterleave frames ``[start_frame, start_frame + n_frames)`` of a
    ``len(outs)``-channel sc16 file straight into the caller's arrays:
    ``outs[c]``, writable C-contiguous float32 of at least ``2 *
    n_frames`` floats, gets channel c's (re, im) pairs, the layout of a
    complex64 row's float32 view.  One mmap and one pass on up to
    ``n_threads`` threads (0: up to 8, one a core; one below 2^16 frames).
    Returns the threads the pass ran on.  A file that cannot be read, or
    that holds fewer frames, raises OSError."""
    if start_frame < 0 or n_frames < 0:
        raise ValueError(f"frames [{start_frame}, +{n_frames}) out of range")
    if not outs:
        raise ValueError("outs must hold one array a channel")
    for a in outs:
        if (not isinstance(a, np.ndarray) or a.dtype != np.float32
                or not a.flags.c_contiguous or not a.flags.writeable
                or a.size < 2 * n_frames):
            raise ValueError(
                "each out must be a writable C-contiguous float32 array of at "
                f"least {2 * n_frames} floats, got {getattr(a, 'dtype', type(a))} "
                f"{getattr(a, 'shape', '')}")
    used = ctypes.c_int(0)
    got = int(load().twstft_ingest_file(
        os.fsencode(path), len(outs), start_frame, n_frames, _chan_ptrs(outs),
        _n_threads(n_threads), ctypes.byref(used)))
    if got < 0:
        raise OSError(f"ingest failed: {path}")
    if got != n_frames:
        raise OSError(f"{path}: {got} of {n_frames} frames read (the file "
                      "shrank during the read)")
    return used.value


def ingest_decimated(path: str, decim: int, channels: int = 2,
                     max_out: int | None = None):
    """Every decim-th sample as float32 (channels, m, 2).  ``max_out``
    caps m and reads only that prefix of the file; an empty or sub-frame
    file gives m = 0."""
    m = max(0, (file_frames(path, channels) + decim - 1) // decim)
    if max_out is not None:
        m = min(m, max_out)
    out = np.empty((channels, m, 2), dtype=np.float32)
    n = int(load().twstft_ingest_decimated(os.fsencode(path), channels, decim,
                                           m, _chan_ptrs(list(out))))
    if n != m:
        raise OSError(f"decimated ingest failed: {path}")
    return out


def quantize_q8(
    path: str,
    start_frame: int,
    n_frames: int,
    channels: int = 2,
    select: int = -1,
    pow2: bool = False,
    n_threads: int = 0,
    decim: int = 0,
    out: np.ndarray | None = None,
):
    """Threaded native int8 quantization of an sc16 frame range.

    Returns ``(q, n, scale[, dec])``: ``q`` is int8 of shape ``(n,
    width)`` with ``width = 2*channels`` (or 2 with ``select``), bit for
    bit the plain quantizer of ``utils/io.read_sc16_epochs_q8``.  With
    ``out`` (C-contiguous, ``(n_frames, width)`` int8) the library writes
    there and ``q`` is ``out[:n]``.  ``decim > 0`` also returns every
    decim-th frame as float32 ``(m, width)`` — the df pre-pass read fused
    into the quantize pass.  A short read at the end of the file returns
    fewer frames.
    """
    lib = load()
    width = 2 if select >= 0 else 2 * channels
    q = _dest(out, n_frames, width, np.int8)
    scale = ctypes.c_double(1.0)
    dec_n = ctypes.c_int64(0)
    if decim > 0:
        dec = np.empty(((n_frames + decim - 1) // decim, width), dtype=np.float32)
        dec_ptr = dec.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    else:
        dec = None
        dec_ptr = ctypes.POINTER(ctypes.c_float)()
    n = int(lib.twstft_quantize_q8(
        path.encode(), channels, start_frame, n_frames, select,
        1 if pow2 else 0, q.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        ctypes.byref(scale), _n_threads(n_threads), decim, dec_ptr,
        ctypes.byref(dec_n),
    ))
    if n < 0:
        raise OSError(f"quantize failed: {path}")
    if decim > 0:
        return q[:n], n, float(scale.value), dec[: int(dec_n.value)]
    return q[:n], n, float(scale.value)


def read_raw16(
    path: str,
    start_frame: int,
    n_frames: int,
    channels: int = 2,
    select: int = -1,
    n_threads: int = 0,
    out: np.ndarray | None = None,
):
    """Raw int16 frame-range copy (the sc16 ship-the-wire-format ingest).

    Returns ``(a, n)`` with ``a`` int16 of shape ``(n, width)``; with
    ``out`` (C-contiguous, ``(n_frames, width)`` int16) the frames land
    there and ``a`` is ``out[:n]``.  A short read at the end of the file
    returns fewer frames."""
    lib = load()
    width = 2 if select >= 0 else 2 * channels
    a = _dest(out, n_frames, width, np.int16)
    n = int(lib.twstft_read_raw16(
        path.encode(), channels, start_frame, n_frames, select,
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), _n_threads(n_threads),
    ))
    if n < 0:
        raise OSError(f"raw16 read failed: {path}")
    return a[:n], n


def write_sc16(path: str, *channels_ri: np.ndarray) -> int:
    """Write float32 (n, 2) channels as an interleaved sc16 file."""
    lib = load()
    arrs = [np.ascontiguousarray(c, dtype=np.float32).reshape(-1)
            for c in channels_ri]
    n = len(arrs[0]) // 2
    return int(lib.twstft_write_sc16(path.encode(), len(arrs), _chan_ptrs(arrs), n))


def save_mat(path: str, fields: dict[str, np.ndarray]) -> None:
    """Write a MAT v5 file of double column vectors (real or complex),
    the C++ ``GoRanging::save`` role (``processing/CPP/main.cpp:521-656``)."""
    lib = load()
    h = lib.twstft_mat_open(path.encode())
    if not h:
        raise OSError(f"cannot open {path}")
    try:
        for name, arr in fields.items():
            a = np.asarray(arr)
            if np.iscomplexobj(a):
                re = np.ascontiguousarray(a.real, dtype=np.float64)
                im = np.ascontiguousarray(a.imag, dtype=np.float64)
                rc = lib.twstft_mat_write_complex(
                    h, name.encode(),
                    re.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                    im.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                    a.size,
                )
            else:
                re = np.ascontiguousarray(a, dtype=np.float64)
                rc = lib.twstft_mat_write_real(
                    h, name.encode(),
                    re.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                    a.size,
                )
            if rc != 0:
                raise OSError(f"mat write failed for {name}: {rc}")
    finally:
        lib.twstft_mat_close(h)


def is_mseq(bit_len: int, taps: int, seed: int = 1) -> bool:
    return bool(load().twstft_is_mseq(bit_len, taps, seed))


def find_mseq(bit_len: int, limit: int = 10) -> list[int]:
    out = (ctypes.c_uint64 * limit)()
    n = load().twstft_find_mseq(bit_len, out, limit)
    return [int(out[i]) for i in range(n)]


def prn_chips(bit_len: int, taps: int, n: int, seed: int = 1) -> np.ndarray:
    out = np.empty(n, dtype=np.uint8)
    load().twstft_prn_chips(bit_len, taps, seed, n,
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.astype(np.int8)
