"""The sc16 epoch reader (``utils/io.read_sc16_epochs``) and the native
binding behind it (``native.ingest_into``), on the CPU.

A read takes one threaded native pass from the memory map into a
complex64 output's float32 view, cast to another dtype where one is
asked for.  It must give, bit for bit, the plain numpy construction kept
here and the JAX package's reader: each part is ``(float)int16``.
"""

import numpy as np
import pytest

from amaranth_twstft_tpu.utils import io as jio
from amaranth_twstft_tpu_torch import native as tnative
from amaranth_twstft_tpu_torch.utils import io as tio

FRAMES = 200_000  # int16 pairs a file holds at one input (half that at two)


@pytest.fixture(scope="module")
def sc16_file(tmp_path_factory):
    """Full-scale random int16, with both extremes in the first frames
    of each input."""
    rng = np.random.default_rng(20)
    raw = rng.integers(-32768, 32767, 2 * FRAMES, dtype=np.int16, endpoint=True)
    raw[:8] = (-32768, 32767, 32767, -32768, 0, -1, 1, -32768)
    p = str(tmp_path_factory.mktemp("read") / "cap.bin")
    raw.tofile(p)
    return p


def _plain(path, start, n_epochs, L, channels, dtype):
    """The numpy construction the native pass replaced."""
    mm = tio.open_sc16(path, channels)
    n = min(n_epochs, max(0, (mm.shape[0] - start) // L))
    if n == 0:
        return np.zeros((channels, 0, L), dtype=dtype), 0
    raw = np.asarray(mm[start : start + n * L]).astype(np.float32)
    out = np.empty((channels, n, L), dtype=dtype)
    for c in range(channels):
        out[c] = (raw[:, 2 * c] + 1j * raw[:, 2 * c + 1]).reshape(n, L)
    return out, n


def _bits(a):
    return a.view(np.uint32 if a.dtype == np.complex64 else np.uint64)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("start, n_epochs, L, dtype, want_n", [
    (0, 3, 1000, np.complex64, 3),  # from the first frame, both extremes
    (777, 5, 999, np.complex64, 5),  # an odd frame, an odd epoch length
    (None, 4, 700, np.complex64, None),  # near the end: the short tail dropped
    (0, 10_000, 7_000, np.complex64, None),  # past the file's end
    (10 * FRAMES, 2, 1000, np.complex64, 0),  # a start past the file's end
    (0, 1, 90_000, np.complex64, 1),  # >= 2^16 frames: the threaded pass
    (13, 2, 30_000, np.complex128, 2),  # another dtype: cast from complex64
])
def test_read_equals_plain_and_jax_bit_for_bit(sc16_file, channels, start, n_epochs, L,
                                               dtype, want_n):
    total = 2 * FRAMES // (2 * channels)
    if start is None:
        start = total - 2 * L - 123  # two whole epochs, then 123 frames
        want_n = 2
    if want_n is None:
        want_n = total // L
    got, n = tio.read_sc16_epochs(sc16_file, start, n_epochs, L, channels=channels,
                                  dtype=dtype)
    plain, n_p = _plain(sc16_file, start, n_epochs, L, channels, dtype)
    jax_, n_j = jio.read_sc16_epochs(sc16_file, start, n_epochs, L, channels=channels,
                                     dtype=dtype)
    assert n == n_p == n_j == want_n
    assert got.shape == plain.shape == jax_.shape == (channels, want_n, L)
    assert got.dtype == plain.dtype == jax_.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(_bits(got), _bits(plain))
    np.testing.assert_array_equal(_bits(got), _bits(jax_))
    if start == 0 and want_n:
        assert got[0, 0, 0] == -32768 + 32767j


@pytest.mark.parametrize("n_threads", [1, 3, 8])
def test_ingest_into_gives_the_same_bits_on_any_threads(sc16_file, n_threads):
    n_frames = FRAMES // 2 - 5
    want, _ = _plain(sc16_file, 5, 1, n_frames, 2, np.complex64)
    outs = [np.full(2 * n_frames, np.nan, np.float32) for _ in range(2)]
    assert tnative.ingest_into(sc16_file, 5, n_frames, outs, n_threads=n_threads) == n_threads
    for c in range(2):
        np.testing.assert_array_equal(outs[c].view(np.uint32),
                                      want[c, 0].view(np.float32).view(np.uint32))
    # below 2^16 frames the pass runs on one thread, whatever it is given
    assert tnative.ingest_into(sc16_file, 5, (1 << 16) - 1, outs, n_threads=n_threads) == 1


def test_ingest_into_refuses_bad_paths_reads_and_arrays(sc16_file, tmp_path):
    ok = [np.empty(2 * 100, np.float32) for _ in range(2)]
    with pytest.raises(OSError, match="ingest failed"):
        tnative.ingest_into(str(tmp_path / "missing.bin"), 0, 100, ok)
    # the file holds FRAMES // 2 two-input frames: a read past them is short
    long = [np.empty(2 * 200, np.float32) for _ in range(2)]
    with pytest.raises(OSError, match="150 of 200 frames"):
        tnative.ingest_into(sc16_file, FRAMES // 2 - 150, 200, long)
    empty = tmp_path / "empty.bin"
    empty.write_bytes(b"")
    with pytest.raises(OSError, match="0 of 100 frames"):
        tnative.ingest_into(str(empty), 0, 100, ok)
    bad = {
        "undersized": np.empty(2 * 100 - 1, np.float32),
        "not contiguous": np.empty(4 * 100, np.float32)[::2],
        "float64": np.empty(2 * 100, np.float64),
        "read-only": np.frombuffer(bytes(8 * 100), np.float32),
        "not an array": [0.0] * 200,
    }
    for a in bad.values():
        with pytest.raises(ValueError):
            tnative.ingest_into(sc16_file, 0, 100, [ok[0], a])
    with pytest.raises(ValueError):
        tnative.ingest_into(sc16_file, 0, 100, [])
    with pytest.raises(ValueError):
        tnative.ingest_into(sc16_file, -1, 100, ok)
