"""The device pack of the banked receiver (``ops/pack.py`` and
``BankedReceiver._pack_device``) against the host pack it replaces on the
card (``BankedReceiver._pack_host``), on the CPU, where the wrapper runs
the plain version of the kernel.  The kernel itself is held to the plain
version in ``tests/test_torch_cuda.py``.
"""

import ctypes
import dataclasses
import os
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from amaranth_twstft_tpu_torch import SignalConfig
from amaranth_twstft_tpu_torch.models import dllpll as td
from amaranth_twstft_tpu_torch.models import tracker as tt
from amaranth_twstft_tpu_torch.models.emitter import ChannelSim, synthesize_capture
from amaranth_twstft_tpu_torch.ops import pack as tpack
from amaranth_twstft_tpu_torch.utils import cuda_build, profiling

FS, L = 100_000, 2000  # the small geometry: fs = 1e5, 2000 samples a code
S = FS + L  # samples of a second's buffer row
# the host pack's px is numpy's float32 pairwise mean, the device pack's a
# float64 sum: they agree to float32 rounding
PX_RTOL = 1e-6


def _chan(taps, prn_id, physical="A"):
    return td.ChannelConfig(physical=physical, prn_id=prn_id, bit_len=10, taps=taps,
                            fc_init_hz=0.0, chip_rate=5e4, code_len=1000,
                            filter_hz=5e4, acq_range_hz=500.0, acq_step_hz=50.0,
                            snr_min_db=20.0, nlag=8)


@pytest.fixture(scope="module")
def stream():
    cfg = SignalConfig(fs=1e5, chip_rate=5e4, code_len=1000, bit_len=10, taps=9)
    (s,) = synthesize_capture(
        cfg,
        [ChannelSim(delay_samples=137.2, doppler_hz=120.0, amplitude=900,
                    noise_sigma=120)],
        n_seconds=5, seed=17,
        extra_emissions=[(dataclasses.replace(cfg, taps=27),
                          ChannelSim(delay_samples=555.0, doppler_hz=-210.0,
                                     amplitude=900, noise_sigma=0.0))],
    )
    return s


def _seconds(stream, n, dtype=np.complex128):
    return [{"A": stream[s * FS : (s + 1) * FS + 2 * L].astype(dtype)} for s in range(n)]


def _three_inputs(stream, dtype):
    """A second on three inputs: A whole, B short of the buffer (m < S),
    C missing."""
    sec = stream[FS : 2 * FS + L].astype(dtype)
    return {"A": sec, "B": (0.5 * sec[: S - 777]).astype(dtype)}


def _three_input_rx(transfer):
    chans = [_chan(9, 100, "A"), _chan(27, 101, "B"), _chan(9, 102, "C")]
    return tt.BankedReceiver(chans, fs=1e5, transfer=transfer, device="cpu")


def _both(rx, sec):
    host = rx._pack_host(sec)
    slot, scale, px, have = rx._pack_device(sec)
    return host, (slot, scale, px, have)


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16 if a.dtype == np.float16 else np.uint32)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("transfer", ["f16", "f32", "auto"])
def test_device_pack_equals_the_host_pack(stream, dtype, transfer):
    """Every row a channel reads holds the host pack's bits (float16 or
    float32), the noise power agrees to float32 rounding, and a short and
    a missing input give zeros past their samples, as on the host."""
    rx = _three_input_rx(transfer)
    sec = _three_inputs(stream, dtype)
    (packed, scale_h, px_h, have_h), (slot, scale_d, px_d, have_d) = _both(rx, sec)
    assert isinstance(slot, tt._PackSlot) and scale_h is None and scale_d is None
    assert slot.out.shape == (3, S, 2) and packed.shape == (6, S, 2)
    got = slot.out.numpy()
    assert got.dtype == packed.dtype == (np.float32 if transfer == "f32" else np.float16)
    idx = rx._buf_idx
    np.testing.assert_array_equal(_bits(got[idx]), _bits(packed[idx]))
    assert not got[1, S - 777 :].any() and not got[2].any()
    np.testing.assert_allclose(px_d.numpy()[idx], px_h[idx], rtol=PX_RTOL, atol=0)
    assert px_d.dtype == torch.float64 and px_d.shape == (3,)
    np.testing.assert_array_equal(have_d, have_h)
    assert have_d.tolist() == [True, True, False]


@pytest.mark.parametrize("peak, f16", [(5.999e4, True), (6.001e4, False)])
def test_auto_decides_as_the_host_pack(stream, peak, f16):
    """``transfer="auto"`` ships float16 below a peak of 6e4 and the
    float32 rows from there, on both sides of the bound, as the host pack."""
    rx = _three_input_rx("auto")
    sec = _three_inputs(stream, np.complex128)
    sec["B"] = sec["B"].copy()
    sec["B"][1234] = complex(0.25, -peak)
    (packed, *_), (slot, *_) = _both(rx, sec)
    assert (packed.dtype == np.float16) is f16
    assert slot.out is (slot.half if f16 else slot.rows)
    assert float(slot.stats[3]) == pytest.approx(peak, rel=1e-7)
    np.testing.assert_array_equal(_bits(slot.out.numpy()), _bits(packed[:3]))


def _noise_close(a, b):
    """``pnoise_dbm`` is the dBm of ``px - pk``: the host pack's float32
    ``px`` and the device pack's float64 one differ by ``px``'s float32
    rounding (``PX_RTOL``), which the subtraction magnifies by ``px / (px -
    pk)`` in dB (16 at these captures' SNR: 7.5e-6 dB).  So the noise
    powers are compared, within ``PX_RTOL`` of ``px``."""
    def lin(dbm):
        return 10.0 ** (dbm / 10.0)

    px = lin(a.pnoise_dbm) + lin(a.pk_dbm)
    assert abs(lin(a.pnoise_dbm) - lin(b.pnoise_dbm)) <= PX_RTOL * px


def _stream_run(stream, device_pack: bool, prefetch=True, transfer="auto"):
    rx = tt.BankedReceiver([_chan(9, 100), _chan(27, 101)], fs=1e5,
                           transfer=transfer, device="cpu")
    if device_pack:
        rx._pack_second = rx._pack_device
    reps = list(rx.run_stream(iter(_seconds(stream, 4)), prefetch=prefetch))
    return rx, reps


@pytest.mark.parametrize("prefetch", [True, False])
def test_receiver_through_the_device_pack_matches_the_host_pack(stream, prefetch):
    """Four seconds through each pack: the same log, states and reports
    but ``pnoise_dbm``, which differs by the noise power's float32 rounding
    on the host (``_noise_close``), and two slots serve the stream."""
    rx_h, rep_h = _stream_run(stream, False, prefetch)
    rx_d, rep_d = _stream_run(stream, True, prefetch)
    assert rx_d.log == rx_h.log and any("code lock" in ln for ln in rx_d.log)
    assert [dataclasses.asdict(s) for s in rx_d.states] == [
        dataclasses.asdict(s) for s in rx_h.states]
    assert all(r is not None and r.locked for r in rep_d[3])
    for sec_h, sec_d in zip(rep_h, rep_d, strict=True):
        for a, b in zip(sec_h, sec_d, strict=True):
            assert (a is None) == (b is None)
            if a is None:
                continue
            _noise_close(a, b)
            assert dataclasses.replace(a, pnoise_dbm=0.0) == dataclasses.replace(
                b, pnoise_dbm=0.0)
    assert len(rx_d._slots) == (2 if prefetch else 1)
    assert all(s.free() for s in rx_d._slots)


def test_upload_span_counts_the_device_pack(stream):
    """Through the device pack a second ships the n_phys float32 rows
    (the host pack's bytes, with every row read) and says so."""
    rx = tt.BankedReceiver([_chan(9, 100)], fs=1e5, transfer="f16", device="cpu")
    rx._pack_second = rx._pack_device
    n0 = len(profiling.spans())
    with profile(activities=[ProfilerActivity.CPU]):
        for pending in (rx.upload_second(s, second=k)
                        for k, s in enumerate(_seconds(stream, 2))):
            assert pending.slot is not None and pending.dev is pending.slot.half
            rx.process_second(pending=pending)
    ups = [r for r in profiling.spans()[n0:] if r.name == "bank.upload"]
    assert [u.counts for u in ups] == [
        {"bytes": S * 8, "rows": 1, "rows_used": 1, "device_pack": 1}] * 2


def test_a_held_slot_is_not_reused(stream):
    """A slot stays with its second until that second is processed: a
    second packed while another is in flight gets a slot of its own."""
    rx = tt.BankedReceiver([_chan(9, 100)], fs=1e5, transfer="f16", device="cpu")
    rx._pack_second = rx._pack_device
    s0, s1 = _seconds(stream, 2)
    p0 = rx.upload_second(s0)
    p1 = rx.upload_second(s1)
    assert p0.slot is not p1.slot
    assert np.array_equal(p0.dev.numpy(), p0.slot.half.numpy())
    rx.process_second(pending=p0)
    assert p0.slot.free() and not p1.slot.free()
    assert rx.upload_second(s0).slot is p0.slot


def test_only_card_float_complex_banks_pack_on_the_device():
    """The CPU, SIC banks, real input and the integer transfers keep the
    host pack."""
    chans = [_chan(9, 100)]
    assert not tt.BankedReceiver(chans, fs=1e5, device="cpu")._device_pack
    rx = tt.BankedReceiver(chans, fs=1e5, device="cpu")
    for kw, want in ((dict(), True), (dict(transfer="f32"), True),
                     (dict(transfer="int8"), False), (dict(real_input=True), False)):
        rx._setup(1e5, device="cpu", **kw)
        rx.device = torch.device("cuda")  # the choice only, no card needed
        rx._init_bank(rx.channels)
        assert rx._device_pack is want, kw
    rx._setup(1e5, device="cpu")
    rx.device = torch.device("cuda")
    rx._init_bank(rx.channels[:1] + [dataclasses.replace(
        rx.channels[0], cfg=dataclasses.replace(rx.channels[0].cfg, is_sic=True))])
    assert not rx._device_pack


@pytest.mark.parametrize("rows, samples, nsum", [(2, 1000, 900), (3, 1001, 1001)])
def test_pack_rows_plain(rows, samples, nsum):
    """The plain version: float16 by round to nearest even (numpy's), the
    mean square of the first ``nsum`` samples in float64, and the peak."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((rows, samples, 2)) * 3e3).astype(np.float32)
    half = torch.empty((rows, samples, 2), dtype=torch.float16)
    stats = torch.empty(rows + 1, dtype=torch.float64)
    tpack.pack_rows(torch.from_numpy(x), nsum, half, stats)
    np.testing.assert_array_equal(_bits(half.numpy()), _bits(x.astype(np.float16)))
    px = (x[:, :nsum].astype(np.float64) ** 2).sum(axis=(1, 2)) / nsum
    np.testing.assert_allclose(stats[:rows].numpy(), px, rtol=1e-12)
    assert float(stats[rows]) == float(np.abs(x).max())
    assert tpack.pack_rows.launches == 0  # the CPU launches nothing


def test_pack_rows_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((2, 10, 2))
    stats = torch.empty(3, dtype=torch.float64)
    with pytest.raises(ValueError):
        tpack.pack_rows(x.double(), 5, None, stats)
    with pytest.raises(ValueError):
        tpack.pack_rows(x, 11, None, stats)
    with pytest.raises(ValueError):
        tpack.pack_rows(x, 5, torch.empty((2, 10, 2)), stats)
    with pytest.raises(ValueError):
        tpack.pack_rows(x, 5, None, torch.empty(2, dtype=torch.float64))
    with pytest.raises(ValueError):
        tpack.pack_rows(x.transpose(0, 1).contiguous().transpose(0, 1), 5, None, stats)


def test_argtypes_match_the_c_entries():
    """The ctypes binding of ``pack_rows_launch`` has the C declaration's
    arguments, type for type (a mismatch would only show on the card), and
    the library is built with the others."""
    assert cuda_build.SOURCES["pack"] == "pack.cu"
    with open(os.path.join(cuda_build.CSRC, "pack.cu")) as f:
        src = f.read()
    kinds = {"long long": ctypes.c_longlong, "int": ctypes.c_int}
    decl = re.search(r'extern "C" int pack_rows_launch\((.*?)\)', src, re.S).group(1)
    want = []
    for arg in (a.strip() for a in decl.split(",")):
        ctype = arg.rsplit(" ", 1)[0].removeprefix("const ")
        want.append(ctypes.c_void_p if ctype.endswith("*") else kinds[ctype])
    assert want == tpack._ARGTYPES
    decl = re.search(r'extern "C" long long pack_rows_workspace_bytes\((.*?)\)', src,
                     re.S).group(1)
    assert [kinds[a.strip().rsplit(" ", 1)[0]] for a in decl.split(",")] == [
        ctypes.c_int, ctypes.c_longlong]
