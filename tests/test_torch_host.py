"""The port's own copies of the JAX package's host (numpy) code against
the originals: LFSR codes and the m-sequence search, the replica
helpers, the sc16 reader/writer, the capture synthesizer and the
replica bank build."""

import dataclasses

import numpy as np
import pytest

from amaranth_twstft_tpu.models import dllpll as jd
from amaranth_twstft_tpu.models import emitter as jem
from amaranth_twstft_tpu.ops import lfsr as jlfsr
from amaranth_twstft_tpu.ops import prn as jprn
from amaranth_twstft_tpu.utils import io as jio
from amaranth_twstft_tpu_torch import SignalConfig
from amaranth_twstft_tpu_torch.models import dllpll as td
from amaranth_twstft_tpu_torch.models import emitter as tem
from amaranth_twstft_tpu_torch.ops import lfsr as tlfsr
from amaranth_twstft_tpu_torch.ops import prn as tprn
from amaranth_twstft_tpu_torch.utils import io as tio


def test_lfsr_codes_and_mseq_search_match():
    assert tlfsr.find_mseq_taps(10, 6) == jlfsr._find_mseq_taps_np(10, 6)
    taps = np.asarray(tlfsr.find_mseq_taps(10, 6), np.uint64)
    assert all(tlfsr.is_mseq(10, int(t)) for t in taps)
    assert not tlfsr.is_mseq(10, 2)
    np.testing.assert_array_equal(
        tlfsr.prn_chips_batch(10, taps, 1500), jlfsr.prn_chips_batch(10, taps, 1500)
    )
    np.testing.assert_array_equal(tlfsr.prn_chips(9, 17, 511), jlfsr.prn_chips(9, 17, 511))


def test_prn_helpers_match():
    chips = jlfsr.prn_chips(10, 9, 1000)
    np.testing.assert_array_equal(
        tprn.chips_to_pm1(tprn.upsample_zoh(chips, 2)),
        np.asarray(jprn.chips_to_pm1(jprn.upsample_zoh(chips, 2))),
    )
    np.testing.assert_array_equal(
        tprn.lowpass_spectrum_mask(2000, 50.0, 5e4, -5e4),
        np.asarray(jprn.lowpass_spectrum_mask(2000, 50.0, 5e4, -5e4)),
    )


def test_sc16_round_trip_matches(tmp_path):
    rng = np.random.default_rng(2)
    a = (rng.normal(0, 900, 5000) + 1j * rng.normal(0, 900, 5000))
    b = 0.5 * a[::-1]
    path = str(tmp_path / "cap.bin")
    tio.write_sc16(path, a, b)
    ref = str(tmp_path / "ref.bin")
    jio.write_sc16(ref, a, b)
    assert open(path, "rb").read() == open(ref, "rb").read()
    assert tio.n_samples_sc16(path) == jio.n_samples_sc16(ref) == 5000
    d_t, n_t = tio.read_sc16_epochs(path, 700, 3, 1200)
    d_j, n_j = jio.read_sc16_epochs(ref, 700, 3, 1200)
    assert n_t == n_j
    np.testing.assert_array_equal(d_t, d_j)


def test_synthesize_capture_matches(small_cfg):
    sims = [jem.ChannelSim(delay_samples=137.4, doppler_hz=120.0, amplitude=900,
                           noise_sigma=50)]
    ref = jem.synthesize_capture(small_cfg, sims, n_seconds=2, seed=4)
    cfg = SignalConfig(fs=small_cfg.fs, chip_rate=small_cfg.chip_rate,
                       code_len=small_cfg.code_len, bit_len=small_cfg.bit_len,
                       taps=small_cfg.taps)
    got = tem.synthesize_capture(
        cfg, [tem.ChannelSim(**dataclasses.asdict(s)) for s in sims],
        n_seconds=2, seed=4,
    )
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("n", [2, 9])
def test_replica_bank_build_matches(n):
    """build_channels_batch of the port against the JAX package's (the
    batched path; n >= 8 also exercises the disk-cache branch, disabled
    by the test environment)."""
    taps = jlfsr._find_mseq_taps_np(10, n)
    kw = dict(bit_len=10, chip_rate=5e4, code_len=1000, filter_hz=4e4, nlag=8)
    ref = jd.build_channels_batch([jd.ChannelConfig(taps=t, **kw) for t in taps], 1e5)
    got = td.build_channels_batch([td.ChannelConfig(taps=t, **kw) for t in taps], 1e5)
    for g, r in zip(got, ref):
        assert g.nobs == r.nobs and g.sps_per_chip == r.sps_per_chip
        np.testing.assert_allclose(g.wav, r.wav, rtol=0, atol=1e-6)
        np.testing.assert_allclose(g.fcode, r.fcode, rtol=1e-5, atol=1e-3)
        assert abs(g.psbb - r.psbb) < 1e-6 * r.psbb
        np.testing.assert_array_equal(g.chips, r.chips)
    # the float64 one-channel build agrees with the batched float32 one
    one = td.build_channel(got[0].cfg, 1e5)
    np.testing.assert_allclose(one.wav, got[0].wav, rtol=0, atol=1e-5)
    assert abs(one.psbb - got[0].psbb) < 1e-5 * one.psbb
