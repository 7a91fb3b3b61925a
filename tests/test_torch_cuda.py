"""Tests of the port that need a CUDA card (marker ``cuda``; without a card
they skip).  They import neither JAX nor the JAX package, so they run on a
machine that has only PyTorch, without the JAX test harness:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from amaranth_twstft_tpu_torch import SignalConfig
from amaranth_twstft_tpu_torch.models import dllpll as td
from amaranth_twstft_tpu_torch.models import tracker as tt
from amaranth_twstft_tpu_torch.models.emitter import ChannelSim, synthesize_capture
from amaranth_twstft_tpu_torch.ops import lagbank as tlb

pytestmark = pytest.mark.cuda

# the card against the CPU: float32 sums in other orders (the kernel's
# K-chunks, cuFFT) — the same bounds as the port against the JAX package
# in tests/test_torch_tracker.py
FC_HZ = 1e-3
GD_NS = 1.0  # 1e-4 sample at fs = 1e5
PHI_CYCLES = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(kernel_out, plain_out):
    """power within 1e-4 of each row's maximum; phase within 1e-4 cycles
    wherever power >= 1e-3 x the row maximum."""
    pk, phk = kernel_out[:2]
    pp, php = plain_out[:2]
    rowmax = pp.amax(-1, keepdim=True)
    assert float(((pk - pp).abs() / rowmax).max()) < 1e-4
    dph = torch.remainder(phk - php + 0.5, 1.0) - 0.5
    assert float(dph.abs()[pp >= 1e-3 * rowmax].max()) < 1e-4


def test_kernel_matches_plain_on_card(cuda):
    """The hand-written kernel against its plain version, both input
    forms, at unaligned shapes and the production group shape."""
    gen = torch.Generator().manual_seed(0)
    for g, p, k, nlag in [(3, 49, 2000, 8), (1, 5, 300, 2), (8, 24, 200_000, 28)]:
        obs = torch.randn(g, 2, p, k, generator=gen).to(cuda)
        wav_ext = torch.randn(g, k + 2 * nlag, generator=gen).to(cuda)
        before = tlb.lag_bank_kernel.launches
        _close(tlb.lag_bank_windows(obs, wav_ext, nlag),
               tlb.lag_bank_windows_plain(obs, wav_ext, nlag))
        w_mat = wav_ext[0].unfold(-1, k, 1).flip(0).T.contiguous()
        _close(tlb.lag_bank_correlate(obs[0], w_mat), tlb.lag_bank_plain(obs[0], w_mat))
        assert tlb.lag_bank_kernel.launches == before + 2
    torch.cuda.synchronize()


# the window form's compensated 3xTF32 products against float64: within
# 1e-5 of the row maximum (10x inside the kernel-vs-plain tolerance; one
# tf32 pass gives ~1e-3), and at the production group shape within 4x of
# the float32 plain version's own error (chip_smoke.py's gate)
F64_TOL = 1e-5
F64_GATE = 4.0


@pytest.mark.parametrize("g,p,k,nlag", [
    (8, 24, 200_000, 28),  # the production group shape
    (1, 5, 257, 2),        # K % 4 != 0: zero-padded copy; 10 of 48 rows
    (2, 7, 4099, 40),      # 81 lags: two lag blocks
    (3, 49, 2000, 8),      # 98 rows: three row blocks
])
def test_window_kernel_float64_accuracy(cuda, g, p, k, nlag):
    gen = torch.Generator().manual_seed(k + nlag)
    obs = torch.randn(g, 2, p, k, generator=gen).to(cuda)
    wav_ext = torch.randn(g, k + 2 * nlag, generator=gen).to(cuda)
    ref64 = tlb.lag_bank_windows_plain(obs.double(), wav_ext.double(), nlag)
    kern = tlb.lag_bank_errors(tlb.lag_bank_windows(obs, wav_ext, nlag), ref64)
    plain = tlb.lag_bank_errors(tlb.lag_bank_windows_plain(obs, wav_ext, nlag), ref64)
    assert kern[0] < F64_TOL and kern[1] < F64_TOL, (kern, plain)
    if (g, p, k, nlag) == (8, 24, 200_000, 28):
        assert kern[0] <= F64_GATE * plain[0] and kern[1] <= F64_GATE * plain[1]


def test_window_kernel_is_deterministic(cuda):
    """No atomics: two launches on the same inputs give the same bits."""
    gen = torch.Generator().manual_seed(3)
    for g, p, k, nlag in [(8, 24, 200_000, 28), (1, 5, 257, 2)]:
        obs = torch.randn(g, 2, p, k, generator=gen).to(cuda)
        wav_ext = torch.randn(g, k + 2 * nlag, generator=gen).to(cuda)
        first = tlb.lag_bank_windows(obs, wav_ext, nlag)
        second = tlb.lag_bank_windows(obs, wav_ext, nlag)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


def test_padded_lags_and_rows_contribute_nothing(cuda):
    """An exact-zero obs code gives exactly zero re, im and power; the
    other codes, the rows past 2P in the block and the lags past NL in
    the last m16 tile leave the results NaN-free and equal to the plain
    version's; a view whose data is not 16-byte aligned is copied."""
    gen = torch.Generator().manual_seed(11)
    g, p, k, nlag = 2, 5, 1000, 8
    obs = torch.randn(g, 2, p, k, generator=gen).to(cuda)
    obs[1, :, 3] = 0.0
    wav_ext = torch.randn(g, k + 2 * nlag, generator=gen).to(cuda)
    power, phase, re, im = tlb.lag_bank_windows(obs, wav_ext, nlag)
    for t in (power, phase, re, im):
        assert bool(torch.isfinite(t).all())
    for t in (power[1, 3], re[1, 3], im[1, 3]):
        assert bool((t == 0).all())
    keep = [0, 1, 2, 4]  # the zero code has no row maximum to compare to
    plain = tlb.lag_bank_windows_plain(obs, wav_ext, nlag)
    _close((power[:, keep], phase[:, keep]), (plain[0][:, keep], plain[1][:, keep]))
    flat = torch.randn(obs.numel() + 1, generator=gen).to(cuda)
    view = flat[1:].view(g, 2, p, k)
    assert view.data_ptr() % 16 != 0
    _close(tlb.lag_bank_windows(view, wav_ext, nlag),
           tlb.lag_bank_windows_plain(view, wav_ext, nlag))


def test_bank_on_card_matches_cpu(cuda):
    """Four seconds of the banked receiver on the card against the same
    receiver on the CPU (plain lag bank): same log lines and lock counts,
    fc/gd/phi within the bounds above, and the kernel launched."""
    cfg = SignalConfig(fs=1e5, chip_rate=5e4, code_len=1000, bit_len=10, taps=9)
    (stream,) = synthesize_capture(
        cfg,
        [ChannelSim(delay_samples=137.2, doppler_hz=120.0, amplitude=900,
                    noise_sigma=120)],
        n_seconds=5, seed=17,
        extra_emissions=[(dataclasses.replace(cfg, taps=27),
                          ChannelSim(delay_samples=555.0, doppler_hz=-210.0,
                                     amplitude=900, noise_sigma=0.0))],
    )
    chans = [
        td.ChannelConfig(physical="A", prn_id=100 + i, bit_len=10, taps=t,
                         fc_init_hz=0.0, chip_rate=5e4, code_len=1000,
                         filter_hz=5e4, acq_range_hz=500.0, acq_step_hz=50.0,
                         snr_min_db=20.0, nlag=8)
        for i, t in enumerate((9, 27))
    ]
    fs, L = 100_000, 2000
    secs = [{"A": stream[s * fs : (s + 1) * fs + 2 * L]} for s in range(4)]
    rx_c = tt.BankedReceiver(chans, fs=cfg.fs, device="cpu")
    rx_g = tt.BankedReceiver(chans, fs=cfg.fs, device=cuda)
    before = tlb.lag_bank_kernel.launches
    rep_c = list(rx_c.run_stream(iter(secs)))
    rep_g = list(rx_g.run_stream(iter(secs)))
    assert tlb.lag_bank_kernel.launches > before
    assert rx_g.log == rx_c.log
    assert any("code lock" in ln for ln in rx_g.log)
    for sec_c, sec_g in zip(rep_c, rep_g):
        for a, b in zip(sec_c, sec_g):
            assert (a is None) == (b is None)
            if a is None:
                continue
            assert a.locked == b.locked and a.cnt == b.cnt
            assert abs(a.fc_hz - b.fc_hz) < FC_HZ
            assert abs(a.gd_ns - b.gd_ns) < GD_NS
            assert abs(a.phi_cycles - b.phi_cycles) < PHI_CYCLES
    assert [s.pt for s in rx_g.states] == [s.pt for s in rx_c.states]
    assert all(r is not None and r.locked for r in rep_g[3])


# ---------------------------------------------------------------- GoRanging
# the card against the CPU, complex64: cuFFT and the cuBLAS window product
# sum in other orders than the CPU's, so the port-vs-JAX bounds apply
# (indice identical, correction 1e-4 sample, snr within 1e-3 of the total)
def _close_ranging(card, cpu):
    np.testing.assert_array_equal(card["indice"], cpu["indice"])
    np.testing.assert_allclose(card["correction"], cpu["correction"], rtol=0, atol=1e-4)
    snr = cpu["snr_r"] + cpu["snr_i"]
    for f in ("snr_r", "snr_i"):
        assert np.all(np.abs(card[f] - cpu[f]) <= 1e-3 * snr), f


def _ranging_capture(tmp_path, n_seconds=1):
    from amaranth_twstft_tpu_torch.ops.lfsr import write_prn_file
    from amaranth_twstft_tpu_torch.utils import io as tio

    cfg = SignalConfig(fs=1e5, chip_rate=5e4, code_len=1000, bit_len=10, taps=9)
    code = str(tmp_path / "code.bin")
    write_prn_file(code, cfg.bit_len, cfg.code_len, cfg.taps)
    meas, ref = synthesize_capture(
        cfg, [ChannelSim(431.4, 130.0, amplitude=900, noise_sigma=250),
              ChannelSim(12.75, 5.0, amplitude=2000, noise_sigma=100)],
        n_seconds=n_seconds, seed=5)
    cap = str(tmp_path / "cap.bin")
    tio.write_sc16(cap, meas, ref)
    return cfg, code, cap


@pytest.mark.parametrize("fast", [False, True])
def test_correlate_epochs_on_card_matches_cpu(cuda, tmp_path, fast):
    from amaranth_twstft_tpu_torch.config import ProcessingConfig
    from amaranth_twstft_tpu_torch.models.godual import build_replica
    from amaranth_twstft_tpu_torch.ops.correlator import correlate_epochs
    from amaranth_twstft_tpu_torch.utils import io as tio

    cfg, code, cap = _ranging_capture(tmp_path)
    rep = build_replica(code, cfg, ProcessingConfig())
    d, n = tio.read_sc16_epochs(cap, 0, 16, rep.samples_per_code)
    out = {}
    for dev in ("cpu", cuda):
        df = torch.full((n,), 130.25, dtype=torch.float32, device=dev)
        res = correlate_epochs(
            torch.as_tensor(d[0]).to(dev), torch.as_tensor(rep.fcode).to(dev), df,
            torch.as_tensor(rep.code_interp).to(dev), cfg.fs,
            fcode_interp=torch.as_tensor(rep.fcode_interp).to(dev), fast=fast)
        out[str(dev)] = {f: getattr(res.to_host(), f) for f in
                         ("indice", "correction", "snr_r", "snr_i")}
    _close_ranging(out["cuda"], out["cpu"])
    assert abs(np.median(out["cuda"]["indice"] + out["cuda"]["correction"]) / 3
               - 431.4) < 0.1


def test_ranging_step_packed_int16_on_card_matches_cpu(cuda, tmp_path):
    from amaranth_twstft_tpu_torch.config import ProcessingConfig
    from amaranth_twstft_tpu_torch.models.godual import build_replica
    from amaranth_twstft_tpu_torch.ops import boundary
    from amaranth_twstft_tpu_torch.utils import io as tio

    cfg, code, cap = _ranging_capture(tmp_path)
    rep = build_replica(code, cfg, ProcessingConfig(hamming_window=True))
    L = rep.samples_per_code
    iq, n = tio.read_sc16_epochs_raw16(cap, 0, 20, L)
    df = np.repeat(np.asarray([130.25, 5.5], np.float32), n)
    rows = {}
    for dev in ("cpu", cuda):
        step = boundary.make_ranging_step(rep.fcode, rep.code_interp, np.ones(L, bool),
                                          cfg.fs, packed=True, device=dev)
        out = step(torch.as_tensor(iq).to(dev), df_fixed=torch.as_tensor(df).to(dev))
        res = boundary.to_epoch_result(boundary.unpack_outputs(out.cpu().numpy()))
        rows[str(dev)] = {f: getattr(res, f) for f in
                          ("indice", "correction", "snr_r", "snr_i")}
    _close_ranging(rows["cuda"], rows["cpu"])


def test_pipeline_on_card_matches_process_file(cuda, tmp_path):
    """The overlapped pipeline (pinned buffers, copy stream, packed
    fetch) against goranging.process_file on the card, over 4 s with a
    final partial batch: indice identical, correction within 1e-4
    sample; int16 ingest gives the same bits as float32 ingest."""
    from amaranth_twstft_tpu_torch import pipeline
    from amaranth_twstft_tpu_torch.config import ProcessingConfig
    from amaranth_twstft_tpu_torch.models import goranging

    cfg, code, cap = _ranging_capture(tmp_path, n_seconds=4)
    proc = ProcessingConfig(hamming_window=True, df_decimation=5)
    base = goranging.process_file(cap, code, cfg, proc, batch_epochs=25,
                                  out_mat=str(tmp_path / "b.mat"), device=cuda)
    o16 = pipeline.process_capture_overlapped(cap, code, cfg, proc, batch_epochs=30,
                                              out_mat=str(tmp_path / "f.mat"),
                                              device=cuda)
    o32 = pipeline.process_capture_overlapped(cap, code, cfg, proc, batch_epochs=30,
                                              ingest_dtype="float32",
                                              out_mat=str(tmp_path / "g.mat"),
                                              device=cuda)
    assert o16["df"] == base["df"] == o32["df"]
    for ch in ("ch1", "ch2"):
        assert len(o16[ch]["indice"]) == 200
        np.testing.assert_array_equal(o16[ch]["indice"], base[ch]["indice"])
        np.testing.assert_allclose(o16[ch]["correction"], base[ch]["correction"],
                                   rtol=0, atol=1e-4)
        for k, v in o32[ch].items():
            np.testing.assert_array_equal(o16[ch][k], v, err_msg=k)


# ------------------------------------------------------------------ claudio
# the card against the port's CPU run of the same path (float32 both):
# df bin identical, delay (indice + correction/3) within 1e-4 sample
CLAUDIO_DELAY_TOL = 1e-4


def _claudio_fixture(tmp_path, delay=20.0, doppler=0.0, drop=500):
    """tests/test_claudio.py's slip fixture: 2 s at L = 2000 with 500
    samples lost at 1.0 s."""
    from amaranth_twstft_tpu_torch.ops.lfsr import write_prn_file
    from amaranth_twstft_tpu_torch.utils import io as tio

    cfg = SignalConfig(fs=1e5, chip_rate=5e4, code_len=1000, bit_len=10, taps=9)
    code = str(tmp_path / "code.bin")
    write_prn_file(code, cfg.bit_len, cfg.code_len, cfg.taps)
    (s,) = synthesize_capture(cfg, [ChannelSim(delay, doppler, amplitude=1500,
                                               noise_sigma=100)],
                              n_seconds=2, seed=3)
    cut = int(cfg.fs)
    s = np.concatenate([s[:cut], s[cut + drop:]])
    cap = str(tmp_path / "1755400001_2.bin")
    tio.write_sc16(cap, s)
    return cfg, code, cap


def test_claudio_df_estimators_on_card_match_cpu(cuda, tmp_path):
    from amaranth_twstft_tpu_torch.config import ProcessingConfig
    from amaranth_twstft_tpu_torch.models.godual import build_replica
    from amaranth_twstft_tpu_torch.models.claudio import _quantize_q8
    from amaranth_twstft_tpu_torch.ops import boundary, doppler
    from amaranth_twstft_tpu_torch.utils import io as tio

    cfg, code, cap = _claudio_fixture(tmp_path, delay=333.0, doppler=150.0, drop=0)
    rep = build_replica(code, cfg, ProcessingConfig(), conjugate=False)
    block = 50_000
    raw, _ = tio.read_raw16(cap, 0, block)
    q8, _ = _quantize_q8(raw)
    dc = raw[:2000].astype(np.float32)
    dc -= dc.mean(axis=0, keepdims=True)
    fc = boundary.pack_complex(rep.fcode)
    mask = doppler.window_mask(block, cfg.fs, -8e3, 8e3)
    got = {}
    for dev in ("cpu", cuda):
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        kb, n_above = doppler.search_df_candidates_ri(t(q8), t(dc), t(fc), cfg.fs,
                                                      t(mask))
        refreshed = [doppler.refresh_df_ri(t(q8), cfg.fs, k)
                     for k in (int(kb), 0, block - 1)]
        got[str(dev)] = (int(kb), int(n_above),
                         [(float(df), int(i)) for df, i in refreshed])
    assert got["cuda"] == got["cpu"]
    assert got["cpu"][0] >= 0


def test_resident_claudio_on_card_matches_cpu(cuda, tmp_path):
    from amaranth_twstft_tpu_torch.config import ProcessingConfig, StationConfig
    from amaranth_twstft_tpu_torch.models import claudio

    cfg, code, cap = _claudio_fixture(tmp_path)
    proc = ProcessingConfig(conjugate_data=True, block_seconds=0.5, skip_seconds=0.0)
    out = {}
    for dev in ("cpu", cuda):
        d = tmp_path / str(dev)
        d.mkdir()
        out[str(dev)] = claudio.process_file(cap, code, cfg, proc, StationConfig(),
                                             out_dir=str(d), device=dev,
                                             transfer="int8")
    card, cpu = out["cuda"], out["cpu"]
    assert card["moved"] == cpu["moved"] and len(card["moved"]) >= 2
    np.testing.assert_array_equal(card["df"], cpu["df"])
    delay = lambda o: o["indice"] + o["correction"] / 3.0  # noqa: E731
    assert np.abs(delay(card) - delay(cpu)).max() < CLAUDIO_DELAY_TOL
    # 2 s less 500 samples: three whole 0.5-s blocks, the short tail dropped
    assert len(card["timing"]["block_step_ms"]) == 3
    assert card["timing"]["bytes_shipped"] == 3 * 50_000 * 2


def test_claudio_upload_overlap_leaves_results_unchanged(cuda, tmp_path,
                                                         monkeypatch):
    """The next block's upload issued before the fetch (prefetch) or only
    when due: the same bits."""
    from amaranth_twstft_tpu_torch.config import ProcessingConfig, StationConfig
    from amaranth_twstft_tpu_torch.models import claudio

    cfg, code, cap = _claudio_fixture(tmp_path)
    proc = ProcessingConfig(conjugate_data=True, block_seconds=0.5, skip_seconds=0.0)
    out = []
    for prefetch in (True, False):
        monkeypatch.setattr(claudio, "_PREFETCH", prefetch)
        d = tmp_path / str(prefetch)
        d.mkdir()
        out.append(claudio.process_file(cap, code, cfg, proc, StationConfig(),
                                        out_dir=str(d), device=cuda))
    assert out[0]["moved"] == out[1]["moved"]
    for k in ("indice", "correction", "xval", "snr_r", "snr_i", "df"):
        np.testing.assert_array_equal(out[0][k], out[1][k], err_msg=k)


# ------------------------------------------------- the host DLL/PLL receiver
def _two_prn_seconds(dtype=np.complex64, n=4):
    cfg = SignalConfig(fs=1e5, chip_rate=5e4, code_len=1000, bit_len=10, taps=9)
    (stream,) = synthesize_capture(
        cfg,
        [ChannelSim(delay_samples=137.2, doppler_hz=120.0, amplitude=900,
                    noise_sigma=120)],
        n_seconds=5, seed=17,
        extra_emissions=[(dataclasses.replace(cfg, taps=27),
                          ChannelSim(delay_samples=555.0, doppler_hz=-210.0,
                                     amplitude=900, noise_sigma=0.0))],
    )
    chans = [
        td.ChannelConfig(physical="A", prn_id=100 + i, bit_len=10, taps=t,
                         fc_init_hz=0.0, chip_rate=5e4, code_len=1000,
                         filter_hz=5e4, acq_range_hz=500.0, acq_step_hz=50.0,
                         snr_min_db=20.0, nlag=8)
        for i, t in enumerate((9, 27))
    ]
    fs, L = 100_000, 2000
    secs = [{"A": stream[s * fs : (s + 1) * fs + 2 * L].astype(dtype)} for s in range(n)]
    return cfg, chans, secs


def test_host_receiver_on_card_matches_cpu(cuda):
    """The host-sequential receiver on complex64 samples (the CLI's sc16
    reader), card against CPU: same log lines, lock counts and code
    heads, fc/gd/phi within the bank's card-vs-CPU bounds; the explicit
    form of the kernel launched once per tracked channel per second."""
    cfg, chans, secs = _two_prn_seconds()
    rx_c = td.Receiver(chans, fs=cfg.fs, device="cpu")
    rx_g = td.Receiver(chans, fs=cfg.fs, device=cuda)
    before = tlb.lag_bank_correlate.launches
    rep_c = [rx_c.process_second(s) for s in secs]
    rep_g = [rx_g.process_second(s) for s in secs]
    assert tlb.lag_bank_correlate.launches - before == 2 * 3  # seconds 1-3
    assert rx_g.log == rx_c.log
    for sec_c, sec_g in zip(rep_c, rep_g):
        for a, b in zip(sec_c, sec_g):
            assert (a is None) == (b is None)
            if a is None:
                continue
            assert a.locked == b.locked and a.cnt == b.cnt
            assert abs(a.fc_hz - b.fc_hz) < FC_HZ
            assert abs(a.gd_ns - b.gd_ns) < GD_NS
            assert abs(a.phi_cycles - b.phi_cycles) < PHI_CYCLES
    assert [s.pt for s in rx_g.states] == [s.pt for s in rx_c.states]
    assert all(r is not None and r.locked for r in rep_g[3])


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_caf_search_on_card_matches_cpu(cuda, dtype):
    """Card against CPU (cuFFT against pocketfft): index and indice
    identical, power within 1e-4 relative, df within 1e-3 Hz, correction
    within 1e-4 sample."""
    from amaranth_twstft_tpu_torch.ops import caf

    cfg, chans, secs = _two_prn_seconds()
    ch = td.build_channel(chans[0], cfg.fs)
    d = torch.from_numpy(secs[0]["A"][: 6 * ch.nobs].reshape(6, ch.nobs)).to(dtype)
    out = {}
    for dev in ("cpu", cuda):
        res = caf.caf_search(d.to(dev), torch.from_numpy(ch.fcode).to(dev, dtype),
                             torch.from_numpy(ch.code_interp).to(dev), cfg.fs,
                             -500.0, 500.0, 50.0)
        shifts, _ = caf.doppler_bins(cfg.fs, ch.nobs, -500.0, 500.0, 50.0)
        pk = caf.caf_peaks(d.to(dev), torch.from_numpy(ch.fcode).to(dev, dtype), shifts,
                           chunk=8)
        out[str(dev)] = (res.df_hz.cpu(), res.epoch.indice.cpu(),
                         res.epoch.correction.cpu(), pk.power.cpu(), pk.index.cpu())
    (df_c, ind_c, cor_c, pw_c, ix_c), (df_g, ind_g, cor_g, pw_g, ix_g) = (
        out["cpu"], out["cuda"])
    assert torch.equal(ix_g, ix_c) and torch.equal(ind_g, ind_c)
    assert float(((pw_g - pw_c).abs() / pw_c).max()) < 1e-4
    assert float((df_g - df_c).abs().max()) < 1e-3
    assert float((cor_g - cor_c).abs().max()) < 1e-4
    assert float((df_g - 120.0).abs().max()) < 10.0


def _explicit_case(cuda, g, p, k, nl, seed):
    gen = torch.Generator().manual_seed(seed)
    obs = torch.randn(g, 2, p, k, generator=gen).to(cuda)
    w = torch.randn(g, k, nl, generator=gen).to(cuda)
    return obs, w


def _explicit_plain(obs, w):
    """The plain version per channel, stacked to (G, P, NL)."""
    outs = [tlb.lag_bank_plain(o, m) for o, m in zip(obs, w)]
    return tuple(torch.stack([o[j] for o in outs]) for j in (0, 1))


@pytest.mark.parametrize("g,p,k,nl", [
    (1, 24, 200_000, 57),  # the host receiver's shape
    (1, 5, 257, 57),       # K % 4 != 0: obs padded, the matrix's tail masked
    (1, 7, 4099, 81),      # 81 lags: two lag blocks
    (1, 49, 2000, 17),     # 98 rows: three row blocks
    (3, 24, 2000, 57),     # G = 3 through lag_bank_kernel
])
def test_explicit_kernel_float64_accuracy(cuda, g, p, k, nl):
    """The explicit (K, NL) form's compensated 3xTF32 products: within the
    kernel-vs-plain bounds of its plain version, within 1e-5 of the row
    maximum of float64, and at the host shape within 4x of the float32
    plain version's own float64 error."""
    obs, w = _explicit_case(cuda, g, p, k, nl, seed=5)
    if g == 1:
        before = tlb.lag_bank_correlate.launches
        kern = tlb.lag_bank_correlate(obs[0], w[0])
        assert tlb.lag_bank_correlate.launches == before + 1
        kern = tuple(t[None] for t in kern)
    else:
        kern = tlb.lag_bank_kernel(
            obs, w, G=g, P=p, K=k, NL=nl,
            obs_strides=(2 * p * k, p * k, k),
            w_layout=(k * nl, nl, 1, 0, k * nl), power_scale=0.5,
        )
    plain = _explicit_plain(obs, w)
    _close(kern, plain)
    ref64 = _explicit_plain(obs.double(), w.double())
    k64 = tlb.lag_bank_errors(kern, ref64)
    p64 = tlb.lag_bank_errors(plain, ref64)
    assert k64[0] < F64_TOL and k64[1] < F64_TOL, (k64, p64)
    if (g, p, k, nl) == (1, 24, 200_000, 57):
        assert k64[0] <= F64_GATE * p64[0] and k64[1] <= F64_GATE * p64[1], (k64, p64)


def test_explicit_kernel_is_deterministic(cuda):
    """No atomics: two launches of the explicit form give the same bits."""
    for g, p, k, nl in [(1, 24, 200_000, 57), (1, 5, 257, 57)]:
        obs, w = _explicit_case(cuda, g, p, k, nl, seed=3)
        first = tlb.lag_bank_correlate(obs[0], w[0])
        second = tlb.lag_bank_correlate(obs[0], w[0])
        for a, b in zip(first, second):
            assert torch.equal(a, b)


def test_explicit_kernel_edges(cuda):
    """An exact-zero code gives exactly zero power and NaN-free results;
    obs and lag-matrix views whose data are not 16-byte aligned are copied
    and agree with the plain version; a row pitch of 400 (a two-stage
    ring) agrees with it too; a layout that is neither the window form's
    nor row-major with a pitch of at least NL, or a pitch whose two-stage
    ring exceeds a block's shared memory, makes the C entry point refuse
    the launch."""
    obs, w = _explicit_case(cuda, 1, 5, 1000, 57, seed=13)
    obs, w = obs[0], w[0]
    obs[:, 3] = 0.0
    power, phase = tlb.lag_bank_correlate(obs, w)
    assert bool(torch.isfinite(power).all()) and bool(torch.isfinite(phase).all())
    assert bool((power[3] == 0).all())
    keep = [0, 1, 2, 4]  # the zero code has no row maximum to compare to
    plain = tlb.lag_bank_plain(obs, w)
    _close((power[keep], phase[keep]), (plain[0][keep], plain[1][keep]))
    gen = torch.Generator().manual_seed(14)
    obs_view = torch.randn(obs.numel() + 1, generator=gen).to(cuda)[1:].view(obs.shape)
    w_view = torch.randn(w.numel() + 1, generator=gen).to(cuda)[1:].view(w.shape)
    assert obs_view.data_ptr() % 16 != 0 and w_view.data_ptr() % 16 != 0
    _close(tlb.lag_bank_correlate(obs_view, w_view), tlb.lag_bank_plain(obs_view, w_view))
    k, nl = w.shape
    w_wide = torch.randn(k, 400, generator=gen).to(cuda)
    wide = tlb.lag_bank_kernel(obs[None], w_wide, G=1, P=5, K=k, NL=nl,
                               obs_strides=(0, 5 * k, k), w_layout=(0, 400, 1, 0, k * 400),
                               power_scale=0.5)
    plain = tlb.lag_bank_plain(obs, w_wide[:, :nl].contiguous())
    _close((wide[0][0][keep], wide[1][0][keep]), (plain[0][keep], plain[1][keep]))
    before = tlb.lag_bank_kernel.launches
    w_huge = torch.zeros(k, 1000, device=cuda)
    for w_arg, layout in [(w.T.contiguous(), (0, 1, k, 0, k * nl)),  # column-major
                          (w, (0, nl - 1, 1, 0, k * nl)),          # pitch < NL
                          (w_huge, (0, 1000, 1, 0, k * 1000))]:    # ring too large
        with pytest.raises(RuntimeError, match="cudaError"):
            tlb.lag_bank_kernel(obs[None], w_arg, G=1, P=5, K=k, NL=nl,
                                obs_strides=(0, 5 * k, k), w_layout=layout,
                                power_scale=0.5)
    assert tlb.lag_bank_kernel.launches == before


def test_run_stream_copy_stream_prefetch_identical(cuda):
    """Second k+1's upload on the copy stream beside second k's compute,
    or no prefetch: the same bits, for f16 and int8 transfers."""
    cfg, chans, secs = _two_prn_seconds(np.complex128)
    for transfer in ("auto", "int8"):
        out = []
        for prefetch in (True, False):
            rx = tt.BankedReceiver(chans, fs=cfg.fs, transfer=transfer, device=cuda)
            reps = list(rx.run_stream(iter(secs), prefetch=prefetch))
            out.append((reps, rx.log, [dataclasses.asdict(s) for s in rx.states]))
        assert out[0] == out[1]
        assert all(r is not None and r.locked for r in out[0][0][3])
