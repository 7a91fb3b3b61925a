"""Tests of the port that need a CUDA card (marker ``cuda``; without a card
they skip).  They import neither JAX nor the JAX package, so they run on a
machine that has only PyTorch, without the JAX test harness:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import dataclasses
import time

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
    (8, 24, 200_000, 32),  # dllpll --nlag 32: NL 65, two lag blocks
    (8, 24, 200_000, 100),  # --nlag 100: NL 201, four lag blocks
    (8, 24, 200_000, 201),  # --nlag 201: NL 403, seven lag blocks
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


@pytest.mark.parametrize("fine_freq", [False, True])
def test_godual_card_branch_matches_cpu(cuda, tmp_path, fine_freq):
    """``godual.process_file`` on the card takes the bound step with the
    per-epoch masked df: its epochs against the same bound step on the
    CPU (indice identical, correction 1e-4 sample, snr 1e-3 of the total,
    df within 0.05 Hz) and against the CPU's host branch (squaring_df and
    the full correlator: delays within 0.01 sample)."""
    from amaranth_twstft_tpu_torch.config import ProcessingConfig, StationConfig
    from amaranth_twstft_tpu_torch.models import godual
    from amaranth_twstft_tpu_torch.ops import boundary, doppler
    from amaranth_twstft_tpu_torch.utils import io as tio

    cfg, code, cap = _ranging_capture(tmp_path)
    proc = ProcessingConfig(fine_freq=fine_freq)
    outs = {}
    for dev in ("cpu", cuda):
        outs[str(dev)] = godual.process_file(
            cap, code, cfg, proc, batch_epochs=20, device=dev,
            out_mat=str(tmp_path / f"{dev}.mat"))
    rep = godual.build_replica(code, cfg, proc)
    L = rep.samples_per_code
    mask = doppler.window_mask(L, cfg.fs, *godual.df_window(StationConfig(), False))
    step = boundary.make_ranging_step(rep.fcode, rep.code_interp, mask, cfg.fs,
                                      fine_freq=fine_freq, device="cpu")
    d, n = tio.read_sc16_epochs(cap, 0, 50, L)
    for c, ch in enumerate(("ch1", "ch2")):
        card = outs["cuda"][ch]
        assert len(card["indice"]) == n == 50
        res = step(torch.from_numpy(d[c]))
        cpu = {f: getattr(res, f).numpy() for f in ("indice", "correction", "snr_r",
                                                     "snr_i", "df")}
        _close_ranging(card, cpu)
        np.testing.assert_allclose(card["df"], cpu["df"], rtol=0, atol=0.05)
        host = outs["cpu"][ch]
        delay = lambda o: (o["indice"] + o["correction"]) / 3  # noqa: E731
        np.testing.assert_allclose(delay(card), delay(host), rtol=0, atol=0.01)
    truth = (431.4, 12.75)
    for c, ch in enumerate(("ch1", "ch2")):
        got = outs["cuda"][ch]
        assert abs(np.median((got["indice"] + got["correction"]) / 3) - truth[c]) < 0.01


def test_nint4_step_on_card_matches_cpu(cuda):
    """``make_ranging_step(nint=4, packed=True)`` on the card against the
    CPU at the JAX package's adversarial fractions (``df_fixed = 0``):
    the CPU's bounds, and the card's error under 3e-4 sample, the JAX
    package's 60-ps bound at 5 MS/s (the same 2 samples per chip here)."""
    from amaranth_twstft_tpu_torch.ops import boundary
    from amaranth_twstft_tpu_torch.ops.lfsr import prn_chips
    from amaranth_twstft_tpu_torch.ops.prn import chips_to_pm1, interp_code, upsample_zoh

    code64 = chips_to_pm1(upsample_zoh(prn_chips(10, 9, 1000), 2), np.float64)
    spec = np.fft.fft(code64)
    L, r = len(code64), 9
    k = np.fft.fftfreq(L)
    fracs = np.array([0.1, 0.25, 0.37, 0.5, 0.62, 0.83])
    frames = np.empty((len(fracs), L, 2), np.float32)
    for i, fr in enumerate(fracs):
        s = np.fft.ifft(spec * np.exp(-2j * np.pi * k * (123 + fr)))
        frames[i, :, 0], frames[i, :, 1] = 3000 * s.real, 3000 * s.imag
    rows = {}
    for dev in ("cpu", cuda):
        step = boundary.make_ranging_step(
            np.conj(spec).astype(np.complex64),
            interp_code(code64.astype(np.float32), r).astype(np.float32),
            np.ones(L, bool), 1e5, nint=4, packed=True, device=dev)
        out = step(torch.from_numpy(frames).to(dev),
                   df_fixed=torch.zeros(len(fracs), device=dev))
        res = boundary.to_epoch_result(boundary.unpack_outputs(out.cpu().numpy()))
        rows[str(dev)] = {f: getattr(res, f) for f in
                          ("indice", "correction", "snr_r", "snr_i")}
    _close_ranging(rows["cuda"], rows["cpu"])
    got = (rows["cuda"]["indice"].astype(np.float64) + rows["cuda"]["correction"]) / r
    assert np.abs(got - (123 + fracs)).max() < 3e-4


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
    (1, 24, 200_000, 57),  # the host receiver's shape: one span, whole rows
    (1, 5, 257, 57),       # K % 4 != 0: obs padded, the matrix's tail masked
    (1, 7, 4099, 81),      # 81 lags: six m16 tiles in one span
    (1, 49, 2000, 17),     # 98 rows: three row blocks
    (3, 24, 2000, 57),     # G = 3 through lag_bank_kernel
    (3, 24, 2000, 201),    # G = 3 over two spans
    (1, 49, 2000, 129),    # three row blocks over two spans
    (1, 24, 200_000, 65),  # dllpll --host --nlag 32: four lag warps, one span
    (1, 24, 200_000, 201),  # --nlag 100: two spans
    (1, 24, 200_000, 403),  # --nlag 201: four spans, windows of each row
    # the span edges: 4 m16 tiles in one span of two lag warps, up to 8
    # in a span of four, balanced spans above
    (1, 24, 20_000, 64),
    (1, 24, 20_000, 80),
    (1, 24, 20_000, 128),
    (1, 24, 20_000, 129),
    (1, 24, 20_000, 256),
    (1, 24, 20_000, 257),
    (1, 24, 20_000, 601),
])
def test_explicit_kernel_float64_accuracy(cuda, g, p, k, nl):
    """The explicit (K, NL) form's compensated 3xTF32 products: within the
    kernel-vs-plain bounds of its plain version, within 1e-5 of the row
    maximum of float64, and at the host shape (K = 200 000) within 4x of
    the float32 plain version's own float64 error."""
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
    if (g, p, k) == (1, 24, 200_000):
        assert k64[0] <= F64_GATE * p64[0] and k64[1] <= F64_GATE * p64[1], (k64, p64)


def test_explicit_kernel_is_deterministic(cuda):
    """No atomics in the sums: two launches of the explicit form give the
    same bits, in both of its stage layouts (whole rows at NL 57 and 129,
    windows at 403 and 601), whichever blocks sum the partials."""
    for g, p, k, nl in [(1, 24, 200_000, 57), (1, 5, 257, 57), (1, 24, 200_000, 403),
                        (1, 24, 20_000, 129), (1, 24, 20_000, 601)]:
        obs, w = _explicit_case(cuda, g, p, k, nl, seed=3)
        first = tlb.lag_bank_correlate(obs[0], w[0])
        second = tlb.lag_bank_correlate(obs[0], w[0])
        for a, b in zip(first, second):
            assert torch.equal(a, b)


def test_explicit_kernel_edges(cuda):
    """An exact-zero code gives exactly zero power and NaN-free results;
    obs and lag-matrix views whose data are not 16-byte aligned are copied
    and agree with the plain version; row pitches of 400 and 1000 at NL 57
    (whose whole rows would not fit the ring: the kernel stages each row's
    lag window), 300 at NL 201 and 1000 at 403 agree with it too; a layout
    that is neither the
    window form's nor row-major with a pitch of at least NL makes the C
    entry point refuse the launch."""
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
    for pitch, lags in ((400, nl), (1000, nl), (300, 201), (1000, 403)):
        w_wide = torch.randn(k, pitch, generator=gen).to(cuda)
        wide = tlb.lag_bank_kernel(obs[None], w_wide, G=1, P=5, K=k, NL=lags,
                                   obs_strides=(0, 5 * k, k),
                                   w_layout=(0, pitch, 1, 0, k * pitch), power_scale=0.5)
        plain = tlb.lag_bank_plain(obs, w_wide[:, :lags].contiguous())
        _close((wide[0][0][keep], wide[1][0][keep]), (plain[0][keep], plain[1][keep]))
    before = tlb.lag_bank_kernel.launches
    for w_arg, layout in [(w.T.contiguous(), (0, 1, k, 0, k * nl)),  # column-major
                          (w, (0, nl - 1, 1, 0, k * nl))]:         # pitch < NL
        with pytest.raises(RuntimeError, match="cudaError"):
            tlb.lag_bank_kernel(obs[None], w_arg, G=1, P=5, K=k, NL=nl,
                                obs_strides=(0, 5 * k, k), w_layout=layout,
                                power_scale=0.5)
    assert tlb.lag_bank_kernel.launches == before


def test_correlate_channels_at_403_lags(cuda):
    """``lag_bank_correlate_channels`` (the sharded lag-bank step's one
    launch over C channels) at NL 403, where the explicit form stages each
    block's lag windows: one launch, every channel's bits equal to its own
    ``lag_bank_correlate``, within 1e-5 of the row maximum of float64."""
    c, p, k, nl = 3, 24, 200_000, 403
    obs, w = _explicit_case(cuda, c, p, k, nl, seed=21)
    before = tlb.lag_bank_correlate.launches
    power, phase = tlb.lag_bank_correlate_channels(obs, w)
    assert tlb.lag_bank_correlate.launches == before + 1
    for i in range(c):
        own = tlb.lag_bank_correlate(obs[i], w[i])
        assert torch.equal(power[i], own[0]) and torch.equal(phase[i], own[1])
    ref64 = _explicit_plain(obs.double(), w.double())
    k64 = tlb.lag_bank_errors((power, phase), ref64)
    assert k64[0] < F64_TOL and k64[1] < F64_TOL, k64


def test_explicit_lags_keep_their_bits_at_every_nl(cuda):
    """The K split, the stage chains, the K halves and the chunk groups do
    not depend on NL, so a lag's power and phase are the same bits
    whichever lag count, span and stage layout the call takes (NL 57:
    one span of whole rows; 65 and 129: four lag warps; 201 and 403:
    spans of windows)."""
    obs, w = _explicit_case(cuda, 1, 24, 20_000, 403, seed=51)
    base = tlb.lag_bank_correlate(obs[0], w[0][:, :57].contiguous())
    for nl in (65, 129, 201, 403):
        got = tlb.lag_bank_correlate(obs[0], w[0][:, :nl].contiguous())
        for a, b in zip(base, got):
            assert torch.equal(a, b[:, :57]), nl


def test_explicit_kernel_is_one_launch(cuda):
    """A call of the explicit form is one CUDA kernel (the chunks' partial
    sums are added in the same launch) and no allocation but its output,
    counted by torch.profiler over 5 calls at NL 57 and 403.  A trace can
    come back short of device events (seen on the H100 in a process that
    had traced before) but never holds events that did not run: every
    trace must hold only this kernel, at most once per call, and one of
    three traces all 5 launches."""
    from torch.profiler import ProfilerActivity, profile

    for nl in (57, 403):
        obs, w = _explicit_case(cuda, 1, 24, 200_000, nl, seed=31)
        tlb.lag_bank_correlate(obs[0], w[0])
        torch.cuda.synchronize()
        counts = []
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    tlb.lag_bank_correlate(obs[0], w[0])
                torch.cuda.synchronize()
            kernels = [e.name for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            assert len(kernels) <= 5 and all("lagbank_explicit_kernel" in k for k in kernels), \
                kernels
            counts.append(len(kernels))
            if counts[-1] == 5:
                break
        assert counts[-1] == 5, counts


def test_explicit_workspace_grows_and_stays_right(cuda):
    """The stream's workspace grows for a larger call and is reused, not
    reallocated, by a smaller one after it; every call stays equal to its
    plain version, a call repeated after the larger one gives its first
    bits, and every launch leaves the counters zero."""
    small, big = _explicit_case(cuda, 1, 24, 2000, 65, seed=41), \
        _explicit_case(cuda, 1, 24, 200_000, 403, seed=42)
    first = tlb.lag_bank_correlate(small[0][0], small[1][0])
    _close(first, tlb.lag_bank_plain(small[0][0], small[1][0]))
    _close(tlb.lag_bank_correlate(big[0][0], big[1][0]),
           tlb.lag_bank_plain(big[0][0], big[1][0]))
    key = (cuda.index or 0, torch.cuda.current_stream().cuda_stream)
    grown = tlb._WORKSPACES[key]
    again = tlb.lag_bank_correlate(small[0][0], small[1][0])
    assert tlb._WORKSPACES[key] is grown
    assert bool((grown[:3] == 0).all())
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    # another stream has a workspace of its own
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        other = tlb.lag_bank_correlate(small[0][0], small[1][0])
    torch.cuda.current_stream().wait_stream(side)
    assert tlb._WORKSPACES[(key[0], side.cuda_stream)] is not grown
    for a, b in zip(first, other):
        assert torch.equal(a, b)


def _wait_for(streams, seconds: float) -> None:
    """Wait until the work queued so far on ``streams`` is done, failing
    after ``seconds`` (a launch that waited for blocks the card never ran
    would hang here)."""
    events = [s.record_event() for s in streams]
    t0 = time.monotonic()
    while not all(e.query() for e in events):
        assert time.monotonic() - t0 < seconds, "the lag-bank launches did not finish"
        time.sleep(0.01)


def test_explicit_kernel_beside_other_streams(cuda):
    """The explicit form's reducers wait only for blocks that started
    before them, so calls stay right while other streams' kernels hold
    the SMs: a large fp32 product and the explicit form itself (NL 403,
    whose 1056 producers take eight waves) on two side streams, with
    calls at NL 57 and 403 on the current stream in between.  Every result
    equals the same call made alone, and the counters end at zero."""
    cases = {nl: _explicit_case(cuda, 1, 24, 200_000, nl, seed=61 + nl) for nl in (57, 403)}
    alone = {nl: tlb.lag_bank_correlate(o[0], w[0]) for nl, (o, w) in cases.items()}
    hog = torch.randn(6144, 6144, device=cuda)
    main = torch.cuda.current_stream()
    sides = [torch.cuda.Stream(), torch.cuda.Stream()]
    for side in sides:
        side.wait_stream(main)
    got = []
    for rep in range(4):
        with torch.cuda.stream(sides[0]):
            hog = torch.matmul(hog, hog).mul_(1e-4)
        with torch.cuda.stream(sides[1]):
            side_out = tlb.lag_bank_correlate(cases[403][0][0], cases[403][1][0])
        for nl in (57, 403):
            got.append((nl, tlb.lag_bank_correlate(cases[nl][0][0], cases[nl][1][0])))
        got.append((403, side_out))
    _wait_for([main, *sides], 60.0)
    for nl, out in got:
        for a, b in zip(alone[nl], out):
            assert torch.equal(a, b), nl
    for stream in (main, sides[1]):
        ws = tlb._WORKSPACES[(cuda.index or 0, stream.cuda_stream)]
        assert bool((ws[:3] == 0).all())


def test_explicit_kernel_in_a_cuda_graph(cuda):
    """Nothing of a launch is kept on the host: two calls captured in one
    CUDA graph (NL 57 and 403) give their eager bits at every replay."""
    cases = [_explicit_case(cuda, 1, 24, 200_000, nl, seed=71 + nl) for nl in (57, 403)]
    eager = [tlb.lag_bank_correlate(o[0], w[0]) for o, w in cases]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # the capture stream's workspace, grown outside the capture
        for o, w in cases:
            tlb.lag_bank_correlate(o[0], w[0])
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        outs = [tlb.lag_bank_correlate(o[0], w[0]) for o, w in cases]
    for _ in range(3):
        for out in outs:
            for t in out:
                t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for want, out in zip(eager, outs):
            for a, b in zip(want, out):
                assert torch.equal(a, b)


def test_explicit_kernel_from_threads(cuda):
    """Four threads calling the explicit form on one stream (the ctypes
    call releases the GIL) each get the bits of the same call made alone."""
    import threading

    cases = [_explicit_case(cuda, 1, 24, 20_000, nl, seed=81 + nl) for nl in (57, 65, 201, 403)]
    alone = [tlb.lag_bank_correlate(o[0], w[0]) for o, w in cases]
    got: dict = {}

    def run(i):
        o, w = cases[i]
        got[i] = [tlb.lag_bank_correlate(o[0], w[0]) for _ in range(20)]

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(cases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    _wait_for([torch.cuda.current_stream()], 60.0)
    for i, want in enumerate(alone):
        for out in got[i]:
            for a, b in zip(want, out):
                assert torch.equal(a, b), i


def test_hunt_above_quantile_limit_on_card_matches_cpu(cuda):
    """The claudio hunt over more than 2^24 spectrum bins (a 2-s block
    above 8.39 MS/s takes the median by a sort): the card and the CPU give
    the same ``(kbon, n_above)``, and the line is found."""
    from amaranth_twstft_tpu_torch.ops import doppler
    from amaranth_twstft_tpu_torch.ops.lfsr import prn_chips
    from amaranth_twstft_tpu_torch.ops.prn import chips_to_pm1, upsample_zoh

    fs, n = 1e5, doppler.QUANTILE_MAX_ELEMENTS + (1 << 20)
    code = chips_to_pm1(upsample_zoh(prn_chips(10, 9, 1000), 2), np.float32)
    rng = np.random.default_rng(2)
    t = np.arange(n)
    dop = 2000 * fs / n  # twice it on bin 4000 of the squaring spectrum
    x = (800 * code[t % code.size] * np.exp(2j * np.pi * dop * t / fs)
         + 300 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    mask = doppler.window_mask(n, fs, -2000.0, 2000.0)
    fcode = np.fft.fft(code).astype(np.complex64)
    got = {}
    for dev in ("cpu", cuda):
        d = torch.from_numpy(x).to(dev)
        got[str(dev)] = doppler.search_df_candidates(
            d, d[: code.size], torch.from_numpy(fcode).to(dev), fs, mask)
    assert got["cuda"] == got["cpu"]
    assert got["cpu"][0] >= 0 and got["cpu"][1] > 0


def test_complex128_goranging_on_card_matches_cpu(cuda, tmp_path):
    """``goranging --f64`` without ``--fast``: the plain chain in
    complex128 on the card (cuFFT Z2Z, the complex128 zoom products and
    float64 SNR) against the same chain on the CPU: the same df, indice
    identical, correction within 1e-9 sample (the complex128 bound of the
    port against the JAX package), snr within 1e-9 of the total."""
    from amaranth_twstft_tpu_torch.config import ProcessingConfig
    from amaranth_twstft_tpu_torch.models import goranging

    cfg, code, cap = _ranging_capture(tmp_path)
    outs = {}
    for dev in ("cpu", cuda):
        outs[str(dev)] = goranging.process_file(
            cap, code, cfg, ProcessingConfig(hamming_window=True),
            dtype=torch.complex128, device=dev, out_mat=str(tmp_path / f"{dev}.mat"))
    assert outs["cuda"]["df"] == outs["cpu"]["df"]
    for ch in ("ch1", "ch2"):
        g, c = outs["cuda"][ch], outs["cpu"][ch]
        np.testing.assert_array_equal(g["indice"], c["indice"])
        np.testing.assert_allclose(g["correction"], c["correction"], rtol=0, atol=1e-9)
        tot = np.asarray(c["snr_r"]) + np.asarray(c["snr_i"])
        for f in ("snr_r", "snr_i"):
            assert np.all(np.abs(np.asarray(g[f]) - np.asarray(c[f])) <= 1e-9 * tot), f
    got = outs["cuda"]["ch1"]
    assert abs(np.median((got["indice"] + got["correction"]) / 3) - 431.4) < 0.01


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


def _reports_close(rep_c, rep_g):
    """Card against CPU: the same reports present, lock and cnt identical,
    fc/gd/phi within the bank's card-vs-CPU bounds."""
    for sec_c, sec_g in zip(rep_c, rep_g, strict=True):
        for a, b in zip(sec_c, sec_g, strict=True):
            assert (a is None) == (b is None)
            if a is None:
                continue
            assert a.locked == b.locked and a.cnt == b.cnt
            assert abs(a.fc_hz - b.fc_hz) < FC_HZ
            assert abs(a.gd_ns - b.gd_ns) < GD_NS
            assert abs(a.phi_cycles - b.phi_cycles) < PHI_CYCLES


def _on_truth(rep, delay, dop):
    """Doppler within 1 Hz, code delay within a quarter sample (fs = 1e5,
    L = 2000)."""
    assert rep is not None and rep.locked
    assert abs(rep.fc_hz - dop) < 1.0, rep.fc_hz
    err = (rep.gd_ns - delay * 1e4) % (2000 * 1e4)
    assert min(err, 2000 * 1e4 - err) < 0.25 * 1e4, rep.gd_ns


@pytest.mark.parametrize("transfer", ["int4", "int2"])
def test_run_stream_packed_transfers_prefetch_identical(cuda, transfer):
    """The counterpart of the JAX suite's on-device stream check
    (tests_tpu/test_run_stream_device.py) for both packed formats: the
    prefetching stream and the unprefetched one give the same bits, the
    upload is the packed format, and both PRNs lock on their truths."""
    cfg, chans, secs = _two_prn_seconds(np.complex128)
    out = []
    for prefetch in (True, False):
        rx = tt.BankedReceiver(chans, fs=cfg.fs, transfer=transfer, device=cuda)
        assert rx.upload_second(secs[0]).dev.dtype == (
            torch.uint8 if transfer == "int2" else torch.int8)
        before = tlb.lag_bank_kernel.launches
        reps = list(rx.run_stream(iter(secs), prefetch=prefetch))
        assert tlb.lag_bank_kernel.launches > before
        out.append((reps, rx.log, [dataclasses.asdict(s) for s in rx.states]))
    assert out[0] == out[1]
    for rep, (delay, dop) in zip(out[0][0][3], ((137.2, 120.0), (555.0, -210.0))):
        _on_truth(rep, delay, dop)


def test_sic_bank_on_card_matches_cpu(cuda):
    """SIC rows on the bank (tests/test_torch_receiver_modes.py's capture:
    a weak PRN 27 dB under a strong one, on an ``S`` row), card against
    CPU over four seconds: the same log lines, reports and code heads, and
    the weak channel reaches code lock on its truth."""
    cfg = SignalConfig(fs=1e5, chip_rate=5e4, code_len=1000, bit_len=10, taps=9)
    (stream,) = synthesize_capture(
        cfg,
        [ChannelSim(delay_samples=137.0, doppler_hz=120.0, amplitude=2500,
                    noise_sigma=40)],
        n_seconds=5, seed=5,
        extra_emissions=[(dataclasses.replace(cfg, taps=27),
                          ChannelSim(delay_samples=555.0, doppler_hz=-210.0,
                                     amplitude=110, noise_sigma=0.0))],
    )
    _, chans, _ = _two_prn_seconds()
    chans[1] = dataclasses.replace(chans[1], is_sic=True)
    fs, L = 100_000, 2000
    secs = [{"A": stream[s * fs : (s + 1) * fs + 2 * L]} for s in range(4)]
    rx_c = tt.BankedReceiver(chans, fs=cfg.fs, device="cpu")
    rx_g = tt.BankedReceiver(chans, fs=cfg.fs, device=cuda)
    rep_c = list(rx_c.run_stream(iter(secs)))
    rep_g = list(rx_g.run_stream(iter(secs)))
    assert rx_g.log == rx_c.log
    assert "code lock   : Ch. A, PRN#151, count = 49 / 50" in rx_g.log
    _reports_close(rep_c, rep_g)
    assert [s.pt for s in rx_g.states] == [s.pt for s in rx_c.states] == [137, 555]
    assert abs(rx_g.states[1].fc - -210.0) < 1.0


def test_multibank_on_card_matches_cpu(cuda):
    """Two code geometries (50 and 25 kcps: L = 2000 and 4000) through
    MultiBankReceiver, card against CPU over four seconds: the same logs,
    reports in the callers' order and code heads, both channels on their
    truths."""
    cfg = SignalConfig(fs=1e5, chip_rate=5e4, code_len=1000, bit_len=10, taps=9)
    (stream,) = synthesize_capture(
        cfg,
        [ChannelSim(delay_samples=137.0, doppler_hz=120.0, amplitude=900,
                    noise_sigma=120)],
        n_seconds=5, seed=23,
        extra_emissions=[(dataclasses.replace(cfg, chip_rate=2.5e4, taps=27),
                          ChannelSim(delay_samples=1555.0, doppler_hz=-210.0,
                                     amplitude=900, noise_sigma=0.0))],
    )
    _, chans, _ = _two_prn_seconds()
    chans[1] = dataclasses.replace(chans[1], chip_rate=2.5e4, filter_hz=2.5e4)
    fs, L = 100_000, 4000
    secs = [{"A": stream[s * fs : (s + 1) * fs + 2 * L]} for s in range(4)]
    rx_c = tt.MultiBankReceiver(chans, fs=cfg.fs, device="cpu")
    rx_g = tt.MultiBankReceiver(chans, fs=cfg.fs, device=cuda)
    assert len(rx_g.receivers) == 2
    before = tlb.lag_bank_kernel.launches
    rep_c = [rx_c.process_second(s) for s in secs]
    rep_g = [rx_g.process_second(s) for s in secs]
    assert tlb.lag_bank_kernel.launches > before
    assert rx_g.log == rx_c.log
    _reports_close(rep_c, rep_g)
    assert [s.pt for s in rx_g.states] == [s.pt for s in rx_c.states]
    assert [c.cfg.prn_id for c in rx_g.channels] == [100, 101]
    _on_truth(rep_g[3][0], 137.0, 120.0)
    rep = rep_g[3][1]
    assert rep is not None and rep.locked and abs(rep.fc_hz - -210.0) < 1.0
    err = (rep.gd_ns - 1555.0 * 1e4) % (4000 * 1e4)
    assert min(err, 4000 * 1e4 - err) < 0.25 * 1e4


# ------------------------------------------------------- the device pack
def _bits16(t: torch.Tensor) -> torch.Tensor:
    return t.cpu().view(torch.int16)


@pytest.mark.parametrize("rows, samples, nsum, half", [
    (2, 5_200_000, 5_000_000, True),  # the bench's second: fs + nobs samples
    (3, 1_000_001, 999_999, True),  # ragged: odd rows start off 16 bytes
    (1, 77, 77, True),  # one block, fewer floats than one thread's loads
    (2, 5_200_000, 5_000_000, False),  # transfer="f32": sums only
])
def test_pack_kernel_matches_plain(cuda, rows, samples, nsum, half):
    """The pack kernel against its plain version: the float16 rows bit for
    bit (both round to nearest even), the float64 statistics within 1e-12
    (sums in other orders), and two launches give the same bits."""
    from amaranth_twstft_tpu_torch.ops import pack as tpack

    g = torch.Generator().manual_seed(rows * samples)
    x = (torch.randn((rows, samples, 2), generator=g) * 3000.0).round()
    x[0, 5] = 0.333  # a value float16 rounds
    x[-1, -1, 1] = -7.0e4  # the peak, past nsum and past float16's range
    xd = x.to(cuda)
    want_h, want_s = tpack.pack_rows_plain(x, nsum)
    outs = []
    for _ in range(2):
        h = torch.empty_like(xd, dtype=torch.float16) if half else None
        s = torch.empty(rows + 1, dtype=torch.float64, device=cuda)
        before = tpack.pack_rows.launches
        tpack.pack_rows(xd, nsum, h, s)
        assert tpack.pack_rows.launches == before + 1
        torch.cuda.synchronize()
        outs.append((h, s.cpu()))
    for h, s in outs:
        if half:
            assert torch.equal(_bits16(h), _bits16(want_h))
        torch.testing.assert_close(s, want_s, rtol=1e-12, atol=0)
        assert float(s[rows]) == 7.0e4
    assert torch.equal(outs[0][1], outs[1][1])
    if half:
        assert torch.equal(_bits16(outs[0][0]), _bits16(outs[1][0]))


def _noise_close(a, b):
    """``pnoise_dbm`` is the dBm of ``px - pk``: the host pack's float32
    ``px`` (numpy's pairwise mean) and the device pack's float64 sum differ
    by ``px``'s float32 rounding (1e-6 relative), which the subtraction
    magnifies by ``px / (px - pk)`` in dB.  So the noise powers are
    compared, within 1e-6 of ``px``."""
    def lin(dbm):
        return 10.0 ** (dbm / 10.0)

    px = lin(a.pnoise_dbm) + lin(a.pk_dbm)
    assert abs(lin(a.pnoise_dbm) - lin(b.pnoise_dbm)) <= 1e-6 * px


@pytest.mark.parametrize("transfer", ["f16", "auto", "f32"])
def test_device_pack_on_card_matches_host_pack(cuda, transfer):
    """A card bank over four seconds through the device pack and, the same
    bank, through the host pack (``_pack_host`` called in its place): the
    same log, states and reports but ``pnoise_dbm`` (``_noise_close``),
    one pack launch a second, and each upload span says which pack ran."""
    from torch.profiler import ProfilerActivity, profile

    from amaranth_twstft_tpu_torch.ops import pack as tpack
    from amaranth_twstft_tpu_torch.utils import profiling

    cfg, chans, secs = _two_prn_seconds(np.complex128)
    out = []
    for device_pack in (True, False):
        rx = tt.BankedReceiver(chans, fs=cfg.fs, transfer=transfer, device=cuda)
        assert rx._device_pack
        if not device_pack:
            rx._pack_second = rx._pack_host
        before, n0 = tpack.pack_rows.launches, len(profiling.spans())
        with profile(activities=[ProfilerActivity.CPU]):
            reps = list(rx.run_stream(iter(secs)))
        assert tpack.pack_rows.launches - before == (len(secs) if device_pack else 0)
        ups = [r for r in profiling.spans()[n0:] if r.name == "bank.upload"]
        assert [u.counts["device_pack"] for u in ups] == [int(device_pack)] * len(secs)
        assert [u.counts["rows"] for u in ups] == [1 if device_pack else 2] * len(secs)
        out.append((reps, rx.log, [dataclasses.asdict(s) for s in rx.states]))
    (rep_d, log_d, st_d), (rep_h, log_h, st_h) = out
    assert log_d == log_h and st_d == st_h
    assert all(r is not None and r.locked for r in rep_d[3])
    for sec_d, sec_h in zip(rep_d, rep_h, strict=True):
        for a, b in zip(sec_h, sec_d, strict=True):
            assert (a is None) == (b is None)
            if a is not None:
                _noise_close(a, b)
                assert dataclasses.replace(a, pnoise_dbm=0.0) == dataclasses.replace(
                    b, pnoise_dbm=0.0)


def test_int8_bank_packs_on_the_host(cuda):
    """The integer transfers keep the host pack on the card: its upload
    spans count ``device_pack`` 0 and no pack kernel runs."""
    from torch.profiler import ProfilerActivity, profile

    from amaranth_twstft_tpu_torch.ops import pack as tpack
    from amaranth_twstft_tpu_torch.utils import profiling

    cfg, chans, secs = _two_prn_seconds(np.complex128)
    rx = tt.BankedReceiver(chans, fs=cfg.fs, transfer="int8", device=cuda)
    before, n0 = tpack.pack_rows.launches, len(profiling.spans())
    with profile(activities=[ProfilerActivity.CPU]):
        list(rx.run_stream(iter(secs[:2])))
    assert tpack.pack_rows.launches == before
    ups = [r for r in profiling.spans()[n0:] if r.name == "bank.upload"]
    assert [u.counts["device_pack"] for u in ups] == [0, 0]


def test_auto_device_pack_ships_f32_above_the_f16_range(cuda):
    """``transfer="auto"`` on the card reads the kernel's peak back: a
    second whose peak reaches 6e4 runs on the uploaded float32 rows, as the
    host pack's would, with the same reports."""
    cfg, chans, secs = _two_prn_seconds(np.complex128)
    for s in secs:
        s["A"] = s["A"].copy()
        s["A"][100_000 + 1999] = 6.5e4  # the buffer's last sample (fs + nobs - 1)
    out = []
    for device_pack in (True, False):
        rx = tt.BankedReceiver(chans, fs=cfg.fs, transfer="auto", device=cuda)
        if not device_pack:
            rx._pack_second = rx._pack_host
        assert rx.upload_second(secs[0]).dev.dtype == torch.float32
        reps = list(rx.run_stream(iter(secs)))
        out.append((reps, rx.log))
    assert out[0][1] == out[1][1]
    for sec_d, sec_h in zip(out[0][0], out[1][0], strict=True):
        for a, b in zip(sec_h, sec_d, strict=True):
            assert (a is None) == (b is None)
            if a is not None:
                _noise_close(a, b)
                assert dataclasses.replace(a, pnoise_dbm=0.0) == dataclasses.replace(
                    b, pnoise_dbm=0.0)


# ------------------------------------------------------------- multi-GPU
@pytest.fixture
def nccl_mesh(cuda):
    """A world of one rank under NCCL on the card, and its 1x1 mesh."""
    import torch.distributed as dist

    from amaranth_twstft_tpu_torch.parallel.mesh import init_distributed, make_mesh

    started = not dist.is_initialized()
    dev = init_distributed(device=cuda)
    assert dist.get_backend() == "nccl" and dev.type == "cuda"
    try:
        yield make_mesh(1, 1)
    finally:
        if started:
            dist.destroy_process_group()


def test_sharded_lagbank_step_under_nccl(nccl_mesh):
    """The sharded lag-bank step launches the explicit form once over its
    channels, each channel bit for bit its own lag_bank_correlate and,
    on the same inputs, within the kernel-vs-plain bounds of the plain
    version, within 1e-5 of the row maximum of float64 and within 4x of
    the float32 plain version's own float64 error; the gathered result
    is the local one."""
    from amaranth_twstft_tpu_torch.parallel.sharded import make_sharded_lagbank_step

    gen = torch.Generator().manual_seed(4)
    dev = nccl_mesh.device
    obs = torch.randn(4, 2, 24, 200_000, generator=gen).to(dev)  # the host shape
    wav = torch.randn(4, 200_000, 57, generator=gen).to(dev)
    step = make_sharded_lagbank_step(nccl_mesh)
    before = tlb.lag_bank_correlate.launches
    pw, ph = step(obs, wav)
    assert tlb.lag_bank_correlate.launches == before + 1
    for c in range(4):
        p1, h1 = tlb.lag_bank_correlate(obs[c], wav[c])
        assert torch.equal(pw[c], p1) and torch.equal(ph[c], h1)
    plain = _explicit_plain(obs, wav)
    _close((pw, ph), plain)
    ref64 = _explicit_plain(obs.double(), wav.double())
    k64 = tlb.lag_bank_errors((pw, ph), ref64)
    p64 = tlb.lag_bank_errors(plain, ref64)
    assert k64[0] < F64_TOL and k64[1] < F64_TOL, (k64, p64)
    assert k64[0] <= F64_GATE * p64[0] and k64[1] <= F64_GATE * p64[1], (k64, p64)
    gp, gh = step(obs, wav, gather=True)
    assert torch.equal(gp, pw) and torch.equal(gh, ph)


def test_sharded_tracker_step_under_nccl(nccl_mesh):
    """BankedReceiver on a 1x1 NCCL mesh: the same log, reports and
    window-form launches as the unsharded bank, bit for bit."""
    cfg, chans, secs = _two_prn_seconds()
    rx = tt.BankedReceiver(chans, fs=cfg.fs, device=nccl_mesh.device)
    rx_m = tt.BankedReceiver(chans, fs=cfg.fs, mesh=nccl_mesh)
    n0 = tlb.lag_bank_kernel.launches
    rep = [rx.process_second(s) for s in secs]
    n1 = tlb.lag_bank_kernel.launches
    rep_m = [rx_m.process_second(s) for s in secs]
    assert tlb.lag_bank_kernel.launches - n1 == n1 - n0 > 0
    assert rx_m.log == rx.log
    assert [[dataclasses.astuple(r) if r else None for r in s] for s in rep_m] == \
        [[dataclasses.astuple(r) if r else None for r in s] for s in rep]


def test_sharded_pipeline_under_nccl_equals_overlapped(nccl_mesh, tmp_path):
    """process_capture_sharded on a one-rank NCCL mesh gives the overlapped
    pipeline's epochs bit for bit over several batches, a final partial
    batch included (each batch's gathered rows are fetched into one reused
    pinned buffer while the next batch runs)."""
    from amaranth_twstft_tpu_torch import pipeline
    from amaranth_twstft_tpu_torch.config import ProcessingConfig

    cfg, code, cap = _ranging_capture(tmp_path, n_seconds=4)
    proc = ProcessingConfig(hamming_window=True)
    fast = pipeline.process_capture_overlapped(cap, code, cfg, proc, batch_epochs=30,
                                               out_mat=str(tmp_path / "f.mat"),
                                               device=nccl_mesh.device)
    shard = pipeline.process_capture_sharded(cap, code, cfg, proc, mesh=nccl_mesh,
                                             batch_epochs=30,
                                             out_mat=str(tmp_path / "s.mat"))
    assert shard["df"] == fast["df"]
    assert shard["timing"]["n_batches"] == 7
    for ch in ("ch1", "ch2"):
        assert len(shard[ch]["indice"]) == 200
        for k, v in fast[ch].items():
            np.testing.assert_array_equal(shard[ch][k], v, err_msg=k)


def test_polyphase_decimate_on_card_matches_cpu(cuda):
    """One strided conv1d per re/im part (cuDNN, TF32 off) against the CPU:
    complex128 within 1e-12, complex64 within 1e-5 of the peak."""
    from amaranth_twstft_tpu_torch.ops.resample import design_lowpass, polyphase_decimate

    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 20_000)) + 1j * rng.normal(size=(3, 20_000))
    h = design_lowpass(25)
    for dt, tol in ((torch.complex128, 1e-12), (torch.complex64, 1e-5)):
        xt = torch.from_numpy(x).to(dt)
        cpu = polyphase_decimate(xt, h, 25)
        card = polyphase_decimate(xt.to(cuda), h, 25).cpu()
        assert card.shape == cpu.shape == (3, 800) and card.dtype == dt
        assert float((card - cpu).abs().max()) <= tol * float(cpu.abs().max())


def test_mxufft_on_card_matches_cufft(cuda):
    """The staged matmul FFT on the card: complex64 within 5e-5 of the
    maximum of the float64 cuFFT truth, complex128 within 1e-10."""
    from amaranth_twstft_tpu_torch.ops import mxufft

    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((4, 200_000), dtype=torch.complex64, generator=gen, device=cuda)
    x64 = x.to(torch.complex128)
    for fn, lib in ((mxufft.fft_factored, torch.fft.fft),
                    (mxufft.ifft_factored, torch.fft.ifft)):
        truth = lib(x64, dim=-1)
        peak = truth.abs().max()
        y = fn(x)
        assert y.dtype == torch.complex64 and y.device == x.device
        assert float((y.to(torch.complex128) - truth).abs().max() / peak) < 5e-5
        y64 = fn(x64[:, :6000])
        t64 = lib(x64[:, :6000], dim=-1)
        assert float((y64 - t64).abs().max() / t64.abs().max()) < 1e-10


def test_studies_on_card_match_cpu(cuda):
    """A small correlator study and the f16-ingest chains on the card
    against the CPU: delays within 1e-6 sample (complex128), the float64
    chain's percentiles within 1e-6 ns, the conclusions on both."""
    from amaranth_twstft_tpu_torch import studies

    card = studies.code_length_study(device=cuda)
    cpu = studies.code_length_study(device="cpu")
    np.testing.assert_allclose(card["mean_samples"], cpu["mean_samples"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(card["std_samples"], cpu["std_samples"], rtol=1e-6)
    kw = dict(n_epochs=64, chunk=32)
    f_card = studies.f16_ingest_error_study(device=cuda, **kw)
    f_cpu = studies.f16_ingest_error_study(device="cpu", **kw)
    for k in ("p50_ns", "p90_ns", "p99_ns", "max_ns"):
        assert abs(f_card["quant"][k] - f_cpu["quant"][k]) < 1e-6
    for res in (f_card, f_cpu):
        assert res["f32"]["max_ns"] < 0.01 and res["int8"]["max_ns"] < 0.1
