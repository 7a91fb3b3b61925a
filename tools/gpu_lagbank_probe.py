#!/usr/bin/env python3
"""Where the lag-bank kernel's time goes, on a CUDA card (H100).

    python3 tools/gpu_lagbank_probe.py

Builds variants of ``amaranth_twstft_tpu_torch/csrc/lagbank.cu`` with
``nvcc`` for ``sm_90a`` (all at once) into the git-ignored
``amaranth_twstft_tpu_torch/build/probe/``:

- ``kernel``: the source as it is;
- ``no_products``: the consumer warps wait for each ring stage and
  release it without computing (the bulk-copy ring and the second pass);
- ``no_copies``: the producer arrives on each stage without copying (the
  products on whatever the ring holds, and the second pass);
- ``one_flush``: the tensor-core chain is added to the IEEE fp32 sum once
  per block instead of once per stage (the accuracy fix removed);
- ``cvt_split``: the tf32 split by ``cvt.rna.tf32.f32`` instead of integer
  rounding of the bits (the same values);
- ``explicit``: the source as it is, launched on the explicit (K, NL)
  layout;
- ``explicit_no_products``: the explicit form's consumer warps wait for
  each ring stage and release it without computing;
- ``explicit_no_copies``: the explicit form's producer arrives on each
  stage without copying either operand.

The variants are made by exact text substitutions in the kernel source;
after an edit to the lines they replace, the probe stops with "the kernel
source no longer has ..." and its substitutions must be updated.

On random data at the production group shape (G, P, K, NL) =
(8, 24, 200 000, 57) for the window variants, and at the host receiver's
(2, 24, 200 000) x (200 000, 57) for the explicit ones, it prints each
variant's registers and spills, the float64 error of ``kernel``,
``one_flush``, ``cvt_split``, ``explicit`` and the float32 plain versions
(power error over the row maximum, phase error in cycles), the mean time
per launch from CUDA events (variants in turns, forward then backward),
the device time of each CUDA kernel from ``torch.profiler``, and the
card's name and power limit.  Exits 1 without a card.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

G, P, K, NLAG = 8, 24, 200_000, 28
NL_EXPLICIT = 57  # the host receiver's lags

_CONSUME = """      if (lim >= kKPart) {
        consume_part<false>(acc, st, wv, tq, lim);
      } else if (lim > 0) {
        consume_part<true>(acc, st, wv, tq, lim);
      }
"""
_FLUSH = """#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            mine[((i * kNT + n) * 4 + e) * 32] += acc[i][n][e];
            acc[i][n][e] = 0.f;
          }
"""
_LOOP_END = "    }\n  }\n  __syncthreads();"
_X_CONSUME = """      if (lim >= kXPart) {
        consume_explicit<false>(acc, st, wt, wn, tq, lim);
      } else if (lim > 0) {
        consume_explicit<true>(acc, st, wt, wn, tq, lim);
      }
"""
_INT_SPLIT = """  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;
"""
_CVT_SPLIT = """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));
  big &= 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(x - __uint_as_float(big)));
"""


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"the kernel source no longer has {old!r}")
    return src.replace(old, new)


def variants(src: str) -> dict[str, str]:
    no_copies = _sub(src, "if (lane == 0) mbar_arrive_expect_tx(&full[s], row_bytes * rows);",
                     "if (lane == 0) mbar_arrive(&full[s]);")
    no_copies = _sub(no_copies, "        bulk_g2s(dst", "        if (false) bulk_g2s(dst")
    x_no_copies = _sub(src, "mbar_arrive_expect_tx(&full[s], x_bytes * rows + w_bulk);",
                       "mbar_arrive(&full[s]);")
    for dst in ("wdst", "xdst"):
        x_no_copies = _sub(x_no_copies, f"bulk_g2s({dst}", f"if (false) bulk_g2s({dst}")
    return {
        "kernel": src,
        "no_products": _sub(src, _CONSUME, ""),
        "no_copies": no_copies,
        "one_flush": _sub(src, _FLUSH + _LOOP_END, "    }\n" + _FLUSH + "  }\n  __syncthreads();"),
        "cvt_split": _sub(src, _INT_SPLIT, _CVT_SPLIT),
        "explicit_no_products": _sub(src, _X_CONSUME, ""),
        "explicit_no_copies": x_no_copies,
    }


def build(srcs: dict[str, str], out_dir: str) -> dict:
    """Write each variant's source, compile them all together and load
    each one's C entry."""
    from amaranth_twstft_tpu_torch.ops import lagbank
    from amaranth_twstft_tpu_torch.utils import cuda_build

    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name, text in srcs.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        jobs[name] = (cu, os.path.join(out_dir, f"lib{name}.so"))
    fns = {}
    for name, out in cuda_build.compile_all(jobs).items():
        for kern in ("lagbank_window_kernel", "lagbank_explicit_kernel"):
            at = out.find(kern)
            report = [ln.strip() for ln in out[at:].splitlines()[1:4]
                      if "spill" in ln or "registers" in ln]
            print(f"{name}, {kern}: {' | '.join(report)}", flush=True)
        fn = ctypes.CDLL(jobs[name][1]).lagbank_launch
        fn.argtypes = lagbank._ARGTYPES
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def launch(fn, obs, wav_ext):
    """One launch of a variant's C entry on the window layout."""
    from amaranth_twstft_tpu_torch.ops.lagbank import K_BLOCK

    g, _, p, k = obs.shape
    nl, e = 2 * NLAG + 1, wav_ext.shape[1]
    nchunk = -(-k // K_BLOCK)
    part = torch.empty(g * nchunk * 2 * p * nl, device=obs.device)
    outs = [torch.empty(g, p, nl, device=obs.device) for _ in range(4)]
    err = fn(obs.data_ptr(), 2 * p * k, p * k, k, wav_ext.data_ptr(), e, 1, -1,
             2 * NLAG, e, g, p, k, nl, K_BLOCK, 0.5, part.data_ptr(),
             *(o.data_ptr() for o in outs), obs.device.index,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed (cudaError {err})")
    return outs


def launch_explicit(fn, obs_ri, w):
    """One launch of a variant's C entry on the explicit (K, NL) layout,
    split as ``lag_bank_correlate`` splits it."""
    from amaranth_twstft_tpu_torch.ops.lagbank import explicit_chunk

    _, c, k = obs_ri.shape
    nl = w.shape[1]
    n_sm = torch.cuda.get_device_properties(obs_ri.device).multi_processor_count
    chunk = explicit_chunk(1, k, n_sm)
    part = torch.empty(-(-k // chunk) * 2 * c * nl, device=obs_ri.device)
    outs = [torch.empty(1, c, nl, device=obs_ri.device) for _ in range(4)]
    err = fn(obs_ri.data_ptr(), 0, c * k, k, w.data_ptr(), 0, nl, 1, 0, k * nl,
             1, c, k, nl, chunk, 0.5,
             part.data_ptr(), *(o.data_ptr() for o in outs), obs_ri.device.index,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed (cudaError {err})")
    return [o[0] for o in outs]


def main() -> int:
    if not torch.cuda.is_available():
        print("gpu_lagbank_probe: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from amaranth_twstft_tpu_torch.ops import lagbank
    from amaranth_twstft_tpu_torch.utils import cuda_build
    from chip_smoke import cuda_ms

    def errors(out, ref64) -> str:
        pow_err, ph_err = lagbank.lag_bank_errors(out, ref64)
        return f"power err / row max {pow_err:.3e}, phase err {ph_err:.3e} cycles"

    with open(os.path.join(cuda_build.CSRC, "lagbank.cu")) as f:
        fns = build(variants(f.read()), os.path.join(cuda_build.BUILD_DIR, "probe"))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    obs = torch.randn(G, 2, P, K, generator=gen, device=dev)
    wav_ext = torch.randn(G, K + 2 * NLAG, generator=gen, device=dev)

    ref64 = lagbank.lag_bank_windows_plain(obs.double(), wav_ext.double(), NLAG)
    print(f"float32 plain vs float64: "
          f"{errors(lagbank.lag_bank_windows_plain(obs, wav_ext, NLAG), ref64)}")
    for name in ("kernel", "one_flush", "cvt_split"):
        print(f"{name} vs float64: {errors(launch(fns[name], obs, wav_ext), ref64)}")
    del ref64

    # the explicit form at the host receiver's shape; `explicit` is the
    # source as it is (the `kernel` build)
    obs_ri = obs[0]
    w = torch.randn(K, NL_EXPLICIT, generator=gen, device=dev)
    ref64 = lagbank.lag_bank_plain(obs_ri.double(), w.double())
    print(f"explicit form, float32 plain vs float64: "
          f"{errors(lagbank.lag_bank_plain(obs_ri, w), ref64)}")
    print(f"explicit vs float64: {errors(launch_explicit(fns['kernel'], obs_ri, w), ref64)}")
    del ref64

    runs = {name: (lambda f=fns[name]: launch(f, obs, wav_ext))
            for name in fns if not name.startswith("explicit")}
    runs["explicit"] = lambda: launch_explicit(fns["kernel"], obs_ri, w)
    for name in ("explicit_no_products", "explicit_no_copies"):
        runs[name] = lambda f=fns[name]: launch_explicit(f, obs_ri, w)
    names = list(runs)
    for name in names + names[::-1]:
        ms = cuda_ms(runs[name], 20)
        print(f"{name}: {ms:.4f} ms per launch (CUDA events, 20 launches)", flush=True)
    for name in names:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                runs[name]()
            torch.cuda.synchronize()
        rows = [f"{(re.search(r'\w+_kernel', ev.key) or [ev.key[:40]])[0]} "
                f"{ev.device_time_total / 10:.1f} us"
                for ev in prof.key_averages() if ev.device_time_total > 0]
        print(f"{name} per launch (torch.profiler): {'; '.join(rows)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
