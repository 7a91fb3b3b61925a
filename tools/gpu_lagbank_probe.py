#!/usr/bin/env python3
"""Where the lag-bank kernel's time goes, on a CUDA card (H100).

    python3 tools/gpu_lagbank_probe.py [NL,NL,...]
    python3 tools/gpu_lagbank_probe.py --trees TREE [TREE ...]

With ``--trees`` it only compares checkouts of this repository (for
example a ``git archive`` of the parent commit unpacked under the
git-ignored ``build/``, and ``.``): ``chip_smoke.py --explicit-times``
(chip_smoke's own measurement of the explicit form at NL 57, 65, 201 and
403 and of ``lag_bank_correlate_channels``) runs on each tree in turn, in
a process of its own, so "parent, change, change, parent" is
``A B B A``.  Otherwise it builds variants of ``amaranth_twstft_tpu_torch/csrc/lagbank.cu`` with
``nvcc`` for ``sm_90a`` (all at once) into the git-ignored
``amaranth_twstft_tpu_torch/build/probe/`` and prints each kernel entry's
registers and spills:

- ``kernel``: the source as it is;
- ``no_products``: the window form's consumer warps wait for each ring
  stage and release it without computing (the bulk-copy ring and the
  second pass);
- ``no_copies``: the window form's producer arrives on each stage without
  copying (the products on whatever the ring holds, and the second pass);
- ``one_flush``: the tensor-core chain is added to the IEEE fp32 sum once
  per block instead of once per stage (the accuracy fix removed);
- ``cvt_split``: the tf32 split by ``cvt.rna.tf32.f32`` instead of integer
  rounding of the bits (the same values);
- ``explicit``: the source as it is, launched on the explicit (K, NL)
  layout;
- ``explicit_no_products``: the explicit form's consumer warps wait for
  each ring stage and release it without computing (the copies and the
  in-launch sum of the partials);
- ``explicit_no_copies``: the explicit form's producer warps arrive on
  each stage without copying either operand;
- ``explicit_no_sum``: the explicit form's reducer blocks wait for every
  producer's arrival and skip the sum of the partials (the outputs are
  not written);
- ``explicit_no_tail``: the reducer blocks neither wait nor sum (the
  producers' time, with the reducer blocks' start and exit);
- ``explicit_ring4``: four ring stages at two blocks per SM, where the
  launcher takes three.

The variants are made by exact text substitutions in the kernel source;
after an edit to the lines they replace, the probe stops with "the kernel
source no longer has ..." and its substitutions must be updated.

On random data at the production group shape (G, P, K, NL) =
(8, 24, 200 000, 57) for the window variants, and at the host receiver's
(2, 24, 200 000) x (200 000, NL) for the explicit ones at each NL given
(default 57, 65, 201 and 403), it prints the float64 error of ``kernel``,
``one_flush``, ``cvt_split``, ``explicit`` and the float32 plain versions
(power error over the row maximum, phase error in cycles), the mean time
per launch from CUDA events (variants in turns, forward then backward),
each CUDA kernel's device time and launches per call from
``torch.profiler``, and the card's name and power limit.  Exits 1 without
a card.
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
NL_EXPLICIT = (57, 65, 201, 403)  # the host receiver's lags: --nlag 28, 32, 100, 201

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
_X_CONSUME = """      if (nt > 0) consume_half(acc, st, wt, pitch, tq, lim);
"""
_X_WAIT = "    while (ld_acquire(&a.ctr[1]) < (unsigned)a.nblocks) __nanosleep(32);\n"
_X_SUM = "  explicit_reduce<WL>(a, reducer, red);\n"
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
    # the explicit form's producer warps arrive with their bytes, then copy
    x_no_copies = _sub(src, "if (lane == 0) mbar_arrive_expect_tx(&full[s], total);",
                       "if (lane == 0) mbar_arrive(&full[s]);")
    x_no_copies = _sub(x_no_copies, "if (bytes[m] > 0) bulk_g2s(", "if (false) bulk_g2s(")
    return {
        "kernel": src,
        "no_products": _sub(src, _CONSUME, ""),
        "no_copies": no_copies,
        "one_flush": _sub(src, _FLUSH + _LOOP_END, "    }\n" + _FLUSH + "  }\n  __syncthreads();"),
        "cvt_split": _sub(src, _INT_SPLIT, _CVT_SPLIT),
        "explicit_no_products": _sub(src, _X_CONSUME, ""),
        "explicit_no_copies": x_no_copies,
        "explicit_no_sum": _sub(src, _X_SUM, ""),
        "explicit_no_tail": _sub(_sub(src, _X_SUM, ""), _X_WAIT, ""),
        "explicit_ring4": _sub(src, "int ring = wl <= 2 ? 3 : kXMaxRing;", "int ring = kXMaxRing;"),
    }


def ptxas_report(out: str) -> dict[str, str]:
    """Registers and spills of each kernel entry in ``nvcc -Xptxas -v``
    output, by kernel name with its template arguments (``ILi4ELb1E``:
    4, true)."""
    reports: dict[str, str] = {}
    name = None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"(lagbank_\w+?_kernel)(I\w*?E)?(?:v|E)", m.group(1))
            name = (k.group(1) + (k.group(2) or "")) if k else m.group(1)
            reports[name] = ""
        elif name and ("spill" in line or "registers" in line):
            item = line.split("info    :")[-1].strip()
            reports[name] = f"{reports[name]} | {item}" if reports[name] else item
    return reports


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
        for kern, report in ptxas_report(out).items():
            print(f"{name}, {kern}: {report}", flush=True)
        lib = ctypes.CDLL(jobs[name][1])
        lib.lagbank_launch.argtypes = lagbank._ARGTYPES
        lib.lagbank_launch.restype = ctypes.c_int
        fns[name] = lib
    return fns


_WORK: dict = {}


def _call(lib, geo, obs, w, out_shape):
    """One launch of a variant's C entry with geometry ``geo`` (a
    ``lagbank._Geometry``); the workspace is kept per variant and shape,
    zeroed once, as the port keeps one per stream."""
    from amaranth_twstft_tpu_torch.ops import lagbank

    ref = ctypes.byref(geo)
    key = (id(lib), bytes(geo))
    if key not in _WORK:
        floats = lagbank.workspace_floats(geo.G, geo.P, geo.K, geo.NL, geo.kb)
        _WORK[key] = torch.zeros(floats, device=obs.device)
    work = _WORK[key]
    out = torch.empty(4, *out_shape, device=obs.device)
    err = lib.lagbank_launch(ref, obs.data_ptr(), w.data_ptr(), work.data_ptr(),
                             work.numel(), out.data_ptr(),
                             obs.device.index, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed (cudaError {err})")
    return out.unbind(0)


def launch(lib, obs, wav_ext):
    """One launch of a variant on the window layout."""
    from amaranth_twstft_tpu_torch.ops.lagbank import K_BLOCK, _Geometry

    g, _, p, k = obs.shape
    nl, e = 2 * NLAG + 1, wav_ext.shape[1]
    geo = _Geometry(2 * p * k, p * k, k, e, 1, -1, 2 * NLAG, e, g, p, k, nl, K_BLOCK, 0.5)
    return _call(lib, geo, obs, wav_ext, (g, p, nl))


def launch_explicit(lib, obs_ri, w):
    """One launch of a variant on the explicit (K, NL) layout, split as
    ``lag_bank_correlate`` splits it."""
    from amaranth_twstft_tpu_torch.ops.lagbank import _Geometry, explicit_chunk

    _, c, k = obs_ri.shape
    nl = w.shape[1]
    n_sm = torch.cuda.get_device_properties(obs_ri.device).multi_processor_count
    geo = _Geometry(0, c * k, k, 0, nl, 1, 0, k * nl, 1, c, k, nl,
                    explicit_chunk(1, k, n_sm), 0.5)
    return [o[0] for o in _call(lib, geo, obs_ri, w, (1, c, nl))]


def profile_kernels(fn, reps: int = 10) -> str:
    """Each CUDA kernel's device time per call from ``torch.profiler`` over
    ``reps`` calls, and how many times it ran per call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [f"{(re.search(r'\w+_kernel', ev.key) or [ev.key[:40]])[0]} "
            f"{ev.device_time_total / reps:.1f} us x {ev.count / reps:g}"
            for ev in prof.key_averages() if ev.device_time_total > 0]
    return "; ".join(rows)


def compare_trees(trees: list[str]) -> int:
    """``chip_smoke.py --explicit-times TREE`` for each tree in turn, each
    in a process of its own (that tree's package and kernel build)."""
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rc = 0
    for tree in trees:
        print(f"tree {tree}:", flush=True)
        rc |= subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                              "--explicit-times", tree], timeout=900).returncode
    return rc


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("gpu_lagbank_probe: no CUDA device", file=sys.stderr)
        return 1
    if argv and argv[0] == "--trees":
        return compare_trees(argv[1:])
    from amaranth_twstft_tpu_torch.ops import lagbank
    from amaranth_twstft_tpu_torch.utils import cuda_build
    from chip_smoke import cuda_ms

    nls = [int(v) for v in argv[0].split(",")] if argv else list(NL_EXPLICIT)

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
    runs = {name: (lambda f=fns[name]: launch(f, obs, wav_ext))
            for name in fns if not name.startswith("explicit")}
    names = list(runs)
    for name in names + names[::-1]:
        ms = cuda_ms(runs[name], 20)
        print(f"{name}: {ms:.4f} ms per launch (CUDA events, 20 launches)", flush=True)
    for name in names:
        print(f"{name} per launch (torch.profiler): {profile_kernels(runs[name])}",
              flush=True)

    # the explicit form at the host receiver's shape and lag counts;
    # `explicit` is the source as it is (the `kernel` build)
    obs_ri = obs[0]
    for nl in nls:
        w = torch.randn(K, nl, generator=gen, device=dev)
        ref64 = lagbank.lag_bank_plain(obs_ri.double(), w.double())
        print(f"NL {nl}: explicit form, float32 plain vs float64: "
              f"{errors(lagbank.lag_bank_plain(obs_ri, w), ref64)}")
        print(f"NL {nl}: explicit vs float64: "
              f"{errors(launch_explicit(fns['kernel'], obs_ri, w), ref64)}")
        del ref64
        runs = {"explicit": lambda w=w: launch_explicit(fns["kernel"], obs_ri, w)}
        for name in ("explicit_no_products", "explicit_no_copies", "explicit_no_sum",
                     "explicit_no_tail", "explicit_ring4"):
            runs[name] = lambda f=fns[name], w=w: launch_explicit(f, obs_ri, w)
        names = list(runs)
        for name in names + names[::-1]:
            ms = cuda_ms(runs[name], 20)
            print(f"NL {nl}: {name}: {ms:.4f} ms per launch (CUDA events, 20 launches)",
                  flush=True)
        for name in names:
            print(f"NL {nl}: {name} per launch (torch.profiler): "
                  f"{profile_kernels(runs[name])}", flush=True)
        del w
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
