"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, in the git-ignored
``amaranth_twstft_tpu_torch/build/`` directory, at the first use of any
(or ahead of time) by :func:`build_all`, which starts one ``nvcc`` per
stale source, all together.  A library is rebuilt when its source is
newer.  Loaded with ``ctypes``; nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

__all__ = ["SOURCES", "BUILD_DIR", "build_all", "compile_all", "load"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

#: kernel library name -> its source file under ``csrc/``
SOURCES = {"lagbank": "lagbank.cu", "pack": "pack.cu"}

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is required "
                           "to build the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _paths(name: str) -> tuple[str, str]:
    return (os.path.join(CSRC, SOURCES[name]),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    return not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(src)


def build_all(names=None, force: bool = False) -> dict[str, str]:
    """Compile the named kernel libraries (default: all), one ``nvcc``
    process per source, started together.  Returns name -> the
    compiler's ``-Xptxas -v`` report (registers, shared memory, spills);
    raises with the compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {n: "up to date" for n in names}
    return compile_all({n: _paths(n) for n in todo})


def compile_all(jobs: dict[str, tuple[str, str]]) -> dict[str, str]:
    """Compile each ``name -> (source path, library path)`` for ``sm_90a``,
    one ``nvcc`` process per source, started together.  Returns name ->
    the compiler's ``-Xptxas -v`` report; raises with the compiler's
    output if any build fails."""
    nvcc = _nvcc()
    procs = {}
    for n, (src, lib) in jobs.items():
        os.makedirs(os.path.dirname(lib), exist_ok=True)
        tmp = f"{lib}.tmp{os.getpid()}"
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp, src]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, lib)
    reports, failed = {}, []
    for n, (p, tmp, lib) in procs.items():
        out, _ = p.communicate()
        reports[n] = out
        if p.returncode != 0:
            failed.append(f"{n}: nvcc exit {p.returncode}\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, built if needed, with
    every other stale library beside it (one ``nvcc`` each, together: the
    first launch of a run pays one build's wall, not each)."""
    lib = _LOADED.get(name)
    if lib is None:
        if _stale(name):
            build_all()
        lib = ctypes.CDLL(_paths(name)[1])
        _LOADED[name] = lib
    return lib
