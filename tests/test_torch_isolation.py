"""The port stands alone: it never imports JAX or the JAX package, and
its entry points refuse to fall back to the CPU on their own."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import amaranth_twstft_tpu_torch
from amaranth_twstft_tpu_torch.utils import platform

PKG_DIR = os.path.dirname(amaranth_twstft_tpu_torch.__file__)
ROOT = os.path.dirname(PKG_DIR)


def _port_modules():
    return [
        m.name
        for m in pkgutil.walk_packages([PKG_DIR], "amaranth_twstft_tpu_torch.")
        if not m.name.endswith("__main__")
    ]


def test_port_imports_no_jax():
    mods = _port_modules()
    assert "amaranth_twstft_tpu_torch.ops.lagbank" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'amaranth_twstft_tpu' or k.startswith('amaranth_twstft_tpu.'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr


# `amaranth_twstft_tpu` followed by a dot or a word boundary (the port's
# own name continues the prefix with `_torch`)
_JAX_PKG_IMPORT = re.compile(
    r"^\s*(from\s+amaranth_twstft_tpu(\.|\b)|import\s+amaranth_twstft_tpu(\.|\b))",
    re.M,
)
_JAX_IMPORT = re.compile(r"^\s*(import|from)\s+jax\b", re.M)


def _port_sources():
    for d, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith((".py", ".cu")):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_sources_never_import_the_jax_package():
    seen = 0
    for path in _port_sources():
        with open(path) as f:
            text = f.read()
        assert not _JAX_PKG_IMPORT.search(text), path
        assert not _JAX_IMPORT.search(text), path
        seen += 1
    assert seen > 10
    assert _JAX_PKG_IMPORT.search("from amaranth_twstft_tpu.ops import x")
    assert _JAX_PKG_IMPORT.search("import amaranth_twstft_tpu")
    assert not _JAX_PKG_IMPORT.search("from amaranth_twstft_tpu_torch.ops import x")


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        platform.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        platform.resolve_device("cuda")
    assert platform.resolve_device("cpu") == torch.device("cpu")
    from amaranth_twstft_tpu_torch.models.dllpll import ChannelConfig
    from amaranth_twstft_tpu_torch.models.tracker import BankedReceiver

    cfg = ChannelConfig(bit_len=5, taps=5, chip_rate=5e3, code_len=31,
                        filter_hz=5e3, nlag=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        BankedReceiver([cfg], fs=1e4)


def test_tf32_is_off():
    """PARITY deviation 12 on Hopper: IEEE fp32 products only."""
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    platform.check_no_tf32()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            platform.check_no_tf32()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
