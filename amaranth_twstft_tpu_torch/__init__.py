"""PyTorch/CUDA port of the TWSTFT post-processing framework.

A second package beside the JAX one (``amaranth_twstft_tpu``), which stays
the reference: every module here mirrors its counterpart's layout and is
held against it by the CPU tests (``tests/test_torch_*.py``).  The port
imports ``torch`` and never ``jax`` nor the JAX package.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(:func:`amaranth_twstft_tpu_torch.utils.platform.resolve_device`).  The
one hand-written CUDA kernel is the DLL/PLL lag bank (``csrc/lagbank.cu``,
wrapped by :mod:`.ops.lagbank`); the host library of the ingest paths and
the LFSR search is C++ built with ``g++`` (:mod:`.native`).

PARITY deviation 12 on Hopper: every estimate-bearing float32 contraction
runs in IEEE fp32, never TF32 — set here for the whole process and
asserted where a contraction runs.
"""

import torch

from amaranth_twstft_tpu_torch.config import (
    MeshConfig,
    ProcessingConfig,
    SignalConfig,
    StationConfig,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["SignalConfig", "ProcessingConfig", "StationConfig", "MeshConfig"]
