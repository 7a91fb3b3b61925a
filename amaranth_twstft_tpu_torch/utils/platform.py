"""Device resolution for the port.

Replaces the JAX package's ``ops/boundary.on_accelerator`` and
``utils/platform.py``: every entry point takes a ``device`` argument,
``None`` means the card, and a missing card is an error — the port never
falls back to the CPU on its own.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "check_no_tf32"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; raise when a CUDA device is asked for and
    absent.  ``device="cpu"`` is the only way onto the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run the port "
                "on the CPU"
            )
        check_no_tf32()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_no_tf32() -> None:
    """PARITY deviation 12: the lag bank is read directly as an estimate,
    so float32 products must stay IEEE fp32 (no TF32 rounding)."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError(
            "TF32 is enabled (torch.backends.cuda.matmul.allow_tf32 / "
            "torch.backends.cudnn.allow_tf32); the port requires IEEE fp32"
        )
