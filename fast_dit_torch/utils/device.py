"""Device resolution for the port's entry points: the card by default, the
CPU only when the caller asks for it."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """`torch.device(device)`, raising when a CUDA device is asked for and
    CUDA is absent. There is no silent CPU fallback: pass device="cpu"."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; fast_dit_torch runs on the GPU by default. "
            "Pass device='cpu' (--device cpu on the CLI) to run on the CPU.")
    return device
