"""Device resolution for the port's entry points: the card by default, the
CPU only when the caller asks for it; and the TF32 setting, which every
entry point sets itself instead of taking the library's defaults; and the
process's place in a `torch.distributed` world."""

from __future__ import annotations

import contextlib
import datetime
import os

import torch
import torch.distributed as dist

__all__ = ["resolve_device", "tf32", "world_and_rank"]


def resolve_device(device="cuda") -> torch.device:
    """`torch.device(device)`, raising when a CUDA device is asked for and
    CUDA is absent. There is no silent CPU fallback: pass device="cpu"."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; fast_dit_torch runs on the GPU by default. "
            "Pass device='cpu' (--device cpu on the CLI) to run on the CPU.")
    return device


@contextlib.contextmanager
def tf32(enabled: bool):
    """Run the block with TF32 on or off for both cuBLAS matmuls and cuDNN
    convolutions (cuDNN's own default is on), and restore both after."""
    backends = torch.backends
    saved = backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32
    backends.cuda.matmul.allow_tf32 = backends.cudnn.allow_tf32 = bool(enabled)
    try:
        yield
    finally:
        backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32 = saved


def world_and_rank(device: torch.device, backend=None):
    """(world, rank, device): join the `torch.distributed` group when RANK and
    WORLD_SIZE are set, taking card LOCAL_RANK on CUDA; else (1, 0, device).
    The backend is NCCL on the card and gloo on the CPU unless `backend`
    names one."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return 1, 0, device
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                                init_method="env://",
                                timeout=datetime.timedelta(minutes=30))
    return dist.get_world_size(), dist.get_rank(), device
