"""Joining a `torch.distributed` world and sharing a string from rank 0
(counterparts of `maybe_initialize_distributed` and `broadcast_string` in
`fast_dit_tpu/utils/platform.py:54-98`).

`torchrun` sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT;
`maybe_initialize_distributed` joins that world (`utils.device.world_and_rank`:
NCCL on the card, each rank on card LOCAL_RANK, gloo on the CPU) and is a
no-op without them. Half a world's environment (RANK without WORLD_SIZE, or
the other way round) raises, as JAX's check of JAX_NUM_PROCESSES without
JAX_PROCESS_ID does. `backend=` picks the backend for callers that need
another (two ranks sharing one card must use gloo: NCCL refuses a duplicate
GPU); the CLIs have no such flag. JAX's CPU switch and compile cache have
no counterpart.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.collectives import broadcast
from .device import world_and_rank

__all__ = ["maybe_initialize_distributed", "broadcast_string", "destroy_distributed"]


def maybe_initialize_distributed(device: torch.device, backend: Optional[str] = None):
    """(world, rank, device): join torchrun's world when its environment is
    set, else (1, 0, device)."""
    has_rank, has_world = "RANK" in os.environ, "WORLD_SIZE" in os.environ
    if has_rank != has_world:
        missing = "RANK" if has_world else "WORLD_SIZE"
        raise RuntimeError(
            f"{'WORLD_SIZE' if has_world else 'RANK'} is set but {missing} is not — "
            f"explicit multi-process bring-up needs both (plus MASTER_ADDR and MASTER_PORT; "
            f"torchrun sets all four)")
    return world_and_rank(device, backend=backend)


def broadcast_string(s: Optional[str], *, max_bytes: int = 4096,
                     device: Optional[torch.device] = None) -> str:
    """Rank 0's string on every rank (the experiment directory, which only
    rank 0 may make). A no-op in a world of one."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return s or ""
    data = (s or "").encode()
    if len(data) > max_bytes:
        raise ValueError(f"string too long to broadcast: {len(data)} bytes")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) if (
            dist.get_backend() == "nccl") else torch.device("cpu")
    buf = torch.zeros(max_bytes, dtype=torch.uint8)
    buf[:len(data)] = torch.tensor(list(data), dtype=torch.uint8)
    buf = broadcast(buf.to(device), 0, dist.group.WORLD).cpu()
    return bytes(buf.tolist()).rstrip(b"\x00").decode()


def destroy_distributed() -> None:
    """Leave the world, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
