"""Attention backend dispatch (counterpart of `fast_dit_tpu/ops/attention.py`).

- "auto":   `flash_attention_qkv_flat`: the CUDA kernel on a CUDA tensor,
            its plain twin on a CPU tensor.
- "einsum": the plain twin on any device, the numerical ground truth.

The TPU's rule for choosing between the XLA and the Pallas forward (a 64 MB
VMEM residency threshold, `ops/attention.py:57,94-102`) describes the TPU
and is not carried over: on the card every forward goes through the kernel.
"""

from __future__ import annotations

import torch

from .flash_attention import _attention_qkv_plain, flash_attention_qkv_flat

__all__ = ["BACKENDS", "attention_qkv", "resolve_backend"]

BACKENDS = ("auto", "einsum")


def resolve_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}; choose from {BACKENDS}")
    return backend


def attention_qkv(qkv: torch.Tensor, num_heads: int, *, backend: str = "auto",
                  scale=None) -> torch.Tensor:
    """Packed (B, S, 3*H*hd) qkv -> (B, S, H*hd) through `backend`."""
    if resolve_backend(backend) == "einsum":
        hd = qkv.shape[-1] // (3 * num_heads)
        return _attention_qkv_plain(qkv, num_heads, float(hd ** -0.5 if scale is None else scale))
    return flash_attention_qkv_flat(qkv, num_heads, scale=scale)
