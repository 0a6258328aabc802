"""Attention backend dispatch (counterpart of `fast_dit_tpu/ops/attention.py`).

- "auto":   `flash_attention_qkv_flat`: the CUDA kernel on a CUDA tensor,
            its plain twin on a CPU tensor.
- "einsum": the plain twin on any device, the numerical ground truth.
- "ring":   exact sequence-parallel ring attention over a sharded token axis
            (`ops/ring_attention.py`), the counterpart of "ring:<axis>"
            (:86-93, :120-124). It needs the ring the tokens are sharded
            around, which `parallel/sequence.py` passes down through the
            blocks; without one it raises. "auto" never chooses it.

The TPU's rule for choosing between the XLA and the Pallas forward (a 64 MB
VMEM residency threshold, `ops/attention.py:57,94-102`) describes the TPU
and is not carried over: on the card every forward goes through the kernel.
"""

from __future__ import annotations

import torch

from .flash_attention import _attention_qkv_plain, flash_attention_qkv_flat
from .ring_attention import ring_attention_qkv

__all__ = ["BACKENDS", "RING", "attention_qkv", "resolve_backend"]

# the backends of a dense (unsharded) model, the choices of the CLIs
BACKENDS = ("auto", "einsum")
RING = "ring"


def resolve_backend(backend: str) -> str:
    """A dense model's backend; "ring" is not one, since it needs a ring."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}; choose from {BACKENDS}")
    return backend


def attention_qkv(qkv: torch.Tensor, num_heads: int, *, backend: str = "auto",
                  scale=None, ring=None) -> torch.Tensor:
    """Packed (B, S, 3*H*hd) qkv -> (B, S, H*hd) through `backend`. With
    `ring`, qkv is a token shard and attention runs around the ring; the ring
    and the "ring" backend come together or not at all."""
    if ring is not None or backend == RING:
        if ring is None:
            raise RuntimeError(
                "the 'ring' attention backend runs only inside a sequence-parallel "
                "forward (fast_dit_torch.parallel.sequence), which passes the ring "
                "the tokens are sharded around; no ring was given")
        if backend != RING:
            raise ValueError(f"a ring needs the {RING!r} backend, got {backend!r}")
        return ring_attention_qkv(qkv, num_heads, ring, scale=scale)
    if resolve_backend(backend) == "einsum":
        hd = qkv.shape[-1] // (3 * num_heads)
        return _attention_qkv_plain(qkv, num_heads, float(hd ** -0.5 if scale is None else scale))
    return flash_attention_qkv_flat(qkv, num_heads, scale=scale)
