"""Attention backend dispatch (counterpart of `fast_dit_tpu/ops/attention.py`).

- "auto":   `flash_attention_qkv_flat`: the CUDA kernel on a CUDA tensor,
            its plain twin on a CPU tensor.
- "einsum": the plain twin on any device, the numerical ground truth.
- "ring":   exact sequence-parallel ring attention over a sharded token axis
            (`ops/ring_attention.py`), the counterpart of "ring:<axis>"
            (:86-93, :120-124). It needs the ring the tokens are sharded
            around, which `parallel/sequence.py` passes down through the
            blocks; without one it raises. "auto" never chooses it.

`dot_product_attention` is the counterpart of JAX's entry over separate
q, k and v (`ops/attention.py:106-128`), which the cross-attention of the
NVS model calls: (B, Sq, D) queries against (B, Sk, D) keys and values.
Under "auto" on a CUDA tensor it packs q, k and v along the last dim into
the (3, H, hd) column order and runs the packed kernels, as JAX's compat
wrapper stacks them (`flash_attention.py:404-408`); that needs Sq == Sk,
and otherwise it raises, as JAX's stack fails on a TPU. On a CPU tensor
and under "einsum" anywhere it runs the plain version, which takes any
Sq and Sk (JAX's "xla" and "einsum").

The TPU's rule for choosing between the XLA and the Pallas forward (a 64 MB
VMEM residency threshold, `ops/attention.py:57,94-102`) describes the TPU
and is not carried over: on the card every forward goes through the kernel.
"""

from __future__ import annotations

import torch

from .flash_attention import _attention_qkv_plain, flash_attention_qkv_flat
from .ring_attention import ring_attention_qkv

__all__ = ["BACKENDS", "RING", "attention_qkv", "dot_product_attention", "resolve_backend"]

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


def _attention_plain(q, k, v, num_heads: int, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over (B, Sq, D) q and (B, Sk, D) k, v, fp32
    throughout, output in q's dtype."""
    B, Sq, D = q.shape
    qh, kh, vh = (a.float().reshape(B, a.shape[1], num_heads, D // num_heads)
                  for a in (q, k, v))
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vh).reshape(B, Sq, D).to(q.dtype)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                          *, backend: str = "auto", scale=None) -> torch.Tensor:
    """Attention of (B, Sq, H*hd) queries over (B, Sk, H*hd) keys and values
    -> (B, Sq, H*hd). "auto" on a CUDA tensor launches the packed kernels
    (forward, and backward where a gradient is wanted) and raises unless
    Sq == Sk; a CPU tensor or "einsum" takes the plain version."""
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2]:
        raise ValueError(f"expected q (B, Sq, D) and k, v (B, Sk, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[2] % num_heads:
        raise ValueError(f"width {q.shape[2]} is not a multiple of num_heads={num_heads}")
    hd = q.shape[2] // num_heads
    scale = float(hd ** -0.5 if scale is None else scale)
    if resolve_backend(backend) == "einsum" or q.device.type == "cpu":
        return _attention_plain(q, k, v, num_heads, scale)
    if q.shape[1] != k.shape[1]:
        raise ValueError(
            f"the attention kernel reads q, k and v packed in one (B, S, 3D) tensor, so it "
            f"takes equal query and key lengths; got Sq={q.shape[1]} and Sk={k.shape[1]}. "
            f"Pass backend='einsum' for attention over unequal lengths")
    return flash_attention_qkv_flat(torch.cat([q, k, v], dim=-1), num_heads, scale=scale)
