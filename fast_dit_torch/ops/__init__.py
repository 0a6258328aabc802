"""Kernels and their plain versions: the packed-qkv attention forward and
backward (`flash_attention`), the ring-attention hop forward and backward
(`ring_attention`), their dispatch (`attention`), the fused AdamW + EMA
update (`fused_update`), the clamped attention forward of the head-dim
layout experiment (`attn_layout`) and the nvcc/ctypes build (`_build`); and the
stock-op options JAX leaves to XLA: W8A8 int8 products (`quant`) and token
merging (`tome`). The module
`ring_attention` is imported by its path: its function of the same name
would hide it as an attribute of this package."""

from ._build import launch_counts, reset_launch_counts
from .attention import attention_qkv
from .attn_layout import transposed_forward
from .flash_attention import flash_attention_qkv_flat
from .fused_update import fused_adamw_ema_apply, fused_adamw_ema_init

__all__ = ["attention_qkv", "flash_attention_qkv_flat", "fused_adamw_ema_apply",
           "fused_adamw_ema_init", "launch_counts", "reset_launch_counts",
           "transposed_forward"]
