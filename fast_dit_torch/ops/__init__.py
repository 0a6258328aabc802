"""Kernels and their plain versions: the packed-qkv attention forward and
backward (`flash_attention`), its dispatch (`attention`), the fused AdamW +
EMA update (`fused_update`) and the nvcc/ctypes build (`_build`)."""

from ._build import launch_counts, reset_launch_counts
from .attention import attention_qkv
from .flash_attention import flash_attention_qkv_flat
from .fused_update import fused_adamw_ema_apply, fused_adamw_ema_init

__all__ = ["attention_qkv", "flash_attention_qkv_flat", "fused_adamw_ema_apply",
           "fused_adamw_ema_init", "launch_counts", "reset_launch_counts"]
