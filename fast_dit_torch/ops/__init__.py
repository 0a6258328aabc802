"""Kernels and their plain twins: the packed-qkv attention forward
(`flash_attention`), its dispatch (`attention`) and the nvcc/ctypes build
(`_build`)."""

from ._build import launch_counts, reset_launch_counts
from .attention import attention_qkv
from .flash_attention import flash_attention_qkv_flat

__all__ = ["attention_qkv", "flash_attention_qkv_flat", "launch_counts",
           "reset_launch_counts"]
