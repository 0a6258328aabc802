"""Packed-qkv attention forward: the hand-written CUDA kernel and its plain
twin.

Counterpart of `fast_dit_tpu/ops/flash_attention.py`. The TPU kernel
`_fwd_kernel` (:119-153, launched by `_forward`, :156-177) becomes
`csrc/flash_attention_fwd.cu`; `_xla_attention_qkv` (:291-299) becomes
`_attention_qkv_plain`. Both read the packed (B, S, 3D) projection output in
place (q at column h*hd, k at D + h*hd, v at 2D + h*hd) and return (B, S, D).

`flash_attention_qkv_flat` (mirroring :352-387) holds the kernel's contract
on every device: fp32 or bf16, a contiguous 3-D tensor, hd a multiple of 8
and at most 128. On a CPU tensor it computes the twin; on a CUDA tensor it
launches the kernel or raises. There is no fallback from one to the other.
The TPU's `3D % 128 == 0` lane rule is not carried over.

The softmax is exact in both dtypes: the TPU kernel's clamped, unnormalised
bf16 softmax (`_CLAMP`, `_unnormalized_softmax`, :102-111) is a VPU
workaround that is not ported (see the note in the CUDA source).

Forward only: the backward kernel (`_bwd_kernel`) comes with the training
slice, so the autograd wrapper refuses a backward pass on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["flash_attention_qkv_flat", "check_qkv"]

MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _attention_qkv_plain(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v in plain torch, fp32 throughout, output in
    the input dtype (the twin of `_xla_attention_qkv`)."""
    B, S, threeD = qkv.shape
    D = threeD // 3
    hd = D // num_heads
    x = qkv.float().reshape(B, S, 3, num_heads, hd)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, D).to(qkv.dtype)


def check_qkv(qkv: torch.Tensor, num_heads: int) -> int:
    """Raise unless the kernel takes `qkv`; return the head dim."""
    if qkv.dtype not in _DTYPE_CODES:
        raise ValueError(f"attention kernel takes float32 or bfloat16, got {qkv.dtype}")
    if qkv.dim() != 3:
        raise ValueError(f"expected packed qkv (B, S, 3D), got shape {tuple(qkv.shape)}")
    B, S, threeD = qkv.shape
    if num_heads < 1 or threeD % (3 * num_heads):
        raise ValueError(f"last dim {threeD} is not 3 * num_heads({num_heads}) * hd")
    hd = threeD // (3 * num_heads)
    if hd % 8 or hd > MAX_HEAD_DIM:
        raise ValueError(f"attention kernel takes hd a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}, got {hd}")
    if B < 1 or S < 1 or B > 65535 or num_heads > 65535:
        raise ValueError(f"attention kernel takes 1 <= B, H <= 65535 and S >= 1, "
                         f"got B={B}, S={S}, H={num_heads}")
    if not qkv.is_contiguous():
        raise ValueError("attention kernel takes a contiguous qkv tensor")
    return hd


def _launch_fwd(qkv: torch.Tensor, num_heads: int, hd: int, scale: float) -> torch.Tensor:
    if qkv.device.type != "cuda":
        raise ValueError(f"attention kernel runs on CUDA tensors, got {qkv.device}")
    if qkv.data_ptr() % 16:
        raise ValueError("attention kernel takes a 16-byte aligned qkv tensor")
    B, S, threeD = qkv.shape
    lib = _build.load("flash_attention_fwd")
    fn = lib.fdt_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                   ctypes.c_void_p]
    out = torch.empty((B, S, threeD // 3), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(qkv.data_ptr(), out.data_ptr(), B, S, num_heads, hd, scale,
                  _DTYPE_CODES[qkv.dtype], stream)
    _build.check_status(lib, code, "attention_fwd launch")
    _build.launch_counts["attention_fwd"] += 1
    return out


class _AttentionFwd(torch.autograd.Function):
    """Kernel forward; the backward kernel comes with the training slice."""

    @staticmethod
    def forward(ctx, qkv, num_heads, hd, scale):
        return _launch_fwd(qkv, num_heads, hd, scale)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "the attention backward kernel is not ported yet (training slice)")


def flash_attention_qkv_flat(qkv: torch.Tensor, num_heads: int, scale=None) -> torch.Tensor:
    """Attention over a packed (B, S, 3*H*hd) qkv tensor -> (B, S, H*hd).

    A CPU tensor takes the plain twin; a CUDA tensor launches the kernel.
    `scale` defaults to hd ** -0.5.
    """
    hd = check_qkv(qkv, num_heads)
    scale = float(hd ** -0.5 if scale is None else scale)
    if qkv.device.type == "cpu":
        return _attention_qkv_plain(qkv, num_heads, scale)
    return _AttentionFwd.apply(qkv, num_heads, hd, scale)
