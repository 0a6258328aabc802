"""Packed-qkv attention, forward and backward: the hand-written CUDA kernels
and their plain versions.

Counterpart of `fast_dit_tpu/ops/flash_attention.py`. The TPU kernels
`_fwd_kernel` (:119-153, launched by `_forward`, :156-177) and `_bwd_kernel`
(:185-252, launched by `_backward`, :255-283) become
`csrc/flash_attention_fwd.cu` and `csrc/flash_attention_bwd.cu`;
`_xla_attention_qkv` (:291-299) becomes `_attention_qkv_plain`, and the
closed-form gradient `_attention_qkv_bwd_plain` is the backward's plain
version. All read the packed (B, S, 3D) projection output in place (q at
column h*hd, k at D + h*hd, v at 2D + h*hd); the backward writes the packed
(B, S, 3D) dqkv.

`flash_attention_qkv_flat` (mirroring :352-387) holds the kernels' contract
on every device: fp32 or bf16, a contiguous 3-D tensor, hd a multiple of 8
and at most 128, any S. On a CPU tensor it computes the plain version, and
gradients flow through it under torch autograd. On a CUDA tensor it
launches the kernel or raises; where a gradient is wanted it goes through
`_AttentionFn`, the counterpart of `_flash`'s custom VJP (:302-316): the
forward kernel forward (also writing the rows' log-sum-exp), the backward
kernel backward. There is no fallback from one to the other. The TPU's
`3D % 128 == 0` lane rule and its S <= 1024 backward bound with an XLA
recompute above it (`_BWD_MAX_SEQ`, :64, :333-349) are VMEM rules and are
not carried over.

Numerics are exact in both dtypes: the TPU kernels' clamped, unnormalised
bf16 softmax (`_CLAMP`, `_unnormalized_softmax`, :102-111, :226-242) is a
VPU workaround that is not ported (see the notes in the CUDA sources). The
bf16 kernels run on the tensor cores and round p, and in the backward ds,
to bf16 before their products, as the TPU's exact path does (:141, :217,
:221); the plain versions keep them fp32, and the kernels are held to them
within 2e-2 (forward, absolute; backward, of max |dqkv|).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["flash_attention_qkv_flat", "check_qkv"]

MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_FWD_ARGS = [_P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _P]
_BWD_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _P]


def _split_heads(x: torch.Tensor, num_heads: int, parts: int):
    B, S, W = x.shape
    return x.float().reshape(B, S, parts, num_heads, W // (parts * num_heads)).unbind(2)


def _attention_qkv_plain(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v in plain torch, fp32 throughout, output in
    the input dtype (the plain version of `_xla_attention_qkv`)."""
    B, S, threeD = qkv.shape
    q, k, v = _split_heads(qkv, num_heads, 3)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, threeD // 3).to(qkv.dtype)


def _attention_qkv_bwd_plain(qkv: torch.Tensor, dout: torch.Tensor, num_heads: int,
                             scale: float) -> torch.Tensor:
    """The closed-form gradient of `_attention_qkv_plain` with respect to the
    packed qkv, given dO (B, S, D): the exact formulas of `_bwd_kernel`
    (:213-224) in fp32, returned as the packed (B, S, 3D) dqkv in the input
    dtype."""
    B, S, threeD = qkv.shape
    q, k, v = _split_heads(qkv, num_heads, 3)
    (do,) = _split_heads(dout.to(qkv.dtype), num_heads, 1)
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale, dim=-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    return torch.stack([dq, dk, dv], dim=2).reshape(B, S, threeD).to(qkv.dtype)


def check_qkv(qkv: torch.Tensor, num_heads: int) -> int:
    """Raise unless the kernels take `qkv`; return the head dim."""
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


def _check_cuda(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"attention kernel runs on CUDA tensors, got {t.device}")
        if t.data_ptr() % 16:
            raise ValueError("attention kernel takes 16-byte aligned tensors")


def _launch_fwd(qkv: torch.Tensor, num_heads: int, hd: int, scale: float,
                with_lse: bool = False):
    """(out, lse or None); lse is fp32 (B, H, S) in the log2 domain."""
    _check_cuda(qkv)
    B, S, threeD = qkv.shape
    fn = _build.function("flash_attention_fwd", "fdt_attention_fwd", _FWD_ARGS)
    out = torch.empty((B, S, threeD // 3), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((B, num_heads, S), dtype=torch.float32, device=qkv.device)
           if with_lse else None)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(qkv.data_ptr(), out.data_ptr(), 0 if lse is None else lse.data_ptr(),
                  B, S, num_heads, hd, scale, _DTYPE_CODES[qkv.dtype], stream)
    _build.check_status("flash_attention_fwd", code, "attention_fwd launch")
    _build.launch_counts["attention_fwd"] += 1
    return out, lse


def _launch_bwd(qkv, out, dout, lse, num_heads: int, hd: int, scale: float) -> torch.Tensor:
    """Packed dqkv from the forward's qkv, output and LSE and dO."""
    _check_cuda(qkv, out, dout, lse)
    if not (dout.shape == out.shape and dout.dtype == qkv.dtype and dout.is_contiguous()):
        raise ValueError("attention backward takes a contiguous dO of the output's "
                         "shape in the qkv dtype")
    B, S, _ = qkv.shape
    fn = _build.function("flash_attention_bwd", "fdt_attention_bwd", _BWD_ARGS)
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((B, num_heads, S), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                  delta.data_ptr(), dqkv.data_ptr(), B, S, num_heads, hd, scale,
                  _DTYPE_CODES[qkv.dtype], stream)
    _build.check_status("flash_attention_bwd", code, "attention_bwd launch")
    _build.launch_counts["attention_bwd"] += 1
    return dqkv


class _AttentionFn(torch.autograd.Function):
    """Kernel forward, kernel backward (the counterpart of `_flash`). The
    residuals are qkv, the output and the rows' LSE; the softmax is rebuilt
    in the backward, no probabilities are kept."""

    @staticmethod
    def forward(ctx, qkv, num_heads, hd, scale):
        out, lse = _launch_fwd(qkv, num_heads, hd, scale, with_lse=True)
        ctx.save_for_backward(qkv, out, lse)
        ctx.args = (num_heads, hd, scale)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        qkv, out, lse = ctx.saved_tensors
        # the upstream gradient is cast to the qkv dtype, as `_backward` does
        dout = grad_out.to(qkv.dtype).contiguous()
        return _launch_bwd(qkv, out, dout, lse, *ctx.args), None, None, None


def flash_attention_qkv_flat(qkv: torch.Tensor, num_heads: int, scale=None) -> torch.Tensor:
    """Attention over a packed (B, S, 3*H*hd) qkv tensor -> (B, S, H*hd).

    A CPU tensor takes the plain version (differentiable by autograd); a
    CUDA tensor launches the kernels. `scale` defaults to hd ** -0.5.
    """
    hd = check_qkv(qkv, num_heads)
    scale = float(hd ** -0.5 if scale is None else scale)
    if qkv.device.type == "cpu":
        return _attention_qkv_plain(qkv, num_heads, scale)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _AttentionFn.apply(qkv, num_heads, hd, scale)
    return _launch_fwd(qkv, num_heads, hd, scale)[0]
