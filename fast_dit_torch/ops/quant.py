"""Int8 W8A8 products for inference (counterpart of `fast_dit_tpu/ops/quant.py:47-82`).

Symmetric absmax quantisation, as in JAX:

- activations: one scale per row, absmax / 127 over the whole contraction
  axis, computed in fp32 at every call;
- weights: one scale per output channel;
- values: round half to even (`torch.round`, as `jnp.round`), clipped to
  [-127, 127];
- the product accumulates in int32, is dequantised in fp32 as
  `acc * row_scale * col_scale` (in that order), gets the bias in fp32 and
  is cast to the output dtype.

JAX leaves the int8 product to XLA; here it is `torch._int_mm`, the stock
int8 GEMM (cuBLAS on the card), exact against an int32 matmul. On the card
`_int_mm` takes more than 16 rows and K and N multiples of 8: fewer rows are
padded with zero rows (exact: a zero row adds nothing and is cut off), and
any other shape raises. There is no float fallback.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["QUANT_MODES", "quantize_rows", "quantize_cols", "int8_mm", "int8_matmul"]

QUANT_MODES = ("w8a8",)
# `torch._int_mm`'s shape rules on CUDA (aten/src/ATen/native/cuda/Blas.cpp)
_MIN_ROWS = 17
_ALIGN = 8


def _quantize(x: torch.Tensor, dim: int):
    x = x.float()
    amax = x.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def quantize_rows(x: torch.Tensor):
    """(R, K) float -> (int8 (R, K), fp32 (R, 1) scale), symmetric absmax."""
    return _quantize(x, -1)


def quantize_cols(w: torch.Tensor):
    """(K, N) float -> (int8 (K, N), fp32 (1, N) scale), per output channel."""
    return _quantize(w, 0)


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) @ int8 (K, N) -> int32 (M, N), exact. On the card rows
    are padded to more than 16; K and N must be multiples of 8."""
    if a.dtype != torch.int8 or b.dtype != torch.int8 or a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"int8_mm takes 2-D int8 operands, got {a.dtype} {tuple(a.shape)} "
                         f"and {b.dtype} {tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    if a.device.type == "cuda":
        if K % _ALIGN or N % _ALIGN:
            raise ValueError(f"the card's int8 GEMM takes K and N multiples of {_ALIGN}, "
                             f"got K={K}, N={N}")
        if M < _MIN_ROWS:
            a = torch.cat([a, a.new_zeros(_MIN_ROWS - M, K)])
            return torch._int_mm(a, b)[:M]
    return torch._int_mm(a, b)


def int8_matmul(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                out_dtype: Optional[torch.dtype] = None, wq=None) -> torch.Tensor:
    """Quantised x @ w with fp32 dequantisation: x (..., K) of any float
    dtype, w (K, N) -> (..., N) in `out_dtype` (default x.dtype). `wq`, if
    given, is `quantize_cols(w)` computed before."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    lead, K = x.shape[:-1], x.shape[-1]
    xq, xs = quantize_rows(x.reshape(-1, K))
    wq, ws = quantize_cols(w) if wq is None else wq
    out = int8_mm(xq, wq).float() * xs * ws
    if bias is not None:
        out = out + bias.float().reshape(-1)
    return out.reshape(*lead, wq.shape[-1]).to(out_dtype)
