"""Where the reference rounds: exact fp32, or the control one step lower."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

__all__ = ["Precision", "EXACT", "LOWER", "no_tf32", "round_fp8"]

_FP8_MAX = 448.0  # largest finite e4m3


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to fp8 e4m3 with one scale for the whole tensor (its largest
    magnitude onto 448), returned in x's dtype."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = _FP8_MAX / amax
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


class _StraightThrough(torch.autograd.Function):
    """Forward: the rounded value; backward: the gradient passed as it is."""

    @staticmethod
    def forward(ctx, x):
        return round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return g


@dataclasses.dataclass(frozen=True)
class Precision:
    """`gemm_fp8`: round both inputs of every matrix product, and the
    activations the stages hand on, to fp8 e4m3; `state_dtype`: the dtype
    the optimizer's master, nu and EMA are kept in, and the sampler's
    guidance and step are computed in (None: fp32)."""

    gemm_fp8: bool = False
    state_dtype: Optional[torch.dtype] = None

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        if not self.gemm_fp8:
            return x
        return _StraightThrough.apply(x) if x.requires_grad else round_fp8(x)

    def linear(self, x, w, b=None):
        return torch.nn.functional.linear(self.operand(x), self.operand(w), b)

    def matmul(self, a, b):
        return torch.matmul(self.operand(a), self.operand(b))

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """A stored activation: as computed, or rounded to fp8 e4m3 in the
        control (the configurations keep activations in bf16)."""
        return round_fp8(x) if self.gemm_fp8 else x

    def state(self, x: torch.Tensor) -> torch.Tensor:
        """x as the configuration keeps it: fp32, or rounded to state_dtype."""
        return x if self.state_dtype is None else x.to(self.state_dtype).float()


EXACT = Precision()
LOWER = Precision(gemm_fp8=True, state_dtype=torch.bfloat16)


@contextlib.contextmanager
def no_tf32():
    """fp32 products in fp32: TF32 off for matmuls and convolutions, then
    restored."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
