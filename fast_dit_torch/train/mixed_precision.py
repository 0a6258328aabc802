"""Master-weight mixed precision: bf16 model parameters, an fp32 optimizer
master (counterpart of `fast_dit_tpu/train/mixed_precision.py`).

`masterize` (`mixed_precision.py:28-45`) wraps an optax transform so it
updates an fp32 master copy and hands the model its low-precision cast.
Here it wraps a torch optimizer built over the master tensors: the model's
bf16 gradients are cast to fp32 into the masters' `.grad`, the inner
optimizer steps the masters, and each master is copied back into its bf16
parameter (JAX's `p + (master.astype(p.dtype) - p)` is that cast). No loss
scaling is needed: bf16 has fp32's exponent range.
"""

from __future__ import annotations

from typing import Callable, List

import torch

__all__ = ["MasterWeightsOptimizer", "masterize", "get_master_params"]


class MasterWeightsOptimizer:
    """An fp32 master copy of `params` stepped by `inner`, cast back into
    `params` after every step."""

    def __init__(self, params: List[torch.Tensor], make_inner: Callable):
        self.params = list(params)
        self.master = [p.detach().float().clone() for p in self.params]
        self.inner = make_inner(self.master)

    @torch.no_grad()
    def step(self) -> None:
        for p, w in zip(self.params, self.master):
            w.grad = p.grad.float()
        self.inner.step()
        for p, w in zip(self.params, self.master):
            p.copy_(w)
            w.grad = None

    def state_dict(self) -> dict:
        return {"master": self.master, "inner": self.inner.state_dict()}


def masterize(params, make_inner: Callable) -> MasterWeightsOptimizer:
    """`make_inner(master_tensors)` builds the optimizer that steps the fp32
    masters of the low-precision `params`."""
    return MasterWeightsOptimizer(params, make_inner)


def get_master_params(opt):
    """The fp32 master list if the optimizer keeps one (masterized or the
    fused update's state), else None."""
    return getattr(opt, "master", None)
