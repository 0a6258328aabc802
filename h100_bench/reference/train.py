"""The first training steps of the reference: the hybrid diffusion loss of
`diffusion.training_loss` through the fp32 DiT, gradients by autograd over
blocks of rows, and `optim.AdamWEma`."""

from __future__ import annotations

import torch

from . import diffusion, dit
from .optim import AdamWEma
from .precision import EXACT, Precision, no_tf32

__all__ = ["run_steps", "row_sq"]


def run_steps(cfg, weights: dict, steps: list, *, lr: float, ema_decay: float,
              block_rows: int, prec: Precision = EXACT) -> dict:
    """Follow `steps`, each {"x", "y", "t", "noise", "force_drop_ids"} of one
    global batch, from `weights` (name -> tensor). Returns the loss of each
    step (the mean over the batch) and, by name, the first step's gradient
    and the change of the master and of the EMA over all the steps, each as
    fp64 squared norms of the leaf's rows (`row_sq`)."""
    names = list(weights)
    opt = AdamWEma(weights, lr=lr, ema_decay=ema_decay, prec=prec)
    sched = diffusion.Schedule(device=next(iter(weights.values())).device)
    losses, grad_rows = [], None
    with no_tf32():
        for k, s in enumerate(steps):
            params = {n: v.requires_grad_() for n, v in opt.params().items()}
            B = s["x"].shape[0]
            total = 0.0
            for r in range(0, B, block_rows):
                rows = slice(r, r + block_rows)
                y = torch.where(s["force_drop_ids"][rows] == 1, cfg["num_classes"], s["y"][rows])
                per_ex = diffusion.training_loss(
                    sched, lambda x_t, t: dit.forward(params, cfg, x_t, t, y, prec),
                    s["x"][rows], s["t"][rows], s["noise"][rows])
                (per_ex.sum() / B).backward()
                total += per_ex.detach().double().sum().item()
            losses.append(total / B)
            grads = {n: p.grad for n, p in params.items()}
            if k == 0:
                grad_rows = {n: row_sq(grads[n]) for n in names}
            opt.step(grads)
            del params, grads
    return {"losses": losses, "grad_rows": grad_rows,
            "change_rows": {n: row_sq(opt.master[n] - weights[n]) for n in names},
            "ema_change_rows": {n: row_sq(opt.ema[n] - weights[n]) for n in names}}


def row_sq(t: torch.Tensor) -> torch.Tensor:
    """The squared norm of each row (index of the first axis) of a leaf, in
    fp64 on the host."""
    t = t.detach().double()
    return (t * t).reshape(t.shape[0], -1).sum(dim=1).cpu()
