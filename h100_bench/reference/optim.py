"""AdamW (decoupled weight decay, bias-corrected moments) over an fp32
master with an EMA of it, in the storage the training configuration
states: mu in bf16, nu, the master and the EMA in fp32, the parameters the
forward reads in bf16."""

from __future__ import annotations

import torch

from .precision import EXACT, Precision

__all__ = ["AdamWEma", "B1", "B2"]

# the moments' decays, the training recipe's and the program's default
B1, B2 = 0.9, 0.999


class AdamWEma:
    """State of one training run over `master` (name -> fp32 tensor)."""

    def __init__(self, master: dict, *, lr: float, ema_decay: float, b1: float = B1,
                 b2: float = B2, eps: float = 1e-8, weight_decay: float = 0.0,
                 prec: Precision = EXACT):
        self.prec = prec
        self.hyper = dict(lr=lr, d=ema_decay, b1=b1, b2=b2, eps=eps, wd=weight_decay)
        self.master = {k: prec.state(v.float().clone()) for k, v in master.items()}
        self.ema = {k: v.clone() for k, v in self.master.items()}
        self.mu = {k: torch.zeros_like(v) for k, v in self.master.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.master.items()}
        self.count = 0

    def params(self) -> dict:
        """The parameters the forward reads: the master rounded to bf16."""
        return {k: v.to(torch.bfloat16).float() for k, v in self.master.items()}

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        h, st = self.hyper, self.prec.state
        self.count += 1
        bc1 = 1.0 / (1.0 - h["b1"] ** self.count)
        bc2 = 1.0 / (1.0 - h["b2"] ** self.count)
        for k, w in self.master.items():
            g = grads[k].float()
            m = (h["b1"] * self.mu[k] + (1 - h["b1"]) * g).to(torch.bfloat16).float()
            v = h["b2"] * self.nu[k] + (1 - h["b2"]) * g * g
            w_new = st(w - h["lr"] * (m * bc1 / (torch.sqrt(v * bc2) + h["eps"]) + h["wd"] * w))
            self.mu[k], self.nu[k], self.master[k] = m, st(v), w_new
            self.ema[k] = st(h["d"] * self.ema[k] + (1 - h["d"]) * w_new)
