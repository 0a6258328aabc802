"""Mixture-of-experts MLP for DiT blocks (counterpart of `MoeMlp`,
`expert_capacity` and `_top_k_one_hot` in `fast_dit_tpu/models/moe.py:53-167`).

A top-k routed expert layer in place of the dense MLP:

- **Router**: fp32 logits and softmax whatever the activation dtype; top-k
  by k rounds of argmax (the first maximum wins, as in JAX), each round
  excluding the chosen expert with -inf, so that an expert is never chosen
  twice, even where the other gates underflow to 0. The kept gates are
  renormalised to sum to 1.
- **Capacity per batch row**: C = ceil(k * S * factor / E). A cumulative
  count over each row's k * S (choice, token) slots, choice-major, gives
  each slot its place in its expert's buffer, so first choices claim
  capacity before second choices; slots past C are dropped (their token's
  MLP term is 0, the residual carries it).
- **Experts**: stacked weights in JAX's layout, `wi` (E, D, H), `bi`
  (E, H), `wo` (E, H, D), `bo` (E, D), tanh-GELU, one batched matmul over
  the expert axis each. Dispatch gathers each kept slot's token into its
  expert's buffer (empty places are zero rows); combine gathers each
  choice's expert output and sums them weighted by the gates. JAX does
  both with one-hot matmuls; XLA runs them, so stock index ops stand in.

`forward` returns `(y, aux)`: y in x's dtype, aux a (3,) fp32 tensor of
this layer's load-balance loss E * sum_e f_e p_e (f from the top-1 choice,
p the mean gate), router z-loss mean(logsumexp(logits)^2) and the share of
dropped (token, choice) slots. JAX sows them into a collection; here they
are outputs, so that a checkpointed block (`torch.utils.checkpoint`) that
runs again in the backward neither counts them twice nor loses their graph.

Parameter names: `router.weight` (E, D), the flax (D, E) kernel
transposed, as any `nn.Linear`; `wi`, `bi`, `wo`, `bo` in JAX's per-block
layout (`ckpt/convert.py`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["MoeMlp", "Routing", "expert_capacity", "top_k_gates", "AUX_NAMES"]

# the rows of a layer's aux tensor
AUX_NAMES = ("load_balance", "router_z", "dropped_frac")


def expert_capacity(num_tokens: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Per-expert token capacity C of one batch row: ceil(k S factor / E), >= 1."""
    c = int(-(-top_k * num_tokens * capacity_factor // num_experts))
    return max(c, 1)


def top_k_gates(gates: torch.Tensor, k: int):
    """k rounds of argmax over the expert axis. gates: (..., E) ->
    (idx (..., k) int64, topg (..., k) the chosen gates)."""
    idxs, topgs = [], []
    masked = gates
    for _ in range(k):
        idx = torch.argmax(masked, dim=-1, keepdim=True)
        idxs.append(idx)
        topgs.append(torch.gather(gates, -1, idx))
        # additive exclusion: a multiplicative 0 could choose the same
        # expert again where every other gate underflows to 0
        masked = masked.scatter(-1, idx, float("-inf"))
    return torch.cat(idxs, dim=-1), torch.cat(topgs, dim=-1)


class Routing(NamedTuple):
    """One forward's routing: fp32 `logits` and `gates` (B, S, E); the
    chosen experts `idx` and renormalised gates `topg` (B, S, k); and per
    (choice, token) slot, choice-major (B, k * S): its expert `choice`, its
    place `pos` in that expert's buffer and whether it is kept (`keep`,
    pos < capacity)."""

    logits: torch.Tensor
    gates: torch.Tensor
    idx: torch.Tensor
    topg: torch.Tensor
    choice: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    capacity: int


class MoeMlp(nn.Module):
    """Top-k routed expert MLP (see the module docstring)."""

    def __init__(self, dim, num_experts, hidden_features, top_k=2, capacity_factor=1.25,
                 dtype=torch.float32):
        super().__init__()
        self.num_experts = num_experts
        self.top_k = min(top_k, num_experts)
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        E, H = num_experts, hidden_features
        self.router = nn.Linear(dim, E, bias=False)
        self.wi = nn.Parameter(torch.zeros(E, dim, H))
        self.bi = nn.Parameter(torch.zeros(E, H))
        self.wo = nn.Parameter(torch.zeros(E, H, dim))
        self.bo = nn.Parameter(torch.zeros(E, dim))

    def init_weights(self, g: torch.Generator) -> None:
        """JAX's init: xavier-uniform router, each expert's (D, H) and (H, D)
        xavier-uniform on its own fans, zero biases."""
        with torch.no_grad():
            for w in (self.router.weight, self.wi, self.wo):
                fan_in, fan_out = (w.shape[1], w.shape[0]) if w.dim() == 2 else w.shape[1:]
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                w.uniform_(-bound, bound, generator=g)
            self.bi.zero_()
            self.bo.zero_()

    def route(self, x: torch.Tensor) -> Routing:
        B, S, _ = x.shape
        E, k = self.num_experts, self.top_k
        logits = F.linear(x.float(), self.router.weight.float())  # (B, S, E), fp32
        gates = torch.softmax(logits, dim=-1)
        idx, topg = top_k_gates(gates, k)                          # (B, S, k)
        topg = topg / torch.clamp(topg.sum(dim=-1, keepdim=True), min=1e-9)
        # place of each (choice, token) slot in its expert's buffer, choice-major:
        # first choices claim capacity before second choices
        choice = idx.transpose(1, 2).reshape(B, k * S)
        onehot = (choice[..., None] == torch.arange(E, device=x.device)).to(torch.int32)
        pos = torch.gather(onehot.cumsum(dim=1), 2, choice[..., None])[..., 0] - 1
        C = expert_capacity(S, E, k, self.capacity_factor)
        return Routing(logits, gates, idx, topg, choice, pos, pos < C, C)

    def forward(self, x: torch.Tensor):
        B, S, D = x.shape
        E, k = self.num_experts, self.top_k
        dt = self.dtype
        logits, gates, idx, topg, choice, pos, keep, C = self.route(x)
        # buffer row (e, b, c) of each kept slot; a dropped slot points at
        # the extra last row, which is never read
        rows = E * B * C
        b_idx = torch.arange(B, device=x.device)[:, None]
        dest = torch.where(keep, (choice * B + b_idx) * C + pos, rows)   # (B, kS)
        token = b_idx * S + torch.arange(k * S, device=x.device) % S     # source token
        src = torch.full((rows + 1,), B * S, dtype=torch.long, device=x.device)
        src.scatter_(0, dest.reshape(-1), token.reshape(-1))
        x_rows = torch.cat([x.reshape(B * S, D), x.new_zeros(1, D)])  # last: a zero row
        xe = x_rows.index_select(0, src[:rows]).reshape(E, B * C, D)

        h = torch.baddbmm(self.bi.to(dt)[:, None, :], xe.to(dt), self.wi.to(dt))
        h = F.gelu(h, approximate="tanh")
        ye = torch.baddbmm(self.bo.to(dt)[:, None, :], h, self.wo.to(dt))
        ye = torch.cat([ye.reshape(rows, D), ye.new_zeros(1, D)])
        # combine: each choice's expert output, weighted by its gate
        w = torch.where(keep, topg.transpose(1, 2).reshape(B, k * S), 0.0).to(dt)
        yk = ye.index_select(0, dest.reshape(-1)).reshape(B, k, S, D)
        y = (w.reshape(B, k, S, 1) * yk).sum(dim=1).to(x.dtype)

        # aux values: f_e from the top-1 choice, p_e the mean gate
        f = (idx[..., 0:1] == torch.arange(E, device=x.device)).float().mean(dim=(0, 1))
        p = gates.mean(dim=(0, 1))
        z = torch.logsumexp(logits, dim=-1)
        dropped = 1.0 - keep.float().sum() / (B * S * k)
        aux = torch.stack([E * (f * p).sum(), (z * z).mean(), dropped])
        return y, aux
