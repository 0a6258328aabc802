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

Expert parallelism (`parallel/mesh.py shard_params` sets `ep_group` and
`expert_offset`): a rank holds the experts [offset, offset + E/m) of `wi`,
`bi`, `wo` and `bo`. The batch is replicated over the group, so every rank
routes the same tokens and keeps the same slots; each computes its own
experts' buffers, and the combine is a sum over the group: the input of the
dispatch and the combine weights pass `copy_to_group` (their gradients are
summed over the group, so the router's comes out whole and equal on every
rank) and the combined output `reduce_from_group`. With the tokens
replicated no all-to-all is needed. Under data parallelism (`data_group`)
the aux values are JAX's global ones: f and p are means over the global
batch, so each is averaged over the data group before their product (the
mean of per-rank products is another number), and so are the z-loss and
the dropped share (`collectives.mean_over_group`). The capacity is per
batch row and stays local.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import copy_to_group, full, mean_over_group, reduce_from_group

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
        self.ep_group = None      # the expert group, under expert parallelism
        self.expert_offset = 0    # the first of this rank's experts
        self.data_group = None    # the data group, for the global aux values
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
        logits = F.linear(x.float(), full(self.router.weight).float())  # (B, S, E), fp32
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
        wi, bi, wo, bo = (full(t) for t in (self.wi, self.bi, self.wo, self.bo))
        El, e0, group = wi.shape[0], self.expert_offset, self.ep_group  # this rank's experts
        # buffer row (e, b, c) of each kept slot of this rank's experts; any
        # other slot points at the extra last row, which is never read
        rows = El * B * C
        mine = keep & (choice >= e0) & (choice < e0 + El)
        b_idx = torch.arange(B, device=x.device)[:, None]
        dest = torch.where(mine, ((choice - e0) * B + b_idx) * C + pos, rows)   # (B, kS)
        token = b_idx * S + torch.arange(k * S, device=x.device) % S     # source token
        src = torch.full((rows + 1,), B * S, dtype=torch.long, device=x.device)
        src.scatter_(0, dest.reshape(-1), token.reshape(-1))
        xd = copy_to_group(x, group)
        x_rows = torch.cat([xd.reshape(B * S, D), xd.new_zeros(1, D)])  # last: a zero row
        xe = x_rows.index_select(0, src[:rows]).reshape(El, B * C, D)

        h = torch.baddbmm(bi.to(dt)[:, None, :], xe.to(dt), wi.to(dt))
        h = F.gelu(h, approximate="tanh")
        ye = torch.baddbmm(bo.to(dt)[:, None, :], h, wo.to(dt))
        ye = torch.cat([ye.reshape(rows, D), ye.new_zeros(1, D)])
        # combine: each choice's expert output, weighted by its gate (another
        # rank's slot reads the zero row)
        w = torch.where(keep, topg.transpose(1, 2).reshape(B, k * S), 0.0).to(dt)
        w = copy_to_group(w, group)
        yk = ye.index_select(0, dest.reshape(-1)).reshape(B, k, S, D)
        y = reduce_from_group((w.reshape(B, k, S, 1) * yk).sum(dim=1), group).to(x.dtype)

        # aux values over the global batch: f_e from the top-1 choice, p_e
        # the mean gate
        f = (idx[..., 0:1] == torch.arange(E, device=x.device)).float().mean(dim=(0, 1))
        p = gates.mean(dim=(0, 1))
        z = torch.logsumexp(logits, dim=-1)
        dropped = 1.0 - keep.float().sum() / (B * S * k)
        # one collective for the four: f, p, the z-loss and the dropped share
        stats = mean_over_group(torch.cat([f, p, (z * z).mean()[None], dropped[None]]),
                                self.data_group)
        f, p = stats[:E], stats[E:2 * E]
        return y, torch.stack([E * (f * p).sum(), stats[2 * E], stats[2 * E + 1]])
