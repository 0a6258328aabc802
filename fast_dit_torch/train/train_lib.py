"""Training step: loss, gradients, AdamW and EMA (counterpart of
`fast_dit_tpu/train/train_lib.py:42-287`).

The step draws timesteps, the noise and the label drops, computes the
per-example loss, takes its (weighted) mean and backpropagates; with
`grad_accum > 1` the batch is split into microbatches and their gradients
averaged (`:244-265`). The objective is "eps" (the learned-sigma hybrid
loss, `training_losses`, discrete t) or "flow" (velocity matching,
`flow_training_losses`, t ~ U[0, 1) with unit weights; the model must have
`learn_sigma=False`). With a `LossSecondMomentState` in the train state, eps
draws (t, importance weights) from it and folds each microbatch's
per-example losses back into it, microbatch after microbatch. Then one of
three optimizer routes updates the model's parameters in place:

- default: `torch.optim.AdamW` over fp32 parameters (optax.adamw in JAX,
  the same formula with weight decay 0), then `update_ema`;
- `mixed_precision`: bf16 parameters with an fp32 master stepped by AdamW
  (`mixed_precision.masterize`); the EMA tracks the master;
- `fused_optimizer`: bf16 parameters, bf16 mu, fp32 nu, master and EMA,
  all updated by the fused AdamW + EMA kernel (`ops/fused_update.py`);
  `nu_dtype=torch.bfloat16` stores nu in bf16 (the kernel's bf16-nu
  instantiation), `factored_nu` factors it per JAX leaf (`FactoredNu`).

JAX threads an immutable state through a jitted step; here the state is
updated in place and the step returns only its metrics (0-d tensors on the
device, so nothing waits for the card). Random draws come from one
`torch.Generator` on the model's device: t (and the weights), then the
noise, then the label drops, per microbatch; `draws=` injects them instead
(for the tests).

`model_call(x_t, t_model, batch_mb, force_drop_ids, generator)` overrides
how the model is applied (JAX's `model_call`, `train_lib.py:128,147-153,
181`): it gets the microbatch's dict of every batch key, the label drops
the step drew (None where the model draws them itself from `generator`),
and returns the model output. For `nvs.DiTNVS`:

    lambda x_t, t, b, force, g: model(x_t, t, b["dino_feat"], b["y"], train=True,
                                      force_drop_ids=force, generator=g)

Every batch key is split into microbatches with "x" (and under a mesh each
key is the rank's rows of the global batch, as JAX shards every batch key
on its leading dimension, `:349-351`). A parameter that gets no gradient
(a DiTNVS layer outside `cross_layers` never runs its cross-attention)
gets zeros, as JAX's gradient of a branch multiplied by 0 is, so every
optimizer route steps it, weight decay included.

A MoE model (`models/moe.py`) returns its per-layer aux values from the
same forward (`want_aux=True`); per microbatch, their means over the layers
join the loss as `moe_aux_weight * load_balance + moe_z_weight * router_z`
(`train_lib.py:159-212`), and the metrics carry `moe_load_balance`,
`moe_router_z` and `moe_dropped_frac` (telemetry, never in the loss). The
step refuses quantised and token-merged models: both are inference-only.

`make_sharded_train_step` (counterpart of `make_sharded_train_step`,
`train_lib.py:290-368`) runs the same step on a mesh of ranks
(`parallel/mesh.py`), on a model whose parameters `shard_params` has made
local. The rank is handed its data index's rows of the global batch (the
ranks' local batches, concatenated in data-rank order). Every rank draws t
(and the weights), the noise and the label drops of the global microbatch
from its generator, seeded alike, and keeps its rows, so a world of n
equals one process on the global batch; the loss-second-moment state folds
in the global batch's (t, loss) pairs, its losses all-gathered in global
order, and stays equal on every rank. With `grad_accum > 1` the global batch
is all-gathered first and split into contiguous global microbatches, as
JAX reshapes its global array. After the microbatches the gradients are
averaged over the data group once, before any optimizer route: the
replicated ones all-reduced (one flat buffer per dtype), the FSDP shards,
already summed by their gathers' reduce-scatter, divided. Metrics are
means over the data group, the gradient norm the global one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn

from ..ckpt.convert import jax_leaves
from ..diffusion.flow import flow_training_losses
from ..diffusion.gaussian import training_losses
from ..diffusion.timestep_samplers import sample_timesteps, update_with_losses
from ..ops.fused_update import (FusedAdamWEmaState, fused_adamw_ema_apply,
                                fused_adamw_ema_init)
from ..parallel.collectives import all_gather, all_reduce
from .mixed_precision import get_master_params, masterize

__all__ = ["TrainState", "create_train_state", "update_ema", "make_train_step",
           "make_sharded_train_step", "ema_state_dict"]


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module                 # holds the parameters (fp32, or bf16)
    ema: Dict[str, torch.Tensor]     # fp32, by parameter name
    opt: Any                         # AdamW, MasterWeightsOptimizer or FusedAdamWEmaState
    sampler_state: Any = None        # LossSecondMomentState, or None for uniform t
    # the generator the step draws from, kept so that a checkpoint holds its
    # state (None where the caller injects the draws)
    generator: Optional[torch.Generator] = None

    def params(self) -> List[torch.Tensor]:
        return list(self.model.parameters())


@torch.no_grad()
def update_ema(ema: List[torch.Tensor], params: List[torch.Tensor], decay: float = 0.9999):
    """ema <- decay * ema + (1 - decay) * params, in place."""
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, [p.float() for p in params], alpha=1.0 - decay)


def _adamw(params, lr, weight_decay):
    # optax.adamw's defaults; torch's own weight_decay default (0.01) is not
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def create_train_state(model: nn.Module, *, lr: Optional[float] = None,
                       weight_decay: Optional[float] = None, mixed_precision: bool = False,
                       fused_optimizer: bool = False, nu_dtype: Optional[torch.dtype] = None,
                       factored_nu: bool = False, sampler_state=None,
                       generator: Optional[torch.Generator] = None) -> TrainState:
    """Optimizer state and a warm-started EMA (an exact copy) for `model`.

    With `mixed_precision` or `fused_optimizer` the model's parameters are
    cast to bf16 in place first, so the fp32 master starts from the bf16
    values, as in JAX (`train_lib.py:81-117`). The AdamW routes take `lr`
    (default 1e-4) and `weight_decay` (default 0) here and keep fp32
    moments; the fused route (bf16 mu) takes them from `make_train_step`
    and refuses them here, so that the two cannot disagree. `nu_dtype` and
    `factored_nu` shrink the fused route's second moment and are refused on
    the others (`train_lib.py:101-104`). `sampler_state` is the timestep
    sampler's state (None: uniform t); `generator` the one the step draws
    from, which the state carries into checkpoints."""
    if fused_optimizer and (lr is not None or weight_decay is not None):
        raise ValueError("fused_optimizer=True takes lr and weight_decay from "
                         "make_train_step(lr=..., weight_decay=...), not from here")
    if not fused_optimizer and (nu_dtype is not None or factored_nu):
        raise ValueError("nu_dtype/factored_nu are fused-optimizer features "
                         "(ops/fused_update.py); pass fused_optimizer=True")
    lr = 1e-4 if lr is None else lr
    weight_decay = 0.0 if weight_decay is None else weight_decay
    if fused_optimizer or mixed_precision:
        with torch.no_grad():
            for p in model.parameters():
                p.data = p.data.to(torch.bfloat16)
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    if fused_optimizer:
        sharding = getattr(model, "sharding", None)
        opt = fused_adamw_ema_init(params, mu_dtype=torch.bfloat16,
                                   nu_dtype=nu_dtype or torch.float32, factored=factored_nu,
                                   leaves=(sharding.leaves if sharding is not None else
                                           jax_leaves(model)) if factored_nu else None,
                                   sharding=sharding)
    elif mixed_precision:
        opt = masterize(params, lambda master: _adamw(master, lr, weight_decay))
    else:
        opt = _adamw(params, lr, weight_decay)
    source = get_master_params(opt) or params
    ema = {n: p.detach().float().clone() for n, p in zip(names, source)}
    return TrainState(step=0, model=model, ema=ema, opt=opt, sampler_state=sampler_state,
                      generator=generator)


def ema_state_dict(state: TrainState) -> Dict[str, torch.Tensor]:
    """The EMA as a full state dict of the model (frozen buffers included),
    loadable with `load_state_dict(strict=True)`."""
    sd = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    sd.update({k: v.detach().clone() for k, v in state.ema.items()})
    return sd


def make_train_step(model: nn.Module, schedule, *, ema_decay: float = 0.9999,
                    grad_accum: int = 1, log_grad_norm: bool = False, lr: float = 1e-4,
                    weight_decay: float = 0.0, objective: str = "eps",
                    flow_path: str = "linear", generator: Optional[torch.Generator] = None,
                    moe_aux_weight: float = 1e-2, moe_z_weight: float = 1e-3, mesh=None,
                    model_call: Optional[Callable] = None):
    """Build `train_step(state, batch, draws=None) -> metrics`.

    batch: {"x": (B, C, H, W) fp32 latents, "y": (B,) int64 labels, ...any
    extra conditioning with B rows} on the model's device. `model_call`:
    see the module docstring. `draws`, if given, is a list of `grad_accum` dicts
    {"t" (int timesteps, or fp32 times in [0, 1) for flow), "noise", and
    optionally "weights" and "force_drop_ids"} used instead of the
    generator. `lr` and `weight_decay` serve the fused route; the AdamW
    routes take them from `create_train_state`. `moe_aux_weight` and
    `moe_z_weight` weigh a MoE model's load-balance and router z-losses.
    `mesh`: see `make_sharded_train_step` (the batch is then the rank's
    rows, and `draws` hold the global microbatches' draws).
    """
    if objective not in ("eps", "flow"):
        raise ValueError(f"unknown objective {objective!r}")
    if getattr(model, "quant", None):
        raise ValueError("int8 quantization is inference-only")
    if getattr(model, "tome_ratio", 0) > 0:
        raise ValueError("token merging is inference-only")
    is_moe = getattr(model, "moe_experts", 0) > 0
    if is_moe and model_call is not None:
        raise ValueError(
            "custom model_call with a MoE model would silently drop the routing aux losses "
            "(the default model call alone collects them) - the router could collapse. "
            "Extend the default model call instead.")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    data = mesh.data if mesh is not None else 1
    drank = mesh.data_rank if mesh is not None else 0
    dgroup = mesh.data_group if mesh is not None else None
    drop_prob = model.y_embedder.dropout_prob

    def micro_step(batch_mb, draw, sampler_state):
        x, y = batch_mb["x"], batch_mb["y"]
        B = x.shape[0]          # this rank's rows
        n = B * data            # the global microbatch's
        weights = None
        force = None
        if draw is None:
            if objective == "flow":
                t = torch.rand((n,), generator=generator, device=x.device)
            elif sampler_state is not None:
                t, weights = sample_timesteps(sampler_state, generator, n)
            else:
                t = torch.randint(0, schedule.num_timesteps, (n,), generator=generator,
                                  device=x.device)
            noise = torch.randn((n, *x.shape[1:]), generator=generator, dtype=x.dtype,
                                device=x.device)
            if mesh is not None and drop_prob > 0:
                # the draw the label embedder makes, for the global microbatch
                force = (torch.rand((n,), generator=generator, device=x.device)
                         < drop_prob).long()
        else:
            t, noise, force = draw["t"], draw["noise"], draw.get("force_drop_ids")
            weights = draw.get("weights")
        t_all = t
        if mesh is not None:  # this rank's rows of the global draws
            rows = slice(drank * B, (drank + 1) * B)
            t, noise = t[rows], noise[rows]
            weights = None if weights is None else weights[rows]
            force = None if force is None else force[rows]

        auxes = []  # the aux values of the loss's one model call, with their graph

        def model_fn(x_t, t_model):
            if model_call is not None:
                return model_call(x_t, t_model, batch_mb, force, generator)
            if not is_moe:
                return model(x_t, t_model, y, train=True, force_drop_ids=force,
                             generator=generator)
            out, aux = model(x_t, t_model, y, train=True, force_drop_ids=force,
                             generator=generator, want_aux=True)
            auxes.append(aux)
            return out

        if objective == "flow":
            terms = flow_training_losses(model_fn, x, t, noise, path=flow_path)
        else:
            terms = training_losses(schedule, model_fn, x, t, noise)
        per_example = terms["loss"]
        # unit weights (uniform t, flow) leave the mean as it is
        loss = per_example.mean() if weights is None else (weights * per_example).mean()
        metrics = {k: v.detach().mean() for k, v in terms.items()}
        if is_moe:
            (aux,) = auxes
            lb, zl = aux["load_balance"].mean(), aux["router_z"].mean()
            loss = loss + moe_aux_weight * lb + moe_z_weight * zl
            metrics["moe_load_balance"] = lb.detach()
            metrics["moe_router_z"] = zl.detach()
            metrics["moe_dropped_frac"] = aux["dropped_frac"].detach().mean()
        loss.backward()
        if sampler_state is not None:
            # the global batch's (t, loss) pairs in global order
            sampler_state = update_with_losses(sampler_state, t_all,
                                               all_gather(per_example.detach(), dgroup))
        return metrics, sampler_state

    def train_step(state: TrainState, batch, draws=None) -> Dict[str, torch.Tensor]:
        params = state.params()
        for p in params:
            p.grad = None
        B = batch["x"].shape[0]
        short = [k for k, v in batch.items() if v.shape[0] != B]
        if short:
            raise ValueError(f"batch keys {short} do not have the {B} rows of 'x'")
        if B % grad_accum:
            raise ValueError(f"batch {B} is not divisible by grad_accum {grad_accum}")
        mb = B // grad_accum
        if draws is not None and len(draws) != grad_accum:
            raise ValueError(f"draws holds {len(draws)} microbatches, expected {grad_accum}")
        if objective == "flow" and state.sampler_state is not None:
            raise ValueError("the loss-second-moment sampler draws discrete timesteps; flow "
                             "matching draws continuous t")
        start, step = 0, mb
        if grad_accum > 1 and data > 1:
            # contiguous global microbatches, as JAX reshapes the global batch
            batch = {k: all_gather(v, dgroup) for k, v in batch.items()}
            start, step = drank * mb, mb * data
        per_micro = []
        for i in range(grad_accum):
            # each microbatch sees the sampler state the previous one updated
            rows = slice(start + i * step, start + i * step + mb)
            m, state.sampler_state = micro_step({k: v[rows] for k, v in batch.items()},
                                                None if draws is None else draws[i],
                                                state.sampler_state)
            per_micro.append(m)
        for p in params:
            if p.grad is None:  # a branch this model did not run
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if grad_accum > 1:
            torch._foreach_div_(grads, float(grad_accum))
        metrics = {k: torch.stack([m[k] for m in per_micro]).mean() for k in per_micro[0]}
        if mesh is not None and data > 1:
            _average_over_data(grads, model.sharding, dgroup, data)
            names = list(metrics)
            means = all_reduce(torch.stack([metrics[k] for k in names]), dgroup) / data
            metrics = dict(zip(names, means.unbind()))

        ema = list(state.ema.values())
        if isinstance(state.opt, FusedAdamWEmaState):
            fused_adamw_ema_apply(state.opt, grads, [p.data for p in params], ema,
                                  lr=lr, weight_decay=weight_decay, ema_decay=ema_decay)
        else:
            state.opt.step()
            update_ema(ema, get_master_params(state.opt) or params, ema_decay)
        if log_grad_norm:  # telemetry only: touches every gradient
            norms = torch._foreach_norm([g.float() for g in grads])
            if mesh is None or mesh.size == 1:
                metrics["grad_norm"] = torch.linalg.vector_norm(torch.stack(norms))
            else:
                metrics["grad_norm"] = _global_norm(norms, model.sharding)
        state.step += 1
        return metrics

    return train_step


@torch.no_grad()
def _average_over_data(grads: List[torch.Tensor], sharding, group, data: int) -> None:
    """The data group's mean of each gradient, in place: the replicated
    ones all-reduced as one flat buffer per dtype, the FSDP shards (summed
    by their gathers' backward already) divided."""
    flat: Dict[torch.dtype, List[torch.Tensor]] = {}
    for s, g in zip(sharding.shards, grads):
        if not s.data_sharded:
            flat.setdefault(g.dtype, []).append(g)
    for gs in flat.values():
        buf = all_reduce(torch.cat([g.reshape(-1) for g in gs]), group)
        torch._foreach_copy_(gs, [b.view_as(g) for b, g in
                                  zip(buf.split([g.numel() for g in gs]), gs)])
    torch._foreach_div_(grads, float(data))


def _global_norm(norms: List[torch.Tensor], sharding) -> torch.Tensor:
    """The norm of the whole gradient from the ranks' local norms: each
    square summed over the world, divided by the number of ranks that hold
    the same values."""
    mesh = sharding.mesh
    sq = torch.stack([n * n / ((1 if s.inner_sharded else mesh.inner_size)
                               * (1 if s.data_sharded else mesh.data))
                      for n, s in zip(norms, sharding.shards)]).sum()
    return torch.sqrt(all_reduce(sq, mesh.world_group))


def make_sharded_train_step(model: nn.Module, schedule, mesh, **kw):
    """`make_train_step` on `mesh` for a model that `parallel.mesh.shard_params`
    has sharded on it (see the module docstring). The batch is the rank's
    rows; `draws` hold the global microbatches'. A mesh of one rank is the
    plain step with the label drops drawn beside t and the noise."""
    if getattr(model, "sharding", None) is None or model.sharding.mesh is not mesh:
        raise ValueError("shard the model on this mesh first (parallel.mesh.shard_params)")
    return make_train_step(model, schedule, mesh=mesh, **kw)
