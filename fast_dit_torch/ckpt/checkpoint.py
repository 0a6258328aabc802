"""Trainer checkpoints: save, restore, the latest step and retention
(counterpart of `fast_dit_tpu/ckpt/orbax_io.py:21-68`).

One `torch.save` file per step, `{directory}/{step:07d}.pt`, written to a
temporary name and renamed, so a preempted save leaves no torn file. The
file keeps the reference trainer's layout {"model", "ema", "opt", "args"}
(fp32 weights under the reference torch names, the master where there is
one; the EMA as a full state dict) and adds what a resumed run needs:

- "step": the train state's step;
- "sampler": the loss-second-moment ring buffer and counts, or None for
  uniform t (JAX keeps it inside its TrainState);
- "rng": the state of the generator the train step draws from. JAX's step
  draws from a key folded with the step (`train.py:163`); the port draws
  from one stream, so a resume without it would draw other label drops, t
  and noise.

"opt" names its route and keeps every tensor of it: AdamW's state dict, or
the masterized one's master and inner state dict, or the fused state's
count, mu, master and nu (fp32 or bf16 tensors, and each factored JAX
leaf's row and col under its flax path). `restore` loads a file into a
train state built the same way, in place, and raises if the file holds
another route or another kind of nu.

On a mesh (the model sharded by `parallel.mesh.shard_params`) the file is
the same: full tensors, whatever the world size. `save` must then be called
on every rank: each tensor of the state is gathered from the ranks' parts
one at a time (`Sharding.gather_full`), rank 0 copies it to the host and
alone writes the file, so the whole tree is never gathered on a card.
`restore` reads the file on every rank and keeps each rank's part, so a
file written by any world resumes in any other. The generator and the
loss-second-moment buffers are equal on every rank (each draws the global
batch's draws), so rank 0's are the global ones.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from ..diffusion.timestep_samplers import LossSecondMomentState
from ..ops.fused_update import FactoredNu, FusedAdamWEmaState, nu_kind
from ..train.mixed_precision import MasterWeightsOptimizer, get_master_params

__all__ = ["CheckpointManager", "checkpoint_tree", "load_into"]

_NAME = re.compile(r"^(\d+)\.pt$")


def _route(opt) -> str:
    if isinstance(opt, FusedAdamWEmaState):
        return f"fused/{nu_kind(opt)}"
    if isinstance(opt, MasterWeightsOptimizer):
        return "master"
    return "adamw"


def _opt_tree(opt) -> dict:
    tree = {"route": _route(opt)}
    if isinstance(opt, FusedAdamWEmaState):
        tree.update(count=opt.count, mu=opt.mu, master=opt.master,
                    nu=[None if isinstance(v, FactoredNu) else v for v in opt.nu],
                    factored={v.leaf.path: {"row": v.row, "col": v.col}
                              for v in opt.nu if isinstance(v, FactoredNu)})
    elif isinstance(opt, MasterWeightsOptimizer):
        tree.update(master=opt.master, inner=opt.inner.state_dict())
    else:
        tree.update(state_dict=opt.state_dict())
    return tree


def _map_tree(tree: dict, names: List[str], param: Callable, factored: Callable) -> dict:
    """`tree` (`checkpoint_tree`'s layout) with `param(i, t)` applied to every
    tensor shaped like parameter i and `factored(leaf path, which, t)` to
    every factored row and col, in one fixed order on every rank."""
    index = {n: i for i, n in enumerate(names)}
    out = dict(tree)
    out["model"] = {k: param(index[k], v) if k in index else v for k, v in tree["model"].items()}
    out["ema"] = {k: param(index[k], v) if k in index else v for k, v in tree["ema"].items()}
    opt = dict(tree["opt"])
    for key in ("mu", "master", "nu"):
        if key in opt:
            opt[key] = [None if v is None else param(i, v) for i, v in enumerate(opt[key])]
    if "factored" in opt:
        opt["factored"] = {path: {w: factored(path, w, v[w]) for w in ("row", "col")}
                           for path, v in opt["factored"].items()}
    for key in ("state_dict", "inner"):
        if key in opt:
            sd = dict(opt[key])
            sd["state"] = {i: {k: param(i, v) if torch.is_tensor(v) and v.dim() else v
                               for k, v in st.items()} for i, st in sd["state"].items()}
            opt[key] = sd
    out["opt"] = opt
    return out


def _gathered(tree: dict, state) -> Optional[dict]:
    """The full tree on rank 0 (host tensors), None on the other ranks."""
    sharding = state.model.sharding
    leaves = {leaf.path: leaf for leaf in sharding.leaves}
    keep = sharding.mesh.rank == 0

    def param(i, t):
        t = sharding.gather_full(i, t)
        return t.cpu() if keep else None

    def factored(path, which, t):
        t = sharding.factored_full(leaves[path], t, which)
        return t.cpu() if keep else None

    names = [n for n, _ in state.model.named_parameters()]
    full = _map_tree(tree, names, param, factored)
    return full if keep else None


def _localized(tree: dict, state) -> dict:
    """A full tree cut to this rank's parts."""
    sharding = state.model.sharding
    leaves = {leaf.path: leaf for leaf in sharding.leaves}
    names = [n for n, _ in state.model.named_parameters()]
    return _map_tree(tree, names, sharding.local,
                     lambda path, which, t: sharding.factored_local(leaves[path], t, which))


def _sharded(state) -> bool:
    sharding = getattr(state.model, "sharding", None)
    return sharding is not None and sharding.mesh.size > 1


def checkpoint_tree(state, args=None) -> dict:
    """The file's contents for a train state (`train.train_lib.TrainState`);
    on a mesh, gathered: the tree on rank 0, None on the others."""
    model_sd = {k: v.detach().float() for k, v in state.model.state_dict().items()}
    ema_sd = {**model_sd, **state.ema}  # the frozen buffers, then the EMA weights
    master = get_master_params(state.opt)
    if master is not None:
        names = [n for n, _ in state.model.named_parameters()]
        model_sd.update(dict(zip(names, master)))
    sampler = state.sampler_state
    tree = {"model": model_sd, "ema": ema_sd, "opt": _opt_tree(state.opt),
            "args": args, "step": state.step,
            "sampler": (None if not isinstance(sampler, LossSecondMomentState) else
                        {"loss_history": sampler.loss_history,
                         "loss_counts": sampler.loss_counts}),
            "rng": None if state.generator is None else state.generator.get_state()}
    return _gathered(tree, state) if _sharded(state) else tree


@torch.no_grad()
def _copy_list(dst: List[torch.Tensor], src: List[torch.Tensor], what: str) -> None:
    if len(dst) != len(src):
        raise ValueError(f"checkpoint {what} holds {len(src)} tensors, the state {len(dst)}")
    for d, s in zip(dst, src):
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"checkpoint {what}: {tuple(s.shape)} {s.dtype} does not fit "
                             f"{tuple(d.shape)} {d.dtype}")
        d.copy_(s)


@torch.no_grad()
def load_into(state, tree: dict) -> None:
    """Restore `tree` (`checkpoint_tree`'s layout, full tensors) into
    `state`, in place: weights, EMA, optimizer, step, timestep-sampler state
    and generator; on a mesh, each rank's part."""
    if _sharded(state):
        tree = _localized(tree, state)
    opt, saved = state.opt, tree["opt"]
    if saved["route"] != _route(opt):
        raise ValueError(f"the checkpoint holds the {saved['route']!r} optimizer state; this "
                         f"run builds {_route(opt)!r} (the flags --mixed-precision, "
                         f"--fused-optimizer, --nu-dtype and --factored-nu must match)")
    sampler = state.sampler_state
    if (tree["sampler"] is None) != (not isinstance(sampler, LossSecondMomentState)):
        raise ValueError("the checkpoint and this run disagree on --schedule-sampler")
    state.model.load_state_dict(tree["model"], strict=True)
    for name, e in state.ema.items():
        e.copy_(tree["ema"][name])
    if isinstance(opt, FusedAdamWEmaState):
        opt.count = int(saved["count"])
        _copy_list(opt.mu, saved["mu"], "mu")
        _copy_list(opt.master, saved["master"], "master")
        _copy_list([v for v in opt.nu if not isinstance(v, FactoredNu)],
                   [v for v in saved["nu"] if v is not None], "nu")
        factored = {v.leaf.path: v for v in opt.nu if isinstance(v, FactoredNu)}
        if set(factored) != set(saved["factored"]):
            raise ValueError("the checkpoint factors other leaves than this run")
        for path, v in factored.items():
            _copy_list([v.row, v.col], [saved["factored"][path]["row"],
                                        saved["factored"][path]["col"]], f"nu {path}")
    elif isinstance(opt, MasterWeightsOptimizer):
        _copy_list(opt.master, saved["master"], "master")
        opt.inner.load_state_dict(saved["inner"])
    else:
        opt.load_state_dict(saved["state_dict"])
    state.step = int(tree["step"])
    if tree["sampler"] is not None:
        state.sampler_state = dataclasses.replace(
            sampler, loss_history=tree["sampler"]["loss_history"].to(sampler.device),
            loss_counts=tree["sampler"]["loss_counts"].to(sampler.device))
    if tree["rng"] is not None and state.generator is not None:
        state.generator.set_state(tree["rng"])


class CheckpointManager:
    """Step-numbered checkpoint files in one directory, the oldest dropped
    beyond `max_to_keep` (None keeps every one, as the JAX trainer does)."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self.directory = directory
        self.max_to_keep = max_to_keep
        if not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0:
            os.makedirs(directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step:07d}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, args=None) -> str:
        """Write `state` at `step`; returns the file's path. On a mesh every
        rank calls it and rank 0 writes."""
        path = self.path(step)
        tree = checkpoint_tree(state, args)
        if tree is None:
            return path
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save(tree, tmp)
        os.replace(tmp, path)
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self.path(old))
        return path

    def restore(self, state, step: Optional[int] = None) -> int:
        """Load `step` (default the latest) into `state`; returns the step."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        # the file is this trainer's own: its pickled args are allowed
        load_into(state, torch.load(self.path(step), map_location="cpu", weights_only=False))
        return step
