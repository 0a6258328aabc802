"""Meshes of ranks, the DiT sharding rules and the placement of a model's
parameters on a mesh (counterpart of `fast_dit_tpu/parallel/mesh.py`).

A mesh is the world's ranks on two axes, ('data', 'model') for tensor
parallelism or ('data', 'expert') for expert parallelism, the inner axis
innermost: rank r sits at data index r // m and inner index r % m, so
consecutive ranks share an inner group (`:63-64`). `create_mesh` and
`create_expert_mesh` make one process group per data column and per inner
row (none for a group of one rank) and refuse the sizes JAX refuses.

`dit_param_spec` is JAX's rule (`:107-128`), on JAX's leaf paths and stacked
shapes (`ckpt.convert.jax_leaves`): TP column/row pairs on qkv, proj, fc1
and fc2; the expert axis of the routed MLP over 'expert', or over 'model'
under `--tp`; with FSDP the largest free axis the data size divides.

`param_shardings` applies a spec to the port's tensors. Each port tensor is
one member of a JAX leaf (a block's slice of a stacked leaf); its local
part is the slice of its flax layout (`JaxLeaf.to_jax`) that the spec gives
this rank, mapped back to the port's layout. A TP qkv weight, whose heads
are split, so holds the (3, H/m, hd) rows of its rank, the packed layout of
H/m heads. A spec on the layer axis (FSDP on a stacked leaf whose depth is
its largest free axis) maps to whole blocks: data rank i holds blocks
[i L/n, (i + 1) L/n) of the leaf whole and an empty tensor for the others,
and a block's tensor is broadcast from its holder where it is used.
`shard_params` slices the parameters in place (the same `nn.Parameter`
objects), marks each FSDP shard with the gather that rebuilds it
(`collectives.full`) and tells the attention, MLP and MoE modules their
groups and local heads or experts. The batch is sharded over 'data' only
(`batch_rows`) and replicated across the inner axis (`:141-145`).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .collectives import all_gather, broadcast_owned, gather_shard

__all__ = ["Mesh", "create_mesh", "create_expert_mesh", "dit_param_spec", "ParamShard",
           "Sharding", "param_shardings", "shard_params", "batch_rows"]


@dataclasses.dataclass
class Mesh:
    """The world's ranks on ('data', inner) axes; `inner` is "model" or
    "expert". The groups are None where a group has one rank."""

    data: int
    inner_size: int
    inner: str = "model"
    rank: int = 0
    data_group: Any = None      # the ranks of this rank's inner index
    inner_group: Any = None     # the ranks of this rank's data index
    world_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, self.inner: self.inner_size}

    @property
    def size(self) -> int:
        return self.data * self.inner_size

    @property
    def data_rank(self) -> int:
        return self.rank // self.inner_size

    @property
    def inner_rank(self) -> int:
        return self.rank % self.inner_size

    def group(self, axis: str):
        return self.data_group if axis == "data" else self.inner_group

    def axis_rank(self, axis: str) -> int:
        return self.data_rank if axis == "data" else self.inner_rank


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _make(inner: str, data: int, inner_size: int, world: Optional[int]) -> Mesh:
    n, rank = _world()
    groups = world is None and n > 1
    n = n if world is None else world
    if data * inner_size != n:
        raise ValueError(f"mesh data={data} x {inner}={inner_size} uses {data * inner_size} "
                         f"of {n} ranks; launch {data * inner_size} ranks to use a mesh of "
                         f"that size")
    mesh = Mesh(data, inner_size, inner, rank if groups else 0)
    if not groups:
        return mesh
    mesh.world_group = dist.group.WORLD
    # every rank makes every group, in the same order
    if data > 1:
        for j in range(inner_size):
            g = dist.new_group([i * inner_size + j for i in range(data)])
            if rank % inner_size == j:
                mesh.data_group = g
    if inner_size > 1:
        for i in range(data):
            g = dist.new_group([i * inner_size + j for j in range(inner_size)])
            if rank // inner_size == i:
                mesh.inner_group = g
    return mesh


def create_mesh(data: Optional[int] = None, model: int = 1, world: Optional[int] = None) -> Mesh:
    """Mesh over ('data', 'model') of the `torch.distributed` world (or of
    `world` ranks, without groups, to decide specs). `data` defaults to
    world / model."""
    n = _world()[0] if world is None else world
    if data is None:
        assert n % model == 0, f"{n} ranks not divisible by model={model}"
        data = n // model
    return _make("model", data, model, world)


def create_expert_mesh(expert: int, data: Optional[int] = None,
                       world: Optional[int] = None) -> Mesh:
    """Mesh over ('data', 'expert') for expert-parallel MoE training."""
    n = _world()[0] if world is None else world
    if data is None:
        assert n % expert == 0, f"{n} ranks not divisible by expert={expert}"
        data = n // expert
    return _make("expert", data, expert, world)


# (regex on the flax param path, spec), first match wins; shapes as in JAX:
# qkv kernel (L, D, 3, H, hd), proj kernel (L, H, hd, D), fc1 (L, D, 4D),
# fc2 (L, 4D, D); the routed MLP's wi (L, E, D, H), bi (L, E, H),
# wo (L, E, H, D), bo (L, E, D) shard their expert axis
_EP_PARAM = re.compile(r"blocks/block/mlp/(wi|bi|wo|bo)$")
_TP_RULES = [
    (r"blocks/block/attn/qkv/kernel", (None, None, None, "model", None)),
    (r"blocks/block/attn/qkv/bias", (None, None, "model", None)),
    (r"blocks/block/attn/proj/kernel", (None, "model", None, None)),
    (r"blocks/block/mlp/fc1/kernel", (None, None, "model")),
    (r"blocks/block/mlp/fc1/bias", (None, "model")),
    (r"blocks/block/mlp/fc2/kernel", (None, "model", None)),
]


def dit_param_spec(path: str, shape: Sequence[int], *, tp: bool, fsdp: bool,
                   mesh: Mesh) -> Tuple[Optional[str], ...]:
    """The PartitionSpec of one JAX DiT leaf under the requested modes, as a
    tuple of axis names (None: replicated along that axis)."""
    spec: List[Optional[str]] = [None] * len(shape)
    axes = mesh.shape
    ep_axis = ("expert" if axes.get("expert", 1) > 1
               else "model" if tp and axes.get("model", 1) > 1 else None)
    if ep_axis and _EP_PARAM.search(path):
        spec[1] = ep_axis
    if tp and axes.get("model", 1) > 1:
        for pattern, rule in _TP_RULES:
            if re.search(pattern, path):
                spec = list(rule) + [None] * (len(shape) - len(rule))
                break
    if fsdp and axes.get("data", 1) > 1:
        n = axes["data"]
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if spec[i] is None and shape[i] % n == 0 and shape[i] >= n:
                spec[i] = "data"
                break
    return tuple(spec)


# the heads axis of the flax layouts whose maps depend on the head count
_HEADS_AXIS = {"attn.qkv.weight": 2, "attn.qkv.bias": 1, "attn.proj.weight": 0}


@dataclasses.dataclass
class ParamShard:
    """Where one port tensor's local part comes from. `axes` maps an axis
    of one member's flax layout (the layer axis excluded) to the mesh axis
    it is split over; `owner` is the data rank that holds this block's
    tensor whole when the spec is on the layer axis (else None)."""

    name: str
    full_shape: Tuple[int, ...]
    axes: Dict[int, str]
    owner: Optional[int]
    to_jax: Callable        # the local tensor -> its flax layout
    from_jax: Callable      # a flax-layout array of any split -> the port's layout
    full_to_jax: Callable
    inner_shape: Tuple[int, ...]  # the tensor of this rank's inner index, unsplit on data

    @property
    def sharded(self) -> bool:
        return bool(self.axes) or self.owner is not None

    @property
    def data_sharded(self) -> bool:
        return self.owner is not None or "data" in self.axes.values()

    @property
    def inner_sharded(self) -> bool:
        return any(a != "data" for a in self.axes.values())


def _layout(name: str, suffix: str, heads: int, full_shape):
    """(to_jax, from_jax) of a port tensor, shape-agnostic but for `heads`."""
    from ..ckpt.convert import _layouts  # noqa: PLC0415 (the ckpt package imports models)
    if name in ("x_embedder.proj.weight", "dino_embedder.proj.weight"):
        # (D, C, p, p) <-> (C p p, D); a part split on the C p p axis stays
        # the 2-D (D, C p p / n) and becomes 4-D again when gathered
        rest = tuple(full_shape[1:])
        return (lambda a: a.reshape(a.shape[0], -1).T,
                lambda a: (a.T.reshape(a.shape[1], *rest) if a.shape[0] == math.prod(rest)
                           else a.T))
    return _layouts(heads)[suffix]


class Sharding:
    """The placement of every parameter of a port DiT on a mesh (a
    `ParamShard` per tensor, in `model.parameters()` order), with the
    collectives that rebuild a full tensor from the local ones."""

    def __init__(self, model, mesh: Mesh, *, tp: bool = False, fsdp: bool = False):
        from ..ckpt.convert import jax_leaves  # noqa: PLC0415
        self.mesh = mesh
        names = [n for n, _ in model.named_parameters()]
        params = list(model.parameters())
        heads = model.num_heads
        self.leaves = jax_leaves(model)
        self.specs = {leaf.path: dit_param_spec(leaf.path, leaf.shape, tp=tp, fsdp=fsdp,
                                                mesh=mesh) for leaf in self.leaves}
        shards: List[Optional[ParamShard]] = [None] * len(params)
        for leaf in self.leaves:
            spec = self.specs[leaf.path]
            per_member = spec[1:] if leaf.stacked else spec
            axes = {i: a for i, a in enumerate(per_member) if a is not None}
            depth = len(leaf.members)
            for k, i in enumerate(leaf.members):
                name = names[i]
                suffix = name.split(".", 2)[2] if leaf.stacked else name
                local_heads = heads
                hax = _HEADS_AXIS.get(suffix)
                if hax is not None and hax in axes:
                    local_heads //= mesh.shape[axes[hax]]
                full_to_jax, from_jax = _layout(name, suffix, heads, params[i].shape)
                to_jax, _ = _layout(name, suffix, local_heads, params[i].shape)
                owner = None
                if leaf.stacked and spec[0] == "data":
                    owner = k // (depth // mesh.data)
                a = full_to_jax(torch.empty(params[i].shape, device="meta"))
                for ax, axis in axes.items():
                    if axis != "data":
                        a = a.chunk(mesh.shape[axis], dim=ax)[mesh.axis_rank(axis)]
                shards[i] = ParamShard(name, tuple(params[i].shape), axes, owner, to_jax,
                                       from_jax, full_to_jax, tuple(from_jax(a).shape))
        self.shards: List[ParamShard] = shards

    def local(self, i: int, full: torch.Tensor) -> torch.Tensor:
        """Parameter i's local part of `full` (a tensor of its full shape),
        contiguous; empty where another rank holds the block."""
        s, mesh = self.shards[i], self.mesh
        if s.owner is not None and s.owner != mesh.data_rank:
            return full.new_empty((0,))
        if not s.axes:
            return full
        a = s.full_to_jax(full)
        for ax, name in sorted(s.axes.items()):
            a = a.chunk(mesh.shape[name], dim=ax)[mesh.axis_rank(name)]
        return s.from_jax(a).contiguous()

    def gather_data(self, i: int, local: torch.Tensor) -> torch.Tensor:
        """Parameter i's tensor of this rank's inner index, from its data
        shards (differentiable: FSDP's use-site gather); `local` itself
        where the data axis is not split."""
        s, mesh = self.shards[i], self.mesh
        if s.owner is not None:
            return broadcast_owned(local, mesh.data_group, s.owner, s.inner_shape)
        axis = next((ax for ax, name in s.axes.items() if name == "data"), None)
        if axis is None:
            return local
        return s.from_jax(gather_shard(s.to_jax(local), mesh.data_group, axis))

    @torch.no_grad()
    def gather_full(self, i: int, local: torch.Tensor) -> torch.Tensor:
        """Parameter i's full tensor, on every rank, from the local parts of
        all ranks (a tensor shaped like the parameter: the parameter, its
        mu, nu, master or EMA). Every rank must call it."""
        s, mesh = self.shards[i], self.mesh
        if not s.sharded:
            return local
        a = s.to_jax(self.gather_data(i, local) if s.owner is not None else local)
        for ax, name in sorted(s.axes.items()):
            a = all_gather(a, mesh.group(name), dim=ax)
        return s.from_jax(a).contiguous()

    # -- a factored nu's row and col: the stacked leaf's axes but the last,
    # and but the second to last -------------------------------------------

    def leaf_axes(self, leaf) -> Dict[int, str]:
        """The split axes of a JAX leaf's stacked shape."""
        spec = self.specs[leaf.path]
        return {i: a for i, a in enumerate(spec) if a is not None}

    def factored_local(self, leaf, full: torch.Tensor, which: str) -> torch.Tensor:
        """This rank's part of a full row ("row") or col ("col") of `leaf`."""
        for ax, name in self._factor_axes(leaf, which).items():
            full = full.chunk(self.mesh.shape[name], dim=ax)[self.mesh.axis_rank(name)]
        return full.contiguous()

    @torch.no_grad()
    def factored_full(self, leaf, local: torch.Tensor, which: str) -> torch.Tensor:
        for ax, name in sorted(self._factor_axes(leaf, which).items()):
            local = all_gather(local, self.mesh.group(name), dim=ax)
        return local.contiguous()

    def _factor_axes(self, leaf, which: str) -> Dict[int, str]:
        nd = len(leaf.shape)
        drop = nd - 1 if which == "row" else nd - 2
        out = {}
        for ax, name in self.leaf_axes(leaf).items():
            if ax != drop:
                out[ax if ax < drop else ax - 1] = name
        return out


def param_shardings(model, mesh: Mesh, *, tp: bool = False, fsdp: bool = False) -> Sharding:
    """The `Sharding` of `model`'s parameters under the requested modes."""
    return Sharding(model, mesh, tp=tp, fsdp=fsdp)


@torch.no_grad()
def shard_params(model, mesh: Mesh, *, tp: bool = False, fsdp: bool = False) -> Sharding:
    """Keep this rank's part of every parameter of `model` (built whole, the
    same on every rank) and wire the modules to the mesh; returns the
    `Sharding`, also kept as `model.sharding`. Call it before the train
    state is made, so that the optimizer state is local too."""
    from ..models.layers import Attention, Mlp  # noqa: PLC0415
    from ..models.moe import MoeMlp  # noqa: PLC0415
    sharding = Sharding(model, mesh, tp=tp, fsdp=fsdp)
    for i, p in enumerate(model.parameters()):
        s = sharding.shards[i]
        p.data = sharding.local(i, p.data)
        if s.data_sharded:
            p.fsdp_gather = functools.partial(sharding.gather_data, i)
    inner = mesh.inner_group
    for m in model.modules():
        if isinstance(m, Attention) and tp and mesh.inner == "model" and mesh.inner_size > 1:
            m.num_heads //= mesh.inner_size
            m.tp_group = inner
        elif isinstance(m, Mlp) and tp and mesh.inner == "model" and mesh.inner_size > 1:
            m.tp_group = inner
        elif isinstance(m, MoeMlp):
            m.data_group = mesh.data_group
            if mesh.inner_size > 1 and (mesh.inner == "expert" or tp):
                if m.num_experts % mesh.inner_size:
                    raise ValueError(f"{mesh.inner}={mesh.inner_size} does not divide "
                                     f"{m.num_experts} experts")
                m.ep_group = inner
                m.expert_offset = mesh.inner_rank * (m.num_experts // mesh.inner_size)
    model.sharding = sharding
    return sharding


def batch_rows(mesh: Mesh, batch_size: int) -> slice:
    """The rows of a global batch of `batch_size` that this rank holds: its
    data index's contiguous share (the global batch is the ranks' local
    batches concatenated in data-rank order)."""
    if batch_size % mesh.data:
        raise ValueError(f"batch {batch_size} does not split over data={mesh.data}")
    n = batch_size // mesh.data
    return slice(mesh.data_rank * n, (mesh.data_rank + 1) * n)

