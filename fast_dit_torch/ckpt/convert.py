"""Carry DiT weights into the port (counterpart of
`fast_dit_tpu/ckpt/torch_import.py`).

- `flax_params_to_state_dict` turns a JAX DiT param tree (numpy arrays, as
  `fast_dit_tpu` stores it: stacked (depth, ...) block params, (in, out)
  Dense kernels, (D, 3, H, hd) qkv kernel) into the port's state dict, with
  the reference torch names. The maps are the port's own copy of the
  inverse maps at `torch_import.py:54-121` and `:166-210`. A MoE tree has
  no reference torch format (JAX's exporter refuses it, `:173-177`), so the
  port names its routed MLP itself: `blocks.{i}.mlp.router.weight` (E, D),
  the flax (D, E) router kernel transposed, and `blocks.{i}.mlp.wi` (E, D,
  H), `.bi` (E, H), `.wo` (E, H, D), `.bo` (E, D), JAX's per-block arrays
  as they are. Nor has a `DiTNVS` tree (`nvs/conditioning.py`), whose
  names are the port's too: `blocks.{i}.cross_attn.{to_q,to_k,to_v}` Linear
  weights (D, D) from the flax (D, H, hd) kernels and (D,) biases from
  (H, hd), `blocks.{i}.cross_attn.proj` as the self-attention's proj, and
  `dino_embedder.proj.weight` (D, dino_dim, 1, 1) from the (dino_dim, D)
  kernel, as `x_embedder`'s with patch 1; the 9D adaLN maps as the DiT's.
- `jax_leaves` lists the flax leaves of a port DiT: which of its parameters
  each stacks and how one of them looks in flax's layout, so that a state
  kept per flax leaf (the factored second moment of `ops/fused_update.py`)
  lives in JAX's shapes.
- `load_torch_checkpoint` reads a local reference `.pt` file: a flat state
  dict, or a trainer checkpoint {"model", "ema", ...} resolved to "ema" when
  present. It never downloads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..models.pos_embed import get_2d_sincos_pos_embed

__all__ = ["flax_params_to_state_dict", "load_torch_checkpoint", "JaxLeaf", "jax_leaves"]


def _t(arr):  # flax Dense kernel (in, out) -> torch Linear weight (out, in)
    return arr.T


def _id(arr):
    return arr


def _qkv_w(arr):  # (D, 3, H, hd) -> (3D, D)
    return arr.reshape(arr.shape[0], -1).T


def _qkv_b(arr):  # (3, H, hd) -> (3D,)
    return arr.reshape(-1)


def _proj_w(arr):  # (H, hd, D_out) -> (D_out, H*hd)
    h, hd, d_out = arr.shape
    return arr.reshape(h * hd, d_out).T


def _heads_w(arr):  # (D, H, hd) -> (H*hd, D)
    return arr.reshape(arr.shape[0], -1).T


def _heads_b(arr):  # (H, hd) -> (H*hd,)
    return arr.reshape(-1)


# torch name suffix inside a block -> (flax path inside the block, export)
_BLOCK_MAP = {
    "adaLN_modulation.1.weight": ("adaLN_modulation/kernel", _t),
    "adaLN_modulation.1.bias": ("adaLN_modulation/bias", _id),
    "attn.qkv.weight": ("attn/qkv/kernel", _qkv_w),
    "attn.qkv.bias": ("attn/qkv/bias", _qkv_b),
    "attn.proj.weight": ("attn/proj/kernel", _proj_w),
    "attn.proj.bias": ("attn/proj/bias", _id),
    "mlp.fc1.weight": ("mlp/fc1/kernel", _t),
    "mlp.fc1.bias": ("mlp/fc1/bias", _id),
    "mlp.fc2.weight": ("mlp/fc2/kernel", _t),
    "mlp.fc2.bias": ("mlp/fc2/bias", _id),
}

# the routed MLP of a MoE block, in place of the mlp.fc* entries
_MOE_BLOCK_MAP = {
    "mlp.router.weight": ("mlp/router/kernel", _t),
    "mlp.wi": ("mlp/wi", _id),
    "mlp.bi": ("mlp/bi", _id),
    "mlp.wo": ("mlp/wo", _id),
    "mlp.bo": ("mlp/bo", _id),
}


# the cross-attention of a DiTNVS block, beside the DiT block's entries
_CROSS_BLOCK_MAP = {
    **{f"cross_attn.{n}.weight": (f"cross_attn/{n}/kernel", _heads_w)
       for n in ("to_q", "to_k", "to_v")},
    **{f"cross_attn.{n}.bias": (f"cross_attn/{n}/bias", _heads_b)
       for n in ("to_q", "to_k", "to_v")},
    "cross_attn.proj.weight": ("cross_attn/proj/kernel", _proj_w),
    "cross_attn.proj.bias": ("cross_attn/proj/bias", _id),
}


def _block_map(moe: bool, cross: bool = False):
    block = _BLOCK_MAP
    if moe:
        dense = {k: v for k, v in _BLOCK_MAP.items() if not k.startswith("mlp.")}
        block = {**dense, **_MOE_BLOCK_MAP}
    return {**block, **_CROSS_BLOCK_MAP} if cross else block


# top-level torch name -> (flax path, export)
_TOP_MAP = {
    "x_embedder.proj.bias": ("x_embedder/proj/bias", _id),
    "t_embedder.mlp.0.weight": ("t_embedder/fc1/kernel", _t),
    "t_embedder.mlp.0.bias": ("t_embedder/fc1/bias", _id),
    "t_embedder.mlp.2.weight": ("t_embedder/fc2/kernel", _t),
    "t_embedder.mlp.2.bias": ("t_embedder/fc2/bias", _id),
    "y_embedder.embedding_table.weight": ("y_embedder/embedding_table/embedding", _id),
    "final_layer.adaLN_modulation.1.weight": ("final_layer/adaLN_modulation/kernel", _t),
    "final_layer.adaLN_modulation.1.bias": ("final_layer/adaLN_modulation/bias", _id),
    "final_layer.linear.weight": ("final_layer/linear/kernel", _t),
    "final_layer.linear.bias": ("final_layer/linear/bias", _id),
}

# a DiTNVS's DINO embedder; its weight maps as x_embedder's, with patch 1
_NVS_TOP_MAP = {"dino_embedder.proj.bias": ("dino_embedder/proj/bias", _id)}
# patch embedding weight -> the flax kernel it comes from
_PATCH_WEIGHTS = {"x_embedder.proj.weight": "x_embedder/proj/kernel",
                  "dino_embedder.proj.weight": "dino_embedder/proj/kernel"}


def _get(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return np.asarray(tree)


def flax_params_to_state_dict(params: dict, patch_size: int, in_channels: int = 4,
                              input_size: int = 32) -> Dict[str, torch.Tensor]:
    """JAX DiT or DiTNVS param tree (numpy leaves, with or without the
    "params" level) -> the port's fp32 state dict, `pos_embed` included."""
    p = params["params"] if "params" in params else params
    nvs = "dino_embedder" in p
    arrays: Dict[str, np.ndarray] = {}
    kern = _get(p, "x_embedder/proj/kernel")  # (C*p*p, D)
    d = kern.shape[1]
    arrays["x_embedder.proj.weight"] = kern.T.reshape(d, in_channels, patch_size, patch_size)
    top = dict(_TOP_MAP)
    if nvs:
        kern = _get(p, "dino_embedder/proj/kernel")  # (dino_dim, D)
        arrays["dino_embedder.proj.weight"] = kern.T.reshape(d, kern.shape[0], 1, 1)
        top.update(_NVS_TOP_MAP)
    for name, (path, export) in top.items():
        arrays[name] = export(_get(p, path))
    block = p["blocks"]["block"]
    depth = _get(block, "attn/qkv/kernel").shape[0]
    for suffix, (path, export) in _block_map("router" in block["mlp"], nvs).items():
        stacked = _get(block, path)
        for i in range(depth):
            arrays[f"blocks.{i}.{suffix}"] = export(stacked[i])
    arrays["pos_embed"] = get_2d_sincos_pos_embed(d, input_size // patch_size)[None]
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            for k, v in arrays.items()}


@dataclasses.dataclass(frozen=True)
class JaxLeaf:
    """One leaf of the JAX DiT's param tree, in terms of the port's
    parameters: `members` index `model.parameters()`; a block leaf stacks
    its `depth` members on a leading axis (nn.scan), a top-level leaf has
    one. `to_jax` maps one member to its flax layout, `from_jax` back."""

    path: str
    members: Tuple[int, ...]
    shape: Tuple[int, ...]   # the flax leaf's shape, the depth axis included
    to_jax: Callable
    from_jax: Callable

    @property
    def stacked(self) -> bool:
        return self.path.startswith("blocks/")


def _layouts(heads: int):
    """{torch name suffix: (to_jax, from_jax)} for a DiT with `heads` heads:
    the inverses of the exports above, as views where the layout allows."""
    t = (lambda a: a.T, lambda a: a.T)
    same = (lambda a: a, lambda a: a)
    qkv_w = (lambda a: a.T.reshape(a.shape[1], 3, heads, -1),
             lambda a: a.reshape(a.shape[0], -1).T)
    qkv_b = (lambda a: a.reshape(3, heads, -1), lambda a: a.reshape(-1))
    proj_w = (lambda a: a.T.reshape(heads, -1, a.shape[0]),
              lambda a: a.reshape(-1, a.shape[-1]).T)
    heads_w = (lambda a: a.T.reshape(a.shape[1], heads, -1),
               lambda a: a.reshape(a.shape[0], -1).T)
    heads_b = (lambda a: a.reshape(heads, -1), lambda a: a.reshape(-1))
    table = {}
    for suffix, (_, export) in {**_BLOCK_MAP, **_MOE_BLOCK_MAP, **_CROSS_BLOCK_MAP,
                                **_TOP_MAP, **_NVS_TOP_MAP}.items():
        table[suffix] = {_t: t, _id: same, _qkv_w: qkv_w, _qkv_b: qkv_b,
                         _proj_w: proj_w, _heads_w: heads_w, _heads_b: heads_b}[export]
    return table


def jax_leaves(model) -> List[JaxLeaf]:
    """The flax leaves of `model` (a port DiT or DiTNVS) in flax's order of
    paths, each with the port's parameters it holds. A MoE block's expert
    leaves keep JAX's stacked shapes, (depth, E, D, H) for `wi`; a DiTNVS
    block's cross-attention leaves too, (depth, D, H, hd) for `to_q`."""
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    index = {n: i for i, n in enumerate(names)}
    layouts = _layouts(model.num_heads)
    nvs = "dino_embedder.proj.weight" in index
    leaves = []
    for name, (path, _) in {**_TOP_MAP, **(_NVS_TOP_MAP if nvs else {})}.items():
        i = index[name]
        to_jax, from_jax = layouts[name]
        leaves.append(JaxLeaf(path, (i,), tuple(to_jax(params[i]).shape), to_jax, from_jax))
    for name, path in _PATCH_WEIGHTS.items():
        if name not in index:
            continue
        i = index[name]
        shape4 = tuple(params[i].shape)
        leaves.append(JaxLeaf(path, (i,), (math.prod(shape4[1:]), shape4[0]),
                              lambda a: a.reshape(a.shape[0], -1).T,
                              lambda a, s=shape4: a.T.reshape(s)))
    for suffix, (path, _) in _block_map(getattr(model, "moe_experts", 0) > 0, nvs).items():
        members = tuple(index[f"blocks.{b}.{suffix}"] for b in range(len(model.blocks)))
        to_jax, from_jax = layouts[suffix]
        one = tuple(to_jax(params[members[0]]).shape)
        leaves.append(JaxLeaf(f"blocks/block/{path}", members, (len(members), *one),
                              to_jax, from_jax))
    leaves.sort(key=lambda leaf: leaf.path)
    if sorted(i for leaf in leaves for i in leaf.members) != list(range(len(params))):
        raise ValueError("the model's parameters do not map one to one onto JAX's leaves")
    return leaves


def load_torch_checkpoint(path: str, prefer_ema: bool = True) -> Dict[str, torch.Tensor]:
    """A local reference `.pt` file -> flat {name: CPU tensor} state dict.
    Trainer checkpoints resolve to "ema" when present (and `prefer_ema`),
    else "model". The file is the caller's own, so its pickled extras (the
    trainer's argparse namespace) are allowed."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and ("ema" in ckpt or "model" in ckpt):
        ckpt = ckpt["ema" if (prefer_ema and "ema" in ckpt) else "model"]
    return {k: v.detach().cpu() for k, v in ckpt.items()}
