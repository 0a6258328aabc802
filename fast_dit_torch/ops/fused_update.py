"""Fused AdamW + fp32 master + EMA update: the hand-written CUDA kernel and
its plain version.

Counterpart of `fast_dit_tpu/ops/fused_update.py`. The TPU kernel
`_leaf_kernel` (:138-147, launched by `_fused_leaf`, :150-181) becomes
`csrc/fused_update.cu`; `_update_math` (:103-116) is the plain version, op
for op. Math follows optax.adamw with mu stored in `mu_dtype`, nu in
`nu_dtype`, and the bias corrections computed in fp32:

    m <- b1 m + (1-b1) g            (stored in mu_dtype, then used rounded)
    v <- b2 v + (1-b2) g^2          (fp32; stored in nu_dtype, used unrounded)
    master <- master - lr (mhat / (sqrt(vhat) + eps) + wd master)
    ema    <- d ema + (1-d) master
    param  <- master.to(param.dtype)

`factored=True` keeps `FactoredNu` (:40-53) for every leaf of JAX's param
tree that `_factorable` (:66-68) admits, and `_update_math_factored`
(:119-135) updates it. Those leaves are JAX's, not the port's: a block
leaf stacks the `depth` blocks' tensors on a leading axis, and every
tensor is seen in flax's layout (`ckpt.convert.jax_leaves`: (D, 3, H, hd)
for qkv, (H, hd, D) for proj, (in, out) for a Dense), so row and col have
JAX's shapes and the same tensors decide what is factored.

Under a mesh (`parallel/mesh.py`) every tensor of the state is the rank's
local part of the parameter's, so the kernel and the dense plain update run
on local shards unchanged (they are elementwise). A factored leaf keeps the
rank's part of row and col (`FactoredSplit`: JAX replicates them, but each
rank needs only its own), and a mean over an axis that the mesh splits is a
sum over the local part, all-reduced over that axis's group, over the full
length. A rank that holds none of a block's tensor (an FSDP spec on the
layer axis) has an empty tensor there, which the update skips.

JAX returns new arrays; here the state, the EMA and the parameters are
updated in place, as the TPU kernel's input/output aliases do (:174). On
CPU tensors each leaf goes through `_update_math` (`_apply_plain`); on CUDA
tensors every dense leaf, of any size and fp32 or bf16 nu, goes through the
kernel, one launch per leaf, or the call raises. Factored leaves take the
plain `_update_math_factored` on the card too: JAX leaves them to XLA
(:213-216), not to its kernel. The TPU's lane rule (`size % 128 == 0 and
size >= 1024`, :218-219) is not carried over.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Any, List, Optional, Sequence

import torch

from . import _build

__all__ = ["FusedAdamWEmaState", "FactoredNu", "fused_adamw_ema_init",
           "fused_adamw_ema_apply", "bias_corrections", "nu_kind"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_F = ctypes.c_float
_ARGS = [_P, _P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _P]
# the launch count of each nu dtype's instantiation of the kernel
_COUNTS = {torch.float32: "fused_adamw_ema", torch.bfloat16: "fused_adamw_ema_nu_bf16"}

# factor only where the saving is real; tiny and 1-D leaves keep a dense nu
_FACTOR_MIN_SIZE = 1 << 16


def _factorable(shape) -> bool:
    """JAX's rule (`fused_update.py:66-68`), on a flax leaf's shape."""
    return (len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1
            and math.prod(shape) >= _FACTOR_MIN_SIZE)


@dataclasses.dataclass
class FactoredSplit:
    """How a factored leaf is split over a mesh: the flax layout maps of
    each member's local tensor (`maps`: param index -> (to_jax, from_jax)),
    the process group of each split axis of the stacked leaf (`groups`) and
    the leaf's full shape."""

    maps: dict
    groups: dict
    full_shape: tuple


@dataclasses.dataclass
class FactoredNu:
    """Adafactor-style factored second moment of one leaf of JAX's tree:
    running means of g^2 over its last axis (`row`) and its second-to-last
    (`col`), in JAX's shapes; vhat_ij = row_i col_j / mean_i(row). `leaf`
    (a `ckpt.convert.JaxLeaf`) names the port's tensors it stacks and
    their flax layout."""

    row: torch.Tensor  # (..., R) fp32
    col: torch.Tensor  # (..., C) fp32
    leaf: Any
    split: Optional[FactoredSplit] = None


@dataclasses.dataclass
class FusedAdamWEmaState:
    count: int                 # optax's step counter
    mu: List[torch.Tensor]     # first moment, mu_dtype, one per parameter
    # second moment, one entry per parameter: an fp32 or bf16 tensor, or the
    # FactoredNu of the JAX leaf that holds the parameter (one object, shared
    # by every parameter it stacks)
    nu: List[Any]
    master: List[torch.Tensor]  # fp32 master weights


def nu_kind(state: FusedAdamWEmaState) -> str:
    """"factored", or the dtype of the dense nu: "float32" or "bfloat16"."""
    if any(isinstance(v, FactoredNu) for v in state.nu):
        return "factored"
    return str(state.nu[0].dtype).replace("torch.", "")


def fused_adamw_ema_init(params, mu_dtype=torch.bfloat16, nu_dtype=torch.float32,
                         factored: bool = False, leaves: Optional[Sequence] = None,
                         sharding=None) -> FusedAdamWEmaState:
    """Zero moments and an fp32 master copy of `params` (a list of tensors).
    `nu_dtype` bf16 halves the dense second moment. `factored` replaces it
    by a `FactoredNu` for every factorable leaf of JAX's tree; `leaves`
    (`ckpt.convert.jax_leaves(model)`) says what those are, and `sharding`
    (`parallel.mesh.Sharding`), where the parameters are local parts, how
    each leaf is split."""
    params = list(params)
    nu: List[Any] = [None] * len(params)
    if factored:
        if leaves is None:
            raise ValueError("factored=True needs the model's JAX leaves "
                             "(ckpt.convert.jax_leaves)")
        for leaf in leaves:
            if _factorable(leaf.shape):  # JAX's choice, on the full leaf
                dev = params[leaf.members[0]].device
                row = torch.zeros(leaf.shape[:-1], device=dev)
                col = torch.zeros(leaf.shape[:-2] + leaf.shape[-1:], device=dev)
                split = None
                if sharding is not None and sharding.leaf_axes(leaf):
                    row = sharding.factored_local(leaf, row, "row")
                    col = sharding.factored_local(leaf, col, "col")
                    split = FactoredSplit(
                        maps={i: (sharding.shards[i].to_jax, sharding.shards[i].from_jax)
                              for i in leaf.members},
                        groups={ax: sharding.mesh.group(name)
                                for ax, name in sharding.leaf_axes(leaf).items()},
                        full_shape=tuple(leaf.shape))
                fnu = FactoredNu(row=row, col=col, leaf=leaf, split=split)
                for i in leaf.members:
                    nu[i] = fnu
    nu = [torch.zeros(p.shape, dtype=nu_dtype, device=p.device) if v is None else v
          for p, v in zip(params, nu)]
    return FusedAdamWEmaState(
        count=0,
        mu=[torch.zeros(p.shape, dtype=mu_dtype, device=p.device) for p in params],
        nu=nu, master=[p.detach().float().clone() for p in params])


def bias_corrections(count: int, b1: float, b2: float):
    """(1 / (1 - b1^t), 1 / (1 - b2^t)) as fp32 scalars for step t = count,
    computed in fp32 as `fused_adamw_ema_apply` does in JAX (:206-209)."""
    t = torch.tensor(float(count), dtype=torch.float32)
    one = torch.tensor(1.0, dtype=torch.float32)
    bc1 = one / (one - torch.tensor(b1, dtype=torch.float32) ** t)
    bc2 = one / (one - torch.tensor(b2, dtype=torch.float32) ** t)
    return bc1, bc2


def _update_math(g, m, v, w, e, bc1, bc2, *, lr, b1, b2, eps, wd, ema_decay,
                 mu_dtype, p_dtype):
    """The plain version: one leaf's update, each op rounded to fp32 as in
    JAX. Returns (param, m, v, master, ema)."""
    g32 = g.float()
    m_new = (b1 * m.float() + (1.0 - b1) * g32).to(mu_dtype)
    v32 = b2 * v.float() + (1.0 - b2) * g32 * g32
    v_new = v32.to(v.dtype)
    mhat = m_new.float() * bc1
    vhat = v32 * bc2
    w_new = w - lr * (mhat / (torch.sqrt(vhat) + eps) + wd * w)
    e_new = ema_decay * e + (1.0 - ema_decay) * w_new
    return w_new.to(p_dtype), m_new, v_new, w_new, e_new


def _members(fnu: FactoredNu, tensors) -> List[int]:
    """The leaf's members this rank holds (all of them, unless the layer
    axis is split)."""
    return [i for i in fnu.leaf.members if tensors[i].numel()]


def _mean(t: torch.Tensor, leaf_axis: int, dim: int, split: Optional[FactoredSplit],
          keepdim: bool = False) -> torch.Tensor:
    """The mean of `t` over `dim`, which is the leaf's axis `leaf_axis`: a
    local mean, or, where the mesh splits that axis, the local sum summed
    over the axis's group over the full length."""
    if split is None or leaf_axis not in split.groups:
        return t.mean(dim=dim, keepdim=keepdim)
    from ..parallel.collectives import all_reduce  # noqa: PLC0415
    return all_reduce(t.sum(dim=dim, keepdim=keepdim), split.groups[leaf_axis]) / (
        split.full_shape[leaf_axis])


def _factored_vhat(fnu: FactoredNu, grads, b2, bc2):
    """`_update_math_factored`'s second moment for one JAX leaf: the new
    (row, col) from the stacked g^2 in flax's layout, and vhat per port
    tensor this rank holds, in the port's layout."""
    leaf, split = fnu.leaf, fnu.split
    members = _members(fnu, grads)
    to_jax = (lambda i: leaf.to_jax) if split is None else (lambda i: split.maps[i][0])
    from_jax = leaf.from_jax if split is None else split.maps[leaf.members[0]][1]
    g2 = torch.stack([to_jax(i)(grads[i]).float() for i in members])
    if not leaf.stacked:
        g2 = g2[0]
    g2 = g2 * g2
    nd = g2.dim()
    row = b2 * fnu.row + (1.0 - b2) * _mean(g2, nd - 1, -1, split)
    col = b2 * fnu.col + (1.0 - b2) * _mean(g2, nd - 2, -2, split)
    norm = torch.clamp(_mean(row, nd - 2, -1, split, keepdim=True), min=1e-30)
    vhat = (row / norm)[..., :, None] * col[..., None, :] * bc2
    if not leaf.stacked:
        return row, col, [from_jax(vhat)]
    return row, col, [from_jax(vhat[k]) for k in range(len(members))]


def _update_math_factored(g, m, vhat, w, e, bc1, *, lr, b1, eps, wd, ema_decay, mu_dtype,
                          p_dtype):
    """The plain version's elementwise rest of `_update_math_factored`: one
    tensor's update given its vhat. Returns (param, m, master, ema)."""
    g32 = g.float()
    m_new = (b1 * m.float() + (1.0 - b1) * g32).to(mu_dtype)
    mhat = m_new.float() * bc1
    w_new = w - lr * (mhat / (torch.sqrt(vhat) + eps) + wd * w)
    e_new = ema_decay * e + (1.0 - ema_decay) * w_new
    return w_new.to(p_dtype), m_new, w_new, e_new


def _apply_factored(fnu: FactoredNu, grads, params, state, ema, bc1, bc2, hyper) -> None:
    """One JAX leaf with a factored nu, in stock torch ops on any device."""
    row, col, vhats = _factored_vhat(fnu, grads, hyper["b2"], bc2)
    for i, vhat in zip(_members(fnu, grads), vhats):
        outs = _update_math_factored(
            grads[i], state.mu[i], vhat, state.master[i], ema[i], bc1,
            lr=hyper["lr"], b1=hyper["b1"], eps=hyper["eps"], wd=hyper["wd"],
            ema_decay=hyper["ema_decay"], mu_dtype=state.mu[i].dtype,
            p_dtype=params[i].dtype)
        for dst, src in zip((params[i], state.mu[i], state.master[i], ema[i]), outs):
            dst.copy_(src)
    fnu.row.copy_(row)
    fnu.col.copy_(col)


def _check_leaf(g, p, m, v, w, e) -> None:
    if p.dtype not in _DTYPE_CODES or m.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused update takes fp32 or bf16 params and mu, got "
                         f"{p.dtype} and {m.dtype}")
    if v.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused update takes an fp32 or bf16 nu, got {v.dtype}")
    if g.dtype != p.dtype:
        raise ValueError(f"fused update takes grads in the param dtype, got {g.dtype} "
                         f"for {p.dtype}")
    for name, t in (("master", w), ("ema", e)):
        if t.dtype != torch.float32:
            raise ValueError(f"fused update takes fp32 {name}, got {t.dtype}")
    for t in (g, p, m, v, w, e):
        if t.device.type != "cuda":
            raise ValueError(f"fused update kernel runs on CUDA tensors, got {t.device}")
        if t.numel() != p.numel() or not t.is_contiguous():
            raise ValueError("fused update takes contiguous leaves of one size")


def _launch(g, p, m, v, w, e, bc1: float, bc2: float, hyper: dict) -> None:
    _check_leaf(g, p, m, v, w, e)
    fn = _build.function("fused_update", "fdt_fused_adamw_ema", _ARGS)
    lr, b1, b2, eps = hyper["lr"], hyper["b1"], hyper["b2"], hyper["eps"]
    wd, d = hyper["wd"], hyper["ema_decay"]
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        # ctypes rounds each Python float to fp32 once, as torch does with a
        # Python scalar in `_update_math`
        code = fn(g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(), w.data_ptr(),
                  e.data_ptr(), p.numel(), _DTYPE_CODES[p.dtype], _DTYPE_CODES[m.dtype],
                  _DTYPE_CODES[v.dtype], bc1, bc2, lr, b1, 1.0 - b1, b2, 1.0 - b2, eps, wd,
                  d, 1.0 - d, stream)
    _build.check_status("fused_update", code, "fused_adamw_ema launch")
    _build.launch_counts[_COUNTS[v.dtype]] += 1


@torch.no_grad()
def _apply_plain(state: FusedAdamWEmaState, grads, params, ema, hyper: dict) -> None:
    """The plain version of `fused_adamw_ema_apply`: `_update_math` leaf by
    leaf, on tensors of any device, and `_update_math_factored` for each
    factored JAX leaf. `hyper` holds lr, b1, b2, eps, wd and ema_decay."""
    state.count += 1
    bc1, bc2 = bias_corrections(state.count, hyper["b1"], hyper["b2"])
    for i, (g, p, m, v, w, e) in enumerate(zip(grads, params, state.mu, state.nu,
                                               state.master, ema)):
        if isinstance(v, FactoredNu):
            if i == v.leaf.members[0]:
                _apply_factored(v, grads, params, state, ema, bc1, bc2, hyper)
            continue
        if not p.numel():
            continue
        outs = _update_math(g, m, v, w, e, bc1, bc2, mu_dtype=m.dtype, p_dtype=p.dtype,
                            **hyper)
        for dst, src in zip((p, m, v, w, e), outs):
            dst.copy_(src)


@torch.no_grad()
def fused_adamw_ema_apply(state: FusedAdamWEmaState, grads, params, ema, *, lr: float,
                          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                          weight_decay: float = 0.0, ema_decay: float = 0.9999) -> None:
    """One fused optimizer + EMA step, in place on `state`, `params` (the
    model's parameter tensors) and `ema` (fp32 tensors), leaf by leaf: the
    kernel for each dense leaf, the plain factored math for each factored
    JAX leaf."""
    params = list(params)
    hyper = dict(lr=lr, b1=b1, b2=b2, eps=eps, wd=weight_decay, ema_decay=ema_decay)
    if all(p.device.type == "cpu" for p in params):
        _apply_plain(state, grads, params, ema, hyper)
        return
    state.count += 1
    bc1, bc2 = bias_corrections(state.count, b1, b2)
    for i, (g, p, m, v, w, e) in enumerate(zip(grads, params, state.mu, state.nu,
                                               state.master, ema)):
        if isinstance(v, FactoredNu):
            if i == v.leaf.members[0]:
                # host floats: a CPU tensor moved to the card would sync
                _apply_factored(v, grads, params, state, ema, bc1.item(), bc2.item(), hyper)
            continue
        if not p.numel():
            continue
        _launch(g, p, m, v, w, e, bc1.item(), bc2.item(), hyper)
