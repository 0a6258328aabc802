"""Fused AdamW + fp32 master + EMA update: the hand-written CUDA kernel and
its plain version.

Counterpart of `fast_dit_tpu/ops/fused_update.py`. The TPU kernel
`_leaf_kernel` (:138-147, launched by `_fused_leaf`, :150-181) becomes
`csrc/fused_update.cu`; `_update_math` (:103-116) is the plain version, op
for op. Math follows optax.adamw with mu stored in `mu_dtype` and the bias
corrections computed in fp32:

    m <- b1 m + (1-b1) g            (stored in mu_dtype, then used rounded)
    v <- b2 v + (1-b2) g^2          (fp32)
    master <- master - lr (mhat / (sqrt(vhat) + eps) + wd master)
    ema    <- d ema + (1-d) master
    param  <- master.to(param.dtype)

JAX returns new arrays; here the state, the EMA and the parameters are
updated in place, as the TPU kernel's input/output aliases do (:174). On
CPU tensors each leaf goes through `_update_math` (`_apply_plain`); on CUDA
tensors every leaf, of any size, goes through the kernel, one launch per
leaf, or the call raises. The TPU's lane rule (`size % 128 == 0 and size >= 1024`,
:218-219) is not carried over. bf16 nu and `FactoredNu` (:56-135) were
XLA-only in JAX and are not ported yet.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List

import torch

from . import _build

__all__ = ["FusedAdamWEmaState", "fused_adamw_ema_init", "fused_adamw_ema_apply",
           "bias_corrections"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_F = ctypes.c_float
_ARGS = [_P, _P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
         _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _P]


@dataclasses.dataclass
class FusedAdamWEmaState:
    count: int                 # optax's step counter
    mu: List[torch.Tensor]     # first moment, mu_dtype, one per parameter
    nu: List[torch.Tensor]     # second moment, fp32
    master: List[torch.Tensor]  # fp32 master weights


def fused_adamw_ema_init(params, mu_dtype=torch.bfloat16) -> FusedAdamWEmaState:
    """Zero moments and an fp32 master copy of `params` (a list of tensors)."""
    params = list(params)
    return FusedAdamWEmaState(
        count=0,
        mu=[torch.zeros(p.shape, dtype=mu_dtype, device=p.device) for p in params],
        nu=[torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params],
        master=[p.detach().float().clone() for p in params])


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


def _check_leaf(g, p, m, v, w, e) -> None:
    if p.dtype not in _DTYPE_CODES or m.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused update takes fp32 or bf16 params and mu, got "
                         f"{p.dtype} and {m.dtype}")
    if g.dtype != p.dtype:
        raise ValueError(f"fused update takes grads in the param dtype, got {g.dtype} "
                         f"for {p.dtype}")
    for name, t in (("nu", v), ("master", w), ("ema", e)):
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
                  bc1, bc2, lr, b1, 1.0 - b1, b2, 1.0 - b2, eps, wd, d, 1.0 - d, stream)
    _build.check_status("fused_update", code, "fused_adamw_ema launch")
    _build.launch_counts["fused_adamw_ema"] += 1


@torch.no_grad()
def _apply_plain(state: FusedAdamWEmaState, grads, params, ema, hyper: dict) -> None:
    """The plain version of `fused_adamw_ema_apply`: `_update_math` leaf by
    leaf, on tensors of any device. `hyper` holds lr, b1, b2, eps, wd and
    ema_decay."""
    state.count += 1
    bc1, bc2 = bias_corrections(state.count, hyper["b1"], hyper["b2"])
    for g, p, m, v, w, e in zip(grads, params, state.mu, state.nu, state.master, ema):
        outs = _update_math(g, m, v, w, e, bc1, bc2, mu_dtype=m.dtype, p_dtype=p.dtype,
                            **hyper)
        for dst, src in zip((p, m, v, w, e), outs):
            dst.copy_(src)


@torch.no_grad()
def fused_adamw_ema_apply(state: FusedAdamWEmaState, grads, params, ema, *, lr: float,
                          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                          weight_decay: float = 0.0, ema_decay: float = 0.9999) -> None:
    """One fused optimizer + EMA step, in place on `state`, `params` (the
    model's parameter tensors) and `ema` (fp32 tensors), leaf by leaf."""
    params = list(params)
    hyper = dict(lr=lr, b1=b1, b2=b2, eps=eps, wd=weight_decay, ema_decay=ema_decay)
    if all(p.device.type == "cpu" for p in params):
        _apply_plain(state, grads, params, ema, hyper)
        return
    state.count += 1
    bc1, bc2 = bias_corrections(state.count, b1, b2)
    for g, p, m, v, w, e in zip(grads, params, state.mu, state.nu, state.master, ema):
        _launch(g, p, m, v, w, e, bc1.item(), bc2.item(), hyper)
