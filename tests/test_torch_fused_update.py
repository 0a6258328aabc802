"""The fused AdamW + EMA update (fast_dit_torch/ops/fused_update.py) against
the JAX package's `ops/fused_update.py`.

On the CPU the port's update runs its plain version, `_update_math`, leaf
by leaf, each op rounded to fp32. It is held bit for bit to the JAX
`_update_math` run eagerly (op by op), and, with bf16 params and mu over 3
steps, to `fused_adamw_ema_apply` through both JAX lowerings:

- `use_pallas=False`, run eagerly: to 1 ulp (sqrt and division may round
  apart);
- `use_pallas=True`, the `_leaf_kernel` interpreted as the JAX tests run it
  off the TPU: the interpreter compiles the kernel body, and XLA contracts
  `b * m + c * g` into fused multiply-adds, which moves m where the two
  terms cancel. From there Adam's update differs by up to 2 lr a step where
  m crosses 0, so params and master are held to 2 lr per step, the EMA to
  (1 - decay) of that, mu to one bf16 ulp of its largest value and nu to
  2 ulps.

The CUDA kernel is held against `_update_math` on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_dit_tpu.ops import fused_update as jfu
from fast_dit_torch.ops import _build
from fast_dit_torch.ops import fused_update as fu

HYPER = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, wd=0.0, ema_decay=0.99)
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(_np(a)).to(dtype)


def _equal(got: torch.Tensor, want):
    assert np.array_equal(got.float().numpy(), _np(want))


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance between two fp32 arrays in units in the last place."""
    ia, ib = (x.astype(np.float32).view(np.int32).astype(np.int64) for x in (a, b))
    ia, ib = (np.where(i < 0, -(i & 0x7FFFFFFF), i) for i in (ia, ib))  # order across 0
    return int(np.abs(ia - ib).max())


@pytest.mark.parametrize("count", [1, 2, 3, 10, 1000, 100000])
def test_bias_corrections_equal_jax(count):
    t = jnp.asarray(count, jnp.int32).astype(jnp.float32)
    want = (1.0 / (1.0 - 0.9 ** t), 1.0 / (1.0 - 0.999 ** t))
    got = fu.bias_corrections(count, 0.9, 0.999)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.item() == float(w)


@pytest.mark.parametrize("p_name", list(DTYPES))
@pytest.mark.parametrize("mu_name", list(DTYPES))
def test_update_math_bit_equal_to_jax(p_name, mu_name):
    (jp, tp), (jm, tm) = DTYPES[p_name], DTYPES[mu_name]
    rs = np.random.RandomState(0)
    n = 4096
    g = jnp.asarray(0.1 * rs.randn(n), jnp.float32).astype(jp)
    m = jnp.asarray(0.01 * rs.randn(n), jnp.float32).astype(jm)
    v = np.abs(1e-3 * rs.randn(n)).astype(np.float32)
    w = rs.randn(n).astype(np.float32)
    e = (w + 1e-3 * rs.randn(n)).astype(np.float32)
    t = jnp.float32(2)
    bc1, bc2 = 1.0 / (1.0 - 0.9 ** t), 1.0 / (1.0 - 0.999 ** t)
    want = jfu._update_math(g, m, v, w, e, bc1, bc2, mu_dtype=jm, p_dtype=jp, **HYPER)
    tb1, tb2 = fu.bias_corrections(2, 0.9, 0.999)
    got = fu._update_math(_t(g, tp), _t(m, tm), torch.from_numpy(v), torch.from_numpy(w),
                          torch.from_numpy(e), tb1, tb2, mu_dtype=tm, p_dtype=tp, **HYPER)
    for gt, wt, dt in zip(got, want, (tp, tm, torch.float32, torch.float32, torch.float32)):
        assert gt.dtype == dt
        _equal(gt, wt)


def _tree(seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    return {
        "big": jax.random.normal(ks[0], (4, 64, 128), jnp.bfloat16),   # kernel leaf in JAX
        "mid": jax.random.normal(ks[1], (384,), jnp.bfloat16),         # below its lane rule
        "odd": jax.random.normal(ks[2], (33,), jnp.bfloat16),
        "nested": {"w": jax.random.normal(ks[3], (128, 128), jnp.bfloat16)},
    }


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla-sweep", "pallas-interpreted"])
def test_fused_init_apply_match_jax_over_three_steps(use_pallas):
    params = _tree()
    jstate = jfu.fused_adamw_ema_init(params, mu_dtype=jnp.bfloat16)
    jema = jax.tree.map(lambda p: p.astype(jnp.float32), params)
    jparams = params

    leaves = jax.tree.leaves(params)
    tparams = [_t(p, torch.bfloat16) for p in leaves]
    state = fu.fused_adamw_ema_init(tparams, mu_dtype=torch.bfloat16)
    ema = [w.clone() for w in state.master]
    assert all(m.dtype == torch.bfloat16 for m in state.mu)
    assert all(v.dtype == torch.float32 and w.dtype == torch.float32
               for v, w in zip(state.nu, state.master))

    kw = dict(lr=HYPER["lr"], ema_decay=HYPER["ema_decay"])
    for i in range(3):
        grads = jax.tree.map(lambda p: 0.1 * jax.random.normal(
            jax.random.PRNGKey(100 + i), p.shape, p.dtype), params)
        jparams, jstate, jema = jfu.fused_adamw_ema_apply(
            jstate, grads, jparams, jema, use_pallas=use_pallas, **kw)
        fu.fused_adamw_ema_apply(state, [_t(g, torch.bfloat16) for g in jax.tree.leaves(grads)],
                                 tparams, ema, **kw)

    assert state.count == int(jstate.count) == 3
    assert all(p.dtype == torch.bfloat16 for p in tparams)
    steps_lr = 2 * HYPER["lr"] * 3
    for name, got, want in (("param", tparams, jparams), ("mu", state.mu, jstate.mu),
                            ("nu", state.nu, jstate.nu), ("master", state.master, jstate.master),
                            ("ema", ema, jema)):
        for g, w in zip(got, jax.tree.leaves(want)):
            a, b = g.float().numpy(), _np(w)
            if not use_pallas:
                assert _ulps(a, b) <= 1, name
            elif name in ("param", "master"):
                assert np.abs(a - b).max() <= steps_lr, name
            elif name == "ema":
                assert np.abs(a - b).max() <= (1 - HYPER["ema_decay"]) * steps_lr + 1e-6, name
            elif name == "mu":
                assert np.abs(a - b).max() <= 2 ** -7 * np.abs(b).max(), name
            else:
                assert _ulps(a, b) <= 2, name


def test_kernel_path_raises_rather_than_falling_back(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("no build expected"))
    n = 16
    leaf = dict(g=torch.zeros(n, dtype=torch.bfloat16), p=torch.zeros(n, dtype=torch.bfloat16),
                m=torch.zeros(n, dtype=torch.bfloat16), v=torch.zeros(n), w=torch.zeros(n),
                e=torch.zeros(n))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fu._launch(*leaf.values(), 1.0, 1.0, HYPER)
    with pytest.raises(ValueError, match="fp32 nu"):
        fu._launch(*{**leaf, "v": leaf["v"].to(torch.bfloat16)}.values(), 1.0, 1.0, HYPER)
    with pytest.raises(ValueError, match="grads in the param dtype"):
        fu._launch(*{**leaf, "g": leaf["w"]}.values(), 1.0, 1.0, HYPER)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        fu._launch(*{**leaf, "p": leaf["w"].half(), "g": leaf["w"].half()}.values(), 1.0, 1.0,
                   HYPER)
