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
    # an fp32 or bf16 nu (the kernel's two instantiations), nothing else
    with pytest.raises(ValueError, match="fp32 or bf16 nu"):
        fu._launch(*{**leaf, "v": leaf["v"].half()}.values(), 1.0, 1.0, HYPER)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fu._launch(*{**leaf, "v": leaf["v"].to(torch.bfloat16)}.values(), 1.0, 1.0, HYPER)
    with pytest.raises(ValueError, match="grads in the param dtype"):
        fu._launch(*{**leaf, "g": leaf["w"]}.values(), 1.0, 1.0, HYPER)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        fu._launch(*{**leaf, "p": leaf["w"].half(), "g": leaf["w"].half()}.values(), 1.0, 1.0,
                   HYPER)


# -- bf16 nu and the factored second moment -------------------------------------

@pytest.mark.parametrize("p_name", list(DTYPES))
@pytest.mark.parametrize("mu_name", list(DTYPES))
def test_update_math_with_bf16_nu_bit_equal_to_jax(p_name, mu_name):
    """vhat comes from the unrounded v32; only the stored nu rounds to bf16."""
    (jp, tp), (jm, tm) = DTYPES[p_name], DTYPES[mu_name]
    rs = np.random.RandomState(1)
    n = 4096
    g = jnp.asarray(0.1 * rs.randn(n), jnp.float32).astype(jp)
    m = jnp.asarray(0.01 * rs.randn(n), jnp.float32).astype(jm)
    v = jnp.asarray(np.abs(1e-3 * rs.randn(n)), jnp.float32).astype(jnp.bfloat16)
    w = rs.randn(n).astype(np.float32)
    e = (w + 1e-3 * rs.randn(n)).astype(np.float32)
    t = jnp.float32(3)
    bc1, bc2 = 1.0 / (1.0 - 0.9 ** t), 1.0 / (1.0 - 0.999 ** t)
    want = jfu._update_math(g, m, v, w, e, bc1, bc2, mu_dtype=jm, p_dtype=jp, **HYPER)
    tb1, tb2 = fu.bias_corrections(3, 0.9, 0.999)
    got = fu._update_math(_t(g, tp), _t(m, tm), _t(v, torch.bfloat16), torch.from_numpy(w),
                          torch.from_numpy(e), tb1, tb2, mu_dtype=tm, p_dtype=tp, **HYPER)
    for gt, wt, dt in zip(got, want, (tp, tm, torch.bfloat16, torch.float32, torch.float32)):
        assert gt.dtype == dt
        _equal(gt, wt)
    # the stored nu is rounded, the update is not: vhat from the rounded nu moves w
    v_rounded = got[2].float() * tb2
    assert not torch.equal(got[3], torch.from_numpy(w) - HYPER["lr"] * (
        (got[1].float() * tb1) / (torch.sqrt(v_rounded) + HYPER["eps"])))


# a small DiT whose JAX tree has factored and dense leaves (the threshold is
# 65536 elements): width 192, 3 heads of 64, depth 2
SMALL = dict(input_size=8, patch_size=2, hidden_size=192, depth=2, num_heads=3, num_classes=10)
# the factored moments are means over up to 768 fp32 squares, summed in
# another order by XLA and by torch: row and col agree to a few ulps of their
# largest value (FACTORED_RTOL). An update is mhat lr / sqrt(vhat), so each
# master's step agrees to FACTORED_RTOL of itself, plus the rounding of the
# new master to fp32 (an ulp); the EMA takes (1 - decay) of that
FACTORED_RTOL = 1e-5


def _step_close(got, path, steps=1):
    """|got - path[-1]| <= FACTORED_RTOL * (the sum of |step| along `path`,
    the reference's values from the start) + an ulp per step, elementwise:
    each step's update agrees to FACTORED_RTOL of itself and each new
    master rounds to fp32 once."""
    got, *path = (np.asarray(a, np.float32) for a in (got, *path))
    moved = sum(np.abs(b - a) for a, b in zip(path, path[1:]))
    bound = FACTORED_RTOL * moved + steps * np.spacing(np.abs(path[-1]))
    assert (np.abs(got - path[-1]) <= bound).all(), np.abs(got - path[-1]).max()


def _small_port_model():
    from fast_dit_torch.models import DiT
    return DiT(**SMALL, device="cpu")


@pytest.mark.parametrize("path", ["final_layer/adaLN_modulation/kernel",
                                  "blocks/block/mlp/fc1/kernel", "blocks/block/attn/qkv/kernel",
                                  "blocks/block/attn/proj/kernel"],
                         ids=["dense-2d", "stacked-2d", "qkv", "proj"])
def test_factored_leaf_matches_jax_update_math_factored(path):
    """One JAX leaf, given to the port as its torch weights ((3D, D) qkv,
    (D, H*hd) proj, (out, in) Dense): row and col keep JAX's shapes (qkv
    (depth, D, 3, H) and (depth, D, 3, hd); proj (depth, H, hd) and (depth,
    H, D)), and the update matches `_update_math_factored`."""
    from fast_dit_torch.ckpt import jax_leaves
    model = _small_port_model()
    (leaf,) = [lf for lf in jax_leaves(model) if lf.path == path]
    assert fu._factorable(leaf.shape)
    rs = np.random.RandomState(2)
    shape = leaf.shape
    g = jnp.asarray(0.1 * rs.randn(*shape), jnp.float32).astype(jnp.bfloat16)
    m = jnp.asarray(0.01 * rs.randn(*shape), jnp.float32).astype(jnp.bfloat16)
    row = np.abs(1e-3 * rs.randn(*shape[:-1])).astype(np.float32)
    col = np.abs(1e-3 * rs.randn(*(shape[:-2] + shape[-1:]))).astype(np.float32)
    w = rs.randn(*shape).astype(np.float32)
    e = (w + 1e-3 * rs.randn(*shape)).astype(np.float32)
    t = jnp.float32(2)
    bc1, bc2 = 1.0 / (1.0 - 0.9 ** t), 1.0 / (1.0 - 0.999 ** t)
    want = jfu._update_math_factored(g, m, jfu.FactoredNu(row=row, col=col), w, e, bc1, bc2,
                                     mu_dtype=jnp.bfloat16, p_dtype=jnp.bfloat16, **HYPER)

    def to_port(a, dtype=torch.float32):
        a = _t(a, dtype)
        return {i: leaf.from_jax(a[k] if leaf.stacked else a).contiguous()
                for k, i in enumerate(leaf.members)}

    fnu = fu.FactoredNu(row=torch.from_numpy(row), col=torch.from_numpy(col), leaf=leaf)
    params = to_port(g, torch.bfloat16)  # overwritten by the update
    state = fu.FusedAdamWEmaState(count=1, mu=to_port(m, torch.bfloat16), nu={},
                                  master=to_port(w))
    ema = to_port(e)
    w0, e0 = to_port(w), to_port(e)
    tb1, tb2 = fu.bias_corrections(2, 0.9, 0.999)
    fu._apply_factored(fnu, to_port(g, torch.bfloat16), params, state, ema, tb1, tb2, HYPER)

    assert tuple(fnu.row.shape) == want[2].row.shape and tuple(fnu.col.shape) == want[2].col.shape
    for got, ref in ((fnu.row, want[2].row), (fnu.col, want[2].col)):
        ref = _np(ref)
        assert np.abs(got.numpy() - ref).max() <= FACTORED_RTOL * np.abs(ref).max()
    want_p, want_m, want_w, want_e = (to_port(want[i]) for i in (0, 1, 3, 4))
    for i in leaf.members:
        assert torch.equal(state.mu[i].float(), want_m[i])  # no reduction in m: exact
        _step_close(state.master[i], (w0[i], want_w[i]))
        _step_close(ema[i], (e0[i], want_e[i]))
        # a bf16 parameter rounds the master: equal, or one bf16 ulp where the
        # masters straddle a rounding boundary
        ulp = 2.0 ** (torch.floor(torch.log2(want_p[i].abs() + 1e-30)) - 7)
        assert ((params[i].float() - want_p[i]).abs() <= ulp).all()


def _small_jax_tree(seed=0):
    from fast_dit_tpu.models import DiT as JaxDiT
    params = JaxDiT(**SMALL).init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 4, 8, 8)),
                                  jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))
    return jax.tree.map(lambda p: p.astype(jnp.bfloat16), params)


def _to_port(tree, names):
    from fast_dit_torch.ckpt import flax_params_to_state_dict
    sd = flax_params_to_state_dict(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                                                tree), SMALL["patch_size"], 4, SMALL["input_size"])
    return [sd[n] for n in names]


def test_two_whole_state_steps_match_jax():
    # one test for the three kinds: the eager JAX ops compile once per process
    for kind in ("bf16-nu", "factored", "factored-bf16-nu"):
        _two_whole_state_steps(kind)


def _two_whole_state_steps(kind):
    """A small DiT's whole tree, two steps of `fused_adamw_ema_apply` on each
    side (JAX's XLA sweep, eagerly): the factored row and col to FACTORED_RTOL,
    mu and the dense nu to 1 ulp, the master and EMA steps to FACTORED_RTOL
    of themselves plus an ulp (sqrt and division may round apart, as in
    test_fused_init_apply_match_jax_over_three_steps)."""
    from fast_dit_torch.ckpt import jax_leaves
    nu_bf16, factored = "bf16" in kind, "factored" in kind
    p16 = _small_jax_tree()
    jstate = jfu.fused_adamw_ema_init(p16, mu_dtype=jnp.bfloat16,
                                      nu_dtype=jnp.bfloat16 if nu_bf16 else jnp.float32,
                                      factored=factored)
    jema = jax.tree.map(lambda p: p.astype(jnp.float32), p16)
    jparams = p16
    model = _small_port_model()
    names = [n for n, _ in model.named_parameters()]
    tparams = [t.to(torch.bfloat16) for t in _to_port(p16, names)]
    state = fu.fused_adamw_ema_init(tparams, nu_dtype=torch.bfloat16 if nu_bf16 else
                                    torch.float32, factored=factored, leaves=jax_leaves(model))
    ema = [w.clone() for w in state.master]
    n_factored = sum(isinstance(v, fu.FactoredNu) for v in state.nu)
    assert fu.nu_kind(state) == ("factored" if factored else "bfloat16")
    if factored:  # both kinds occur; proj (2 x 3 x 64 x 192) is factored as a stacked leaf
        assert 0 < n_factored < len(tparams)
        assert any(v.leaf.path == "blocks/block/attn/proj/kernel" for v in state.nu
                   if isinstance(v, fu.FactoredNu))
    kw = dict(lr=HYPER["lr"], ema_decay=HYPER["ema_decay"])
    paths = {"master": [_to_port(jstate.master, names)], "ema": [_to_port(jema, names)]}
    for i in range(2):
        grads = jax.tree.map(lambda p: (0.1 * jax.random.normal(
            jax.random.PRNGKey(100 + i), p.shape)).astype(jnp.bfloat16), p16)
        jparams, jstate, jema = jfu.fused_adamw_ema_apply(jstate, grads, jparams, jema, **kw)
        paths["master"].append(_to_port(jstate.master, names))
        paths["ema"].append(_to_port(jema, names))
        fu.fused_adamw_ema_apply(state, [g.to(torch.bfloat16) for g in _to_port(grads, names)],
                                 tparams, ema, **kw)
    assert state.count == int(jstate.count) == 2
    is_fnu = lambda n: isinstance(n, jfu.FactoredNu)
    jnu = {"/".join(str(getattr(k, "key", k)) for k in path[1:]): leaf for path, leaf in
           jax.tree_util.tree_flatten_with_path(jstate.nu, is_leaf=is_fnu)[0]}
    for v in {id(v): v for v in state.nu if isinstance(v, fu.FactoredNu)}.values():
        ref = jnu[v.leaf.path]
        for got, want in ((v.row, ref.row), (v.col, ref.col)):
            want = _np(want)
            assert np.abs(got.numpy() - want).max() <= FACTORED_RTOL * np.abs(want).max()
    dense_nu = _to_port(jax.tree.map(lambda a: jnp.zeros(()) if is_fnu(a) else a, jstate.nu,
                                     is_leaf=is_fnu), names) if not factored else None
    for n, g, w in zip(names, state.mu, _to_port(jstate.mu, names)):
        assert _ulps(g.float().numpy(), w.numpy()) <= 1, n
    # a step that agrees to an ulp of itself is many ulps of a master near 0,
    # so masters and EMA are held relative to the steps they took
    for name, got in (("master", state.master), ("ema", ema)):
        for i, g in enumerate(got):
            _step_close(g, [p[i] for p in paths[name]], steps=2)
    if dense_nu is not None:
        for n, g, w in zip(names, state.nu, dense_nu):
            assert g.dtype == torch.bfloat16 and _ulps(g.float().numpy(), w.numpy()) <= 1, n
