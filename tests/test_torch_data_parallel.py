"""Data parallelism: a gloo world of 2 ranks, each with half the global
batch, against one process on the whole global batch, after 2 steps
(`fast_dit_torch/train/train_lib.py make_sharded_train_step`), and the world
against JAX's `make_sharded_train_step` on a data=2 CPU mesh.

The routes: AdamW, `--mixed-precision`, the fused optimizer with fp32, bf16
and factored nu, grad-accum 2, flow matching and the loss-second-moment t
sampler (warmed up), each once with the draws injected and once drawn from
the seeded generator (every rank draws the global batch's and keeps its
rows). Compared: the losses and their terms, the gradient norm, and every
tensor of the checkpoint tree (parameters or fp32 master, EMA, and every
optimizer moment), gathered from the ranks; the sampler's buffers.

Limits are JAX's own for its sharded step (`tests/test_parallel.py:116-123`):
losses and the gradient norm rtol 2e-4 / atol 2e-5, and on the fp32 routes
(AdamW, grad-accum 2, flow, loss-second-moment) every tensor rtol 2e-3 /
atol 2e-5, elementwise. Measured: losses within 2e-6 relative, tensors
within 6e-7 absolute.

The bf16 routes (`--mixed-precision`, the fused optimizer) keep bf16
parameters, so each rank's gradient is rounded to bf16 before the ranks sum
it, where one process rounds the sum once. Where a gradient nearly cancels
between the two halves of the batch the two sides then hold different bf16
gradients, and Adam moves a parameter by about +-lr whatever the size of its
gradient: the limit of `tests/test_torch_train.py` for bf16 parameters holds,
2 lr a step on the master and the parameters, (1 - decay) of that on the
EMA, and at most 0.1 % of the elements may pass JAX's rtol/atol; an
optimizer moment may differ by two bf16 steps of its leaf's largest value
(one in the gradient it folds in, one in its own rounding). Measured: at
most 1.2e-4 (about lr) on 1 to 3 elements of a master, 1.2e-4 on a mu whose
largest value is 1.8e-2 (one bf16 step there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_world import (ATOL, RTOL, assert_metrics_close, assert_replicas_equal,  # noqa: F401
                              assert_trees_close, batches, drop_tmp_path, one_torch_thread,
                              shared_world, spawn_world, train_route)

from fast_dit_tpu.diffusion import create_diffusion as jax_create_diffusion
from fast_dit_tpu.models import DiT as JaxDiT
from fast_dit_tpu.parallel import batch_sharding as jax_batch_sharding
from fast_dit_tpu.parallel import create_expert_mesh as jax_create_expert_mesh
from fast_dit_tpu.parallel import create_mesh as jax_create_mesh
from fast_dit_tpu.train.train_lib import TrainState as JaxTrainState
from fast_dit_tpu.train.train_lib import make_sharded_train_step as jax_sharded_step
from fast_dit_torch.ckpt import flax_params_to_state_dict

CFG = dict(input_size=8, patch_size=2, hidden_size=128, depth=2, num_heads=4, num_classes=10)
B, STEPS = 8, 2
LOSS_RTOL, LOSS_ATOL = 2e-4, 2e-5

ROUTES = {
    "adamw": {},
    "mixed_precision": {"state": {"mixed_precision": True}},
    "fused_nu_fp32": {"state": {"fused_optimizer": True}},
    "fused_nu_bf16": {"state": {"fused_optimizer": True, "nu_dtype": torch.bfloat16}},
    "fused_factored_nu": {"state": {"fused_optimizer": True, "factored_nu": True}},
    "grad_accum_2": {"step": {"grad_accum": 2}},
    "flow": {"step": {"objective": "flow"}, "flow": True},
    "loss_second_moment": {"lsm": True},
}


def _route(name, seeded):
    spec = ROUTES[name]
    rs = np.random.RandomState(7)
    cfg = dict(CFG, learn_sigma=not spec.get("flow"))
    route = {"name": f"{name}-{'seeded' if seeded else 'injected'}", "model": cfg,
             "state": spec.get("state", {}), "step": spec.get("step", {}),
             "batches": batches(rs, B, STEPS), "seed": 11}
    if spec.get("lsm"):
        route["sampler"] = rs.rand(1000, 10).astype(np.float32)
    if not seeded:
        accum = route["step"].get("grad_accum", 1)
        mb = B // accum
        route["draws"] = [[{
            "t": (rs.rand(mb).astype(np.float32) if spec.get("flow")
                  else rs.randint(1, 1000, size=mb).astype(np.int64)),
            "noise": rs.randn(mb, 4, 8, 8).astype(np.float32),
            "force_drop_ids": (rs.rand(mb) < 0.25).astype(np.int64),
            **({"weights": rs.uniform(0.5, 2.0, size=mb).astype(np.float32)}
               if spec.get("lsm") else {})} for _ in range(accum)] for _ in range(STEPS)]
    return route


CASES = [(name, seeded) for name in ROUTES for seeded in (False, True)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    routes = [_route(n, s) for n, s in CASES]
    res = shared_world(tmp_path_factory, "dp", 2, "run_routes", routes=routes)
    return {r["name"]: (r, [res[k][r["name"]] for k in range(2)]) for r in routes}


@pytest.mark.parametrize("name,seeded", CASES,
                         ids=[f"{n}-{'seeded' if s else 'injected'}" for n, s in CASES])
def test_world_of_two_equals_one_process(world, name, seeded):
    route, ranks = world[f"{name}-{'seeded' if seeded else 'injected'}"]
    want = train_route(route, mesh=None)
    bf16_grads = bool(route["state"])  # the mixed-precision and fused routes
    # every rank's metrics are the global ones
    for res in ranks:
        assert_metrics_close(res["metrics"], want["metrics"], bf16_grads)
    got = ranks[0]["tree"]
    assert ranks[1]["tree"] is None  # rank 0 alone holds the gathered file tree
    assert got["step"] == want["tree"]["step"] == STEPS
    assert_trees_close({k: got[k] for k in ("model", "ema", "opt")},
                       {k: want["tree"][k] for k in ("model", "ema", "opt")}, bf16_grads,
                       STEPS)
    assert_replicas_equal(ranks)
    if route.get("sampler") is not None:
        # both ranks fold the global batch's pairs in: equal buffers, and
        # those of one process
        h0, h1 = ranks[0]["sampler"], ranks[1]["sampler"]
        assert torch.equal(h0, h1)
        assert torch.allclose(h0, want["tree"]["sampler"]["loss_history"], rtol=RTOL,
                              atol=ATOL)
    if seeded:  # the generator's state is the one global stream's
        assert torch.equal(got["rng"], want["tree"]["rng"])


def _jax_params(seed=0, cfg=CFG, **kw):
    model = JaxDiT(**cfg, class_dropout_prob=0.0, attn_backend="xla", **kw)
    params = model.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 4, 8, 8)),
                        jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))
    rs = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda p: jnp.asarray(np.asarray(p) + 0.02 * rs.randn(*p.shape).astype(np.float32)),
        params)
    return model, params


def jax_draws(rng, step, n, grad_accum=1):
    """t and noise of the global batch as JAX's step draws them
    (`train_lib.py:216-231,239,256`), one dict per microbatch."""
    r = jax.random.fold_in(rng, step)
    mb = n // grad_accum
    out = []
    for i in range(grad_accum):
        ri = r if grad_accum == 1 else jax.random.fold_in(r, i)
        rt, rn, _ = jax.random.split(ri, 3)
        out.append({"t": np.asarray(jax.random.randint(rt, (mb,), 0, 1000)).astype(np.int64),
                    "noise": np.asarray(jax.random.normal(rn, (mb, 4, 8, 8), jnp.float32))})
    return out


def jax_sharded_run(jmodel, params, data, model, tp, fsdp, bs, rng, jbatches, step_kw=None,
                    expert=False):
    """JAX's sharded AdamW step on a (data, model) mesh of the CPU devices,
    or a (data, expert) one: (metrics per step, final state)."""
    tx = optax.adamw(1e-4, weight_decay=0.0)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          ema=jax.tree.map(jnp.copy, params), opt_state=tx.init(params))
    devices = jax.devices()[:data * model]
    mesh = (jax_create_expert_mesh(model, data=data, devices=devices) if expert else
            jax_create_mesh(data=data, model=model, devices=devices))
    step, st_sh = jax_sharded_step(jmodel, jax_create_diffusion("").schedule, tx, mesh, tp=tp,
                                   fsdp=fsdp, example_state=state, log_grad_norm=True,
                                   **(step_kw or {}))
    state = jax.device_put(state, st_sh)
    ms = []
    for b in jbatches:
        sb = jax.device_put({"x": jnp.asarray(b["x"]), "y": jnp.asarray(b["y"])},
                            {"x": jax_batch_sharding(mesh), "y": jax_batch_sharding(mesh)})
        state, m = step(state, sb, rng)
        ms.append({k: float(v) for k, v in m.items()})
    return ms, jax.device_get(state)


def jax_state_dict(tree, cfg=CFG):
    sd = flax_params_to_state_dict(jax.tree.map(np.asarray, tree), cfg["patch_size"], 4,
                                   cfg["input_size"])
    return sd


def test_world_of_two_matches_jax_sharded_step_on_a_data_mesh(tmp_path):
    """JAX's draws injected into the world of 2; JAX's AdamW step sharded
    over data=2. Losses and gradient norm to JAX's limits; parameters and
    EMA elementwise to rtol 2e-3 / atol 2e-5 (measured: 1.9e-7 relative in
    the losses, parameters within 3e-8)."""
    jmodel, params = _jax_params()
    weights = jax_state_dict(params)  # before the sharded step donates them
    rs = np.random.RandomState(3)
    bs = batches(rs, B, STEPS)
    rng = jax.random.PRNGKey(5)
    jm, jstate = jax_sharded_run(jmodel, params, 2, 1, False, False, B, rng,
                                 [{"x": b["x"], "y": b["y"].astype(np.int32)} for b in bs])
    route = {"name": "jax", "model": dict(CFG, class_dropout_prob=0.0),
             "weights": weights, "batches": bs,
             "draws": [jax_draws(rng, s, B) for s in range(STEPS)]}
    ranks = spawn_world(2, "run_routes", tmp_path, routes=[route])
    got = ranks[0]["jax"]
    for g, w in zip(got["metrics"], jm):
        for k in ("loss", "mse", "vb", "grad_norm"):
            assert abs(g[k] - w[k]) <= LOSS_ATOL + LOSS_RTOL * abs(w[k]), (k, g[k], w[k])
    for key, tree in (("model", jstate.params), ("ema", jstate.ema)):
        want = jax_state_dict(tree)
        for n, w in want.items():
            g = got["tree"][key][n]
            assert torch.allclose(g, w, rtol=RTOL, atol=ATOL), (key, n)
