"""The train step's `model_call` hook and extra batch keys
(fast_dit_torch/train/train_lib.py) with the NVS model, against JAX's
`make_train_step(..., model_call=...)` (`fast_dit_tpu/train/train_lib.py:
128,147-153,164-168,181`), and on a mesh of two gloo ranks against one
process.

The model is tests/test_torch_nvs.py's narrow DiTNVS (cross-attention at
layer 1 of 3) at class_dropout_prob 0 (flax derives the label-drop key
inside `make_rng`, which torch cannot reproduce), with t and noise drawn
from the JAX step's own key splits and injected (tests/test_torch_train.py
`_jax_draws`). Weight decay is 0.1, so the cross-attention leaves of the
two layers that skip the branch, whose gradient is zero, move by weight
decay alone. Tolerances as in tests/test_torch_train.py: losses 1e-5
relative, the gradients (read from JAX's first moment, (1 - b1) g after
one step) within 1e-4 of each leaf's largest (the timestep MLP 2e-3),
parameters 2 lr a step (bf16 parameters also one bf16 ulp), the
EMA (1 - decay) of that; the skipped leaves 1e-6 relative (a product and a
sum rounded apart from JAX's), the world JAX's sharded-step limits
(tests/test_torch_world.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_nvs import CFG, jax_nvs_params, port_nvs
from test_torch_train import _jax_draws
from test_torch_world import (assert_metrics_close, assert_replicas_equal,  # noqa: F401
                              assert_trees_close, drop_tmp_path, nvs_model_call,
                              spawn_world, train_route)

from fast_dit_tpu.diffusion import create_diffusion as jax_create_diffusion
from fast_dit_tpu.ops.fused_update import fused_adamw_ema_init as jax_fused_init
from fast_dit_tpu.train.train_lib import TrainState as JaxTrainState
from fast_dit_tpu.train.train_lib import make_train_step as jax_make_train_step
from fast_dit_torch.ckpt import flax_params_to_state_dict
from fast_dit_torch.diffusion import create_diffusion
from fast_dit_torch.models import DiT
from fast_dit_torch.train import create_train_state, make_train_step

LR, WD, DECAY, B = 1e-4, 0.1, 0.9999, 4
LOSS_RTOL, GRAD_RTOL, T_EMB_RTOL = 1e-5, 1e-4, 2e-3
SKIPPED = ("blocks.0.cross_attn.", "blocks.2.cross_attn.")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sd(tree):
    sd = flax_params_to_state_dict(jax.tree.map(np.asarray, tree), 2, 4, 8)
    return {k: v.numpy() for k, v in sd.items() if k != "pos_embed"}


def _batch(seed=8):
    rs = np.random.RandomState(seed)
    return {"x": rs.randn(B, 4, 8, 8).astype(np.float32),
            "y": rs.randint(0, 10, size=B).astype(np.int32),
            "dino_feat": rs.randn(B, CFG["dino_dim"], 4, 4).astype(np.float32)}


@pytest.mark.parametrize("route,grad_accum", [("default", 1), ("fused", 1), ("default", 2)],
                         ids=["adamw", "fused-optimizer", "grad-accum-2"])
def test_model_call_step_matches_jax(route, grad_accum):
    fused = route == "fused"
    jmodel, params = jax_nvs_params(class_dropout_prob=0.0)
    if fused:
        p16 = jax.tree.map(lambda p: jnp.asarray(p, jnp.bfloat16), params)
        opt = jax_fused_init(p16, mu_dtype=jnp.bfloat16)
        jstate, tx = JaxTrainState(step=jnp.zeros((), jnp.int32), params=p16,
                                   ema=jax.tree.map(jnp.copy, opt.master), opt_state=opt), None
    else:
        tx = optax.adamw(LR, weight_decay=WD)
        jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                               ema=jax.tree.map(jnp.copy, params), opt_state=tx.init(params))

    def jax_call(p, x_t, t, b, r):
        return jmodel.apply(p, x_t, t, b["dino_feat"], b["y"], train=True,
                            rngs={"label_drop": r})

    jstep = jax.jit(jax_make_train_step(jmodel, jax_create_diffusion("").schedule, tx,
                                        ema_decay=DECAY, grad_accum=grad_accum, lr=LR,
                                        weight_decay=WD, model_call=jax_call))
    model = port_nvs(params, class_dropout_prob=0.0)
    state = create_train_state(model, lr=None if fused else LR,
                               weight_decay=None if fused else WD, fused_optimizer=fused)
    step = make_train_step(model, create_diffusion("", device="cpu").schedule, ema_decay=DECAY,
                           grad_accum=grad_accum, lr=LR, weight_decay=WD,
                           model_call=nvs_model_call(model))
    batch = _batch()
    before = {n: p.detach().float().clone() for n, p in model.named_parameters()}
    rng = jax.random.PRNGKey(0)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    tb = {k: torch.from_numpy(v.astype(np.int64) if k == "y" else v) for k, v in batch.items()}
    m = step(state, tb, draws=_jax_draws(rng, 0, grad_accum))
    for k in ("loss", "mse", "vb"):
        assert abs(m[k].item() - float(jm[k])) <= LOSS_RTOL * abs(float(jm[k])) + 1e-7, k

    if route == "default" and grad_accum == 1:
        mu = _sd(jstate.opt_state[0].mu)  # optax.adamw: scale_by_adam first
        for n, p in model.named_parameters():
            rtol = T_EMB_RTOL if n.startswith("t_embedder.") else GRAD_RTOL
            # a key bias moves every logit of a row alike, so softmax cancels
            # its gradient to rounding noise of 1e-13 on both sides: a floor
            scale = max(np.abs(mu[n]).max(), 1e-8)
            assert np.abs(0.1 * p.grad.numpy() - mu[n]).max() <= rtol * scale, n
        assert model.blocks[1].cross_attn.to_k.weight.grad.abs().max() > 0

    bound = 2 * LR
    want_p, want_e = _sd(jstate.params), _sd(jstate.ema)
    for n, p in model.named_parameters():
        got, want = p.detach().float().numpy(), want_p[n]
        if n.startswith(SKIPPED):
            assert p.grad is not None and not p.grad.any(), n  # zero-filled, not None
            master = (state.opt.master[list(state.ema).index(n)].numpy() if fused else got)
            want_m = _sd(jstate.opt_state.master)[n] if fused else want
            assert np.abs(master - want_m).max() <= 1e-6 * np.abs(want_m).max(), n
            # weight decay alone moved it, as in JAX
            assert not np.array_equal(master, before[n].numpy()), n
            continue
        ulp = 0 if not fused else 2.0 ** (np.floor(np.log2(np.abs(want) + 1e-30)) - 7)
        assert (np.abs(got - want) <= np.maximum(bound, ulp)).all(), n
    for n in want_e:
        assert np.abs(state.ema[n].numpy() - want_e[n]).max() <= (1 - DECAY) * bound + 1e-6, n


def test_model_call_is_refused_with_a_moe_model_and_short_keys():
    moe = DiT(input_size=8, hidden_size=32, depth=1, num_heads=2, num_classes=10, moe_experts=4,
              device="cpu")
    sched = create_diffusion("", device="cpu").schedule
    with pytest.raises(ValueError, match="MoE model would silently drop the routing aux"):
        make_train_step(moe, sched, model_call=lambda *a: None)
    model = port_nvs(jax_nvs_params()[1])
    state = create_train_state(model)
    step = make_train_step(model, sched, model_call=nvs_model_call(model))
    tb = {k: torch.from_numpy(v) for k, v in _batch().items()}
    tb["y"] = tb["y"].long()
    tb["dino_feat"] = tb["dino_feat"][:2]
    with pytest.raises(ValueError, match=r"\['dino_feat'\] do not have the 4 rows"):
        step(state, tb)


def _nvs_route(name, step=None, tp=False, fsdp=False):
    rs = np.random.RandomState(9)
    cfg = dict(CFG, num_heads=2)
    return {"name": name, "model": cfg, "state": {}, "step": step or {}, "tp": tp,
            "fsdp": fsdp, "inner": ("model", 2 if tp else 1), "seed": 5,
            "batches": [{"x": rs.randn(8, 4, 8, 8).astype(np.float32),
                         "y": rs.randint(0, 10, size=8).astype(np.int64),
                         "dino_feat": rs.randn(8, CFG["dino_dim"], 4, 4).astype(np.float32)}
                        for _ in range(2)]}


def test_ditnvs_on_a_mesh_of_two_equals_one_process(tmp_path):
    """Data parallelism with grad-accum 2 (the DINO features split by rows
    with x and y, all-gathered into global microbatches), FSDP and tensor
    parallelism (the cross-attention replicated, as JAX's rules leave it)
    on two gloo ranks, against one process on the global batch, 2 steps."""
    routes = [_nvs_route("dp2_accum2", {"grad_accum": 2}), _nvs_route("fsdp2", fsdp=True),
              _nvs_route("tp2", tp=True)]
    res = spawn_world(2, "run_routes", tmp_path, routes=routes)
    for route in routes:
        ranks = [r[route["name"]] for r in res]
        want = train_route(route, mesh=None)
        for r in ranks:
            assert_metrics_close(r["metrics"], want["metrics"])
        assert_trees_close({k: ranks[0]["tree"][k] for k in ("model", "ema", "opt")},
                           {k: want["tree"][k] for k in ("model", "ema", "opt")}, steps=2)
        assert_replicas_equal(ranks)
