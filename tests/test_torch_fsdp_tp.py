"""FSDP, tensor parallelism and both together: gloo worlds against one
process on the global batch after 2 steps (`parallel/mesh.py shard_params`,
`train/train_lib.py make_sharded_train_step`), and TP against JAX's
`make_sharded_train_step` on a model=2 CPU mesh.

- FSDP 2 and TP 2 run in one world of 2 ranks, TP 2 + FSDP in a world of 4
  (data 2 x model 2), over the optimizer routes, nu kinds, remat policies,
  grad-accum 2 and the loss-second-moment sampler; TP also on a MoE model,
  whose experts split over the model axis as in JAX, and FSDP on a model
  deep enough that FSDP picks the layer axis of a leaf (whole blocks per
  rank). Compared as in `tests/test_torch_data_parallel.py`, to its limits.
- Ranks that hold the same part of a parameter hold it bit for bit equal:
  a replicated leaf (adaLN, the embedders, the final layer, proj's and fc2's
  biases under TP) comes out equal on every rank of a model group, which a
  missing all-reduce in a backward would break.
- Each rank holds 1/n of every split leaf: its parameters are the full
  ones divided by the split, and its state's bytes are the one process's
  over the split (FSDP 2 with every leaf even: exactly half, on the routes
  with a dense nu).
- FSDP is held to JAX transitively: world == one process here, one process
  == JAX in `tests/test_torch_train.py`, and JAX's FSDP == JAX's one
  device in `tests/test_parallel.py`.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_data_parallel import _jax_params, jax_draws, jax_sharded_run, jax_state_dict
from test_torch_world import (ATOL, LOSS_ATOL, LOSS_RTOL, RTOL, assert_metrics_close,  # noqa: F401
                              assert_replicas_equal, assert_trees_close, batches, drop_tmp_path,
                              one_torch_thread, shared_world, spawn_world, train_route)

CFG = dict(input_size=8, patch_size=2, hidden_size=128, depth=2, num_heads=4, num_classes=10,
           remat=True)
MOE = dict(CFG, moe_experts=4, moe_top_k=2)
# hd 8 at depth 8: FSDP splits the qkv bias (8, 3, 2, 8) on its layer axis
DEEP = dict(CFG, hidden_size=16, depth=8, num_heads=2)
B, STEPS = 8, 2

FUSED_FACTORED = {"fused_optimizer": True, "factored_nu": True}
# (name, model, mesh, options)
WORLD2 = [
    ("fsdp-adamw", CFG, ("model", 1), {"fsdp": True}),
    ("fsdp-adamw-remat-attn", dict(CFG, remat_policy="attn"), ("model", 1), {"fsdp": True}),
    ("fsdp-fused-factored-remat-attn_mlp", dict(CFG, remat_policy="attn_mlp"), ("model", 1),
     {"fsdp": True, "state": FUSED_FACTORED}),
    ("fsdp-fused-nu-bf16", CFG, ("model", 1),
     {"fsdp": True, "state": {"fused_optimizer": True, "nu_dtype": torch.bfloat16}}),
    ("fsdp-mixed-precision-grad-accum-2", CFG, ("model", 1),
     {"fsdp": True, "state": {"mixed_precision": True}, "step": {"grad_accum": 2}}),
    ("fsdp-layer-axis", DEEP, ("model", 1), {"fsdp": True}),
    ("tp-adamw", CFG, ("model", 2), {"tp": True}),
    ("tp-adamw-no-remat", dict(CFG, remat=False), ("model", 2), {"tp": True}),
    ("tp-fused-factored", CFG, ("model", 2), {"tp": True, "state": FUSED_FACTORED}),
    ("tp-flow-grad-accum-2", dict(CFG, learn_sigma=False), ("model", 2),
     {"tp": True, "step": {"objective": "flow", "grad_accum": 2}}),
    ("tp-moe", MOE, ("model", 2), {"tp": True}),
]
WORLD4 = [
    ("tp-fsdp-adamw", CFG, ("model", 2), {"tp": True, "fsdp": True}),
    ("tp-fsdp-fused-factored", CFG, ("model", 2),
     {"tp": True, "fsdp": True, "state": FUSED_FACTORED}),
    ("tp-fsdp-loss-second-moment-grad-accum-2", CFG, ("model", 2),
     {"tp": True, "fsdp": True, "lsm": True, "step": {"grad_accum": 2}}),
]


def _route(name, cfg, inner, opts, seeded):
    rs = np.random.RandomState(9)
    route = {"name": f"{name}-{'seeded' if seeded else 'injected'}", "model": cfg,
             "inner": inner, "tp": opts.get("tp", False), "fsdp": opts.get("fsdp", False),
             "state": opts.get("state", {}), "step": opts.get("step", {}),
             "batches": batches(rs, B, STEPS), "seed": 5}
    if opts.get("lsm"):
        route["sampler"] = rs.rand(1000, 10).astype(np.float32)
    if not seeded:
        accum = route["step"].get("grad_accum", 1)
        flow = route["step"].get("objective") == "flow"
        mb = B // accum
        route["draws"] = [[{
            "t": (rs.rand(mb).astype(np.float32) if flow
                  else rs.randint(1, 1000, size=mb).astype(np.int64)),
            "noise": rs.randn(mb, 4, 8, 8).astype(np.float32),
            "force_drop_ids": (rs.rand(mb) < 0.25).astype(np.int64)}
            for _ in range(accum)] for _ in range(STEPS)]
    return route


def _cases(table):
    return [(name, seeded) for name, *_ in table for seeded in (False, True)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for n, table in ((2, WORLD2), (4, WORLD4)):
        routes = [_route(name, cfg, inner, opts, seeded) for name, cfg, inner, opts in table
                  for seeded in (False, True)]
        res = shared_world(tmp_path_factory, f"fsdp-tp-{n}", n, "run_routes", routes=routes)
        out.update({r["name"]: (r, [res[k][r["name"]] for k in range(n)]) for r in routes})
    return out


CASES = _cases(WORLD2) + _cases(WORLD4)


@pytest.mark.parametrize("name,seeded", CASES,
                         ids=[f"{n}-{'seeded' if s else 'injected'}" for n, s in CASES])
def test_world_equals_one_process(worlds, name, seeded):
    route, ranks = worlds[f"{name}-{'seeded' if seeded else 'injected'}"]
    want = train_route(route, mesh=None)
    bf16_grads = bool(route["state"])
    for res in ranks:
        assert_metrics_close(res["metrics"], want["metrics"], bf16_grads)
    got = ranks[0]["tree"]
    assert all(r["tree"] is None for r in ranks[1:])
    assert_trees_close({k: got[k] for k in ("model", "ema", "opt")},
                       {k: want["tree"][k] for k in ("model", "ema", "opt")}, bf16_grads,
                       STEPS)
    assert_replicas_equal(ranks)
    if route.get("sampler") is not None:
        assert all(torch.equal(ranks[0]["sampler"], r["sampler"]) for r in ranks[1:])
    # each rank holds its share of every split leaf, and no more
    n = len(ranks)
    if route["fsdp"] and not route["tp"] and name != "fsdp-layer-axis":
        assert all(s == n for s in ranks[0]["split"].values())  # every leaf is even
        # (a factored nu's row or col keeps the whole of an axis that the
        # split leaf reduces away, so only the dense routes halve exactly)
        if not route["state"].get("factored_nu"):
            assert all(2 * r["state_bytes"] == want["state_bytes"] for r in ranks)
    if name == "fsdp-layer-axis":
        # whole blocks of the qkv bias: each rank holds four of the eight
        held = [[r["local"][f"blocks.{b}.attn.qkv.bias"].numel() > 0 for b in range(8)]
                for r in ranks]
        assert held == [[True] * 4 + [False] * 4, [False] * 4 + [True] * 4]
    for r in ranks:
        assert r["state_bytes"] < want["state_bytes"]


def test_tp_matches_jax_sharded_step_on_a_model_mesh(tmp_path):
    """JAX's draws injected into a world of 2 with --tp 2; JAX's AdamW step
    with tp=True on a model=2 mesh. Losses and gradient norm to JAX's limits,
    parameters and EMA to rtol 2e-3 / atol 2e-5."""
    cfg = {k: v for k, v in CFG.items() if k != "remat"}
    jmodel, params = _jax_params(cfg=cfg, remat=True)
    weights = jax_state_dict(params)
    bs = batches(np.random.RandomState(4), B, STEPS)
    rng = jax.random.PRNGKey(6)
    jm, jstate = jax_sharded_run(jmodel, params, 1, 2, True, False, B, rng,
                                 [{"x": b["x"], "y": b["y"].astype(np.int32)} for b in bs])
    route = {"name": "jax", "model": dict(CFG, class_dropout_prob=0.0), "inner": ("model", 2),
             "tp": True, "weights": weights, "batches": bs,
             "draws": [jax_draws(rng, s, B) for s in range(STEPS)]}
    ranks = spawn_world(2, "run_routes", tmp_path, routes=[route])
    got = ranks[0]["jax"]
    for g, w in zip(got["metrics"], jm):
        for k in ("loss", "mse", "vb", "grad_norm"):
            assert abs(g[k] - w[k]) <= LOSS_ATOL + LOSS_RTOL * abs(w[k]), (k, g[k], w[k])
    for key, tree in (("model", jstate.params), ("ema", jstate.ema)):
        for n, w in jax_state_dict(tree).items():
            assert torch.allclose(got["tree"][key][n], w, rtol=RTOL, atol=ATOL), (key, n)
    assert_replicas_equal([r["jax"] for r in ranks])
