"""Expert parallelism (`models/moe.py` under `parallel/mesh.py
shard_params`): a gloo world of 4 ranks, data 2 x expert 2, each expert rank
holding 2 of the 4 experts of a small DiT-MoE, with and without FSDP,
against one process on the global batch after 2 steps, and against JAX's
`make_sharded_train_step` on a data=2 x expert=2 CPU mesh.

- Every rank of an expert group routes the same tokens: the kept (choice,
  token) slots of each rank equal one process's for its rows.
- The load-balance loss is JAX's global one, E sum_e f_e p_e with f and p
  means over the whole batch (`fast_dit_tpu/models/moe.py:153-158`): the
  world's equals JAX's sharded step's, and a mean of per-rank products
  would be another number (shown on the same batch).
- Compared as in `tests/test_torch_data_parallel.py`, to its limits;
  replicated leaves (the router among them) bit for bit equal across ranks.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_data_parallel import _jax_params, jax_draws, jax_sharded_run, jax_state_dict
from test_torch_world import (ATOL, LOSS_ATOL, LOSS_RTOL, RTOL, assert_metrics_close,  # noqa: F401
                              assert_replicas_equal, assert_trees_close, batches, drop_tmp_path,
                              one_torch_thread, shared_world, small_model, spawn_world,
                              train_route)

CFG = dict(input_size=8, patch_size=2, hidden_size=64, depth=2, num_heads=4, num_classes=10,
           moe_experts=4, moe_top_k=2, remat=True)
B, STEPS = 8, 2
ROUTES = [
    ("ep", {}),
    ("ep-fsdp", {"fsdp": True}),
    ("ep-fsdp-fused-factored", {"fsdp": True,
                                "state": {"fused_optimizer": True, "factored_nu": True}}),
    ("ep-mixed-precision-grad-accum-2", {"state": {"mixed_precision": True},
                                         "step": {"grad_accum": 2}}),
]


def _route(name, opts, seeded):
    rs = np.random.RandomState(13)
    route = {"name": f"{name}-{'seeded' if seeded else 'injected'}", "model": CFG,
             "inner": ("expert", 2), "fsdp": opts.get("fsdp", False),
             "state": opts.get("state", {}), "step": opts.get("step", {}),
             "batches": batches(rs, B, STEPS), "seed": 3}
    if not seeded:
        accum = route["step"].get("grad_accum", 1)
        mb = B // accum
        route["draws"] = [[{"t": rs.randint(1, 1000, size=mb).astype(np.int64),
                            "noise": rs.randn(mb, 4, 8, 8).astype(np.float32),
                            "force_drop_ids": (rs.rand(mb) < 0.25).astype(np.int64)}
                           for _ in range(accum)] for _ in range(STEPS)]
    return route


CASES = [(name, seeded) for name, _ in ROUTES for seeded in (False, True)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    routes = [_route(name, opts, seeded) for name, opts in ROUTES for seeded in (False, True)]
    res = shared_world(tmp_path_factory, "ep", 4, "run_routes", routes=routes)
    return {r["name"]: (r, [res[k][r["name"]] for k in range(4)]) for r in routes}


@pytest.mark.parametrize("name,seeded", CASES,
                         ids=[f"{n}-{'seeded' if s else 'injected'}" for n, s in CASES])
def test_world_equals_one_process(world, name, seeded):
    route, ranks = world[f"{name}-{'seeded' if seeded else 'injected'}"]
    want = train_route(route, mesh=None)
    bf16_grads = bool(route["state"])
    for res in ranks:
        assert_metrics_close(res["metrics"], want["metrics"], bf16_grads)
    assert_trees_close({k: ranks[0]["tree"][k] for k in ("model", "ema", "opt")},
                       {k: want["tree"][k] for k in ("model", "ema", "opt")}, bf16_grads,
                       STEPS)
    assert_replicas_equal(ranks)
    # the same kept slots as one process, for each rank's rows
    rows = B // route["step"].get("grad_accum", 1) // 2
    for res in ranks:
        d = res["data_rank"]
        assert torch.equal(res["keep"], want["keep"][d * rows:(d + 1) * rows])
    # each expert rank holds half of the experts
    for res in ranks:
        assert res["local"]["blocks.0.mlp.wi"].shape[0] == 2 or route["fsdp"]
        assert res["split"]["blocks.0.mlp.wi"] == (4 if route["fsdp"] else 2)


def test_load_balance_is_global_and_matches_jax(tmp_path):
    """The world's load-balance loss, z-loss and dropped share equal JAX's
    sharded step's on a data=2 x expert=2 mesh (JAX's draws injected), and
    the parameters after 2 steps match to JAX's limits."""
    cfg = {k: v for k, v in CFG.items() if k != "remat"}
    jmodel, params = _jax_params(cfg=cfg, remat=True)
    weights = jax_state_dict(params, cfg)
    bs = batches(np.random.RandomState(8), B, STEPS)
    rng = jax.random.PRNGKey(2)
    jm, jstate = jax_sharded_run(jmodel, params, 2, 2, False, False, B, rng,
                                 [{"x": b["x"], "y": b["y"].astype(np.int32)} for b in bs],
                                 expert=True)
    route = {"name": "jax", "model": dict(CFG, class_dropout_prob=0.0),
             "inner": ("expert", 2), "weights": weights, "batches": bs,
             "draws": [jax_draws(rng, s, B) for s in range(STEPS)]}
    ranks = spawn_world(4, "run_routes", tmp_path, routes=[route])
    for res in ranks:
        for g, w in zip(res["jax"]["metrics"], jm):
            for k in ("loss", "grad_norm", "moe_load_balance", "moe_router_z",
                      "moe_dropped_frac"):
                assert abs(g[k] - w[k]) <= LOSS_ATOL + LOSS_RTOL * abs(w[k]), (k, g[k], w[k])
    got = ranks[0]["jax"]["tree"]
    for key, tree in (("model", jstate.params), ("ema", jstate.ema)):
        for n, w in jax_state_dict(tree, cfg).items():
            assert torch.allclose(got[key][n], w, rtol=RTOL, atol=ATOL), (key, n)


def test_a_mean_of_per_rank_products_is_another_number():
    """E sum_e f_e p_e over the global batch against the mean over the two
    data halves of the per-half products: they differ (here by more than ten times
    the limits above), which is why the port averages f and p over the
    data group before the product."""
    model = small_model(CFG)
    moe = model.blocks[0].mlp
    x = torch.from_numpy(np.random.RandomState(1).randn(B, 16, 64).astype(np.float32))

    def lb(x):
        _, aux = moe(x)
        return aux[0].item()

    whole = lb(x)
    halves = (lb(x[:B // 2]) + lb(x[B // 2:])) / 2
    assert abs(whole - halves) > 10 * (LOSS_ATOL + LOSS_RTOL * abs(whole))
