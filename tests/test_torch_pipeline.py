"""The port's GPipe pipeline (fast_dit_torch/parallel/pipeline.py) against the
JAX package's (fast_dit_tpu/parallel/pipeline.py), as tests/test_pipeline.py
holds JAX's.

A tiny DiT is made on the JAX side, its leaves replaced by 0.05 N(0, 1)
draws from a numpy seed (so the zero-initialised gates do not make the
blocks the identity), and carried into the port through
`flax_params_to_state_dict`. JAX's pipeline runs under `shard_map` on the
conftest's virtual CPU devices; the port's over `LocalStages(n)`, and over
`ProcessGroupStages` in gloo worlds of 2 and 4 processes that import no JAX,
whose ranks hold only their own blocks. All fp32; each test states its
tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_dit_tpu.models import DiT as JaxDiT
from fast_dit_tpu.parallel import create_pipeline_mesh
from fast_dit_tpu.parallel import dit_pipeline_forward as jax_pipeline_forward
from fast_dit_tpu.parallel import pipeline_apply as jax_pipeline_apply
from fast_dit_torch.ckpt import flax_params_to_state_dict
from fast_dit_torch.models import DiT
from fast_dit_torch.parallel import LocalStages, dit_pipeline_forward, pipeline_apply
from test_torch_world import (drop_tmp_path, one_torch_thread, pipeline_run,  # noqa: F401
                              spawn_world)

TINY = dict(input_size=8, patch_size=2, hidden_size=32, num_heads=4, num_classes=10)


def _jax_tiny(depth=8, seed=0):
    model = JaxDiT(**TINY, depth=depth, in_channels=4, attn_backend="einsum")
    params = model.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 4, 8, 8)),
                        jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))
    rs = np.random.RandomState(seed)
    params = jax.tree.map(lambda p: (0.05 * rs.randn(*p.shape)).astype(np.float32), params)
    return model, params


def _weights(params):
    return flax_params_to_state_dict(params, 2, 4, 8)


def _port_tiny(params, depth=8, **kw):
    model = DiT(**TINY, depth=depth, device="cpu", **kw)
    model.load_state_dict(_weights(params), strict=True)
    return model


def _inputs(B=4, seed=1):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, 4, 8, 8).astype(np.float32)
    t = (np.arange(B) * 137 % 1000).astype(np.int32)
    y = (np.arange(B) % 10).astype(np.int32)
    return x, t, y


class _Toy(torch.nn.Module):
    """tanh(x w + c): the toy block of tests/test_pipeline.py."""

    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w))

    def forward(self, x, c):
        return torch.tanh(x @ self.w + c[:, None, :])


def test_pipeline_apply_matches_the_sequential_blocks_and_jax():
    """As test_pipeline_apply_matches_scan: 8 toy blocks over 4 stages and 3
    microbatches equal the blocks applied in sequence (1e-6) and JAX's
    pipeline_apply on the same weights (1e-5: two matmul libraries)."""
    L, B, N, D = 8, 6, 4, 16
    rs = np.random.RandomState(0)
    ws = (0.2 * rs.randn(L, D, D)).astype(np.float32)
    x = rs.randn(B, N, D).astype(np.float32)
    c = rs.randn(B, D).astype(np.float32)
    blocks = [_Toy(w) for w in ws]
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    with torch.no_grad():
        got = pipeline_apply(blocks, xt, ct, LocalStages(4), 3)
        want = xt
        for block in blocks:
            want = block(want, ct)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    jax_got = jax_pipeline_apply(lambda w, xs, cs: jnp.tanh(xs @ w + cs[:, None, :]), ws, x, c,
                                 mesh=create_pipeline_mesh(4), num_microbatches=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_got), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_stages,microbatches", [(2, 2), (4, 4), (8, 2)])
def test_dit_pipeline_forward_matches_jax(n_stages, microbatches):
    """As test_dit_pipeline_forward_equivalence: the port's pipelined forward
    equals JAX's on the same mesh shape and the port's plain forward (1e-5)."""
    jmodel, params = _jax_tiny()
    x, t, y = _inputs()
    want = jax_pipeline_forward(jmodel, params, x, t, y, mesh=create_pipeline_mesh(n_stages),
                                num_microbatches=microbatches)
    model = _port_tiny(params)
    xt, tt, yt = map(torch.from_numpy, (x, t, y))
    with torch.no_grad():
        got = dit_pipeline_forward(model, xt, tt, yt, LocalStages(n_stages), microbatches)
        dense = model(xt, tt, yt)
    assert got.shape == (4, 8, 8, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5, atol=1e-5)


def _jax_grads(depth=4, n_stages=4, microbatches=2):
    jmodel, params = _jax_tiny(depth=depth)
    x, t, y = _inputs()
    mesh = create_pipeline_mesh(n_stages)

    def loss(p):
        return jnp.sum(jax_pipeline_forward(jmodel, p, x, t, y, mesh=mesh,
                                            num_microbatches=microbatches) ** 2)

    grads = jax.tree.map(np.asarray, jax.grad(loss)(params))
    return params, _weights(grads)


def test_pipeline_gradients_match_jax():
    """As test_pipeline_gradients_match: d sum(out^2) / d every parameter
    through LocalStages(4) with 2 microbatches equals JAX's gradient through
    its pipeline, mapped into the port's names by the same converter (rtol
    1e-4, atol 1e-5), and the port's plain model's gradient."""
    params, want = _jax_grads()
    x, t, y = map(torch.from_numpy, _inputs())
    runs = []
    for forward in (lambda m: dit_pipeline_forward(m, x, t, y, LocalStages(4), 2),
                    lambda m: m(x, t, y)):
        model = _port_tiny(params, depth=4)
        (forward(model) ** 2).sum().backward()
        runs.append({n: p.grad for n, p in model.named_parameters()})
    got, dense = runs
    assert len(got) == len(want) - 1  # pos_embed is a buffer
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
        torch.testing.assert_close(g, dense[name], rtol=1e-5, atol=1e-6, msg=name)


@pytest.mark.parametrize("option", [{"quant": "w8a8"}, {"tome_ratio": 0.5},
                                    {"moe_experts": 4}], ids=["quant", "tome", "moe"])
def test_pipeline_refuses_the_inexact_and_moe_options(option):
    """JAX's refusal (pipeline.py:141-146): dense DiT only."""
    model = DiT(**TINY, depth=4, device="cpu", **option)
    x, t, y = map(torch.from_numpy, _inputs())
    with pytest.raises(ValueError, match="exact-only dense-DiT"):
        dit_pipeline_forward(model, x, t, y, LocalStages(2), 2)


@pytest.mark.parametrize("n_stages,microbatches,match", [(3, 2, "depth 8 does not split"),
                                                         (2, 3, "batch 4 does not split")])
def test_pipeline_needs_divisible_depth_and_batch(n_stages, microbatches, match):
    model = DiT(**TINY, depth=8, device="cpu")
    x, t, y = map(torch.from_numpy, _inputs())
    with pytest.raises(ValueError, match=match):
        dit_pipeline_forward(model, x, t, y, LocalStages(n_stages), microbatches)


def test_process_stages_forward_equals_local_stages(tmp_path):
    """Four gloo ranks, one stage each (2 blocks), holding only their own
    blocks, no gradient: every rank's output equals LocalStages(4)'s (1e-6)
    and JAX's on a 4-stage mesh (1e-5)."""
    jmodel, params = _jax_tiny()
    inputs = _inputs(B=8, seed=3)
    weights = _weights(params)
    res = spawn_world(4, "pipeline_run", tmp_path, cfg=dict(TINY, depth=8), weights=weights,
                      inputs=inputs, microbatches=4, grad=False)
    local = pipeline_run(dict(TINY, depth=8), weights, inputs, 4, stages=LocalStages(4),
                         grad=False)["out"]
    want = jax_pipeline_forward(jmodel, params, *inputs, mesh=create_pipeline_mesh(4),
                                num_microbatches=4)
    for r in res:
        torch.testing.assert_close(r["out"], local, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(local.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_process_stages_gradients_equal_local_stages(tmp_path):
    """Two gloo ranks (2 blocks each of depth 4), the reverse schedule of
    `_StageStack`: each rank's block gradients, on its own blocks only,
    equal LocalStages(2)'s; the replicated parameters' gradients (the
    embedders and the final layer) come out whole and equal on both ranks
    (rtol 1e-5, atol 1e-6: the conditioning's gradient is summed over the
    stages in another order); and LocalStages(2)'s equal JAX's (rtol 1e-4,
    atol 1e-5)."""
    params, want = _jax_grads(n_stages=2)
    inputs = _inputs()
    weights = _weights(params)
    res = spawn_world(2, "pipeline_run", tmp_path, cfg=dict(TINY, depth=4), weights=weights,
                      inputs=inputs, microbatches=2)
    local = pipeline_run(dict(TINY, depth=4), weights, inputs, 2, stages=LocalStages(2))
    for rank, r in enumerate(res):
        torch.testing.assert_close(r["out"], local["out"], rtol=1e-6, atol=1e-6)
        blocks = {n for n in local["grads"] if n.startswith("blocks.")}
        held = {n for n in blocks if 2 * rank <= int(n.split(".")[1]) < 2 * rank + 2}
        assert {n for n in r["grads"] if n.startswith("blocks.")} == held
        assert set(r["grads"]) == held | (set(local["grads"]) - blocks)
        for name, g in r["grads"].items():
            torch.testing.assert_close(g, local["grads"][name], rtol=1e-5, atol=1e-6, msg=name)
            if not name.startswith("blocks."):
                assert torch.equal(g, res[0]["grads"][name]), name
    for name, g in local["grads"].items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
