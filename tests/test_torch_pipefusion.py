"""The port's PipeFusion (fast_dit_torch/parallel/pipefusion.py) against the
JAX package's (fast_dit_tpu/parallel/pipefusion.py), as
tests/test_pipefusion.py holds JAX's: one chunk is exact, a chunked forward
after an identical exact one is exact (the only approximation is stale
K/V), a warm cache beats a cold one, and the sampler degenerates to DDIM
when every step is a warmup step. Each port result is also held against
JAX's `pipefusion_forward` or `pipefusion_sample_loop` on the same inputs,
chunked paths and the cache each returns included: the port reads the
step's input cache in every chunk, as JAX's code does (`:170`).

A tiny DiT is made on the JAX side (attention "xla", the op JAX's chunked
path calls), its leaves replaced by 0.05 N(0, 1) draws from a numpy seed,
and carried into the port through `flax_params_to_state_dict`. JAX runs on
the conftest's virtual CPU mesh, the port over `LocalStages(n)` and, in gloo
worlds of 2 and 4 processes that import no JAX, over `ProcessGroupStages`.
All fp32; each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_dit_tpu.diffusion import create_diffusion as jax_create_diffusion
from fast_dit_tpu.models import DiT as JaxDiT
from fast_dit_tpu.parallel import create_pipeline_mesh
from fast_dit_tpu.parallel import init_kv_cache as jax_init_kv_cache
from fast_dit_tpu.parallel import pipefusion_forward as jax_pipefusion_forward
from fast_dit_tpu.parallel import pipefusion_sample_loop as jax_pipefusion_sample_loop
from fast_dit_torch.ckpt import flax_params_to_state_dict
from fast_dit_torch.diffusion import create_diffusion
from fast_dit_torch.models import DiT
from fast_dit_torch.parallel import (LocalStages, init_kv_cache, pipefusion_forward,
                                     pipefusion_sample_loop)
from test_torch_world import (drop_tmp_path, one_torch_thread, pipefusion_run,  # noqa: F401
                              spawn_world)

TINY = dict(input_size=8, patch_size=2, hidden_size=32, depth=8, num_heads=4, num_classes=10)
EXACT = 2e-5     # one chunk against the plain forward, as JAX's test
CHUNKED = 2e-4   # chunked forwards and chains, as JAX's test


def _jax_tiny(seed=2):
    model = JaxDiT(**TINY, in_channels=4, attn_backend="xla")
    params = model.init({"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 4, 8, 8)),
                        jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))
    rs = np.random.RandomState(seed)
    params = jax.tree.map(lambda p: (0.05 * rs.randn(*p.shape)).astype(np.float32), params)
    return model, params


def _weights(params):
    return flax_params_to_state_dict(params, 2, 4, 8)


def _port_tiny(params, **kw):
    model = DiT(**TINY, device="cpu", **kw)
    model.load_state_dict(_weights(params), strict=True)
    return model.eval()


def _inputs(B=4, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, 4, 8, 8).astype(np.float32)
    t = (np.arange(B) % 10).astype(np.int32)
    y = (np.arange(B) % 10).astype(np.int32)
    return x, t, y


def _next_step(x, t, seed=5):
    """One reverse step later: a slightly changed x at t - 1."""
    rs = np.random.RandomState(seed)
    return ((0.98 * x + 0.02 * rs.randn(*x.shape)).astype(np.float32),
            np.maximum(t - 1, 0).astype(np.int32))


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("n_stages", [2, 4, 8])
def test_single_chunk_is_exact(n_stages):
    """As test_single_chunk_is_exact: one chunk equals the plain forward and
    JAX's pipefusion_forward, and the cache holds JAX's K/V, none left zero
    (2e-5)."""
    jmodel, params = _jax_tiny()
    x, t, y = _inputs()
    mesh = create_pipeline_mesh(n_stages)
    jax_out, jax_kv = jax_pipefusion_forward(jmodel, params, x, t, y,
                                             jax_init_kv_cache(jmodel, 4), mesh=mesh,
                                             num_chunks=1)
    model = _port_tiny(params)
    kv = init_kv_cache(model, 4)
    assert tuple(kv.shape) == tuple(jax_kv.shape) == (8, 2, 4, 16, 4, 8)
    assert kv.dtype == torch.float32
    with torch.no_grad():
        got, new_kv = pipefusion_forward(model, *_t(x, t, y), kv, LocalStages(n_stages), 1)
        want = model(*_t(x, t, y))
    assert new_kv is kv
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=EXACT, atol=EXACT)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), rtol=EXACT, atol=EXACT)
    np.testing.assert_allclose(kv.numpy(), np.asarray(jax_kv), rtol=EXACT, atol=EXACT)
    assert (kv.abs().amax(dim=(1, 2, 4, 5)) > 0).all()  # every layer and token written


@pytest.mark.parametrize("num_chunks", [2, 4])
def test_chunked_after_exact_is_exact(num_chunks):
    """As test_chunked_after_exact_is_exact: with a cache warmed on the same
    inputs, stale K/V equal fresh K/V, so the chunked forward equals the
    plain forward and JAX's (2e-4)."""
    jmodel, params = _jax_tiny()
    x, t, y = _inputs()
    mesh = create_pipeline_mesh(4)
    _, jax_kv = jax_pipefusion_forward(jmodel, params, x, t, y, jax_init_kv_cache(jmodel, 4),
                                       mesh=mesh, num_chunks=1)
    jax_out, _ = jax_pipefusion_forward(jmodel, params, x, t, y, jax_kv, mesh=mesh,
                                        num_chunks=num_chunks)
    model = _port_tiny(params)
    stages = LocalStages(4)
    with torch.no_grad():
        _, kv = pipefusion_forward(model, *_t(x, t, y), init_kv_cache(model, 4), stages, 1)
        got, _ = pipefusion_forward(model, *_t(x, t, y), kv, stages, num_chunks)
        want = model(*_t(x, t, y))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=CHUNKED, atol=CHUNKED)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), rtol=CHUNKED, atol=CHUNKED)


def test_warm_cache_beats_cold():
    """As test_warm_cache_beats_cold: one reverse step later, the chunked
    forward with a warm cache is within 0.05 of exact and under half the
    cold cache's error; warm and cold, the output and the cache returned
    equal JAX's (2e-4)."""
    jmodel, params = _jax_tiny()
    x, t, y = _inputs()
    x2, t2 = _next_step(x, t)
    mesh = create_pipeline_mesh(4)
    jkv0 = jax_init_kv_cache(jmodel, 4)
    _, jkv = jax_pipefusion_forward(jmodel, params, x, t, y, jkv0, mesh=mesh, num_chunks=1)
    jax_runs = [jax_pipefusion_forward(jmodel, params, x2, t2, y, kv, mesh=mesh, num_chunks=4)
                for kv in (jkv, jkv0)]
    model = _port_tiny(params)
    stages = LocalStages(4)
    with torch.no_grad():
        want = model(*_t(x2, t2, y)).numpy()
        _, kv = pipefusion_forward(model, *_t(x, t, y), init_kv_cache(model, 4), stages, 1)
        runs = [pipefusion_forward(model, *_t(x2, t2, y), c, stages, 4)
                for c in (kv, init_kv_cache(model, 4))]
    (warm, _), (cold, _) = runs
    assert _rel(warm, want) < 0.05, _rel(warm, want)
    assert _rel(warm, want) < 0.5 * _rel(cold, want), (_rel(warm, want), _rel(cold, want))
    for (got_out, got_kv), (jax_out, jax_kv) in zip(runs, jax_runs):
        np.testing.assert_allclose(got_out.numpy(), np.asarray(jax_out), rtol=CHUNKED,
                                   atol=CHUNKED)
        np.testing.assert_allclose(got_kv.numpy(), np.asarray(jax_kv), rtol=CHUNKED,
                                   atol=CHUNKED)


@pytest.mark.parametrize("num_chunks", [2, 4])
def test_a_chunked_step_refreshes_only_the_last_chunk_as_jax_does(num_chunks):
    """From a cold cache, a chunked forward returns JAX's output and cache
    (2e-4): every chunk attends to the step's input cache with its own K/V
    fresh, and the cache keeps only the last chunk's fresh K/V, equal to
    the exact forward's at layer 0 (whose K/V depend on the tokens only)."""
    jmodel, params = _jax_tiny()
    x, t, y = _inputs()
    jax_out, jax_kv = jax_pipefusion_forward(jmodel, params, x, t, y,
                                             jax_init_kv_cache(jmodel, 4),
                                             mesh=create_pipeline_mesh(2), num_chunks=num_chunks)
    model = _port_tiny(params)
    stages = LocalStages(2)
    with torch.no_grad():
        _, exact_kv = pipefusion_forward(model, *_t(x, t, y), init_kv_cache(model, 4), stages, 1)
        got, kv = pipefusion_forward(model, *_t(x, t, y), init_kv_cache(model, 4), stages,
                                     num_chunks)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), rtol=CHUNKED, atol=CHUNKED)
    np.testing.assert_allclose(kv.numpy(), np.asarray(jax_kv), rtol=CHUNKED, atol=CHUNKED)
    n = 16 // num_chunks
    assert not kv[:, :, :, :16 - n].any()
    assert (kv[:, :, :, 16 - n:].abs().amax(dim=(0, 1, 2, 4, 5)) > 0).all()
    np.testing.assert_allclose(kv[0, :, :, 16 - n:].numpy(), exact_kv[0, :, :, 16 - n:].numpy(),
                               rtol=EXACT, atol=EXACT)


def _noise(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _chains(steps, warmup, seed, cfg_scale=None, n_stages=4, num_chunks=4):
    """(port PipeFusion chain, JAX PipeFusion chain, the port's exact DDIM
    chain) from the same noise; with `cfg_scale`, the exact chain is DDIM on
    the doubled batch through forward_with_cfg, first half kept."""
    jmodel, params = _jax_tiny()
    _, _, y = _inputs()
    z = _noise((4, 4, 8, 8), seed)
    jax_got = jax_pipefusion_sample_loop(
        jmodel, params, z.shape, jax_create_diffusion(f"ddim{steps}").schedule, y,
        mesh=create_pipeline_mesh(n_stages), num_chunks=num_chunks, warmup=warmup,
        kind="ddim", noise=z, cfg_scale=cfg_scale)
    model = _port_tiny(params)
    diffusion = create_diffusion(f"ddim{steps}", device="cpu")
    zt, yt = _t(z, y)
    with torch.no_grad():
        got = pipefusion_sample_loop(model, zt.shape, diffusion.schedule, yt,
                                     LocalStages(n_stages), num_chunks, warmup=warmup,
                                     kind="ddim", noise=zt, cfg_scale=cfg_scale)
        if cfg_scale is None:
            want = diffusion.ddim_sample_loop(lambda xs, ts: model(xs, ts, yt), zt.shape,
                                              noise=zt)
        else:
            yy = torch.cat([yt, torch.full_like(yt, model.num_classes)])
            want = diffusion.ddim_sample_loop(
                lambda xs, ts: model.forward_with_cfg(xs, ts, yy, cfg_scale), (8, 4, 8, 8),
                noise=torch.cat([zt, zt]))[:4]
    return got.numpy(), np.asarray(jax_got), want.numpy()


def test_sample_loop_all_warmup_matches_ddim():
    """As test_sample_loop_all_warmup_matches_ddim: warmup >= T equals the
    port's DDIM chain and JAX's PipeFusion chain (2e-4)."""
    got, jax_got, want = _chains(5, 5, seed=7)
    np.testing.assert_allclose(got, want, rtol=CHUNKED, atol=CHUNKED)
    np.testing.assert_allclose(got, jax_got, rtol=CHUNKED, atol=CHUNKED)


def test_sample_loop_chunked_close_to_exact():
    """As test_sample_loop_chunked_close_to_exact: warmup 2 of 8 DDIM steps
    lands within 0.05 of the exact chain, is not equal to it (the
    approximate path ran), and equals JAX's chunked chain (2e-4)."""
    got, jax_got, want = _chains(8, 2, seed=9)
    rel = _rel(got, want)
    assert 0.0 < rel < 0.05, rel
    np.testing.assert_allclose(got, jax_got, rtol=CHUNKED, atol=CHUNKED)


def test_cfg_all_warmup_matches_doubled_batch_cfg():
    """As test_cfg_all_warmup_matches_doubled_batch_cfg: CFG with warmup >=
    T equals DDIM on the doubled batch through forward_with_cfg and JAX's
    chain (2e-4)."""
    got, jax_got, want = _chains(5, 5, seed=13, cfg_scale=2.5)
    np.testing.assert_allclose(got, want, rtol=CHUNKED, atol=CHUNKED)
    np.testing.assert_allclose(got, jax_got, rtol=CHUNKED, atol=CHUNKED)


def test_cfg_chunked_close_to_exact():
    """As test_cfg_chunked_close_to_exact: the chunked CFG chain stays
    within 0.05 of the exact CFG chain, differs from it, and equals JAX's
    (2e-4)."""
    got, jax_got, want = _chains(8, 2, seed=17, cfg_scale=2.5)
    rel = _rel(got, want)
    assert 0.0 < rel < 0.05, rel
    np.testing.assert_allclose(got, jax_got, rtol=CHUNKED, atol=CHUNKED)


def _jax_p_draws(rng, shape, T):
    """JAX's draws in pipefusion_sample_loop (:243-258): x_T from
    fold_in(rng, 2^30), step k's Gaussian from fold_in(rng, T - 1 - k)."""
    noise = jax.random.normal(jax.random.fold_in(rng, 2 ** 30), shape)
    step_noise = jax.vmap(lambda i: jax.random.normal(jax.random.fold_in(rng, i), shape,
                                                      jnp.float32))(jnp.arange(T - 1, -1, -1))
    return np.asarray(noise), np.asarray(step_noise)


@pytest.mark.parametrize("cfg_scale", [None, 2.5], ids=["plain", "cfg"])
def test_p_kind_with_jax_draws_matches_jax(cfg_scale):
    """As test_p_sampler_kind_runs, and held to JAX's chain: DDPM over 5
    respaced steps, 2 stages, 2 chunks, warmup 1, with JAX's x_T and step
    noise injected, equals JAX's chain from the same key (2e-4)."""
    jmodel, params = _jax_tiny()
    _, _, y = _inputs()
    rng = jax.random.PRNGKey(3)
    shape = (4, 4, 8, 8)
    jax_got = jax_pipefusion_sample_loop(jmodel, params, shape,
                                         jax_create_diffusion("5").schedule, y,
                                         mesh=create_pipeline_mesh(2), num_chunks=2, warmup=1,
                                         kind="p", rng=rng, cfg_scale=cfg_scale)
    noise, step_noise = _jax_p_draws(rng, shape, 5)
    model = _port_tiny(params)
    with torch.no_grad():
        got = pipefusion_sample_loop(
            model, shape, create_diffusion("5", device="cpu").schedule, *_t(y),
            LocalStages(2), 2, warmup=1, kind="p", noise=torch.from_numpy(noise.copy()),
            step_noise=torch.from_numpy(step_noise.copy()), cfg_scale=cfg_scale)
    assert got.shape == shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_got), rtol=CHUNKED, atol=CHUNKED)


@pytest.mark.parametrize("option", [{"quant": "w8a8"}, {"tome_ratio": 0.5},
                                    {"moe_experts": 4}], ids=["quant", "tome", "moe"])
def test_pipefusion_refuses_the_inexact_and_moe_options(option):
    """PipeFusion rebuilds the dense block: JAX asserts MoE away
    (pipefusion.py:122-125); the port also refuses quant and ToMe, which
    the rebuilt block would drop."""
    model = DiT(**TINY, device="cpu", **option)
    x, t, y = _t(*_inputs())
    with pytest.raises(ValueError, match="exact-only dense-DiT"):
        pipefusion_forward(model, x, t, y, init_kv_cache(model, 4), LocalStages(2), 1)


def test_pipefusion_needs_splits_mlp_ratio_4_and_a_known_kind():
    model = DiT(**TINY, device="cpu")
    x, t, y = _t(*_inputs())
    kv = init_kv_cache(model, 4)
    with pytest.raises(ValueError, match="mlp_ratio=4"):  # JAX's assert (:121)
        pipefusion_forward(DiT(**TINY, mlp_ratio=2.0, device="cpu"), x, t, y, kv,
                           LocalStages(2), 1)
    with pytest.raises(ValueError, match="depth 8 does not split into 3"):
        pipefusion_forward(model, x, t, y, kv, LocalStages(3), 1)
    with pytest.raises(ValueError, match="16 tokens do not split into 3"):
        pipefusion_forward(model, x, t, y, kv, LocalStages(2), 3)
    sched = create_diffusion("ddim2", device="cpu").schedule
    with pytest.raises(ValueError, match="kind must be"):
        pipefusion_sample_loop(model, x.shape, sched, y, LocalStages(2), 2, kind="ddim_reverse",
                               noise=x)


def test_process_stages_pipefusion_step_equals_local_stages(tmp_path):
    """Four gloo ranks (2 layers each) holding only their own blocks and
    their own (2, 2, B, N, H, hd) slice of the cache: an exact step, then a
    chunked step one reverse step later; each rank's outputs equal
    LocalStages(4)'s and its cache the matching slice of LocalStages(4)'s
    (1e-6)."""
    _, params = _jax_tiny()
    x, t, y = _inputs()
    x2, t2 = _next_step(x, t)
    inputs = {"x": x, "t": t, "y": y, "x2": x2, "t2": t2}
    weights = _weights(params)
    res = spawn_world(4, "pipefusion_run", tmp_path, cfg=TINY, weights=weights, inputs=inputs,
                      chunks=4)
    local = pipefusion_run(TINY, weights, inputs, 4, stages=LocalStages(4))
    for rank, r in enumerate(res):
        assert tuple(r["kv"].shape) == (2, 2, 4, 16, 4, 8)
        for key in ("exact", "chunked"):
            torch.testing.assert_close(r[key], local[key], rtol=1e-6, atol=1e-6, msg=key)
        torch.testing.assert_close(r["kv"], local["kv"][2 * rank:2 * rank + 2], rtol=1e-6,
                                   atol=1e-6)


def test_process_stages_pipefusion_chain_equals_local_stages(tmp_path):
    """Two gloo ranks run a 3-step chunked DDPM chain with CFG (4 chunks,
    warmup 1, the cache over both halves, injected x_T and step noise):
    both ranks' samples equal LocalStages(2)'s (1e-6)."""
    _, params = _jax_tiny()
    _, _, y = _inputs()
    inputs = {"y": y, "noise": _noise((4, 4, 8, 8), 21),
              "step_noise": _noise((3, 4, 4, 8, 8), 22)}
    chain = {"respacing": "3", "kind": "p", "warmup": 1, "cfg_scale": 4.0}
    weights = _weights(params)
    res = spawn_world(2, "pipefusion_run", tmp_path, cfg=TINY, weights=weights, inputs=inputs,
                      chunks=4, chain=chain)
    local = pipefusion_run(TINY, weights, inputs, 4, stages=LocalStages(2), chain=chain)["out"]
    assert torch.isfinite(local).all()
    for r in res:
        torch.testing.assert_close(r["out"], local, rtol=1e-6, atol=1e-6)
