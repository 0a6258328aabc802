"""The port's DiT (fast_dit_torch/models, ckpt) against the JAX package.

Weights are made once on the JAX side (init + a 0.02 N(0, 1) perturbation
from a numpy seed, so the zero-initialised heads do not make the comparison
trivial) and carried into the port through `flax_params_to_state_dict`. The
JAX side runs attn_backend="pallas", i.e. the Pallas forward `_fwd_kernel`,
interpreted on the CPU; the port's CPU path runs the attention twin.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_dit_tpu.ckpt import flax_to_state_dict
from fast_dit_tpu.models import DiT as JaxDiT
from fast_dit_tpu.models.layers import DiTBlock as JaxDiTBlock
from fast_dit_tpu.models.layers import TimestepEmbedder as JaxTimestepEmbedder
from fast_dit_tpu.models.pos_embed import get_2d_sincos_pos_embed as jax_pos_embed
from fast_dit_torch.ckpt import flax_params_to_state_dict, load_torch_checkpoint
from fast_dit_torch.models import DiT, DiT_models, TimestepEmbedder
from fast_dit_torch.models.pos_embed import get_2d_sincos_pos_embed
from test_torch_world import drop_tmp_path  # noqa: F401 (an autouse fixture)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
ATOL = 1e-4  # fp32 model outputs, both sides; sums run in other orders

S2 = dict(input_size=8, patch_size=2, hidden_size=384, depth=2, num_heads=6)
XL = dict(input_size=8, patch_size=2, hidden_size=1152, depth=2, num_heads=16)


def jax_params(cfg, seed=0):
    """Init the JAX DiT and perturb every leaf by 0.02 N(0, 1) (numpy seed)."""
    model = JaxDiT(**cfg, attn_backend="pallas")
    n = cfg["input_size"]
    params = model.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 4, n, n)),
                        jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))
    rs = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.02 * rs.randn(*p.shape).astype(np.float32), params)
    return model, params


def port_model(cfg, params):
    model = DiT(**cfg, device="cpu")
    model.load_state_dict(flax_params_to_state_dict(
        params, cfg["patch_size"], 4, cfg["input_size"]), strict=True)
    return model.eval()


def inputs(B, n, seed=1):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, 4, n, n).astype(np.float32)
    t = rs.randint(0, 1000, size=B).astype(np.int32)
    y = np.concatenate([rs.randint(0, 1000, size=B // 2), np.full(B - B // 2, 1000)])
    return x, t, y.astype(np.int32)


@pytest.mark.parametrize("dim,grid", [(384, 4), (1152, 16), (32, 4)])
def test_pos_embed_bit_equal(dim, grid):
    ours = get_2d_sincos_pos_embed(dim, grid)
    theirs = jax_pos_embed(dim, grid)
    assert ours.dtype == theirs.dtype == np.float64
    assert np.array_equal(ours, theirs)
    model = DiT(input_size=2 * grid, hidden_size=dim, depth=1, num_heads=4, device="cpu")
    assert model.pos_embed.dtype == torch.float32
    assert np.array_equal(model.pos_embed.numpy()[0], theirs.astype(np.float32))


@pytest.mark.parametrize("dim", [256, 7])
def test_timestep_embedding_cos_first(dim):
    t = np.array([0, 1, 17, 250, 999], np.int32)
    want = np.asarray(JaxTimestepEmbedder.timestep_embedding(jnp.asarray(t), dim))
    got = TimestepEmbedder.timestep_embedding(torch.from_numpy(t), dim).numpy()
    assert got.shape == want.shape == (5, dim)
    # XLA's and torch's fp32 exp may round a frequency one ulp apart; at
    # t = 999 that moves the argument by about one ulp of 999 (6.1e-5), and
    # cos/sin follow it: two ulps of the largest argument
    assert np.abs(got - want).max() <= 2 * np.spacing(np.float32(999))
    assert np.allclose(got[0, : dim // 2], 1.0)  # t = 0: the cos half comes first


def test_null_class_id_is_num_classes():
    model = DiT(input_size=8, hidden_size=32, depth=1, num_heads=4, num_classes=10, device="cpu")
    table = model.y_embedder.embedding_table.weight
    assert table.shape[0] == 11
    labels = torch.tensor([3, 10])
    out = model.y_embedder(labels)
    assert torch.equal(out[1], table[10])
    dropped = model.y_embedder(labels, force_drop_ids=torch.tensor([1, 0]))
    assert torch.equal(dropped[0], table[10]) and torch.equal(dropped[1], table[10])


def test_converter_matches_jax_export_and_loads_strict():
    cfg = dict(S2)
    _, params = jax_params(cfg)
    ours = flax_params_to_state_dict(params, 2, 4, cfg["input_size"])
    theirs = flax_to_state_dict(params, 2, in_channels=4, input_size=cfg["input_size"])
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        assert ours[k].dtype == torch.float32, k
        assert np.array_equal(ours[k].numpy(), np.asarray(v, np.float32)), k
    model = DiT(**cfg, device="cpu")
    assert set(model.state_dict()) == set(ours)
    model.load_state_dict(ours, strict=True)


def test_registry_names_match_jax():
    # the MoE family is ported too (tests/test_torch_moe.py): every entry
    from fast_dit_tpu.models import DiT_models as jax_models

    assert set(DiT_models) == set(jax_models)
    for name in jax_models:
        j, p = jax_models[name], DiT_models[name]
        assert j.keywords == p.keywords, name
        for key in ("depth", "hidden_size", "patch_size", "num_heads"):
            assert j.keywords[key] == p.keywords[key], (name, key)


def test_load_reference_checkpoint(tmp_path):
    path = os.path.join(FIXTURES, "ref_bundle_model.pt")
    sd = load_torch_checkpoint(path)
    model = DiT(input_size=8, patch_size=2, hidden_size=32, depth=2, num_heads=4,
                num_classes=10, device="cpu")
    model.load_state_dict(sd, strict=True)
    # a trainer checkpoint resolves to its EMA weights
    ema = {k: v + 1 for k, v in sd.items()}
    torch.save({"model": sd, "ema": ema, "opt": {}}, tmp_path / "ckpt.pt")
    got = load_torch_checkpoint(str(tmp_path / "ckpt.pt"))
    assert torch.equal(got["final_layer.linear.bias"], ema["final_layer.linear.bias"])
    got = load_torch_checkpoint(str(tmp_path / "ckpt.pt"), prefer_ema=False)
    assert torch.equal(got["final_layer.linear.bias"], sd["final_layer.linear.bias"])


def test_block_full_step_and_cached_step_match_jax():
    # block 0 of the perturbed S/2-width DiT, run alone on both sides
    _, params = jax_params(S2)
    block_params = {"params": jax.tree.map(lambda a: a[0], params["params"]["blocks"]["block"])}
    jblock = JaxDiTBlock(S2["hidden_size"], S2["num_heads"], attn_backend="pallas")
    block = port_model(S2, params).blocks[0]
    rs = np.random.RandomState(2)
    x = rs.randn(2, 16, S2["hidden_size"]).astype(np.float32)
    c, c2 = (rs.randn(2, S2["hidden_size"]).astype(np.float32) for _ in range(2))

    want_x, (want_a, want_m) = jax.jit(
        lambda p, x, c: jblock.apply(p, x, c, method=jblock.full_step))(block_params, x, c)
    want_cached = jax.jit(lambda p, x, c, a, m: jblock.apply(
        p, x, c, a, m, method=jblock.cached_step))(block_params, x, c2, want_a, want_m)
    with torch.no_grad():
        tx, tc, tc2 = (torch.from_numpy(a) for a in (x, c, c2))
        got_x, (got_a, got_m) = block.full_step(tx, tc)
        got_cached = block.cached_step(tx, tc2, got_a, got_m)
        assert torch.equal(block(tx, tc), got_x)
    for got, want in ((got_x, want_x), (got_a, want_a), (got_m, want_m),
                      (got_cached, want_cached)):
        assert np.abs(got.numpy() - np.asarray(want)).max() <= ATOL


@pytest.mark.parametrize("cfg", [S2, XL], ids=["S2-width", "XL-width-hd72"])
def test_forward_and_forward_with_cfg_match_jax(cfg):
    jmodel, params = jax_params(cfg)
    model = port_model(cfg, params)
    x, t, y = inputs(4, cfg["input_size"])

    fwd = jax.jit(lambda p, x, t, y: jmodel.apply(p, x, t, y))
    cfgf = jax.jit(lambda p, x, t, y: jmodel.apply(p, x, t, y, 4.0,
                                                   method=jmodel.forward_with_cfg))
    want = np.asarray(fwd(params, x, t, y))
    want_cfg = np.asarray(cfgf(params, x, t, y))
    with torch.no_grad():
        tx, tt, ty = (torch.from_numpy(a) for a in (x, t.astype(np.int64), y.astype(np.int64)))
        got = model(tx, tt, ty).numpy()
        got_cfg = model.forward_with_cfg(tx, tt, ty, 4.0).numpy()
    assert got.shape == want.shape == (4, 8, cfg["input_size"], cfg["input_size"])
    assert np.abs(want).max() > 0.1  # the perturbed heads are not zero
    assert np.abs(got - want).max() <= ATOL
    assert np.abs(got_cfg - want_cfg).max() <= ATOL
    # the 3-channel quirk: the guided channels are mirrored into both halves,
    # channel 3 and the variance half keep each half's own output
    assert np.array_equal(got_cfg[:2, :3], got_cfg[2:, :3])
    assert np.abs(got_cfg[:2, 3:] - got_cfg[2:, 3:]).max() > 0
