"""The port's NVS model and inpainting (fast_dit_torch/nvs/conditioning.py,
inpaint.py, the separate-q/k/v attention of ops/attention.py and the
converter's DiTNVS names) against the JAX package (`fast_dit_tpu/nvs/`).

Weights are made once on the JAX side (init + a 0.02 N(0, 1) perturbation
from a numpy seed) and carried into the port through
`flax_params_to_state_dict`; inputs are numpy. The model is narrow (width
32, 4 heads of 8, depth 3, cross-attention at layer 1, 8x8 latents against
a 4x4 grid of 24-d DINO tokens: 16 query and 16 key tokens). Tolerances:
fp32 outputs within 1e-5 of max |JAX| (the gradients are held in
tests/test_torch_nvs_train.py), the RePaint chain with JAX's `fold_in` draws injected within 1e-5 of max,
its known region exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_dit_tpu.diffusion import create_diffusion as jax_create_diffusion
from fast_dit_tpu.nvs import DiTNVS as JaxDiTNVS
from fast_dit_tpu.nvs import inpaint_sample_loop as jax_inpaint
from fast_dit_tpu.ops.attention import dot_product_attention as jax_dpa
from fast_dit_torch.ckpt import flax_params_to_state_dict, jax_leaves
from fast_dit_torch.diffusion import create_diffusion
from fast_dit_torch.nvs import DiTNVS, inpaint_sample_loop, mask_from_black_pixels
from fast_dit_torch.ops.attention import dot_product_attention

RTOL = 1e-5
CFG = dict(input_size=8, patch_size=2, hidden_size=32, depth=3, num_heads=4, num_classes=10,
           dino_dim=24, dino_patch_grid=4, cross_layers=(1,))
B = 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_nvs_params(seed=0, **kw):
    """A JAX DiTNVS (einsum attention) and its perturbed params (numpy)."""
    model = JaxDiTNVS(**{**CFG, **kw}, attn_backend="einsum")
    params = model.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 4, 8, 8)),
                        jnp.zeros((1,), jnp.int32), jnp.zeros((1, CFG["dino_dim"], 4, 4)),
                        jnp.zeros((1,), jnp.int32))
    rs = np.random.RandomState(seed)
    return model, jax.tree.map(
        lambda p: np.asarray(p) + 0.02 * rs.randn(*p.shape).astype(np.float32), params)


def port_nvs(params, **kw):
    model = DiTNVS(**{**CFG, **kw}, device="cpu")
    model.load_state_dict(flax_params_to_state_dict(params, CFG["patch_size"], 4,
                                                    CFG["input_size"]), strict=True)
    return model


def nvs_inputs(seed=1):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, 4, 8, 8).astype(np.float32), np.array([0, 17, 500, 999]),
            rs.randn(B, CFG["dino_dim"], 4, 4).astype(np.float32),
            rs.randint(0, CFG["num_classes"], size=B).astype(np.int32))


def _pt(*arrays):
    return [torch.from_numpy(np.asarray(a, np.int64) if a.dtype.kind == "i" else a)
            for a in arrays]


@pytest.fixture(scope="module")
def pair():
    jmodel, params = jax_nvs_params()
    return jmodel, params, port_nvs(params)


def _close(got, want, rtol=RTOL):
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert err <= rtol * scale, (err, rtol * scale)


def test_forward_and_forward_with_cfg_match_jax(pair):
    jmodel, params, model = pair
    x, t, f, y = nvs_inputs()
    with torch.no_grad():
        got = model(*_pt(x, t, f, y))
        assert got.dtype == torch.float32 and got.shape == (B, 8, 8, 8)
        _close(got.numpy(), jmodel.apply(params, x, t, f, y))
        y2 = np.array([3, 5, 10, 10], np.int32)  # [cond ; uncond] labels
        got = model.forward_with_cfg(*_pt(x, t, f, y2), 4.0)
    _close(got.numpy(), jmodel.apply(params, x, t, f, y2, 4.0,
                                     method=jmodel.forward_with_cfg))


@pytest.mark.parametrize("cross_layers,condition_on_labels",
                         [((0, 2), True), ((), True), ((1,), False)],
                         ids=["two-cross-layers", "no-cross-layer", "t-only"])
def test_cross_layers_gate_and_label_conditioning_match_jax(cross_layers, condition_on_labels):
    kw = dict(cross_layers=cross_layers, condition_on_labels=condition_on_labels)
    jmodel, params = jax_nvs_params(seed=3, **kw)
    model = port_nvs(params, **kw)
    assert [b.use_cross for b in model.blocks] == [i in cross_layers for i in range(3)]
    x, t, f, y = nvs_inputs(3)
    with torch.no_grad():
        got = model(*_pt(x, t, f, y)).numpy()
        _close(got, jmodel.apply(params, x, t, f, y))
        # labels move the output only when they condition it
        other = model(*_pt(x, t, f, (y + 1) % CFG["num_classes"])).numpy()
    assert np.array_equal(got, other) != condition_on_labels
    with pytest.raises(ValueError, match="out of range"):
        DiTNVS(**{**CFG, "cross_layers": (3,)}, device="cpu")


@pytest.mark.parametrize("sk", [16, 5], ids=["Sq=Sk", "Sq!=Sk"])
def test_separate_qkv_attention_matches_jax(sk):
    rs = np.random.RandomState(4)
    q = rs.randn(2, 16, 4, 8).astype(np.float32)
    k, v = (rs.randn(2, sk, 4, 8).astype(np.float32) for _ in range(2))
    want = np.asarray(jax_dpa(q, k, v, backend="xla")).reshape(2, 16, 32)
    flat = [torch.from_numpy(a.reshape(2, a.shape[1], 32)) for a in (q, k, v)]
    for backend in ("auto", "einsum"):  # a CPU tensor takes the plain version under both
        _close(dot_product_attention(*flat, 4, backend=backend).numpy(), want)
    with pytest.raises(ValueError, match="expected q"):
        dot_product_attention(flat[0], flat[1][:, :3], flat[2], 4)


def test_converter_and_jax_leaves_of_a_ditnvs_tree(pair):
    _, params, model = pair
    leaves = jax_leaves(model)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path[1:]): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert [leaf.path for leaf in leaves] == sorted(flat)
    tensors = list(model.parameters())
    for leaf in leaves:
        assert leaf.shape == flat[leaf.path].shape, leaf.path
        got = np.stack([leaf.to_jax(tensors[i].detach()).numpy() for i in leaf.members])
        assert np.array_equal(got if leaf.stacked else got[0], flat[leaf.path]), leaf.path
        for i in leaf.members:  # from_jax inverts to_jax
            assert torch.equal(leaf.from_jax(leaf.to_jax(tensors[i].detach())), tensors[i])
    assert sum(len(leaf.members) for leaf in leaves) == len(tensors) == 13 + 18 * 3
    sd = flax_params_to_state_dict(params, 2, 4, 8)
    assert sd["dino_embedder.proj.weight"].shape == (32, 24, 1, 1)
    assert sd["blocks.0.cross_attn.to_q.weight"].shape == (32, 32)
    assert sd["blocks.0.adaLN_modulation.1.weight"].shape == (9 * 32, 32)


def _jax_inpaint_draws(rng, T, jump_n, shape):
    """x_T and every step's draws as JAX's loop folds them (inpaint.py:59-85)."""
    normal = lambda key: np.asarray(jax.random.normal(key, shape, jnp.float32))  # noqa: E731
    draws = {n: np.zeros((T, jump_n, *shape), np.float32)
             for n in ("known_noise", "step_noise", "renoise")}
    for k, i in enumerate(range(T - 1, -1, -1)):
        for j in range(jump_n):
            kk = jax.random.fold_in(jax.random.fold_in(rng, i), j)
            for n, c in (("known_noise", 1), ("step_noise", 2), ("renoise", 3)):
                draws[n][k, j] = normal(jax.random.fold_in(kk, c))
    return normal(jax.random.fold_in(rng, 2 ** 30)), draws


@pytest.mark.parametrize("jump_n", [1, 2])
def test_repaint_with_jax_draws_matches_jax(pair, jump_n):
    jmodel, params, model = pair
    x, _, f, y = nvs_inputs(5)
    rs = np.random.RandomState(6)
    known = x.clip(-1, 1)
    mask = (rs.rand(B, 1, 8, 8) < 0.4).astype(np.float32)
    steps, rng = 4, jax.random.PRNGKey(7)
    jsched = jax_create_diffusion(str(steps)).schedule
    want = np.asarray(jax.jit(lambda r: jax_inpaint(
        lambda xx, tt: jmodel.apply(params, xx, tt, f, y), known, mask, jsched, rng=r,
        jump_n=jump_n))(rng))
    noise, draws = _jax_inpaint_draws(rng, steps, jump_n, known.shape)
    tf, ty = _pt(f, y)
    with torch.no_grad():
        got = inpaint_sample_loop(lambda xx, tt: model(xx, tt, tf, ty), torch.from_numpy(known),
                                  torch.from_numpy(mask),
                                  create_diffusion(str(steps), device="cpu").schedule,
                                  noise=noise, jump_n=jump_n,
                                  **{n: torch.from_numpy(d) for n, d in draws.items()}).numpy()
    _close(got, want)
    keep = np.broadcast_to(mask, known.shape) == 0
    assert np.array_equal(got[keep], known[keep])
    # with a generator the draws are the port's own, the known region still exact
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        out = inpaint_sample_loop(lambda xx, tt: model(xx, tt, tf, ty), torch.from_numpy(known),
                                  torch.from_numpy(mask),
                                  create_diffusion(str(steps), device="cpu").schedule,
                                  generator=g, jump_n=jump_n).numpy()
    assert np.isfinite(out).all() and np.array_equal(out[keep], known[keep])


def test_mask_from_black_pixels_and_inpaint_arguments():
    img = np.full((4, 5, 3), 9, np.uint8)
    img[1, 2] = 0
    img[3, 4] = (0, 0, 1)
    m = mask_from_black_pixels(img)
    assert m.dtype == bool and m.sum() == 1 and m[1, 2]
    assert mask_from_black_pixels(img, threshold=1).sum() == 2
    sched = create_diffusion("2", device="cpu").schedule
    known = torch.zeros(1, 1, 2, 2)
    with pytest.raises(ValueError, match="generator"):
        inpaint_sample_loop(lambda x, t: x, known, known, sched, noise=known)
    with pytest.raises(ValueError, match=r"step_noise must be \(T, jump_n"):
        inpaint_sample_loop(lambda x, t: x, known, known, sched, step_noise=torch.zeros(2, 1, 1),
                            generator=torch.Generator())
