"""The port's W8A8 int8 path (fast_dit_torch/ops/quant.py, `QuantLinear`,
`DiT(quant="w8a8")`) against the JAX package (`fast_dit_tpu/ops/quant.py`,
`QuantDenseGeneral`).

The quantisers and the int8 product are integer arithmetic and fp32
scalings in the same order, so they are held to JAX bit for bit. The small
quantised DiT runs fp32 on both sides (the JAX attention through its Pallas
forward, interpreted on the CPU): each block on JAX's own input within 1e-5
of the largest output; the whole forward within a quantisation step's drift
(see `test_quantized_dit_forward_with_cfg_matches_jax`).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_dit_tpu.diffusion import create_diffusion as jax_create_diffusion
from fast_dit_tpu.models import DiT as JaxDiT
from fast_dit_tpu.models.layers import QuantDenseGeneral
from fast_dit_tpu.ops import quant as jq
from fast_dit_torch import sample as cli
from fast_dit_torch.ckpt import flax_params_to_state_dict
from fast_dit_torch.models import DiT
from fast_dit_torch.models.layers import Linear, QuantLinear
from fast_dit_torch.ops import quant as tq
from test_torch_world import drop_tmp_path  # noqa: F401 (an autouse fixture)

# fp32, relative to max |out|: what runs no int8 product (the cached call)
DIT_RTOL = 1e-5
# a quantised block on JAX's own input, and the whole quantised DiT: a 1-ulp
# difference upstream of a quantiser (LayerNorm, adaLN and the matmuls sum in
# other orders; the timestep embedding's exp) can cross a rounding boundary of
# x / scale and move one int8 code by one step, about s_x * |w| in one
# projection output, which the later layers carry on (ROADMAP.md, tolerances)
BLOCK_FLIP_RTOL, DIT_FLIP_RTOL = 1e-3, 1e-2
CFG = dict(input_size=8, patch_size=2, hidden_size=384, depth=2, num_heads=6)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 128), (5, 96), (3, 7)])
def test_quantizers_are_bit_equal_to_jax(shape):
    x = _rand(0, *shape, scale=3.0)
    x[0, :2] = 0.0  # a row with zeros, and values at half steps below
    x[1, 0] = x[1].__abs__().max() * 2.5 / 127.0
    for jfn, tfn in ((jq.quantize_rows, tq.quantize_rows), (jq.quantize_cols, tq.quantize_cols)):
        jqv, js = (np.asarray(a) for a in jfn(jnp.asarray(x)))
        tqv, ts = tfn(torch.from_numpy(x))
        assert tqv.dtype == torch.int8 and ts.dtype == torch.float32
        assert np.array_equal(tqv.numpy(), jqv) and np.array_equal(ts.numpy(), js)


def test_round_half_to_even_like_jnp():
    x = np.array([[0.5, 1.5, 2.5, -0.5, -1.5, 127.0]], np.float32)  # scale = 1
    q, s = tq.quantize_rows(torch.from_numpy(x))
    assert s.item() == 1.0
    assert q.tolist() == [[0, 2, 2, 0, -2, 127]] == np.asarray(jq.quantize_rows(x)[0]).tolist()


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False])
def test_int8_matmul_is_bit_equal_to_jax(out_dtype, bias):
    x = _rand(1, 2, 9, 96)
    w = _rand(2, 96, 40, scale=0.05)
    b = _rand(3, 40) if bias else None
    jdt = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
    want = jq.int8_matmul(jnp.asarray(x), jnp.asarray(w),
                          bias=None if b is None else jnp.asarray(b), out_dtype=jdt)
    got = tq.int8_matmul(torch.from_numpy(x), torch.from_numpy(w),
                         None if b is None else torch.from_numpy(b), out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (2, 9, 40)
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))
    # the int32 products equal an integer matmul of the int8 operands
    xq, _ = tq.quantize_rows(torch.from_numpy(x).reshape(-1, 96))
    wq, _ = tq.quantize_cols(torch.from_numpy(w))
    assert torch.equal(tq.int8_mm(xq, wq), xq.long().mm(wq.long()).int())


@pytest.mark.parametrize("features,axis,shape", [
    ((3, 4, 8), (-1,), (2, 5, 32)),   # qkv: (D, 3, H, hd) kernel
    (32, (-2, -1), (2, 5, 4, 8)),     # proj: rows over the whole H*hd
    (64, (-1,), (2, 5, 32)),          # fc1 / fc2
])
def test_quant_linear_is_bit_equal_to_quant_dense_general(features, axis, shape):
    x = _rand(4, *shape)
    layer = QuantDenseGeneral(features=features, axis=axis, dtype=jnp.float32)
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(lambda p: np.asarray(p) + _rand(5, *p.shape, scale=0.1), params)
    want = np.asarray(layer.apply(params, jnp.asarray(x)))
    kernel, bias = params["params"]["kernel"], params["params"]["bias"]
    n_in = int(np.prod([shape[a] for a in axis]))
    lin = QuantLinear(n_in, int(np.prod(bias.shape)))
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(kernel.reshape(n_in, -1).T.copy()))
        lin.bias.copy_(torch.from_numpy(bias.reshape(-1)))
        got = lin(torch.from_numpy(x.reshape(*shape[:len(shape) - len(axis)], n_in)))
    assert np.array_equal(got.numpy(), want.reshape(got.shape))


def test_quant_linear_state_dict_equals_linear_and_tracks_the_weight():
    torch.manual_seed(0)
    lin, qlin = Linear(48, 24), QuantLinear(48, 24)
    assert {k: v.shape for k, v in qlin.state_dict().items()} == \
        {k: v.shape for k, v in lin.state_dict().items()} == \
        {"weight": (24, 48), "bias": (24,)}
    qlin.load_state_dict(lin.state_dict(), strict=True)
    x = torch.randn(3, 48)
    first = qlin(x)
    with torch.no_grad():
        qlin.weight.mul_(2.0)  # the int8 copy follows a change of the weight
    want = tq.int8_matmul(x, qlin.weight.t(), qlin.bias)
    assert torch.equal(qlin(x), want) and not torch.equal(first, want)


def _jax_params(seed=0, **kw):
    model = JaxDiT(**CFG, attn_backend="pallas", **kw)
    n = CFG["input_size"]
    params = model.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 4, n, n)),
                        jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))
    rs = np.random.RandomState(seed)
    return model, jax.tree.map(
        lambda p: np.asarray(p) + 0.02 * rs.randn(*p.shape).astype(np.float32), params)


def _port(params, **kw):
    model = DiT(**CFG, device="cpu", **kw)
    model.load_state_dict(flax_params_to_state_dict(params, 2, 4, CFG["input_size"]),
                          strict=True)
    return model.eval()


def _inputs(B=4, seed=1):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, 4, 8, 8).astype(np.float32)
    t = rs.randint(0, 1000, size=B).astype(np.int32)
    y = np.concatenate([rs.randint(0, 1000, size=B // 2), np.full(B - B // 2, 1000)])
    return x, t, y.astype(np.int32)


def _jax_blocks(jmodel, params, x, t, y):
    """JAX's quantised DiT run by hand, module by module as its `__call__`
    runs them: (the tokens entering each block and the last, c)."""
    from fast_dit_tpu.models.layers import DiTBlock as JaxBlock
    from fast_dit_tpu.models.layers import (LabelEmbedder, PatchEmbed, TimestepEmbedder)
    from fast_dit_tpu.models.pos_embed import get_2d_sincos_pos_embed

    p = params["params"]
    D = CFG["hidden_size"]
    h = PatchEmbed(2, D).apply({"params": p["x_embedder"]}, x)
    h = h + get_2d_sincos_pos_embed(D, 4).astype(np.float32)[None]
    c = TimestepEmbedder(D).apply({"params": p["t_embedder"]}, t) + LabelEmbedder(
        1000, D, 0.1).apply({"params": p["y_embedder"]}, y, False)
    block = JaxBlock(D, CFG["num_heads"], attn_backend="pallas", quant="w8a8")
    states = [np.asarray(h)]
    for i in range(CFG["depth"]):
        bp = {"params": jax.tree.map(lambda a: a[i], p["blocks"]["block"])}
        states.append(np.asarray(block.apply(bp, states[-1], c)))
    return states, np.asarray(c)


def test_quantized_dit_forward_with_cfg_matches_jax():
    """Each quantised block of the CFG doubled batch on JAX's own block
    input (BLOCK_FLIP_RTOL; measured 5.3e-5 of max, one code flipped), then
    the whole `forward_with_cfg` (DIT_FLIP_RTOL; measured 1.0e-3, where the
    float models differ by 1.8e-6), which must also lie nearer JAX's
    quantised output than JAX's float output (3.0e-3 of max apart)."""
    jmodel, params = _jax_params(quant="w8a8")
    model = _port(params, quant="w8a8")
    x, t, y = _inputs()
    xx = np.concatenate([x[:2], x[:2]])  # what forward_with_cfg runs
    states, c = _jax_blocks(jmodel, params, xx, t, y)
    with torch.no_grad():
        for i, blk in enumerate(model.blocks):
            got = blk(torch.from_numpy(states[i].copy()), torch.from_numpy(c.copy())).numpy()
            want = states[i + 1]
            assert np.abs(got - want).max() <= BLOCK_FLIP_RTOL * np.abs(want).max()

    run = lambda m, p: np.asarray(jax.jit(lambda p, x, t, y: m.apply(
        p, x, t, y, 4.0, method=m.forward_with_cfg))(p, x, t, y))
    want = run(jmodel, params)
    want_float = run(_jax_params()[0], params)
    with torch.no_grad():
        got = model.forward_with_cfg(torch.from_numpy(x), torch.from_numpy(t).long(),
                                     torch.from_numpy(y).long(), 4.0).numpy()
    assert got.shape == want.shape == (4, 8, 8, 8)
    err = np.abs(got - want).max()
    assert err <= DIT_FLIP_RTOL * np.abs(want).max()
    assert err < np.abs(got - want_float).max()  # the projections really are int8
    assert all(isinstance(getattr(b.attn, n), QuantLinear) for b in model.blocks
               for n in ("qkv", "proj"))
    assert all(isinstance(getattr(b.mlp, n), QuantLinear) for b in model.blocks
               for n in ("fc1", "fc2"))
    assert not isinstance(model.blocks[0].adaLN_modulation[-1], QuantLinear)
    assert not isinstance(model.final_layer.linear, QuantLinear)


def test_quantized_dit_layer_cache_matches_jax():
    """The full call's cache and output (DIT_FLIP_RTOL), and the cached call
    replaying JAX's own cache: no int8 product runs there, so DIT_RTOL."""
    jmodel, params = _jax_params(quant="w8a8")
    model = _port(params, quant="w8a8")
    x, t, y = _inputs()
    t2 = (t + 37) % 1000
    jfull = jax.jit(lambda p, x, t, y: jmodel.apply(p, x, t, y, want_cache=True))
    jcached = jax.jit(lambda p, x, t, y, c: jmodel.apply(p, x, t, y, cache=c))
    want_out, cache = jfull(params, x, t, y)
    want_cached = np.asarray(jcached(params, x, t2, y, cache))
    tx, tt, tt2, ty = (torch.from_numpy(a).long() if a.dtype != np.float32 else
                       torch.from_numpy(a) for a in (x, t, t2, y))
    with torch.no_grad():
        out, tcache = model(tx, tt, ty, want_cache=True)
        cached = model(tx, tt2, ty, cache=tuple(torch.from_numpy(np.asarray(a))
                                                for a in cache))
    assert [tuple(a.shape) for a in tcache] == [np.asarray(a).shape for a in cache]
    for got, want in zip((out, *tcache), (want_out, *cache)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= DIT_FLIP_RTOL * np.abs(want).max()
    assert np.abs(cached.numpy() - want_cached).max() <= DIT_RTOL * np.abs(want_cached).max()


def test_quant_is_inference_only_and_unknown_modes_are_refused():
    from fast_dit_torch.diffusion import create_diffusion
    from fast_dit_torch.train import make_train_step

    model = DiT(**CFG, quant="w8a8", device="cpu")
    x = torch.zeros(2, 4, 8, 8)
    t, y = torch.zeros(2, dtype=torch.long), torch.zeros(2, dtype=torch.long)
    with pytest.raises(ValueError, match="inference-only"):
        model(x, t, y, train=True)
    with pytest.raises(ValueError, match="inference-only"):
        make_train_step(model, create_diffusion("", device="cpu").schedule)
    with pytest.raises(ValueError, match=r"quant='w4a4' not in \('w8a8',\)"):
        DiT(**CFG, quant="w4a4", device="cpu")
    with pytest.raises(ValueError, match="int8 quant \\+ MoE is untested"):
        DiT(**CFG, quant="w8a8", moe_experts=4, device="cpu")


def test_int8_mm_refuses_what_the_card_cannot_take():
    a = torch.zeros(4, 12, dtype=torch.int8)
    with pytest.raises(ValueError, match="2-D int8"):
        tq.int8_mm(a.float(), a.t())


def test_sample_cli_quantize_matches_the_jax_chain(tmp_path, monkeypatch):
    """`python -m fast_dit_torch.sample --model DiT-S/8 --quantize w8a8`
    (DDIM, 3 steps, CFG 4.0) on weights carried from JAX: the latents it
    saves equal the JAX quantised model's DDIM chain, as the JAX CLI runs it
    (`sample.py:79-88,176-180`), from the same x_T (the port's seeded draw),
    within DIT_FLIP_RTOL of max (measured 7.1e-4: flipped codes carried
    through the chain)."""
    jmodel = JaxDiT(input_size=32, patch_size=8, hidden_size=384, depth=12, num_heads=6,
                    quant="w8a8", attn_backend="pallas")
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4, 32, 32)),
                         jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))
    rs = np.random.RandomState(0)
    params = jax.tree.map(lambda p: np.asarray(p) + 0.02 * rs.randn(*p.shape).astype(np.float32),
                          params)
    torch.save(flax_params_to_state_dict(params, 8, 4, 32), tmp_path / "w.pt")
    monkeypatch.chdir(tmp_path)
    args = cli.parse_args(["--device", "cpu", "--ckpt", str(tmp_path / "w.pt"),
                           "--model", "DiT-S/8", "--sampler", "ddim",
                           "--num-sampling-steps", "3", "--quantize", "w8a8"])
    cli.main(args)
    got = np.load(tmp_path / "sample.npy")

    z, y, _ = cli.sampling_inputs(args, cli.build_model(args, torch.device("cpu"), args.seed))
    yy = np.concatenate([y.numpy(), np.full(len(y), 1000)]).astype(np.int32)
    jdiff = jax_create_diffusion("3")
    run = jax.jit(lambda p, n: jdiff.ddim_sample_loop(
        lambda x, t: jmodel.apply(p, x, t, yy, 4.0, method=jmodel.forward_with_cfg),
        n.shape, noise=n, clip_denoised=False))
    want = np.asarray(run(params, z.numpy()))[: len(y)]
    assert got.shape == want.shape == (8, 4, 32, 32)
    assert np.abs(got - want).max() <= DIT_FLIP_RTOL * np.abs(want).max()
    assert os.path.exists(tmp_path / "sample.png")
