"""The port's token merging (fast_dit_torch/ops/tome.py and the ToMe option
of the DiT) against the JAX package (`fast_dit_tpu/ops/tome.py`).

The token -> representative map is compared exactly: JAX's is read back by
unmerging the row indices 0..N-r-1 (one-hot rows sum exactly), the port's
the same way. Merged values are means (1e-6); the small DiTs run fp32 on
both sides (JAX's attention through its Pallas forward, interpreted on the
CPU) within 1e-5 of the largest output.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_dit_tpu.diffusion import create_diffusion as jax_create_diffusion
from fast_dit_tpu.models import DiT as JaxDiT
from fast_dit_tpu.ops import tome as jt
from fast_dit_torch import sample as cli
from fast_dit_torch.ckpt import flax_params_to_state_dict
from fast_dit_torch.models import DiT
from fast_dit_torch.ops import tome as tt
from test_torch_world import drop_tmp_path  # noqa: F401 (an autouse fixture)

VALUE_ATOL = 1e-6   # merged means (fp32 sums of a few rows in other orders)
DIT_RTOL = 1e-5     # fp32 DiT outputs, relative to max |out|
CFG = dict(input_size=16, patch_size=2, hidden_size=96, depth=2, num_heads=2)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("num_patches", [16, 64, 256, 1024, 49])
def test_merge_counts_equal_jax(num_patches):
    for ratio in (0.0, 0.1, 0.3, 0.5, 0.7, 0.75, 0.9, 1.0):
        assert tt.tome_merge_count(num_patches, ratio) == jt.tome_merge_count(num_patches, ratio)
    for sx, sy in ((1, 2), (3, 3)):
        assert (tt.tome_merge_count(num_patches, 0.5, sx, sy)
                == jt.tome_merge_count(num_patches, 0.5, sx, sy))
    with pytest.raises(ValueError, match="non-square"):
        tt.tome_merge_count(num_patches + 2, 0.5)
    for gh, sx, sy in ((8, 2, 2), (7, 2, 2), (6, 3, 2)):
        dst, src = tt._dst_src_split(gh, gh, sx, sy)
        jdst, jsrc = jt._dst_src_split(gh, gh, sx, sy)
        assert np.array_equal(dst, jdst) and np.array_equal(src, jsrc)
        on = tt._split_on(torch.device("cpu"), gh, gh, sx, sy)  # made by torch ops
        assert np.array_equal(on[0].numpy(), jdst) and np.array_equal(on[1].numpy(), jsrc)


def _maps(metric, r):
    """(port map, JAX map) of token -> merged row, each read back through
    its own unmerge."""
    B, N, _ = metric.shape
    rows = np.broadcast_to(np.arange(N - r, dtype=np.float32)[None, :, None], (B, N - r, 1))
    _, ju = jt.bipartite_soft_matching_2d(jnp.asarray(metric), r)
    _, tu = tt.bipartite_soft_matching_2d(torch.from_numpy(metric), r)
    want = np.asarray(ju(jnp.asarray(rows)))[..., 0]
    got = tu(torch.from_numpy(rows.copy())).numpy()[..., 0]
    return got, want


def _metric(kind, B=2, N=64, D=16, seed=0):
    """Tokens of an 8 x 8 grid. "duplicates": the sources come in six groups
    of equal tokens (their scores tie exactly, so the index breaks the tie
    in the rank), and two destinations are equal to one group (a tie in
    its argmax, which the first destination wins);
    "all_equal": every score ties (JAX's tests/test_tome.py:80). Scores of
    distinct tokens differ by far more than rounding: where a source's
    score sits within an ulp of another's, each side's fp32 rounding, not
    the contract, orders them (ROADMAP.md, tolerances)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(B, N, D).astype(np.float32)
    if kind == "duplicates":
        dst, src = tt._dst_src_split(8, 8, 2, 2)
        x[:, dst[5]] = x[:, dst[2]]
        groups = rs.randn(B, 6, D).astype(np.float32)
        groups[:, 0] = x[:, dst[2]]  # sources equal to both: their argmax ties
        x[:, src] = groups[:, rs.randint(0, 6, size=len(src))]
    elif kind == "all_equal":
        x = np.ones((B, N, D), np.float32)
    return np.ascontiguousarray(x)


@pytest.mark.parametrize("kind", ["random", "duplicates", "all_equal"])
@pytest.mark.parametrize("ratio", [0.3, 0.5, 0.75])  # 0.75: r == n_src
def test_representative_map_equals_jax(kind, ratio):
    metric = _metric(kind)
    r = tt.tome_merge_count(64, ratio)
    assert (r == 48) == (ratio == 0.75)
    got, want = _maps(metric, r)
    assert np.array_equal(got, want)
    # every merged row has a member: the map is onto [0, N - r)
    assert all(set(np.unique(g).astype(int)) == set(range(64 - r)) for g in got)


@pytest.mark.parametrize("kind", ["random", "duplicates"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_merge_and_unmerge_values_match_jax(kind, dtype):
    metric = _metric(kind, seed=3)
    x = _metric("random", D=24, seed=4)
    r = tt.tome_merge_count(64, 0.5)
    jm, ju = jt.bipartite_soft_matching_2d(jnp.asarray(metric), r)
    tm, tu = tt.bipartite_soft_matching_2d(torch.from_numpy(metric), r)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want_m = np.asarray(jm(jnp.asarray(x).astype(jdt)), np.float32)
    got_m = tm(torch.from_numpy(x).to(dtype))
    assert got_m.dtype == dtype and got_m.shape == (2, 64 - r, 24)
    atol = VALUE_ATOL if dtype == torch.float32 else 2 ** -8 * np.abs(want_m).max()
    assert np.abs(got_m.float().numpy() - want_m).max() <= atol
    y = got_m.float().numpy()
    want_u = np.asarray(ju(jnp.asarray(y)))
    assert np.array_equal(tu(torch.from_numpy(y)).numpy(), want_u)  # a gather: exact
    assert torch.allclose(tm(tu(torch.from_numpy(y))), torch.from_numpy(y), atol=VALUE_ATOL)


def _jax_params(seed=0, **kw):
    model = JaxDiT(**CFG, num_classes=10, attn_backend="pallas", **kw)
    n = CFG["input_size"]
    params = model.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 4, n, n)),
                        jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))
    rs = np.random.RandomState(seed)
    return model, jax.tree.map(
        lambda p: np.asarray(p) + 0.02 * rs.randn(*p.shape).astype(np.float32), params)


def _port(params, **kw):
    model = DiT(**CFG, num_classes=10, device="cpu", **kw)
    model.load_state_dict(flax_params_to_state_dict(params, 2, 4, CFG["input_size"]),
                          strict=True)
    return model.eval()


def _inputs(B=4, seed=1):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, 4, 16, 16).astype(np.float32)
    t = rs.randint(0, 1000, size=B).astype(np.int32)
    y = np.concatenate([rs.randint(0, 10, size=B // 2), np.full(B - B // 2, 10)])
    return x, t, y.astype(np.int32)


@pytest.mark.parametrize("ratio,mlp", [(0.3, False), (0.5, False), (0.5, True)],
                         ids=["0.3", "0.5", "0.5-mlp"])
def test_tome_dit_forward_with_cfg_matches_jax(ratio, mlp):
    jmodel, params = _jax_params(tome_ratio=ratio, tome_mlp=mlp)
    model = _port(params, tome_ratio=ratio, tome_mlp=mlp)
    assert model.tome_r == tt.tome_merge_count(64, ratio) > 0
    x, t, y = _inputs()
    want = np.asarray(jax.jit(lambda p, x, t, y: jmodel.apply(
        p, x, t, y, 4.0, method=jmodel.forward_with_cfg))(params, x, t, y))
    with torch.no_grad():
        tx, tt_, ty = torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(y).long()
        got = model.forward_with_cfg(tx, tt_, ty, 4.0).numpy()
        plain = _port(params).forward_with_cfg(tx, tt_, ty, 4.0).numpy()
    assert got.shape == want.shape == (4, 8, 16, 16)
    assert np.abs(got - want).max() <= DIT_RTOL * np.abs(want).max()
    assert np.abs(got - plain).max() > 100 * DIT_RTOL * np.abs(want).max()  # tokens merged


def test_ratio_zero_is_bit_identical_to_the_plain_model():
    _, params = _jax_params()
    x, t, y = (torch.from_numpy(a) for a in _inputs())
    with torch.no_grad():
        want = _port(params)(x, t.long(), y.long())
        got = _port(params, tome_ratio=0.0, tome_mlp=True)(x, t.long(), y.long())
    assert torch.equal(got, want)


def test_tome_with_the_layer_cache_matches_jax():
    jmodel, params = _jax_params(tome_ratio=0.5)
    model = _port(params, tome_ratio=0.5)
    x, t, y = _inputs()
    t2 = (t + 37) % 1000
    want_out, cache = jax.jit(lambda p, x, t, y: jmodel.apply(p, x, t, y, want_cache=True))(
        params, x, t, y)
    want_cached = np.asarray(jax.jit(lambda p, x, t, y, c: jmodel.apply(p, x, t, y, cache=c))(
        params, x, t2, y, cache))
    tx, tt_, tt2, ty = (torch.from_numpy(a) for a in (x, t, t2, y))
    with torch.no_grad():
        out, tcache = model(tx, tt_.long(), ty.long(), want_cache=True)
        cached = model(tx, tt2.long(), ty.long(), cache=tcache)
    assert tcache[0].shape == (2, 4, 64, 96)  # the cache keeps all N tokens
    for got, want in zip((out, *tcache, cached), (want_out, *cache, want_cached)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= DIT_RTOL * np.abs(want).max()


def test_tome_is_inference_only():
    from fast_dit_torch.diffusion import create_diffusion
    from fast_dit_torch.train import make_train_step

    model = DiT(**CFG, tome_ratio=0.5, device="cpu")
    x, t, y = torch.zeros(2, 4, 16, 16), torch.zeros(2).long(), torch.zeros(2).long()
    with pytest.raises(ValueError, match="token merging is inference-only"):
        model(x, t, y, train=True)
    with pytest.raises(ValueError, match="token merging is inference-only"):
        make_train_step(model, create_diffusion("", device="cpu").schedule)
    with pytest.raises(ValueError, match="sequence parallelism is exact-only"):
        from fast_dit_torch.parallel import LocalRing
        model(x, t, y, ring=LocalRing(2))


@pytest.mark.parametrize("flags", [["--tome-ratio", "0.5"],
                                   ["--tome-ratio", "0.3", "--tome-mlp"]], ids=["0.5", "0.3-mlp"])
def test_sample_cli_tome_matches_the_jax_chain(tmp_path, monkeypatch, flags):
    """`python -m fast_dit_torch.sample --model DiT-S/8` with ToMe (DDIM, 3
    steps, CFG 4.0) on weights carried from JAX: the saved latents equal the
    JAX ToMe model's DDIM chain, as the JAX CLI runs it
    (`sample.py:79-88,176-180`), from the same x_T (the port's seeded draw),
    within 1e-4 of max, the chain limit of tests/test_torch_sample.py."""
    ratio, mlp = float(flags[1]), "--tome-mlp" in flags
    jmodel = JaxDiT(input_size=32, patch_size=8, hidden_size=384, depth=12, num_heads=6,
                    tome_ratio=ratio, tome_mlp=mlp, attn_backend="pallas")
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4, 32, 32)),
                         jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))
    rs = np.random.RandomState(0)
    params = jax.tree.map(lambda p: np.asarray(p) + 0.02 * rs.randn(*p.shape).astype(np.float32),
                          params)
    torch.save(flax_params_to_state_dict(params, 8, 4, 32), tmp_path / "w.pt")
    monkeypatch.chdir(tmp_path)
    args = cli.parse_args(["--device", "cpu", "--ckpt", str(tmp_path / "w.pt"),
                           "--model", "DiT-S/8", "--sampler", "ddim",
                           "--num-sampling-steps", "3", *flags])
    cli.main(args)
    got = np.load(tmp_path / "sample.npy")
    model = cli.build_model(args, torch.device("cpu"), args.seed)
    assert model.tome_r == tt.tome_merge_count(16, ratio) > 0
    z, y, _ = cli.sampling_inputs(args, model)
    yy = np.concatenate([y.numpy(), np.full(len(y), 1000)]).astype(np.int32)
    jdiff = jax_create_diffusion("3")
    run = jax.jit(lambda p, n: jdiff.ddim_sample_loop(
        lambda x, t: jmodel.apply(p, x, t, yy, 4.0, method=jmodel.forward_with_cfg),
        n.shape, noise=n, clip_denoised=False))
    want = np.asarray(run(params, z.numpy()))[: len(y)]
    assert got.shape == want.shape == (8, 4, 32, 32)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert os.path.exists(tmp_path / "sample.png")
