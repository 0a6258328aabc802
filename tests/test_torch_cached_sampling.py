"""The port's FORA layer-cached samplers against the JAX package: the refresh
masks, the DiT's layer cache, the cached DDPM and DDIM loops, the guidance
interval composed with the cache, and both sampler CLIs with the cache (as
tests/test_cached_sampling.py holds JAX's).

Weights are made on the JAX side and cross through
`flax_params_to_state_dict`; inputs are numpy from a seed. JAX's cached
loops draw their step noise from `fold_in(rng, T-1-k)`: the same draws are
made here and handed to the port's loops as `step_noise`. Tolerances:
- the refresh masks (host fp64 arithmetic on both sides) must be equal;
- interval 1 and an all-True mask run the plain loop's calls and step
  math, so they equal it exactly;
- a small DiT's branch outputs and outputs, XLA's einsum against the
  attention's plain version: CACHE_RTOL of max |JAX|;
- whole chains, 10-20 fp32 steps over two blocks: DIT_RTOL (1e-4) of max
  |JAX latents|, the limit of tests/test_torch_samplers.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fast_dit_tpu.diffusion as jdiff
from fast_dit_tpu.diffusion import sampling as jsampling
from fast_dit_tpu.models import DiT as JaxDiT
from fast_dit_torch import sample as cli
from fast_dit_torch import sample_ddp
from fast_dit_torch.ckpt import flax_params_to_state_dict
from fast_dit_torch.diffusion import (cache_refresh_mask, create_diffusion,
                                      guidance_interval_cached_fns, guided_steps_korder)
from fast_dit_torch.models import DiT
from fast_dit_torch.ops import _build
from test_torch_world import drop_tmp_path  # noqa: F401 (an autouse fixture)

TINY = dict(input_size=8, patch_size=2, hidden_size=32, depth=2, num_heads=4, num_classes=10)
CACHE_RTOL = 1e-5
DIT_RTOL = 1e-4
LABELS = [3, 7]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_dits(seed=0):
    jmodel = JaxDiT(**TINY, attn_backend="einsum")
    params = jmodel.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 4, 8, 8)),
                         jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))
    rs = np.random.RandomState(seed)
    params = jax.tree.map(lambda p: np.asarray(p) + 0.05 * rs.randn(*p.shape).astype(np.float32),
                          params)
    model = DiT(**TINY, device="cpu")
    model.load_state_dict(flax_params_to_state_dict(params, 2, 4, 8), strict=True)
    return jmodel, params, model.eval()


def _z(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= rtol * np.abs(want).max(), np.abs(got - want).max()


def _jax_step_noise(rng, T, shape):
    """The draws of JAX's cached loops, in step order."""
    return np.stack([np.asarray(jax.random.normal(jax.random.fold_in(rng, T - 1 - k), shape))
                     for k in range(T)])


def _fns(jmodel, params, model, cfg):
    """(JAX full, JAX cached, port full, port cached), with CFG 4.0 over
    [LABELS; null] or conditional on LABELS."""
    if cfg:
        yy = np.array(LABELS + [10, 10], np.int32)
        ty = torch.from_numpy(yy.astype(np.int64))
        japply = lambda x, t, **kw: jmodel.apply(params, x, t, jnp.asarray(yy), 4.0,
                                                 method=jmodel.forward_with_cfg, **kw)
        apply = lambda x, t, **kw: model.forward_with_cfg(x, t, ty, 4.0, **kw)
    else:
        y = np.array(LABELS, np.int32)
        ty = torch.from_numpy(y.astype(np.int64))
        japply = lambda x, t, **kw: jmodel.apply(params, x, t, jnp.asarray(y), **kw)
        apply = lambda x, t, **kw: model(x, t, ty, **kw)
    return (lambda x, t: japply(x, t, want_cache=True),
            lambda x, t, c: japply(x, t, cache=c),
            lambda x, t: apply(x, t, want_cache=True),
            lambda x, t, c: apply(x, t, cache=c))


# -- the refresh masks ----------------------------------------------------------

@pytest.mark.parametrize("respacing", ["10", "20", "50", "250", "ddim25", "karras12"])
@pytest.mark.parametrize("schedule", ["uniform", "abar", "logsnr"])
@pytest.mark.parametrize("interval", [1, 2, 3, 5])
def test_cache_refresh_mask_equals_jax(respacing, schedule, interval):
    ours, theirs = create_diffusion(respacing, device="cpu"), jdiff.create_diffusion(respacing)
    got = cache_refresh_mask(ours.schedule, interval, schedule)
    want = jsampling.cache_refresh_mask(theirs.schedule, interval, schedule)
    assert got.dtype == bool and np.array_equal(got, want)
    assert got[0] and got.sum() == -(-ours.num_timesteps // interval)  # the budget, exactly


def test_cache_refresh_mask_refuses_an_unknown_schedule():
    with pytest.raises(ValueError, match="unknown cache refresh schedule"):
        cache_refresh_mask(create_diffusion("10", device="cpu").schedule, 2, "cosine")


# -- the DiT's layer cache ------------------------------------------------------

@pytest.mark.parametrize("cfg", [False, True], ids=["cond", "cfg"])
def test_want_cache_and_cache_match_jax_dit(cfg):
    jmodel, params, model = _tiny_dits(seed=2)
    jfull, jcached, full, cached = _fns(jmodel, params, model, cfg)
    B = 4 if cfg else 2
    x = _z((B, 4, 8, 8), seed=3)
    t0, t1 = np.full((B,), 700, np.int32), np.full((B,), 640, np.int32)
    jout, jcache = jfull(jnp.asarray(x), jnp.asarray(t0))
    jout1 = jcached(jnp.asarray(x), jnp.asarray(t1), jcache)
    _build.reset_launch_counts()
    with torch.inference_mode():
        out, cache = full(torch.from_numpy(x), torch.from_numpy(t0.astype(np.int64)))
        out1 = cached(torch.from_numpy(x), torch.from_numpy(t1.astype(np.int64)), cache)
        plain = model.forward_with_cfg(torch.from_numpy(x), torch.from_numpy(
            t0.astype(np.int64)), torch.tensor(LABELS + [10, 10]), 4.0) if cfg else model(
            torch.from_numpy(x), torch.from_numpy(t0.astype(np.int64)), torch.tensor(LABELS))
    assert not any(_build.launch_counts.values())  # the CPU runs the plain versions
    assert torch.equal(out, plain)  # want_cache changes nothing of the output
    assert len(cache) == 2 and all(tuple(c.shape) == (2, B, 16, 32) for c in cache)
    for got, want in zip(cache, jcache):
        _close(got, want, CACHE_RTOL)
    _close(out, jout, CACHE_RTOL)
    _close(out1, jout1, CACHE_RTOL)
    assert not torch.equal(out1, out)  # fresh gates at the new t


def test_a_cached_call_runs_no_attention():
    _, _, model = _tiny_dits()
    x, t, y = torch.randn(2, 4, 8, 8), torch.tensor([5, 5]), torch.tensor(LABELS)
    with torch.inference_mode():
        _, cache = model(x, t, y, want_cache=True)
        for blk in model.blocks:  # any attention call would now raise
            blk.attn.forward = None
        out = model(x, torch.tensor([4, 4]), y, cache=cache)
    assert torch.isfinite(out).all()


# -- the cached loops -----------------------------------------------------------

@pytest.mark.parametrize("loop", ["p_sample_loop", "ddim_sample_loop"])
@pytest.mark.parametrize("cfg", [False, True], ids=["cond", "cfg"])
def test_interval_one_equals_the_plain_loop(loop, cfg):
    jmodel, params, model = _tiny_dits(seed=4)
    _, _, full, cached = _fns(jmodel, params, model, cfg)
    ours = create_diffusion("10", device="cpu")
    B = 4 if cfg else 2
    z = torch.from_numpy(_z((B, 4, 8, 8), seed=5))
    step_noise = torch.from_numpy(_z((10, B, 4, 8, 8), seed=6))
    plain_fn = lambda x, t: full(x, t)[0]
    with torch.inference_mode():
        want = getattr(ours, loop)(plain_fn, z.shape, noise=z, step_noise=step_noise,
                                   clip_denoised=False)
        got = getattr(ours, f"{loop}_cached")(full, cached, z.shape, interval=1, noise=z,
                                              step_noise=step_noise, clip_denoised=False)
        for schedule in ("abar", "logsnr"):  # at interval 1 every schedule refreshes always
            other = getattr(ours, f"{loop}_cached")(full, cached, z.shape, interval=1,
                                                    refresh_schedule=schedule, noise=z,
                                                    step_noise=step_noise, clip_denoised=False)
            assert torch.equal(other, want)
    assert torch.equal(got, want)


@pytest.mark.parametrize("loop", ["p_sample_loop_cached", "ddim_sample_loop_cached"])
@pytest.mark.parametrize("interval,schedule", [(2, "uniform"), (3, "uniform"), (3, "logsnr"),
                                               (2, "abar"), (4, "logsnr")])
def test_cached_loops_match_jax(loop, interval, schedule):
    jmodel, params, model = _tiny_dits(seed=6)
    jfull, jcached, full, cached = _fns(jmodel, params, model, cfg=True)
    ours, theirs = create_diffusion("20", device="cpu"), jdiff.create_diffusion("20")
    z = np.concatenate([_z((2, 4, 8, 8), seed=7)] * 2)
    rng = jax.random.PRNGKey(8)
    want = getattr(theirs, loop)(jfull, jcached, z.shape, interval=interval,
                                 refresh_schedule=schedule, noise=jnp.asarray(z), rng=rng,
                                 clip_denoised=False)
    calls = {"full": 0, "cached": 0}

    def counted(fn, key):
        def f(*a):
            calls[key] += 1
            return fn(*a)
        return f

    step_noise = torch.from_numpy(_jax_step_noise(rng, 20, z.shape))
    with torch.inference_mode():
        got = getattr(ours, loop)(counted(full, "full"), counted(cached, "cached"), z.shape,
                                  interval=interval, refresh_schedule=schedule,
                                  noise=torch.from_numpy(z), step_noise=step_noise,
                                  clip_denoised=False)
    refreshes = int(cache_refresh_mask(ours.schedule, interval, schedule).sum())
    assert calls == {"full": refreshes, "cached": 20 - refreshes}
    _close(got[:2], np.asarray(want)[:2], DIT_RTOL)


def test_cached_loop_needs_noise_or_a_generator():
    _, _, model = _tiny_dits()
    _, _, full, cached = _fns(None, None, model, cfg=False)
    ours = create_diffusion("4", device="cpu")
    with pytest.raises(ValueError, match="generator"):
        ours.p_sample_loop_cached(full, cached, (2, 4, 8, 8), interval=2,
                                  noise=torch.zeros(2, 4, 8, 8))
    with pytest.raises(ValueError, match="interval"):
        ours.ddim_sample_loop_cached(full, cached, (2, 4, 8, 8), interval=0,
                                     noise=torch.zeros(2, 4, 8, 8))
    g = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        a = ours.p_sample_loop_cached(full, cached, (2, 4, 8, 8), interval=2, generator=g)
        b = ours.p_sample_loop_cached(full, cached, (2, 4, 8, 8), interval=2,
                                      generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and torch.isfinite(a).all()


# -- the guidance interval with the cache ---------------------------------------

@pytest.mark.parametrize("respacing,band", [("20", (0.28, 5.42)), ("50", (0.19, 1.61)),
                                            ("10", (0.0, np.inf)), ("10", (1e9, 2e9))])
def test_forced_refresh_mask_equals_jax(respacing, band):
    ours, theirs = create_diffusion(respacing, device="cpu"), jdiff.create_diffusion(respacing)
    noop = lambda *a, **k: None
    *_, got = guidance_interval_cached_fns(noop, noop, ours.schedule, *band)
    *_, want = jdiff.guidance_interval_cached_fns(noop, noop, theirs.schedule, *band)
    assert np.array_equal(got, want)
    g = guided_steps_korder(ours.schedule, *band)
    # each band entry, and only those, is forced
    assert got.sum() == int(g[0]) + int(((~g[:-1]) & g[1:]).sum())


@pytest.mark.parametrize("loop,interval,schedule", [("p_sample_loop_cached", 2, "uniform"),
                                                    ("ddim_sample_loop_cached", 3, "logsnr")])
def test_guidance_interval_with_the_cache_matches_jax(loop, interval, schedule):
    jmodel, params, model = _tiny_dits(seed=9)
    yy = np.array(LABELS + [10, 10], np.int32)
    ty = torch.from_numpy(yy.astype(np.int64))
    jcfg = lambda x, t, **kw: jmodel.apply(params, x, t, jnp.asarray(yy), 4.0,
                                           method=jmodel.forward_with_cfg, **kw)
    jcond = lambda x, t, **kw: jmodel.apply(params, x, t, jnp.asarray(yy[:2]), **kw)
    calls = []
    cfg = lambda x, t, **kw: (calls.append(("cfg", x.shape[0], "cache" in kw)),
                              model.forward_with_cfg(x, t, ty, 4.0, **kw))[1]
    cond = lambda x, t, **kw: (calls.append(("cond", x.shape[0], "cache" in kw)),
                               model(x, t, ty[:2], **kw))[1]
    ours, theirs = create_diffusion("20", device="cpu"), jdiff.create_diffusion("20")
    band = (0.28, 5.42)
    jfull, jcached, jforced = jdiff.guidance_interval_cached_fns(jcfg, jcond, theirs.schedule,
                                                                 *band)
    full, cached, forced = guidance_interval_cached_fns(cfg, cond, ours.schedule, *band)
    z = np.concatenate([_z((2, 4, 8, 8), seed=10)] * 2)
    rng = jax.random.PRNGKey(11)
    want = getattr(theirs, loop)(jfull, jcached, z.shape, interval=interval,
                                 refresh_schedule=schedule, force_refresh_mask=jforced,
                                 noise=jnp.asarray(z), rng=rng, clip_denoised=False)
    with torch.inference_mode():
        got = getattr(ours, loop)(full, cached, z.shape, interval=interval,
                                  refresh_schedule=schedule, force_refresh_mask=forced,
                                  noise=torch.from_numpy(z),
                                  step_noise=torch.from_numpy(_jax_step_noise(rng, 20, z.shape)),
                                  clip_denoised=False)
    _close(got[:2], np.asarray(want)[:2], DIT_RTOL)
    # each step: a guided call on 4 inside the band, a conditional one on 2 outside,
    # a refresh where the mask (with the band entries) says so
    g = guided_steps_korder(ours.schedule, *band)
    refresh = cache_refresh_mask(ours.schedule, interval, schedule) | forced
    assert 0 < g.sum() < 20 and forced.any()
    assert calls == [("cfg" if g[k] else "cond", 4 if g[k] else 2, not refresh[k])
                     for k in range(20)]


# -- the CLIs -------------------------------------------------------------------

def test_cached_sampling_slice_matches_jax():
    """`python -m fast_dit_torch.sample --cache-interval 2 --num-sampling-steps
    10`'s chain (`make_model_fn` + `run_chain`) against the root `sample.py`'s
    cached path (`p_sample_loop_cached` over `forward_with_cfg` with the
    cache, CFG 4.0), same weights and noise, JAX's step noise injected."""
    jmodel, params, model = _tiny_dits(seed=12)
    args = cli.parse_args(["--device", "cpu", "--num-sampling-steps", "10",
                           "--cache-interval", "2", "--num-classes", "10"])
    y = np.array(LABELS + [10, 10], np.int32)
    z = np.concatenate([_z((2, 4, 8, 8), seed=13)] * 2)
    rng = jax.random.PRNGKey(14)
    jd = jdiff.create_diffusion("10")
    japply = lambda x, t, **kw: jmodel.apply(params, x, t, jnp.asarray(y), 4.0,
                                             method=jmodel.forward_with_cfg, **kw)
    want = jd.p_sample_loop_cached(lambda x, t: japply(x, t, want_cache=True),
                                   lambda x, t, c: japply(x, t, cache=c), z.shape, interval=2,
                                   noise=jnp.asarray(z), rng=rng, clip_denoised=False)

    diffusion = cli.build_diffusion(args, torch.device("cpu"))
    fns = cli.make_model_fn(args, model, diffusion, torch.tensor(LABELS))
    assert isinstance(fns, cli.CachedModelFns) and fns.forced is None
    noise = torch.from_numpy(_jax_step_noise(rng, 10, z.shape))
    with torch.inference_mode():
        got = diffusion.p_sample_loop_cached(fns.full, fns.cached, z.shape, interval=2,
                                             noise=torch.from_numpy(z), step_noise=noise,
                                             clip_denoised=False)
        # run_chain draws its step noise from the generator: the same loop
        g = torch.Generator().manual_seed(0)
        chain = cli.run_chain(args, diffusion, fns, torch.from_numpy(z), g)
        again = diffusion.p_sample_loop_cached(fns.full, fns.cached, z.shape, interval=2,
                                               noise=torch.from_numpy(z),
                                               generator=torch.Generator().manual_seed(0),
                                               clip_denoised=False)
    _close(got[:2], np.asarray(want)[:2], DIT_RTOL)
    assert torch.equal(chain, again)


CACHE_FLAGS = [
    ["--cache-interval", "2"],
    ["--sampler", "ddim", "--cache-interval", "3", "--cache-schedule", "logsnr"],
    ["--cache-interval", "2", "--cache-schedule", "abar"],
    ["--cache-interval", "2", "--cfg-interval", "0.28", "5.42"],
    ["--sampler", "ddim", "--cache-interval", "2", "--cfg-scale", "1.0"],
]


@pytest.mark.parametrize("flags", CACHE_FLAGS, ids=lambda f: "_".join(f).replace("-", ""))
def test_sample_cli_runs_the_cache_on_cpu(flags):
    args = cli.parse_args(["--device", "cpu", "--ckpt", "random", "--model", "DiT-S/8",
                           "--num-sampling-steps", "6", *flags])
    cli.check_args(args)
    model, diffusion = cli.build(args)
    calls = []
    hook = model.register_forward_pre_hook(lambda m, a, kw: calls.append("cache" in kw
                                                                         and kw["cache"]
                                                                         is not None),
                                           with_kwargs=True)
    out = cli.sample_latents(args, model, diffusion)
    hook.remove()
    assert out.shape == (len(cli.CLASS_LABELS), 4, 32, 32)
    assert torch.isfinite(out).all() and out.std() > 0
    assert 0 < calls.count(True) < len(calls) == 6  # some steps replayed the cache
    assert torch.equal(out, cli.sample_latents(args, model, diffusion))  # seeded


@pytest.mark.parametrize("flags", CACHE_FLAGS[:2] + CACHE_FLAGS[3:4],
                         ids=lambda f: "_".join(f).replace("-", ""))
def test_sample_ddp_cli_runs_the_cache_on_cpu(tmp_path, flags):
    args = sample_ddp.build_parser().parse_args([
        "--device", "cpu", "--model", "DiT-S/8", "--ckpt", "random", "--num-sampling-steps",
        "4", "--per-proc-batch-size", "2", "--num-fid-samples", "2", "--cfg-scale", "4.0",
        "--sample-dir", str(tmp_path / "s"), "--io-threads", "1", *flags])
    res = sample_ddp.main(args)
    arr = np.load(res["npz"])["arr_0"]
    assert arr.shape == (2, 32, 32, 3) and arr.dtype == np.uint8 and arr.std() > 0


@pytest.mark.parametrize("flags,message", [
    (["--sampler", "dpm", "--cache-interval", "2"], "composes with ddpm/ddim"),
    (["--sampler", "unipc", "--cache-interval", "3"], "honest-compute fast path"),
    (["--sampler", "euler", "--cache-interval", "2"], "discrete-chain features"),
    (["--sampler", "heun", "--cache-interval", "2"], "euler/heun integrate the flow ODE"),
])
def test_both_clis_refuse_the_cache_where_jax_does(flags, message, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for parse, main in ((cli.parse_args, cli.main),
                        (sample_ddp.build_parser().parse_args, sample_ddp.main)):
        args = parse(["--device", "cpu", "--ckpt", "random", "--model", "DiT-S/8", *flags])
        with pytest.raises(SystemExit, match=message):
            main(args)
    assert not list(tmp_path.iterdir())
