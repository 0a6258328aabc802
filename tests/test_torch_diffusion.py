"""The port's diffusion core (fast_dit_torch/diffusion) against the JAX package.

Schedules, respacing, the single DDPM / DDIM steps and whole sampling chains.
Inputs and the per-step noise are made with numpy from a seed and handed to
both sides; the chains run over one analytic model written twice (the
pattern of tests/test_reference_oracle.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_dit_tpu.diffusion import create_diffusion as jax_create_diffusion
from fast_dit_tpu.diffusion import gaussian as jax_gaussian
from fast_dit_tpu.diffusion import space_timesteps as jax_space_timesteps
from fast_dit_torch.diffusion import create_diffusion, gaussian, space_timesteps
from fast_dit_torch.diffusion.schedule import derive_tables

TABLES = sorted(derive_tables(np.linspace(1e-4, 0.02, 10)))
RESPACINGS = ["250", "ddim50", "10,15,20", "", "7"]
STEP_ATOL = 1e-5   # one fp32 step on |x| ~ 1 inputs; the ops run in other orders
CHAIN_RTOL = 1e-5  # whole chains, relative to max |JAX result| (latents reach ~1e2)


def jax_model(x, t):
    a = jnp.cos(0.013 * t.astype(jnp.float32) + 0.7)[:, None, None, None]
    eps = 0.3 * x * a + 0.1 * jnp.sin(2.0 * x)
    return jnp.concatenate([eps, jnp.tanh(0.5 * x)], axis=1)


def torch_model(x, t):
    a = torch.cos(0.013 * t.float() + 0.7)[:, None, None, None]
    eps = 0.3 * x * a + 0.1 * torch.sin(2.0 * x)
    return torch.cat([eps, torch.tanh(0.5 * x)], dim=1)


@pytest.mark.parametrize("respacing", RESPACINGS)
def test_schedule_tables_bit_equal(respacing):
    ours = create_diffusion(respacing, device="cpu").schedule
    theirs = jax_create_diffusion(respacing).schedule
    assert ours.num_timesteps == theirs.num_timesteps
    assert ours.original_num_steps == theirs.original_num_steps == 1000
    assert (ours.mean_type.value, ours.var_type.value, ours.loss_type.value) == (
        theirs.mean_type.value, theirs.var_type.value, theirs.loss_type.value)
    for name in TABLES:
        got = getattr(ours, name)
        assert got.dtype == torch.float32, name
        assert np.array_equal(got.numpy(), np.asarray(getattr(theirs, name))), name
    assert np.array_equal(ours.timestep_map.numpy(), np.asarray(theirs.timestep_map))


@pytest.mark.parametrize("kwargs", [
    dict(learn_sigma=False), dict(learn_sigma=False, sigma_small=True),
    dict(predict_xstart=True), dict(use_kl=True), dict(rescale_learned_sigmas=True),
    dict(noise_schedule="squaredcos_cap_v2"), dict(diffusion_steps=100),
])
def test_create_diffusion_options_match(kwargs):
    ours = create_diffusion("10", device="cpu", **kwargs).schedule
    theirs = jax_create_diffusion("10", **kwargs).schedule
    assert (ours.mean_type.value, ours.var_type.value, ours.loss_type.value) == (
        theirs.mean_type.value, theirs.var_type.value, theirs.loss_type.value)
    for name in TABLES:
        assert np.array_equal(getattr(ours, name).numpy(),
                              np.asarray(getattr(theirs, name))), name


@pytest.mark.parametrize("n,counts", [
    (1000, "250"), (1000, "ddim50"), (1000, "ddim25"), (1000, "10,15,20"),
    (1000, [3, 5]), (1000, "1"), (100, "ddim10"), (37, "5,5,5"), (1000, "1000"),
])
def test_space_timesteps_sets_equal(n, counts):
    assert space_timesteps(n, counts) == jax_space_timesteps(n, counts)


@pytest.mark.parametrize("n,counts", [(1000, "ddim999"), (10, "11")])
def test_space_timesteps_refuses_what_jax_refuses(n, counts):
    with pytest.raises(ValueError):
        jax_space_timesteps(n, counts)
    with pytest.raises(ValueError):
        space_timesteps(n, counts)


def _step_inputs(B=4, C=3, HW=4, seed=0, T=250):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, C, HW, HW).astype(np.float32)
    out = rs.randn(B, 2 * C, HW, HW).astype(np.float32)
    out[:, C:] = np.tanh(out[:, C:])  # the variance half lives in [-1, 1]
    noise = rs.randn(B, C, HW, HW).astype(np.float32)
    t = np.array([0, 1, T // 2, T - 1][:B], np.int64)
    return x, out, noise, t


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("kwargs", [dict(), dict(learn_sigma=False),
                                    dict(learn_sigma=False, sigma_small=True)])
def test_p_sample_step_matches(clip, kwargs):
    ours = create_diffusion("250", device="cpu", **kwargs).schedule
    theirs = jax_create_diffusion("250", **kwargs).schedule
    x, out, noise, t = _step_inputs()
    if not kwargs.get("learn_sigma", True):
        out = out[:, :3]
    want = jax_gaussian.p_sample_step(theirs, jnp.asarray(out), jnp.asarray(x),
                                      jnp.asarray(t, jnp.int32), jnp.asarray(noise),
                                      clip_denoised=clip)
    got = gaussian.p_sample_step(ours, torch.from_numpy(out), torch.from_numpy(x),
                                 torch.from_numpy(t), torch.from_numpy(noise),
                                 clip_denoised=clip)
    assert np.abs(got.sample.numpy() - np.asarray(want.sample)).max() <= STEP_ATOL
    assert np.abs(got.pred_xstart.numpy() - np.asarray(want.pred_xstart)).max() <= STEP_ATOL


@pytest.mark.parametrize("eta", [0.0, 0.5])
@pytest.mark.parametrize("clip", [True, False])
def test_ddim_step_matches(eta, clip):
    ours = create_diffusion("ddim50", device="cpu").schedule
    theirs = jax_create_diffusion("ddim50").schedule
    x, out, noise, t = _step_inputs(T=50)
    want = jax_gaussian.ddim_step(theirs, jnp.asarray(out), jnp.asarray(x),
                                  jnp.asarray(t, jnp.int32), jnp.asarray(noise),
                                  eta=eta, clip_denoised=clip)
    got = gaussian.ddim_step(ours, torch.from_numpy(out), torch.from_numpy(x),
                             torch.from_numpy(t), torch.from_numpy(noise),
                             eta=eta, clip_denoised=clip)
    assert np.abs(got.sample.numpy() - np.asarray(want.sample)).max() <= STEP_ATOL
    assert np.abs(got.pred_xstart.numpy() - np.asarray(want.pred_xstart)).max() <= STEP_ATOL


def test_q_sample_matches():
    ours = create_diffusion("", device="cpu")
    theirs = jax_create_diffusion("")
    x, _, noise, t = _step_inputs(T=1000)
    want = theirs.q_sample(jnp.asarray(x), jnp.asarray(t, jnp.int32), jnp.asarray(noise))
    got = ours.q_sample(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(noise))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= STEP_ATOL


@pytest.mark.parametrize("respacing,loop,eta", [
    ("250", "p_sample_loop", None),
    ("ddim50", "ddim_sample_loop", 0.0),
    ("ddim50", "ddim_sample_loop", 1.0),
])
def test_sampling_chain_matches(respacing, loop, eta):
    ours, theirs = create_diffusion(respacing, device="cpu"), jax_create_diffusion(respacing)
    T = ours.num_timesteps
    rs = np.random.RandomState(3)
    shape = (2, 2, 8, 8)
    noise = rs.randn(*shape).astype(np.float32)
    step_noise = rs.randn(T, *shape).astype(np.float32)
    kw = {} if eta is None else dict(eta=eta)
    want = np.asarray(jax.jit(lambda n, sn: getattr(theirs, loop)(
        jax_model, shape, noise=n, step_noise=sn, clip_denoised=False, **kw))(
            noise, step_noise))
    got = getattr(ours, loop)(torch_model, shape, noise=torch.from_numpy(noise),
                              step_noise=torch.from_numpy(step_noise),
                              clip_denoised=False, **kw).numpy()
    assert got.shape == want.shape == shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= CHAIN_RTOL * np.abs(want).max()


def test_loop_draws_from_the_generator_and_checks_its_inputs():
    d = create_diffusion("5", device="cpu")
    shape = (2, 2, 4, 4)
    run = lambda seed: d.p_sample_loop(torch_model, shape, generator=torch.Generator()
                                       .manual_seed(seed), clip_denoised=False)
    assert torch.equal(run(0), run(0))
    assert not torch.equal(run(0), run(1))
    with pytest.raises(ValueError, match="noise"):
        d.p_sample_loop(torch_model, shape)
    with pytest.raises(ValueError, match="step_noise"):
        d.p_sample_loop(torch_model, shape, noise=torch.zeros(shape),
                        step_noise=torch.zeros(4, *shape))
    # eta = 0 DDIM is deterministic and needs no generator
    x = d.ddim_sample_loop(torch_model, shape, noise=torch.zeros(shape))
    assert x.shape == shape


def test_create_diffusion_raises_without_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_diffusion("10")
