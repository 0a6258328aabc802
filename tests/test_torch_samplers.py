"""The port's fast samplers against the JAX package: the fp64 host tables,
Karras spacing, the Gaussian step math that slice 7 adds (denoised_fn,
classifier guidance, the reverse DDIM step, the likelihood terms), the
loops (DDPM/DDIM options, reverse DDIM, DPM-Solver++, UniPC), the guidance
interval, the `Diffusion` facade, the sampling slice through the CLI's own
functions, and the CLIs' new flags on the CPU.

Inputs and noise are numpy from a seed, handed to both sides; the chains
run over the analytic model of tests/test_torch_diffusion.py or over small
DiTs whose weights cross with `flax_params_to_state_dict`. Tolerances:
- tables built on the host in fp64 (UniPC's coefficients, the Karras grid,
  the guidance mask, the fp64 alphas_cumprod) must be equal;
- DPM-Solver's coefficients are fp32 with log and log1p on each side's own
  CPU math library, so they may round apart: c_x and c_d by 4 ulps (4 *
  2^-24 relative); w = h_k / (2 h_{k-1}) is a ratio of differences of
  lambda (|lambda| up to 10, h down to 0.1 at 20 steps), where an ulp of
  lambda is up to 1e-6 of h: 1e-5 relative (measured 5e-7 at 20 steps);
- one step: STEP_ATOL; whole chains: CHAIN_RTOL of max |JAX| (the analytic
  chains reach |x| ~ 300; measured about 1e-6 relative).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_diffusion import CHAIN_RTOL, STEP_ATOL, TABLES, jax_model, torch_model
from test_vae import make_vae_state_dict

import fast_dit_tpu.diffusion as jdiff
from fast_dit_tpu.diffusion import gaussian as jax_gaussian
from fast_dit_tpu.models import DiT as JaxDiT
from fast_dit_torch import sample as cli
from fast_dit_torch import sample_ddp
from fast_dit_torch.ckpt import flax_params_to_state_dict
from fast_dit_torch.diffusion import (create_diffusion, gaussian, guidance_interval_fn,
                                      guidance_interval_mask, guided_steps_korder,
                                      karras_timesteps, sampling)
from fast_dit_torch.models import DiT
from test_torch_world import drop_tmp_path  # noqa: F401 (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLE_ULPS = 4 * 2.0 ** -24  # DPM-Solver's fp32 c_x and c_d, relative
W_RTOL = 1e-5                # and its multistep weight w
SHAPE = (2, 2, 8, 8)
TINY = dict(input_size=8, patch_size=2, hidden_size=32, depth=2, num_heads=4, num_classes=10)
# a small DiT's chains, relative to max |JAX latents|: 10-20 fp32 steps over
# two blocks, the attention twin against XLA's einsum
DIT_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test process: the suite runs several pytest
    workers on a few cores, and torch's parallel regions oversubscribed
    them about fifty-fold (a DiT-S/8 chain took 98 s instead of 2)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(respacing, **kw):
    return create_diffusion(respacing, device="cpu", **kw), jdiff.create_diffusion(respacing, **kw)


def _z(shape=SHAPE, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, rtol=CHAIN_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= rtol * np.abs(want).max(), np.abs(got - want).max()


def _scan_body_vars(monkeypatch, run):
    """Run `run()` with jax.lax.scan recording the free variables of the
    body it is given: the tables a JAX loop bakes into its scan."""
    seen, real = [], jax.lax.scan

    def spy(body, init, xs, *args, **kwargs):
        cells = body.__closure__ or ()
        seen.append(dict(zip(body.__code__.co_freevars, (c.cell_contents for c in cells))))
        return real(body, init, xs, *args, **kwargs)

    monkeypatch.setattr(jax.lax, "scan", spy)
    run()
    return seen[-1]


# -- the schedule's host tables and Karras spacing --------------------------

@pytest.mark.parametrize("respacing", ["250", "ddim50", "karras10", "karras25", "", "1"])
def test_schedule_keeps_the_fp64_alphas_cumprod_of_jax(respacing):
    ours, theirs = _pair(respacing)
    assert ours.schedule.alphas_cumprod_fp64 == theirs.schedule.alphas_cumprod_fp64
    assert all(type(a) is float for a in ours.schedule.alphas_cumprod_fp64)
    assert ours.schedule.timestep_map_host == tuple(np.asarray(theirs.timestep_map).tolist())
    assert ours.original_num_steps == theirs.original_num_steps == 1000
    assert np.array_equal(ours.timestep_map.numpy(), np.asarray(theirs.timestep_map))


@pytest.mark.parametrize("n", [1, 2, 5, 10, 20, 25, 50, 250, 1000])
@pytest.mark.parametrize("schedule", ["linear", "squaredcos_cap_v2"])
def test_karras_timesteps_equal_jax(n, schedule):
    from fast_dit_tpu.diffusion.schedule import get_named_beta_schedule

    abar = np.cumprod(1.0 - get_named_beta_schedule(schedule, 1000))
    got = karras_timesteps(abar, n)
    assert got == jdiff.karras_timesteps(abar, n) and len(got) == n
    assert karras_timesteps(abar, n, rho=3.0) == jdiff.karras_timesteps(abar, n, rho=3.0)


@pytest.mark.parametrize("n", [0, 1001])
def test_karras_timesteps_refuse_what_jax_refuses(n):
    abar = np.cumprod(1.0 - np.linspace(1e-4, 0.02, 1000))
    with pytest.raises(ValueError):
        jdiff.karras_timesteps(abar, n)
    with pytest.raises(ValueError):
        karras_timesteps(abar, n)


@pytest.mark.parametrize("respacing", ["karras10", "karras25"])
def test_karras_schedule_tables_bit_equal(respacing):
    ours, theirs = _pair(respacing)
    assert ours.num_timesteps == theirs.num_timesteps
    for name in TABLES:
        assert np.array_equal(getattr(ours.schedule, name).numpy(),
                              np.asarray(getattr(theirs.schedule, name))), name


# -- Gaussian step math ------------------------------------------------------

def _step_inputs(T, seed=0, C=3):
    rs = np.random.RandomState(seed)
    x = rs.randn(4, C, 4, 4).astype(np.float32)
    out = rs.randn(4, 2 * C, 4, 4).astype(np.float32)
    out[:, C:] = np.tanh(out[:, C:])
    grad = rs.randn(4, C, 4, 4).astype(np.float32)
    t = np.array([0, 1, T // 2, T - 1], np.int64)
    return x, out, grad, t


def _j(*arrays):
    return [jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("clip", [True, False])
def test_p_mean_variance_applies_denoised_fn_like_jax(clip):
    ours, theirs = _pair("50")
    x, out, _, t = _step_inputs(50)
    want = jax_gaussian.p_mean_variance(theirs.schedule, *_j(out, x, t), clip_denoised=clip,
                                        denoised_fn=lambda a: 1.5 * jnp.tanh(a))
    got = gaussian.p_mean_variance(ours.schedule, *_t(out, x, t), clip_denoised=clip,
                                   denoised_fn=lambda a: 1.5 * torch.tanh(a))
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= STEP_ATOL


@pytest.mark.parametrize("kind", ["mean", "score"])
def test_classifier_guidance_matches_jax(kind):
    ours, theirs = _pair("50")
    x, out, grad, t = _step_inputs(50, seed=1)
    jout = jax_gaussian.p_mean_variance(theirs.schedule, *_j(out, x, t))
    tout = gaussian.p_mean_variance(ours.schedule, *_t(out, x, t))
    if kind == "mean":
        want = jax_gaussian.condition_mean(theirs.schedule, jnp.asarray(grad), jout)
        got = gaussian.condition_mean(ours.schedule, torch.from_numpy(grad), tout)
    else:
        want = jax_gaussian.condition_score(theirs.schedule, jnp.asarray(grad), jout,
                                            *_j(x, t))
        got = gaussian.condition_score(ours.schedule, torch.from_numpy(grad), tout, *_t(x, t))
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= STEP_ATOL


@pytest.mark.parametrize("with_grad", [False, True])
def test_ddim_reverse_step_matches_jax(with_grad):
    ours, theirs = _pair("ddim50")
    x, out, grad, t = _step_inputs(50, seed=2)
    want = jax_gaussian.ddim_reverse_step(theirs.schedule, *_j(out, x, t),
                                          cond_grad=jnp.asarray(grad) if with_grad else None)
    got = gaussian.ddim_reverse_step(ours.schedule, *_t(out, x, t),
                                     cond_grad=torch.from_numpy(grad) if with_grad else None)
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= STEP_ATOL


def test_q_moments_and_likelihood_terms_match_jax():
    ours, theirs = _pair("")
    x, out, grad, t = _step_inputs(1000, seed=3)
    for g, w in zip(ours.q_mean_variance(*_t(x, t)), theirs.q_mean_variance(*_j(x, t))):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= STEP_ATOL
    xt = x + 0.1 * grad
    for g, w in zip(ours.q_posterior_mean_variance(*_t(x, xt, t)),
                    theirs.q_posterior_mean_variance(*_j(x, xt, t))):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= STEP_ATOL
    log_scales = 0.3 * out[:, :3]
    want = jax_gaussian.continuous_gaussian_log_likelihood(*_j(x), means=jnp.asarray(grad),
                                                           log_scales=jnp.asarray(log_scales))
    got = gaussian.continuous_gaussian_log_likelihood(*_t(x), means=torch.from_numpy(grad),
                                                      log_scales=torch.from_numpy(log_scales))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5 * np.abs(np.asarray(want)).max()
    want = jax_gaussian.prior_bpd(theirs.schedule, jnp.asarray(x))
    got = gaussian.prior_bpd(ours.schedule, torch.from_numpy(x))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6


def test_calc_bpd_loop_matches_jax():
    """The whole bound over 10 respaced steps with JAX's own per-timestep
    noise (fold_in(rng, i)) injected in the port's step order; the model
    outputs stay near the truth (x_start's eps), so no term sits in the
    decoder NLL's tail."""
    ours, theirs = _pair("10")
    rs = np.random.RandomState(4)
    x0 = np.clip(rs.randn(2, 3, 4, 4) * 0.5, -1, 1).astype(np.float32)

    def jmodel(xt, tm):
        return jnp.concatenate([0.9 * xt, jnp.zeros_like(xt)], 1)

    def tmodel(xt, tm):
        return torch.cat([0.9 * xt, torch.zeros_like(xt)], 1)

    rng = jax.random.PRNGKey(5)
    want = theirs.calc_bpd_loop(jmodel, jnp.asarray(x0), rng)
    noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(rng, i), x0.shape))
                      for i in range(9, -1, -1)])
    got = ours.calc_bpd_loop(tmodel, torch.from_numpy(x0), noise=torch.from_numpy(noise))
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        assert np.abs(got[k].numpy() - w).max() <= 1e-5 * max(np.abs(w).max(), 1.0), k


# -- loops ------------------------------------------------------------------

@pytest.mark.parametrize("loop", ["p_sample_loop", "ddim_sample_loop"])
def test_loop_denoised_fn_cond_fn_and_intermediates_match_jax(loop):
    ours, theirs = _pair("20")
    z = _z()
    step_noise = np.random.RandomState(1).randn(20, *SHAPE).astype(np.float32)
    kw = {"eta": 0.5} if loop == "ddim_sample_loop" else {}
    want, want_xs = getattr(theirs, loop)(
        jax_model, SHAPE, noise=jnp.asarray(z), step_noise=jnp.asarray(step_noise),
        denoised_fn=lambda a: 0.9 * a, cond_fn=lambda x, t: -0.05 * x,
        return_intermediates=True, **kw)
    got, got_xs = getattr(ours, loop)(
        torch_model, SHAPE, noise=torch.from_numpy(z), step_noise=torch.from_numpy(step_noise),
        denoised_fn=lambda a: 0.9 * a, cond_fn=lambda x, t: -0.05 * x,
        return_intermediates=True, **kw)
    assert got_xs.shape == (20, *SHAPE) and torch.equal(got_xs[-1], got)
    _close(got, want)
    _close(got_xs, want_xs)


@pytest.mark.parametrize("respacing", ["ddim25", "karras10"])
def test_ddim_reverse_sample_loop_matches_jax(respacing):
    ours, theirs = _pair(respacing)
    x0 = np.clip(_z(seed=2), -1, 1)
    want, want_xs = theirs.ddim_reverse_sample_loop(jax_model, jnp.asarray(x0),
                                                    return_intermediates=True)
    got, got_xs = ours.ddim_reverse_sample_loop(torch_model, torch.from_numpy(x0),
                                                return_intermediates=True)
    _close(got, want)
    _close(got_xs, want_xs)


@pytest.mark.parametrize("respacing", ["20", "karras10", "ddim25", "3", "1"])
def test_dpm_solver_coefficients_match_jax(monkeypatch, respacing):
    ours, theirs = _pair(respacing)
    baked = _scan_body_vars(monkeypatch, lambda: theirs.dpm_solver_sample_loop(
        jax_model, SHAPE, noise=jnp.asarray(_z())))
    got = sampling.dpm_solver_coefficients(ours.schedule)
    for name in ("c_x", "c_d", "w"):
        want = np.asarray(baked[name], np.float64)
        g = np.asarray(got[name], np.float64)
        assert g.shape == want.shape, name
        rtol = W_RTOL if name == "w" else TABLE_ULPS
        assert np.all(np.abs(g - want) <= rtol * np.abs(want)), name
    assert got["c_x"][-1] == 0.0 and got["c_d"][-1] == 1.0 and got["w"][0] == got["w"][-1] == 0


@pytest.mark.parametrize("respacing", ["20", "karras10"])
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("clip", [False, True])
def test_dpm_solver_chain_matches_jax(respacing, order, clip):
    ours, theirs = _pair(respacing)
    z = _z(seed=3)
    want = theirs.dpm_solver_sample_loop(jax_model, SHAPE, noise=jnp.asarray(z), order=order,
                                         clip_denoised=clip)
    got, xs = ours.dpm_solver_sample_loop(torch_model, SHAPE, noise=torch.from_numpy(z),
                                          order=order, clip_denoised=clip,
                                          return_intermediates=True)
    _close(got, want)
    assert xs.shape == (ours.num_timesteps, *SHAPE) and torch.equal(xs[-1], got)


def test_dpm_solver_order_1_is_eta_0_ddim():
    ours = create_diffusion("50", device="cpu")
    z = torch.from_numpy(_z(seed=4))
    dpm = ours.dpm_solver_sample_loop(torch_model, SHAPE, noise=z, order=1, clip_denoised=False)
    ddim = ours.ddim_sample_loop(torch_model, SHAPE, noise=z, eta=0.0, clip_denoised=False)
    assert np.abs((dpm - ddim).numpy()).max() <= 1e-4 * ddim.abs().max().item()


@pytest.mark.parametrize("respacing", ["20", "karras10", "2", "1"])
@pytest.mark.parametrize("order,corrector,variant", [
    (2, True, "bh2"), (2, True, "bh1"), (2, False, "bh2"), (2, False, "bh1"),
    (1, True, "bh2"), (1, False, "bh1"),
])
def test_unipc_tables_equal_jax_bit_for_bit(monkeypatch, respacing, order, corrector, variant):
    ours, theirs = _pair(respacing)
    baked = _scan_body_vars(monkeypatch, lambda: theirs.unipc_sample_loop(
        jax_model, SHAPE, noise=jnp.asarray(_z()), order=order, corrector=corrector,
        variant=variant))
    got = sampling.unipc_coefficients(ours.schedule, order, corrector, variant)
    assert set(got) == set(baked["tab"])
    for name, want in baked["tab"].items():
        want = np.asarray(want)
        assert got[name].dtype == want.dtype == np.float32
        assert np.array_equal(got[name], want), name


@pytest.mark.parametrize("respacing", ["20", "karras10", "2"])
@pytest.mark.parametrize("order,corrector,variant", [
    (2, True, "bh2"), (2, True, "bh1"), (2, False, "bh1"), (1, True, "bh2"),
])
def test_unipc_chain_matches_jax(respacing, order, corrector, variant):
    ours, theirs = _pair(respacing)
    z = _z(seed=5)
    want = theirs.unipc_sample_loop(jax_model, SHAPE, noise=jnp.asarray(z), order=order,
                                    corrector=corrector, variant=variant, clip_denoised=False)
    got = ours.unipc_sample_loop(torch_model, SHAPE, noise=torch.from_numpy(z), order=order,
                                 corrector=corrector, variant=variant, clip_denoised=False)
    _close(got, want)


def test_unipc_without_corrector_bh2_is_dpm_solver_2m():
    ours = create_diffusion("25", device="cpu")
    z = torch.from_numpy(_z(seed=6))
    dpm = ours.dpm_solver_sample_loop(torch_model, SHAPE, noise=z, order=2, clip_denoised=False)
    uni = ours.unipc_sample_loop(torch_model, SHAPE, noise=z, order=2, corrector=False,
                                 variant="bh2", clip_denoised=False)
    # the same update written two ways (tests/test_unipc.py holds JAX to 2e-4)
    assert np.abs((uni - dpm).numpy()).max() <= 2e-4 * dpm.abs().max().item()


def test_fast_loops_refuse_without_noise_or_generator():
    ours = create_diffusion("5", device="cpu")
    for loop in (ours.dpm_solver_sample_loop, ours.unipc_sample_loop):
        with pytest.raises(ValueError, match="noise"):
            loop(torch_model, SHAPE)
    g = torch.Generator().manual_seed(0)
    a = ours.unipc_sample_loop(torch_model, SHAPE, generator=g)
    assert a.shape == SHAPE and torch.isfinite(a).all()


# -- the guidance interval ---------------------------------------------------

@pytest.mark.parametrize("respacing", ["50", "karras10", "ddim25", "250"])
@pytest.mark.parametrize("band", [(0.28, 5.42), (0.19, 1.61), (0.0, np.inf), (1e9, 2e9),
                                  (0.5, 0.5)])
def test_guidance_interval_mask_equals_jax(respacing, band):
    ours, theirs = _pair(respacing)
    got = guidance_interval_mask(ours.schedule, *band)
    want = jdiff.guidance_interval_mask(theirs.schedule, *band)
    assert got.dtype == want.dtype == bool and np.array_equal(got, want)
    assert np.array_equal(guided_steps_korder(ours.schedule, *band),
                          jdiff.guided_steps_korder(theirs.schedule, *band))


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


def _interval_fns(jmodel, params, model, band, sched, jsched):
    y = [3, 7]
    yy = np.array(y + [10, 10], np.int32)
    jcfg = lambda x, t: jmodel.apply(params, x, t, jnp.asarray(yy), 4.0,
                                     method=jmodel.forward_with_cfg)
    jcond = lambda x, t: jmodel.apply(params, x, t, jnp.asarray(yy[:2]))
    tyy = torch.from_numpy(yy.astype(np.int64))
    calls = {"cfg": 0, "cond": 0}

    def cfg(x, t):
        calls["cfg"] += 1
        return model.forward_with_cfg(x, t, tyy, 4.0)

    def cond(x, t):
        calls["cond"] += 1
        return model(x, t, tyy[:2])

    return (jdiff.guidance_interval_fn(jcfg, jcond, jsched, *band),
            guidance_interval_fn(cfg, cond, sched, *band), cfg, calls)


@pytest.mark.parametrize("loop", ["p_sample_loop", "dpm_solver_sample_loop"])
def test_guidance_interval_chain_matches_jax(loop):
    """A band that guides some of the 20 steps: the port decides each step
    on the host, JAX with lax.cond on the device; the chains agree and the
    port guided exactly the steps `guided_steps_korder` names."""
    jmodel, params, model = _tiny_dits()
    ours, theirs = _pair("20")
    band = (0.28, 5.42)
    jfn, fn, _, calls = _interval_fns(jmodel, params, model, band, ours.schedule,
                                      theirs.schedule)
    z = np.concatenate([_z((2, 4, 8, 8), seed=7)] * 2)
    kw = {}
    if loop == "p_sample_loop":
        kw = {"step_noise": np.random.RandomState(8).randn(20, *z.shape).astype(np.float32)}
    want = getattr(theirs, loop)(jfn, z.shape, noise=jnp.asarray(z), clip_denoised=False,
                                 **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.inference_mode():
        got = getattr(ours, loop)(fn, z.shape, noise=torch.from_numpy(z), clip_denoised=False,
                                  **{k: torch.from_numpy(v) for k, v in kw.items()})
    guided = int(guided_steps_korder(ours.schedule, *band).sum())
    assert 0 < guided < 20 and calls == {"cfg": guided, "cond": 20 - guided}
    _close(got[:2], np.asarray(want)[:2], DIT_RTOL)


def test_guidance_interval_extreme_bands_are_cfg_and_conditional_only():
    _, _, model = _tiny_dits(seed=1)
    ours = create_diffusion("10", device="cpu")
    tyy = torch.tensor([3, 7, 10, 10])
    cfg = lambda x, t: model.forward_with_cfg(x, t, tyy, 4.0)
    cond = lambda x, t: model(x, t, tyy[:2])
    z = torch.from_numpy(np.concatenate([_z((2, 4, 8, 8), seed=9)] * 2))
    with torch.inference_mode():
        plain = ours.ddim_sample_loop(cfg, z.shape, noise=z, clip_denoised=False)
        full = ours.ddim_sample_loop(guidance_interval_fn(cfg, cond, ours.schedule, 0.0, np.inf),
                                     z.shape, noise=z, clip_denoised=False)
        mirrored = lambda x, t: torch.cat([cond(x[:2], t[:2])] * 2)
        cond_only = ours.ddim_sample_loop(mirrored, z.shape, noise=z, clip_denoised=False)
        empty = ours.ddim_sample_loop(guidance_interval_fn(cfg, cond, ours.schedule, 1e9, 2e9),
                                      z.shape, noise=z, clip_denoised=False)
    assert torch.equal(full, plain)          # the same calls, exactly
    assert torch.equal(empty, cond_only)
    assert not torch.equal(plain, cond_only)


def test_guidance_interval_decides_from_the_host_timestep():
    """Inside a loop the decision comes from `gaussian.host_timestep`, never
    from the device t; `calc_bpd_loop` publishes its timesteps too, and a
    direct call outside a loop raises rather than read t[0]."""
    sched = create_diffusion("10", device="cpu").schedule
    seen = []

    def cfg(x, t):
        seen.append(("cfg", gaussian.host_timestep(), int(t[0])))
        return torch.cat([x, x], dim=1) * 0

    def cond(x, t):
        seen.append(("cond", gaussian.host_timestep(), int(t[0])))
        return torch.cat([x, x], dim=1) * 0

    fn = guidance_interval_fn(cfg, cond, sched, 0.5, 3.0)
    sampling.ddim_sample_loop(fn, (2, 1, 2, 2), sched, noise=torch.zeros(2, 1, 2, 2))
    tm = sched.timestep_map_host
    table = guidance_interval_mask(sched, 0.5, 3.0)
    want = [("cfg" if table[t] else "cond", t, t) for t in tm[::-1]]
    assert seen == want and {s[0] for s in seen} == {"cfg", "cond"}
    assert gaussian.host_timestep() is None
    seen.clear()
    gaussian.calc_bpd_loop(sched, fn, torch.zeros(2, 1, 2, 2), noise=torch.zeros(10, 2, 1, 2, 2))
    assert seen == want
    assert gaussian.host_timestep() is None
    with pytest.raises(RuntimeError, match="host timestep"):
        fn(torch.zeros(2, 1, 2, 2), torch.full((2,), tm[0]))


# -- the facade --------------------------------------------------------------

def test_facade_surface_and_model_kwargs():
    ours, theirs = _pair("ddim25")
    assert ours.original_num_steps == theirs.original_num_steps
    assert np.array_equal(ours.timestep_map.numpy(), np.asarray(theirs.timestep_map))
    z = _z(seed=10)
    kw_model = lambda x, t, scale: torch_model(scale * x, t)
    a = ours.dpm_solver_sample_loop(kw_model, SHAPE, noise=torch.from_numpy(z),
                                    model_kwargs={"scale": 0.5})
    b = ours.dpm_solver_sample_loop(lambda x, t: torch_model(0.5 * x, t), SHAPE,
                                    noise=torch.from_numpy(z))
    assert torch.equal(a, b)
    c = ours.unipc_sample_loop(kw_model, SHAPE, noise=torch.from_numpy(z),
                               model_kwargs={"scale": 0.5})
    assert c.shape == SHAPE


# -- the slice: sample's chains through the CLI's own functions ---------------

def _jax_s2(seed=0):
    cfg = dict(input_size=8, patch_size=2, hidden_size=384, depth=2, num_heads=6)
    model = JaxDiT(**cfg, attn_backend="pallas")
    params = model.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 4, 8, 8)),
                        jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))
    rs = np.random.RandomState(seed)
    return model, jax.tree.map(
        lambda p: np.asarray(p) + 0.02 * rs.randn(*p.shape).astype(np.float32), params), cfg


def test_dpm_sampling_slice_matches_jax():
    """`python -m fast_dit_torch.sample --sampler dpm --num-sampling-steps 10`'s
    chain (`make_model_fn` + `run_chain`) against the root `sample.py`'s dpm
    path (`create_diffusion("10")`, `dpm_solver_sample_loop` over
    `forward_with_cfg`, CFG 4.0) on the same small DiT-S/2 (the JAX Pallas
    forward interpreted), the same weights and the same noise."""
    jmodel, params, cfg = _jax_s2()
    args = cli.parse_args(["--device", "cpu", "--sampler", "dpm", "--num-sampling-steps", "10"])
    model = DiT(**cfg, device="cpu")
    model.load_state_dict(flax_params_to_state_dict(params, 2, 4, 8), strict=True)
    model.eval()
    labels = [207, 88]
    y = np.array(labels + [1000] * 2, np.int32)
    z = np.concatenate([_z((2, 4, 8, 8), seed=11)] * 2)

    jd = jdiff.create_diffusion("10")
    run = jax.jit(lambda p, n: jd.dpm_solver_sample_loop(
        lambda x, t: jmodel.apply(p, x, t, y, 4.0, method=jmodel.forward_with_cfg),
        n.shape, noise=n, clip_denoised=False))
    want = np.asarray(run(params, z))[:2]

    diffusion = cli.build_diffusion(args, torch.device("cpu"))
    fn = cli.make_model_fn(args, model, diffusion, torch.tensor(labels))
    with torch.inference_mode():
        got = cli.run_chain(args, diffusion, fn, torch.from_numpy(z), None)[:2].numpy()
    assert np.abs(want).max() > 1.0
    _close(got, want, DIT_RTOL)


# -- the CLIs on the CPU --------------------------------------------------------

NEW_SAMPLE_FLAGS = [
    ["--sampler", "dpm"], ["--sampler", "unipc"],
    ["--sampler", "unipc", "--time-spacing", "karras"], ["--sampler", "ddim", "--time-spacing", "karras"],
    ["--cfg-interval", "0.28", "5.42"], ["--sampler", "dpm", "--cfg-interval", "0.19", "1.61"],
    ["--sampler", "euler"], ["--sampler", "heun"], ["--sampler", "heun", "--cfg-scale", "1.0"],
]


@pytest.mark.parametrize("flags", NEW_SAMPLE_FLAGS, ids=lambda f: "_".join(f).replace("-", ""))
def test_sample_cli_runs_each_new_flag_on_cpu(flags):
    # DiT-S/8: 16 tokens at 256², so each chain takes about a second here
    args = cli.parse_args(["--device", "cpu", "--ckpt", "random", "--model", "DiT-S/8",
                           "--num-sampling-steps", "3", *flags])
    cli.check_args(args)
    model, diffusion = cli.build(args)
    flow = args.sampler in cli.FLOW_SAMPLERS
    assert model.out_channels == (4 if flow else 8)
    if "--time-spacing" in flags:
        assert diffusion.schedule.timestep_map_host == tuple(sorted(karras_timesteps(
            np.asarray(create_diffusion("", device="cpu").schedule.alphas_cumprod_fp64), 3)))
    out = cli.sample_latents(args, model, diffusion)
    assert out.shape == (len(cli.CLASS_LABELS), 4, 32, 32)
    assert torch.isfinite(out).all() and out.std() > 0
    assert torch.equal(out, cli.sample_latents(args, model, diffusion))  # seeded


def test_sample_cli_dpm_end_to_end_on_cpu(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "fast_dit_torch.sample", "--device", "cpu",
                           "--ckpt", "random", "--model", "DiT-S/8", "--sampler", "dpm",
                           "--num-sampling-steps", "8"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = np.load(tmp_path / "sample.npy")
    assert out.shape == (8, 4, 32, 32) and np.isfinite(out).all()
    assert (tmp_path / "sample.png").exists()


@pytest.mark.parametrize("flags,message", [
    # the layer cache is ported (tests/test_torch_cached_sampling.py): with
    # DPM-Solver it is refused with JAX's own message. ToMe and W8A8 are
    # ported too (tests/test_torch_tome.py, test_torch_quant.py): their cases
    # (message None) now run, with the model the flags name
    (["--sampler", "dpm", "--cache-interval", "2"],
     r"--cache-interval composes with ddpm/ddim; dpm/unipc are already"),
    (["--tome-ratio", "0.5"], None),
    (["--tome-mlp"], None),
    (["--quantize", "w8a8"], None),
    (["--cache-interval", "3", "--quantize", "w8a8"], None),
    (["--sampler", "euler", "--cfg-interval", "0.19", "1.61"], r"--sampler euler integrates"),
    (["--cfg-scale", "1.0", "--cfg-interval", "0.19", "1.61"], r"needs --cfg-scale > 1"),
])
def test_sample_cli_refuses_by_name(flags, message, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = cli.parse_args(["--device", "cpu", "--ckpt", "random", "--model", "DiT-S/8", *flags])
    if message is None:
        args.num_sampling_steps = 3
        cli.main(args)
        out = np.load(tmp_path / "sample.npy")
        assert out.shape == (len(cli.CLASS_LABELS), 4, 32, 32) and np.isfinite(out).all()
        model = cli.build_model(args, torch.device("cpu"), args.seed)
        assert model.tome_r == (8 if "--tome-ratio" in flags else 0)
        assert (model.quant == "w8a8") == ("--quantize" in flags)
        return
    with pytest.raises(SystemExit, match=message) as e:
        cli.main(args)
    assert "--cache-interval > 1" not in str(e.value)
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("flags", [
    ["--sampler", "dpm"], ["--sampler", "unipc", "--time-spacing", "karras"],
    ["--cfg-interval", "0.28", "5.42"], ["--sampler", "euler"], ["--sampler", "heun"],
], ids=lambda f: "_".join(f).replace("-", ""))
def test_sample_ddp_cli_runs_each_new_flag_on_cpu(tmp_path, flags):
    """2 images at batch 2 through the harness's own main (random narrow
    VAE): the npz equals the PNGs and the port's own `generate`."""
    vae_bin = str(tmp_path / "vae.bin")
    torch.save({k: torch.from_numpy(v) for k, v in make_vae_state_dict(0, (32, 64), 4).items()},
               vae_bin)
    args = sample_ddp.build_parser().parse_args([
        "--device", "cpu", "--model", "DiT-S/8", "--ckpt", "random", "--vae-ckpt", vae_bin,
        "--vae-channels", "32,64", "--num-sampling-steps", "2", "--per-proc-batch-size", "2",
        "--num-fid-samples", "2", "--cfg-scale", "4.0", "--sample-dir", str(tmp_path / "s"),
        "--io-threads", "1", *flags])
    res = sample_ddp.main(args)
    arr = np.load(res["npz"])["arr_0"]
    assert arr.shape == (2, 64, 64, 3) and arr.dtype == np.uint8 and arr.std() > 0
    device = torch.device("cpu")
    model = cli.build_model(args, device, seed=0)
    want = sample_ddp.generate(args, model, cli.build_diffusion(args, device),
                               cli.build_vae(args, device), torch.Generator().manual_seed(0))
    assert np.array_equal(arr, want.numpy())
