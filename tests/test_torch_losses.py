"""The port's training losses (fast_dit_torch/diffusion/gaussian.py) against
the JAX package's `gaussian.py` (:60-110, :374-459).

Inputs, timesteps (t = 0 included, for the decoder-NLL branch) and noise are
made with numpy from a seed and handed to both sides; the model is the same
analytic function written twice. Gradients with respect to the model output
are held against `jax.grad`, which checks that the VB term sees the mean
prediction detached (`stop_gradient` there, `.detach()` here).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_dit_tpu.diffusion import create_diffusion as jax_create_diffusion
from fast_dit_tpu.diffusion import gaussian as jg
from fast_dit_tpu.diffusion.schedule import LossType as JaxLossType
from fast_dit_torch.diffusion import create_diffusion, gaussian
from fast_dit_torch.diffusion.schedule import LossType

# fp32 on both sides; XLA and torch round exp, log and tanh apart by an ulp
# or so, and the bpd terms sum over 64 elements, so relative to the largest
# term
RTOL = 1e-5

# (create_diffusion kwargs, loss type override): learned range + MSE (the
# default hybrid), RESCALED_MSE, KL, RESCALED_KL, START_X, fixed variance
CASES = {
    "learned-range-mse": ({}, None),
    "rescaled-mse": (dict(rescale_learned_sigmas=True), None),
    "kl": ({}, "kl"),
    "rescaled-kl": (dict(use_kl=True), None),
    "start-x": (dict(predict_xstart=True), None),
    "fixed-small-mse": (dict(learn_sigma=False, sigma_small=True), None),
}


def _schedules(kwargs, loss_type, respacing=""):
    jsched = jax_create_diffusion(respacing, **kwargs).schedule
    sched = create_diffusion(respacing, device="cpu", **kwargs).schedule
    if loss_type is not None:
        jsched = jsched.replace(loss_type=JaxLossType(loss_type))
        sched = dataclasses.replace(sched, loss_type=LossType(loss_type))
    return jsched, sched


def _inputs(channels_out, num_timesteps, seed=0, predicts_xstart=False):
    """x in [-1, 1], t (two rows at 0), noise, and a model output near the
    truth (the noise, or x_0): far from it, the t == 0 decoder NLL sits in
    the tail of its tanh CDF or at its 1e-12 clamp, where XLA's and torch's
    fp32 tanh and log round apart and decide the value."""
    rs = np.random.RandomState(seed)
    x = rs.uniform(-1.0, 1.0, size=(6, 4, 4, 4)).astype(np.float32)
    x[0, 0, 0, :2] = [-1.0, 1.0]  # the edge bins of the discretized likelihood
    t = rs.randint(0, num_timesteps, size=6).astype(np.int64)
    t[:2] = 0
    noise = rs.randn(*x.shape).astype(np.float32)
    out = (0.5 * rs.randn(6, channels_out, 4, 4)).astype(np.float32)
    if channels_out == 8:
        out[:, 4:] = np.tanh(out[:, 4:])  # the variance half lives in [-1, 1]
    out[:, :4] = x + 0.004 * out[:, :4] if predicts_xstart else noise + 0.2 * out[:, :4]
    return x, t, noise, out


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("case", list(CASES))
def test_training_losses_and_output_grads_match_jax(case):
    kwargs, loss_type = CASES[case]
    jsched, sched = _schedules(kwargs, loss_type)
    learn = kwargs.get("learn_sigma", True)
    x, t, noise, out = _inputs(8 if learn else 4, sched.num_timesteps,
                               predicts_xstart=kwargs.get("predict_xstart", False))

    def jax_terms(o):
        return jg.training_losses(jsched, lambda xt, tm: o, jnp.asarray(x),
                                  jnp.asarray(t, jnp.int32), jnp.asarray(noise))

    want = jax_terms(out)
    want_grad = jax.grad(lambda o: jnp.sum(jax_terms(o)["loss"]))(jnp.asarray(out))

    o = torch.from_numpy(out).requires_grad_()
    seen = {}

    def model_fn(xt, tm):
        seen["t"] = tm
        return o

    got = gaussian.training_losses(sched, model_fn, torch.from_numpy(x), torch.from_numpy(t),
                                   torch.from_numpy(noise))
    assert set(got) == set(want)
    for k in want:
        _close(got[k].detach().numpy(), want[k])
    got["loss"].sum().backward()
    _close(o.grad.numpy(), want_grad)
    assert torch.equal(seen["t"], torch.from_numpy(t))  # the 1000-step map is the identity


def test_vb_detaches_the_mean_prediction():
    # the hybrid loss: the VB term's gradient reaches only the variance half
    _, sched = _schedules({}, None)
    x, t, noise, out = _inputs(8, sched.num_timesteps, seed=1)
    o = torch.from_numpy(out).requires_grad_()
    terms = gaussian.training_losses(sched, lambda xt, tm: o, torch.from_numpy(x),
                                     torch.from_numpy(t), torch.from_numpy(noise))
    terms["vb"].sum().backward()
    assert torch.count_nonzero(o.grad[:, :4]) == 0
    assert torch.count_nonzero(o.grad[:, 4:]) > 0


def test_respaced_timesteps_are_mapped_for_the_model():
    jsched, sched = _schedules({}, None, respacing="25")
    x, t, noise, out = _inputs(8, sched.num_timesteps, seed=2)
    seen = {}

    def model_fn(xt, tm):
        seen["t"] = tm
        return torch.from_numpy(out)

    got = gaussian.training_losses(sched, model_fn, torch.from_numpy(x), torch.from_numpy(t),
                                   torch.from_numpy(noise))
    want = jg.training_losses(jsched, lambda xt, tm: jnp.asarray(out), jnp.asarray(x),
                              jnp.asarray(t, jnp.int32), jnp.asarray(noise))
    assert np.array_equal(seen["t"].numpy(), np.asarray(jsched.timestep_map)[t])
    assert seen["t"].max() > t.max()
    _close(got["loss"].numpy(), want["loss"])


def test_vb_terms_bpd_takes_the_decoder_nll_at_t0():
    jsched, sched = _schedules({}, None)
    x, t, noise, out = _inputs(8, sched.num_timesteps, seed=3)
    xt = gaussian.q_sample(sched, torch.from_numpy(x), torch.from_numpy(t),
                           torch.from_numpy(noise))
    got, got_x0 = gaussian.vb_terms_bpd(sched, torch.from_numpy(out), torch.from_numpy(x), xt,
                                        torch.from_numpy(t), clip_denoised=False)
    want, want_x0 = jg.vb_terms_bpd(jsched, jnp.asarray(out), jnp.asarray(x),
                                    jnp.asarray(xt.numpy()), jnp.asarray(t, jnp.int32),
                                    clip_denoised=False)
    _close(got.numpy(), want)
    _close(got_x0.numpy(), want_x0)
    # the t == 0 rows hold the decoder NLL, not a KL
    pm = gaussian.p_mean_variance(sched, torch.from_numpy(out), xt, torch.from_numpy(t),
                                  clip_denoised=False)
    nll = -gaussian.discretized_gaussian_log_likelihood(
        torch.from_numpy(x), means=pm.mean, log_scales=0.5 * pm.log_variance)
    assert torch.allclose(got[:2], gaussian.mean_flat(nll)[:2] / np.log(2.0))


def test_math_utilities_match_jax():
    rs = np.random.RandomState(4)
    a, b, c, d = (rs.randn(3, 5).astype(np.float32) for _ in range(4))
    x = np.concatenate([rs.uniform(-1, 1, (3, 4)), [[-1.0, -0.9995, 0.9995, 1.0]] * 3],
                       axis=1).astype(np.float32)
    # a decoder mean near x and the scales of t = 0: the CDF's well-conditioned
    # range (see `_inputs`)
    means = (x + 0.005 * rs.randn(*x.shape)).astype(np.float32)
    scales = rs.uniform(-4, -3, x.shape).astype(np.float32)
    T = torch.from_numpy
    _close(gaussian.mean_flat(T(a)).numpy(), jg.mean_flat(a))
    _close(gaussian.normal_kl(T(a), T(b), T(c), T(d)).numpy(), jg.normal_kl(a, b, c, d))
    _close(gaussian.approx_standard_normal_cdf(T(a)).numpy(), jg.approx_standard_normal_cdf(a))
    _close(gaussian.discretized_gaussian_log_likelihood(
        T(x), means=T(means), log_scales=T(scales)).numpy(),
        jg.discretized_gaussian_log_likelihood(x, means=means, log_scales=scales))


def test_facade_training_losses_draws_noise_from_the_generator():
    diffusion = create_diffusion("", device="cpu")
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 4, 4, 4).astype(np.float32))
    t = torch.tensor([3, 700])

    def model_fn(xt, tm, scale):
        return torch.cat([scale * xt, torch.zeros_like(xt)], dim=1)

    runs = [diffusion.training_losses(model_fn, x, t, model_kwargs={"scale": 0.5},
                                      generator=torch.Generator().manual_seed(7))
            for _ in range(2)]
    assert torch.equal(runs[0]["loss"], runs[1]["loss"])
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(7))
    given = diffusion.training_losses(model_fn, x, t, model_kwargs={"scale": 0.5}, noise=noise)
    assert torch.equal(given["mse"], runs[0]["mse"])
