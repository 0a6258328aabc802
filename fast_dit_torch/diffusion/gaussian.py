"""Gaussian-diffusion math as plain tensor functions of a
`DiffusionSchedule`.

Counterpart of `fast_dit_tpu/diffusion/gaussian.py`: the small math
utilities (:60-110), `extract`, `q_mean_variance`, `q_sample`,
`q_posterior_mean_variance`, the prediction helpers, `p_mean_variance` with
the LEARNED_RANGE split and `denoised_fn`, classifier guidance
(`condition_mean`, `condition_score`), the DDPM / DDIM / reverse-DDIM single
steps (:113-372), and the training and likelihood side, `vb_terms_bpd`,
`training_losses`, `prior_bpd` and `calc_bpd_loop` (:374-515). Sampling
functions take the model OUTPUT, so the caller owns the model call;
`training_losses` calls `model_fn` once, `calc_bpd_loop` once per timestep.
A loop over timesteps calls its model through `model_call`, which publishes
the step's timestep on the host (`host_timestep`) for a model function that
decides something per step (the guidance interval) without reading the
device.
"""

from __future__ import annotations

import contextvars
import math
from typing import Callable, NamedTuple, Optional

import torch

from .schedule import DiffusionSchedule, LossType, MeanType, VarType

__all__ = [
    "mean_flat",
    "normal_kl",
    "approx_standard_normal_cdf",
    "discretized_gaussian_log_likelihood",
    "continuous_gaussian_log_likelihood",
    "vb_terms_bpd",
    "training_losses",
    "prior_bpd",
    "calc_bpd_loop",
    "host_timestep",
    "model_call",
    "extract",
    "q_mean_variance",
    "q_sample",
    "q_posterior_mean_variance",
    "PMeanVariance",
    "p_mean_variance",
    "predict_xstart_from_eps",
    "predict_eps_from_xstart",
    "condition_mean",
    "condition_score",
    "StepResult",
    "p_sample_step",
    "ddim_step",
    "ddim_reverse_step",
]

_HOST_TIMESTEP = contextvars.ContextVar("fast_dit_torch_host_timestep", default=None)


def host_timestep() -> Optional[int]:
    """The timestep of the model call a loop is making (`model_call`), as
    a host int; None outside such a call."""
    return _HOST_TIMESTEP.get()


def model_call(model_fn: Callable, x, t_model: int, cond_fn=None):
    """(model_fn(x, t), cond_fn(x, t) or None) for t the (B,) int64 tensor
    filled with the host int `t_model`, which `host_timestep` returns
    meanwhile."""
    t = torch.full((x.shape[0],), t_model, dtype=torch.int64, device=x.device)
    token = _HOST_TIMESTEP.set(t_model)
    try:
        return model_fn(x, t), None if cond_fn is None else cond_fn(x, t)
    finally:
        _HOST_TIMESTEP.reset(token)


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch dimensions."""
    return x.mean(dim=tuple(range(1, x.ndim)))


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL between two diagonal Gaussians."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x):
    """tanh-based approximation of the standard normal CDF."""
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def continuous_gaussian_log_likelihood(x, *, means, log_scales):
    """log N(x; means, exp(log_scales)^2), without the log-scale term, as
    the reference computes it."""
    normalized_x = (x - means) * torch.exp(-log_scales)
    return -0.5 * (normalized_x ** 2 + math.log(2 * math.pi))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of a Gaussian discretized to uint8 bins scaled to
    [-1, 1]."""
    assert x.shape == means.shape == log_scales.shape
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))


def extract(table: torch.Tensor, t: torch.Tensor, ndim: int, dtype=None) -> torch.Tensor:
    """Gather per-timestep scalars and broadcast to `ndim` dims."""
    out = table[t]
    if dtype is not None:
        out = out.to(dtype)
    return out.reshape(t.shape[0], *((1,) * (ndim - 1)))


def q_mean_variance(sched: DiffusionSchedule, x_start, t):
    """q(x_t | x_0) moments: mean, variance, log variance."""
    nd = x_start.ndim
    mean = extract(sched.sqrt_alphas_cumprod, t, nd, x_start.dtype) * x_start
    variance = extract(1.0 - sched.alphas_cumprod, t, nd, x_start.dtype)
    log_variance = extract(sched.log_one_minus_alphas_cumprod, t, nd, x_start.dtype)
    return mean, variance, log_variance


def q_sample(sched: DiffusionSchedule, x_start, t, noise):
    """Sample from q(x_t | x_0)."""
    assert noise.shape == x_start.shape
    nd = x_start.ndim
    return (extract(sched.sqrt_alphas_cumprod, t, nd, x_start.dtype) * x_start
            + extract(sched.sqrt_one_minus_alphas_cumprod, t, nd, x_start.dtype) * noise)


def q_posterior_mean_variance(sched: DiffusionSchedule, x_start, x_t, t):
    """q(x_{t-1} | x_t, x_0) moments."""
    assert x_start.shape == x_t.shape
    nd = x_t.ndim
    posterior_mean = (
        extract(sched.posterior_mean_coef1, t, nd, x_t.dtype) * x_start
        + extract(sched.posterior_mean_coef2, t, nd, x_t.dtype) * x_t)
    posterior_variance = extract(sched.posterior_variance, t, nd, x_t.dtype)
    posterior_log_variance = extract(sched.posterior_log_variance_clipped, t, nd, x_t.dtype)
    return posterior_mean, posterior_variance, posterior_log_variance


class PMeanVariance(NamedTuple):
    mean: torch.Tensor
    variance: torch.Tensor
    log_variance: torch.Tensor
    pred_xstart: torch.Tensor


def predict_xstart_from_eps(sched: DiffusionSchedule, x_t, t, eps):
    assert x_t.shape == eps.shape
    nd = x_t.ndim
    return (extract(sched.sqrt_recip_alphas_cumprod, t, nd, x_t.dtype) * x_t
            - extract(sched.sqrt_recipm1_alphas_cumprod, t, nd, x_t.dtype) * eps)


def predict_eps_from_xstart(sched: DiffusionSchedule, x_t, t, pred_xstart):
    nd = x_t.ndim
    return ((extract(sched.sqrt_recip_alphas_cumprod, t, nd, x_t.dtype) * x_t - pred_xstart)
            / extract(sched.sqrt_recipm1_alphas_cumprod, t, nd, x_t.dtype))


def p_mean_variance(sched: DiffusionSchedule, model_output, x, t, *,
                    clip_denoised: bool = True, denoised_fn=None) -> PMeanVariance:
    """p(x_{t-1} | x_t) moments and the x_0 prediction, from a model OUTPUT.

    Includes the LEARNED_RANGE channel split and the quirk that a
    PREVIOUS_X mean type still routes through the epsilon parameterization.
    `denoised_fn`, then the clip, apply to the x_0 prediction. The channel
    axis is axis 1 (NCHW).
    """
    B, C = x.shape[:2]
    nd = x.ndim

    if sched.var_type in (VarType.LEARNED, VarType.LEARNED_RANGE):
        assert model_output.shape == (B, C * 2, *x.shape[2:])
        model_output, model_var_values = torch.split(model_output, C, dim=1)
        if sched.var_type == VarType.LEARNED:
            model_log_variance = model_var_values
        else:
            min_log = extract(sched.posterior_log_variance_clipped, t, nd, x.dtype)
            max_log = extract(sched.log_betas, t, nd, x.dtype)
            # model_var_values is in [-1, 1] for [min_var, max_var]
            frac = (model_var_values + 1) / 2
            model_log_variance = frac * max_log + (1 - frac) * min_log
        model_variance = torch.exp(model_log_variance)
    else:
        if sched.var_type == VarType.FIXED_LARGE:
            model_variance = extract(sched.fixed_large_variance, t, nd, x.dtype)
            model_log_variance = extract(sched.log_fixed_large_variance, t, nd, x.dtype)
        elif sched.var_type == VarType.FIXED_SMALL:
            model_variance = extract(sched.posterior_variance, t, nd, x.dtype)
            model_log_variance = extract(sched.posterior_log_variance_clipped, t, nd, x.dtype)
        else:
            raise NotImplementedError(sched.var_type)
        model_variance = model_variance.expand(x.shape)
        model_log_variance = model_log_variance.expand(x.shape)

    if sched.mean_type == MeanType.START_X:
        pred_xstart = model_output
    else:
        pred_xstart = predict_xstart_from_eps(sched, x, t, model_output)
    if denoised_fn is not None:
        pred_xstart = denoised_fn(pred_xstart)
    if clip_denoised:
        pred_xstart = pred_xstart.clamp(-1.0, 1.0)
    model_mean, _, _ = q_posterior_mean_variance(sched, pred_xstart, x, t)
    return PMeanVariance(model_mean, model_variance, model_log_variance, pred_xstart)


def condition_mean(sched: DiffusionSchedule, cond_grad, out: PMeanVariance) -> PMeanVariance:
    """Shift the mean by variance * grad log p(y | x) (Sohl-Dickstein et
    al.); in fp32, as the JAX function does."""
    new_mean = out.mean.float() + out.variance * cond_grad.float()
    return out._replace(mean=new_mean)


def condition_score(sched: DiffusionSchedule, cond_grad, out: PMeanVariance, x,
                    t) -> PMeanVariance:
    """Condition the score instead (Song et al. 2020): eps -= sqrt(1 - abar)
    * grad, and the x_0 prediction and mean follow."""
    alpha_bar = extract(sched.alphas_cumprod, t, x.ndim, x.dtype)
    eps = predict_eps_from_xstart(sched, x, t, out.pred_xstart)
    eps = eps - torch.sqrt(1 - alpha_bar) * cond_grad
    pred_xstart = predict_xstart_from_eps(sched, x, t, eps)
    mean, _, _ = q_posterior_mean_variance(sched, pred_xstart, x, t)
    return out._replace(mean=mean, pred_xstart=pred_xstart)


class StepResult(NamedTuple):
    sample: torch.Tensor
    pred_xstart: torch.Tensor


def _nonzero_mask(t, ndim, dtype):
    """1.0 where t != 0, broadcastable; no noise is added at t == 0."""
    return (t != 0).to(dtype).reshape(-1, *((1,) * (ndim - 1)))


def p_sample_step(sched: DiffusionSchedule, model_output, x, t, noise, *,
                  clip_denoised: bool = True, denoised_fn=None, cond_grad=None) -> StepResult:
    """One DDPM ancestral step x_t -> x_{t-1}; `cond_grad` shifts the mean
    (`condition_mean`)."""
    out = p_mean_variance(sched, model_output, x, t, clip_denoised=clip_denoised,
                          denoised_fn=denoised_fn)
    if cond_grad is not None:
        out = condition_mean(sched, cond_grad, out)
    mask = _nonzero_mask(t, x.ndim, x.dtype)
    sample = out.mean + mask * torch.exp(0.5 * out.log_variance) * noise
    return StepResult(sample, out.pred_xstart)


def ddim_step(sched: DiffusionSchedule, model_output, x, t, noise=None, *,
              eta: float = 0.0, clip_denoised: bool = True, denoised_fn=None,
              cond_grad=None) -> StepResult:
    """One DDIM step (Eq. 12); `cond_grad` conditions the score
    (`condition_score`)."""
    out = p_mean_variance(sched, model_output, x, t, clip_denoised=clip_denoised,
                          denoised_fn=denoised_fn)
    if cond_grad is not None:
        out = condition_score(sched, cond_grad, out, x, t)
    eps = predict_eps_from_xstart(sched, x, t, out.pred_xstart)
    nd = x.ndim
    alpha_bar = extract(sched.alphas_cumprod, t, nd, x.dtype)
    alpha_bar_prev = extract(sched.alphas_cumprod_prev, t, nd, x.dtype)
    sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
             * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
    mean_pred = (out.pred_xstart * torch.sqrt(alpha_bar_prev)
                 + torch.sqrt(1 - alpha_bar_prev - sigma ** 2) * eps)
    if eta == 0.0 or noise is None:
        sample = mean_pred
    else:
        sample = mean_pred + _nonzero_mask(t, nd, x.dtype) * sigma * noise
    return StepResult(sample, out.pred_xstart)


def ddim_reverse_step(sched: DiffusionSchedule, model_output, x, t, *,
                      clip_denoised: bool = True, denoised_fn=None,
                      cond_grad=None) -> StepResult:
    """One step of the reverse DDIM ODE, x_t -> x_{t+1}."""
    out = p_mean_variance(sched, model_output, x, t, clip_denoised=clip_denoised,
                          denoised_fn=denoised_fn)
    if cond_grad is not None:
        out = condition_score(sched, cond_grad, out, x, t)
    nd = x.ndim
    eps = ((extract(sched.sqrt_recip_alphas_cumprod, t, nd, x.dtype) * x - out.pred_xstart)
           / extract(sched.sqrt_recipm1_alphas_cumprod, t, nd, x.dtype))
    alpha_bar_next = extract(sched.alphas_cumprod_next, t, nd, x.dtype)
    mean_pred = out.pred_xstart * torch.sqrt(alpha_bar_next) + torch.sqrt(1 - alpha_bar_next) * eps
    return StepResult(mean_pred, out.pred_xstart)


def vb_terms_bpd(sched: DiffusionSchedule, model_output, x_start, x_t, t, *,
                 clip_denoised: bool = True):
    """Per-example variational-bound term in bits: KL(q(x_{t-1} | x_t, x_0)
    || p(x_{t-1} | x_t)), or the decoder NLL at t == 0. Returns
    (output (B,), pred_xstart)."""
    true_mean, _, true_log_variance_clipped = q_posterior_mean_variance(sched, x_start, x_t, t)
    out = p_mean_variance(sched, model_output, x_t, t, clip_denoised=clip_denoised)
    kl = normal_kl(true_mean, true_log_variance_clipped, out.mean, out.log_variance)
    kl = mean_flat(kl) / math.log(2.0)
    decoder_nll = -discretized_gaussian_log_likelihood(
        x_start, means=out.mean, log_scales=0.5 * out.log_variance)
    decoder_nll = mean_flat(decoder_nll) / math.log(2.0)
    return torch.where(t == 0, decoder_nll, kl), out.pred_xstart


def training_losses(sched: DiffusionSchedule, model_fn: Callable, x_start, t, noise, *,
                    map_timesteps: bool = True) -> dict:
    """Per-example training losses {"loss", and "mse", "vb" for the MSE
    types}. `model_fn(x_t, t_model)` is called once; `t` is in respaced index
    space and is mapped through `timestep_map` before the model sees it. The
    hybrid MSE + VB loss learns the variance through the VB term with the
    mean prediction detached, so the VB gradient never reaches the mean."""
    assert noise.shape == x_start.shape
    x_t = q_sample(sched, x_start, t, noise)
    t_model = sched.timestep_map[t] if map_timesteps else t

    terms = {}
    if sched.loss_type in (LossType.KL, LossType.RESCALED_KL):
        model_output = model_fn(x_t, t_model)
        terms["loss"], _ = vb_terms_bpd(sched, model_output, x_start, x_t, t,
                                        clip_denoised=False)
        if sched.loss_type == LossType.RESCALED_KL:
            terms["loss"] = terms["loss"] * sched.num_timesteps
    elif sched.loss_type in (LossType.MSE, LossType.RESCALED_MSE):
        model_output = model_fn(x_t, t_model)
        if sched.var_type in (VarType.LEARNED, VarType.LEARNED_RANGE):
            B, C = x_t.shape[:2]
            assert model_output.shape == (B, C * 2, *x_t.shape[2:])
            model_output, model_var_values = torch.split(model_output, C, dim=1)
            frozen_out = torch.cat([model_output.detach(), model_var_values], dim=1)
            vb, _ = vb_terms_bpd(sched, frozen_out, x_start, x_t, t, clip_denoised=False)
            if sched.loss_type == LossType.RESCALED_MSE:
                # divided by 1000 for equivalence with the initial implementation
                vb = vb * (sched.num_timesteps / 1000.0)
            terms["vb"] = vb
        if sched.mean_type == MeanType.PREVIOUS_X:
            target = q_posterior_mean_variance(sched, x_start, x_t, t)[0]
        elif sched.mean_type == MeanType.START_X:
            target = x_start
        elif sched.mean_type == MeanType.EPSILON:
            target = noise
        else:
            raise NotImplementedError(sched.mean_type)
        assert model_output.shape == target.shape == x_start.shape
        terms["mse"] = mean_flat((target - model_output) ** 2)
        terms["loss"] = terms["mse"] + terms["vb"] if "vb" in terms else terms["mse"]
    else:
        raise NotImplementedError(sched.loss_type)
    return terms


def prior_bpd(sched: DiffusionSchedule, x_start) -> torch.Tensor:
    """The prior term KL(q(x_T | x_0) || N(0, I)) in bits per dim, (B,)."""
    t = torch.full((x_start.shape[0],), sched.num_timesteps - 1, dtype=torch.int64,
                   device=x_start.device)
    qt_mean, _, qt_log_variance = q_mean_variance(sched, x_start, t)
    zero = torch.zeros((), dtype=qt_mean.dtype, device=qt_mean.device)
    kl_prior = normal_kl(qt_mean, qt_log_variance, zero, zero)
    return mean_flat(kl_prior) / math.log(2.0)


def calc_bpd_loop(sched: DiffusionSchedule, model_fn: Callable, x_start, *,
                  generator=None, noise=None, clip_denoised: bool = True,
                  map_timesteps: bool = True) -> dict:
    """The whole variational bound in bits per dim, one model call per
    timestep from t = T-1 down to 0. The k-th step's noise is `noise[k]`
    ((T, *x_start.shape)), else drawn from `generator`. Returns (B,)
    "total_bpd" and "prior_bpd", and (B, T) "vb", "xstart_mse" and "mse",
    columns in the order t = T-1 .. 0, as the JAX function does."""
    B, T = x_start.shape[0], sched.num_timesteps
    if noise is None and generator is None:
        raise ValueError("calc_bpd_loop needs `noise` or `generator`")
    vb, xstart_mse, mse = [], [], []
    for k, i in enumerate(range(T - 1, -1, -1)):
        t = torch.full((B,), i, dtype=torch.int64, device=x_start.device)
        n = (noise[k] if noise is not None else
             torch.randn(x_start.shape, generator=generator, dtype=x_start.dtype,
                         device=x_start.device))
        x_t = q_sample(sched, x_start, t, n)
        model_output, _ = model_call(model_fn, x_t,
                                     sched.timestep_map_host[i] if map_timesteps else i)
        out, pred_xstart = vb_terms_bpd(sched, model_output, x_start, x_t, t,
                                        clip_denoised=clip_denoised)
        vb.append(out)
        xstart_mse.append(mean_flat((pred_xstart - x_start) ** 2))
        mse.append(mean_flat((predict_eps_from_xstart(sched, x_t, t, pred_xstart) - n) ** 2))
    vb, xstart_mse, mse = (torch.stack(v, dim=1) for v in (vb, xstart_mse, mse))
    prior = prior_bpd(sched, x_start)
    return {"total_bpd": vb.sum(dim=1) + prior, "prior_bpd": prior, "vb": vb,
            "xstart_mse": xstart_mse, "mse": mse}
