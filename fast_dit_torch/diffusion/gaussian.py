"""Gaussian-diffusion sampling math as plain tensor functions of a
`DiffusionSchedule`.

Counterpart of `fast_dit_tpu/diffusion/gaussian.py`: the small math
utilities (:60-110), `extract`, `q_sample`, `q_posterior_mean_variance`, the
prediction helpers, `p_mean_variance` with the LEARNED_RANGE split, the
DDPM / DDIM single steps (:113-342), and the training side, `vb_terms_bpd`
and `training_losses` (:374-459). Sampling functions take the model OUTPUT,
so the caller owns the model call; `training_losses` calls `model_fn` once.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from .schedule import DiffusionSchedule, LossType, MeanType, VarType

__all__ = [
    "mean_flat",
    "normal_kl",
    "approx_standard_normal_cdf",
    "discretized_gaussian_log_likelihood",
    "vb_terms_bpd",
    "training_losses",
    "extract",
    "q_sample",
    "q_posterior_mean_variance",
    "PMeanVariance",
    "p_mean_variance",
    "predict_xstart_from_eps",
    "predict_eps_from_xstart",
    "StepResult",
    "p_sample_step",
    "ddim_step",
]


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
                    clip_denoised: bool = True) -> PMeanVariance:
    """p(x_{t-1} | x_t) moments and the x_0 prediction, from a model OUTPUT.

    Includes the LEARNED_RANGE channel split and the quirk that a
    PREVIOUS_X mean type still routes through the epsilon parameterization.
    The channel axis is axis 1 (NCHW).
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
    if clip_denoised:
        pred_xstart = pred_xstart.clamp(-1.0, 1.0)
    model_mean, _, _ = q_posterior_mean_variance(sched, pred_xstart, x, t)
    return PMeanVariance(model_mean, model_variance, model_log_variance, pred_xstart)


class StepResult(NamedTuple):
    sample: torch.Tensor
    pred_xstart: torch.Tensor


def _nonzero_mask(t, ndim, dtype):
    """1.0 where t != 0, broadcastable; no noise is added at t == 0."""
    return (t != 0).to(dtype).reshape(-1, *((1,) * (ndim - 1)))


def p_sample_step(sched: DiffusionSchedule, model_output, x, t, noise, *,
                  clip_denoised: bool = True) -> StepResult:
    """One DDPM ancestral step x_t -> x_{t-1}."""
    out = p_mean_variance(sched, model_output, x, t, clip_denoised=clip_denoised)
    mask = _nonzero_mask(t, x.ndim, x.dtype)
    sample = out.mean + mask * torch.exp(0.5 * out.log_variance) * noise
    return StepResult(sample, out.pred_xstart)


def ddim_step(sched: DiffusionSchedule, model_output, x, t, noise=None, *,
              eta: float = 0.0, clip_denoised: bool = True) -> StepResult:
    """One DDIM step (Eq. 12)."""
    out = p_mean_variance(sched, model_output, x, t, clip_denoised=clip_denoised)
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
