"""Gaussian-diffusion sampling math as plain tensor functions of a
`DiffusionSchedule`.

Counterpart of the sampling side of `fast_dit_tpu/diffusion/gaussian.py`
(:113-342): `extract`, `q_sample`, `q_posterior_mean_variance`, the
prediction helpers, `p_mean_variance` with the LEARNED_RANGE split, and the
DDPM / DDIM single steps. Functions take the model OUTPUT, so the caller owns
the model call. `training_losses` and `vb_terms_bpd` come with the training
slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .schedule import DiffusionSchedule, MeanType, VarType

__all__ = [
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
