"""DDPM with learned variances (Nichol & Dhariwal, arXiv:2102.09672), as DiT
trains and samples it: the linear 1000-step beta schedule, epsilon
prediction with the variance interpolated between the posterior's and
beta_t, the hybrid loss (MSE plus the variational bound with the mean
detached), and the respaced ancestral step."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .precision import EXACT, Precision

__all__ = ["Schedule", "respaced_timesteps", "p_sample", "training_loss"]


def respaced_timesteps(num_timesteps: int, steps: int) -> list:
    """The `steps` timesteps an evenly respaced chain keeps of the
    `num_timesteps` process, by the guided-diffusion rule: a fractional
    stride (T - 1) / (steps - 1) accumulated from 0 and rounded."""
    if steps == num_timesteps:
        return list(range(num_timesteps))
    stride = (num_timesteps - 1) / (steps - 1)
    kept, cur = set(), 0.0
    for _ in range(steps):
        kept.add(round(cur))
        cur += stride
    return sorted(kept)


class Schedule:
    """fp32 tables of the linear schedule (derived in fp64), optionally
    respaced; `timestep_map[i]` is the original timestep of index i."""

    def __init__(self, num_timesteps: int = 1000, steps: Optional[int] = None, device="cpu"):
        scale = 1000 / num_timesteps
        betas = np.linspace(scale * 1e-4, scale * 0.02, num_timesteps, dtype=np.float64)
        kept = respaced_timesteps(num_timesteps, steps or num_timesteps)
        abar_all = np.cumprod(1.0 - betas)
        last, new_betas = 1.0, []
        for t in kept:
            new_betas.append(1.0 - abar_all[t] / last)
            last = abar_all[t]
        betas = np.array(new_betas)
        abar = np.cumprod(1.0 - betas)
        abar_prev = np.append(1.0, abar[:-1])
        post_var = betas * (1.0 - abar_prev) / (1.0 - abar)
        tables = dict(
            sqrt_abar=np.sqrt(abar), sqrt_one_minus_abar=np.sqrt(1.0 - abar),
            sqrt_recip_abar=np.sqrt(1.0 / abar), sqrt_recipm1_abar=np.sqrt(1.0 / abar - 1),
            post_log_var=np.log(np.append(post_var[1], post_var[1:])),
            log_betas=np.log(betas),
            coef1=betas * np.sqrt(abar_prev) / (1.0 - abar),
            coef2=(1.0 - abar_prev) * np.sqrt(1.0 - betas) / (1.0 - abar))
        self.num_timesteps = len(kept)
        self.timestep_map = kept
        self.t = {k: torch.tensor(v, dtype=torch.float32, device=device)
                  for k, v in tables.items()}

    def at(self, name: str, t: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        return self.t[name][t].to(dtype).reshape(-1, 1, 1, 1)


def _mean_logvar(s: Schedule, x_t, t, eps, v, dt=torch.float32):
    """p(x_{t-1} | x_t): the posterior mean from the x_0 that eps gives, and
    the log variance interpolated by v in [-1, 1]."""
    frac = (v + 1) / 2
    logvar = frac * s.at("log_betas", t, dt) + (1 - frac) * s.at("post_log_var", t, dt)
    x0 = s.at("sqrt_recip_abar", t, dt) * x_t - s.at("sqrt_recipm1_abar", t, dt) * eps
    mean = s.at("coef1", t, dt) * x0 + s.at("coef2", t, dt) * x_t
    return mean, logvar


def p_sample(s: Schedule, x_t, model_out, i: int, noise, prec: Precision = EXACT):
    """One ancestral step from respaced index i: mean + exp(logvar / 2) *
    noise, no noise at i == 0. With a lower `prec`, computed in its
    state dtype."""
    dt = prec.state_dtype or torch.float32
    x_t, model_out, noise = x_t.to(dt), model_out.to(dt), noise.to(dt)
    t = torch.full((x_t.shape[0],), i, dtype=torch.long, device=x_t.device)
    C = x_t.shape[1]
    mean, logvar = _mean_logvar(s, x_t, t, model_out[:, :C], model_out[:, C:], dt)
    out = mean + (torch.exp(0.5 * logvar) * noise if i != 0 else 0.0)
    return out.float()


def _normal_kl(m1, lv1, m2, lv2):
    return 0.5 * (-1.0 + lv2 - lv1 + torch.exp(lv1 - lv2) + (m1 - m2) ** 2 * torch.exp(-lv2))


def _std_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def _decoder_nll(x0, mean, log_scale):
    """-log of the Gaussian discretised to 256 bins over [-1, 1]."""
    c = x0 - mean
    inv = torch.exp(-log_scale)
    cdf_plus = _std_normal_cdf(inv * (c + 1.0 / 255.0))
    cdf_min = _std_normal_cdf(inv * (c - 1.0 / 255.0))
    log_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return -torch.where(x0 < -0.999, log_plus,
                        torch.where(x0 > 0.999, log_one_minus_min, log_delta))


def training_loss(s: Schedule, model, x0, t, noise) -> torch.Tensor:
    """Per-example hybrid loss: mean squared error of the predicted noise,
    plus the variational-bound term in bits with the predicted mean
    detached (the decoder NLL at t == 0). `model(x_t, t)` -> (B, 2C, H, W)."""
    C = x0.shape[1]
    x_t = s.at("sqrt_abar", t) * x0 + s.at("sqrt_one_minus_abar", t) * noise
    out = model(x_t, t)
    eps, v = out[:, :C], out[:, C:]
    mse = ((noise - eps) ** 2).mean(dim=(1, 2, 3))
    true_mean = s.at("coef1", t) * x0 + s.at("coef2", t) * x_t
    true_logvar = s.at("post_log_var", t)
    mean, logvar = _mean_logvar(s, x_t, t, eps.detach(), v)
    kl = _normal_kl(true_mean, true_logvar, mean, logvar).mean(dim=(1, 2, 3)) / math.log(2.0)
    nll = _decoder_nll(x0, mean, 0.5 * logvar).mean(dim=(1, 2, 3)) / math.log(2.0)
    return mse + torch.where(t == 0, nll, kl)
