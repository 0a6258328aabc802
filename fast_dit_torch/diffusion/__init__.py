"""Diffusion library: schedules, the respacing DSL, the Gaussian step math,
the sampling loops, flow matching, the guidance interval and the timestep
samplers.

`create_diffusion` keeps the signature and defaults of
`fast_dit_tpu/diffusion/__init__.py:249-291` (1000-step linear schedule,
epsilon prediction, LEARNED_RANGE variance, MSE loss, the "250" / "ddim50" /
"10,15,20" / "karrasN" respacing strings), plus the `device` the tables live
on ("cuda" unless the caller asks for the CPU). The `Diffusion` facade
carries the method surface of the JAX facade (:95-247).
"""

from __future__ import annotations

import numpy as np
import torch

from . import gaussian, sampling
from ..utils.device import resolve_device
from .flow import (FLOW_PATHS, flow_path_coeffs, flow_reverse_loop, flow_sample_loop,
                   flow_training_losses)
from .guidance_interval import (guidance_interval_cached_fns, guidance_interval_fn,
                                guidance_interval_mask, guided_steps_korder)
from .respace import karras_timesteps, space_timesteps
from .sampling import (cache_refresh_mask, ddim_reverse_sample_loop, ddim_sample_loop,
                       ddim_sample_loop_cached, dpm_solver_sample_loop, p_sample_loop,
                       p_sample_loop_cached, unipc_sample_loop)
from .schedule import (DiffusionSchedule, LossType, MeanType, VarType,
                       betas_for_alpha_bar, get_named_beta_schedule)
from .timestep_samplers import (LossSecondMomentState, UniformSamplerState,
                                create_named_schedule_sampler, sample_timesteps,
                                update_with_losses)

__all__ = [
    "create_diffusion",
    "Diffusion",
    "DiffusionSchedule",
    "MeanType",
    "VarType",
    "LossType",
    "space_timesteps",
    "karras_timesteps",
    "get_named_beta_schedule",
    "betas_for_alpha_bar",
    "FLOW_PATHS",
    "flow_path_coeffs",
    "flow_training_losses",
    "flow_sample_loop",
    "flow_reverse_loop",
    "guidance_interval_fn",
    "guidance_interval_cached_fns",
    "guidance_interval_mask",
    "guided_steps_korder",
    "p_sample_loop",
    "ddim_sample_loop",
    "p_sample_loop_cached",
    "ddim_sample_loop_cached",
    "cache_refresh_mask",
    "dpm_solver_sample_loop",
    "unipc_sample_loop",
    "ddim_reverse_sample_loop",
    "gaussian",
    "sampling",
    "create_named_schedule_sampler",
    "sample_timesteps",
    "update_with_losses",
    "UniformSamplerState",
    "LossSecondMomentState",
]


class Diffusion:
    """Facade over the functional core. `model_fn(x, t_original, **model_kwargs)`
    receives original-process timesteps: the respacing remap is applied
    inside."""

    def __init__(self, schedule: DiffusionSchedule):
        self.schedule = schedule

    @property
    def num_timesteps(self) -> int:
        return self.schedule.num_timesteps

    @property
    def original_num_steps(self) -> int:
        return self.schedule.original_num_steps

    @property
    def timestep_map(self) -> torch.Tensor:
        return self.schedule.timestep_map

    @staticmethod
    def _wrap(model_fn, model_kwargs):
        kwargs = model_kwargs or {}
        return lambda x, t: model_fn(x, t, **kwargs)

    def q_sample(self, x_start, t, noise):
        return gaussian.q_sample(self.schedule, x_start, t, noise)

    def q_mean_variance(self, x_start, t):
        return gaussian.q_mean_variance(self.schedule, x_start, t)

    def q_posterior_mean_variance(self, x_start, x_t, t):
        return gaussian.q_posterior_mean_variance(self.schedule, x_start, x_t, t)

    def training_losses(self, model_fn, x_start, t, model_kwargs=None, noise=None,
                        generator=None):
        """Per-example loss terms; `noise` is drawn from `generator` when not
        given (the JAX facade's `rng`)."""
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator, dtype=x_start.dtype,
                                device=x_start.device)
        return gaussian.training_losses(self.schedule, self._wrap(model_fn, model_kwargs),
                                        x_start, t, noise)

    def calc_bpd_loop(self, model_fn, x_start, *, generator=None, noise=None,
                      clip_denoised=True, model_kwargs=None):
        return gaussian.calc_bpd_loop(self.schedule, self._wrap(model_fn, model_kwargs),
                                      x_start, generator=generator, noise=noise,
                                      clip_denoised=clip_denoised)

    def p_sample_loop(self, model_fn, shape, *, generator=None, noise=None,
                      step_noise=None, clip_denoised=True, denoised_fn=None, cond_fn=None,
                      model_kwargs=None, return_intermediates=False, dtype=torch.float32):
        return p_sample_loop(self._wrap(model_fn, model_kwargs), shape, self.schedule,
                             generator=generator, noise=noise, step_noise=step_noise,
                             clip_denoised=clip_denoised, denoised_fn=denoised_fn,
                             cond_fn=cond_fn, return_intermediates=return_intermediates,
                             dtype=dtype)

    def ddim_sample_loop(self, model_fn, shape, *, generator=None, noise=None,
                         step_noise=None, clip_denoised=True, denoised_fn=None, cond_fn=None,
                         eta=0.0, model_kwargs=None, return_intermediates=False,
                         dtype=torch.float32):
        return ddim_sample_loop(self._wrap(model_fn, model_kwargs), shape, self.schedule,
                                generator=generator, noise=noise, step_noise=step_noise,
                                clip_denoised=clip_denoised, denoised_fn=denoised_fn,
                                cond_fn=cond_fn, eta=eta,
                                return_intermediates=return_intermediates, dtype=dtype)

    def p_sample_loop_cached(self, model_full_fn, model_cached_fn, shape, *, interval,
                             refresh_schedule="uniform", force_refresh_mask=None,
                             generator=None, noise=None, step_noise=None, clip_denoised=True,
                             denoised_fn=None, cond_fn=None, dtype=torch.float32):
        """DDPM with the FORA layer cache: `model_full_fn(x, t) -> (out,
        cache)` every refresh, `model_cached_fn(x, t, cache)` between."""
        return p_sample_loop_cached(model_full_fn, model_cached_fn, shape, self.schedule,
                                    interval=interval, refresh_schedule=refresh_schedule,
                                    force_refresh_mask=force_refresh_mask, generator=generator,
                                    noise=noise, step_noise=step_noise,
                                    clip_denoised=clip_denoised, denoised_fn=denoised_fn,
                                    cond_fn=cond_fn, dtype=dtype)

    def ddim_sample_loop_cached(self, model_full_fn, model_cached_fn, shape, *, interval,
                                refresh_schedule="uniform", force_refresh_mask=None,
                                generator=None, noise=None, step_noise=None,
                                clip_denoised=True, denoised_fn=None, cond_fn=None, eta=0.0,
                                dtype=torch.float32):
        """DDIM with the FORA layer cache (see `p_sample_loop_cached`)."""
        return ddim_sample_loop_cached(model_full_fn, model_cached_fn, shape, self.schedule,
                                       interval=interval, refresh_schedule=refresh_schedule,
                                       force_refresh_mask=force_refresh_mask,
                                       generator=generator, noise=noise, step_noise=step_noise,
                                       clip_denoised=clip_denoised, denoised_fn=denoised_fn,
                                       cond_fn=cond_fn, eta=eta, dtype=dtype)

    def dpm_solver_sample_loop(self, model_fn, shape, *, generator=None, noise=None, order=2,
                               clip_denoised=True, denoised_fn=None, model_kwargs=None,
                               return_intermediates=False, dtype=torch.float32):
        """DPM-Solver++(2M), deterministic: pair with 10-25 respaced steps;
        order 1 is eta = 0 DDIM."""
        return dpm_solver_sample_loop(self._wrap(model_fn, model_kwargs), shape, self.schedule,
                                      generator=generator, noise=noise, order=order,
                                      clip_denoised=clip_denoised, denoised_fn=denoised_fn,
                                      return_intermediates=return_intermediates, dtype=dtype)

    def unipc_sample_loop(self, model_fn, shape, *, generator=None, noise=None, order=2,
                          corrector=True, variant="bh2", clip_denoised=True, denoised_fn=None,
                          model_kwargs=None, return_intermediates=False, dtype=torch.float32):
        """UniPC: DPM-Solver++(2M)'s budget plus a corrector that reuses each
        step's evaluation; `corrector=False, variant="bh2"` is DPM++(2M)."""
        return unipc_sample_loop(self._wrap(model_fn, model_kwargs), shape, self.schedule,
                                 generator=generator, noise=noise, order=order,
                                 corrector=corrector, variant=variant,
                                 clip_denoised=clip_denoised, denoised_fn=denoised_fn,
                                 return_intermediates=return_intermediates, dtype=dtype)

    def ddim_reverse_sample_loop(self, model_fn, x_start, *, clip_denoised=True,
                                 denoised_fn=None, cond_fn=None, model_kwargs=None,
                                 return_intermediates=False, dtype=torch.float32):
        return ddim_reverse_sample_loop(self._wrap(model_fn, model_kwargs), x_start,
                                        self.schedule, clip_denoised=clip_denoised,
                                        denoised_fn=denoised_fn, cond_fn=cond_fn,
                                        return_intermediates=return_intermediates, dtype=dtype)


def create_diffusion(
    timestep_respacing,
    noise_schedule: str = "linear",
    use_kl: bool = False,
    sigma_small: bool = False,
    predict_xstart: bool = False,
    learn_sigma: bool = True,
    rescale_learned_sigmas: bool = False,
    diffusion_steps: int = 1000,
    device="cuda",
) -> Diffusion:
    """The reference factory, with the tables on `device`."""
    device = resolve_device(device)
    betas = get_named_beta_schedule(noise_schedule, diffusion_steps)
    if use_kl:
        loss_type = LossType.RESCALED_KL
    elif rescale_learned_sigmas:
        loss_type = LossType.RESCALED_MSE
    else:
        loss_type = LossType.MSE
    if timestep_respacing is None or timestep_respacing == "":
        timestep_respacing = [diffusion_steps]
    if isinstance(timestep_respacing, str) and timestep_respacing.startswith("karras"):
        # "karrasN" needs the betas, so it is dispatched here and not in the
        # schedule-blind space_timesteps DSL
        alphas_cumprod = np.cumprod(1.0 - np.asarray(betas, np.float64))
        use_timesteps = karras_timesteps(alphas_cumprod, int(timestep_respacing[6:]))
    else:
        use_timesteps = space_timesteps(diffusion_steps, timestep_respacing)
    schedule = DiffusionSchedule.create(
        betas,
        mean_type=MeanType.START_X if predict_xstart else MeanType.EPSILON,
        var_type=(VarType.LEARNED_RANGE if learn_sigma
                  else VarType.FIXED_SMALL if sigma_small else VarType.FIXED_LARGE),
        loss_type=loss_type,
        use_timesteps=use_timesteps,
        device=device,
    )
    return Diffusion(schedule)
