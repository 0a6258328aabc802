"""Diffusion sampling core: schedules, the respacing DSL, the Gaussian step
math and the sampling loops.

`create_diffusion` keeps the signature and defaults of
`fast_dit_tpu/diffusion/__init__.py:249-291` (1000-step linear schedule,
epsilon prediction, LEARNED_RANGE variance, MSE loss, the "250" / "ddim50" /
"10,15,20" respacing strings), plus the `device` the tables live on ("cuda"
unless the caller asks for the CPU). The `Diffusion` facade carries
`q_sample`, `training_losses`, `p_sample_loop` and `ddim_sample_loop`.
"""

from __future__ import annotations

import torch

from . import gaussian, sampling
from ..utils.device import resolve_device
from .respace import space_timesteps
from .sampling import ddim_sample_loop, p_sample_loop
from .schedule import (DiffusionSchedule, LossType, MeanType, VarType,
                       betas_for_alpha_bar, get_named_beta_schedule)

__all__ = [
    "create_diffusion",
    "Diffusion",
    "DiffusionSchedule",
    "MeanType",
    "VarType",
    "LossType",
    "space_timesteps",
    "get_named_beta_schedule",
    "betas_for_alpha_bar",
    "gaussian",
    "sampling",
]


class Diffusion:
    """Facade over the functional core. `model_fn(x, t_original)` receives
    original-process timesteps: the respacing remap is applied inside."""

    def __init__(self, schedule: DiffusionSchedule):
        self.schedule = schedule

    @property
    def num_timesteps(self) -> int:
        return self.schedule.num_timesteps

    def q_sample(self, x_start, t, noise):
        return gaussian.q_sample(self.schedule, x_start, t, noise)

    def training_losses(self, model_fn, x_start, t, model_kwargs=None, noise=None,
                        generator=None):
        """Per-example loss terms; `noise` is drawn from `generator` when not
        given (the JAX facade's `rng`)."""
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator, dtype=x_start.dtype,
                                device=x_start.device)
        kwargs = model_kwargs or {}
        return gaussian.training_losses(self.schedule, lambda x, tt: model_fn(x, tt, **kwargs),
                                        x_start, t, noise)

    def p_sample_loop(self, model_fn, shape, *, generator=None, noise=None,
                      step_noise=None, clip_denoised=True, dtype=torch.float32):
        return p_sample_loop(model_fn, shape, self.schedule, generator=generator,
                             noise=noise, step_noise=step_noise,
                             clip_denoised=clip_denoised, dtype=dtype)

    def ddim_sample_loop(self, model_fn, shape, *, generator=None, noise=None,
                         step_noise=None, clip_denoised=True, eta=0.0,
                         dtype=torch.float32):
        return ddim_sample_loop(model_fn, shape, self.schedule, generator=generator,
                                noise=noise, step_noise=step_noise,
                                clip_denoised=clip_denoised, eta=eta, dtype=dtype)


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
    schedule = DiffusionSchedule.create(
        betas,
        mean_type=MeanType.START_X if predict_xstart else MeanType.EPSILON,
        var_type=(VarType.LEARNED_RANGE if learn_sigma
                  else VarType.FIXED_SMALL if sigma_small else VarType.FIXED_LARGE),
        loss_type=loss_type,
        use_timesteps=space_timesteps(diffusion_steps, timestep_respacing),
        device=device,
    )
    return Diffusion(schedule)
