"""Sampling loops: a Python loop over timesteps, one model call per step.

Counterpart of `fast_dit_tpu/diffusion/sampling.py` (`_loop`,
`p_sample_loop`, `ddim_sample_loop`, :35-180), where the chain is one
`lax.scan`. Every loop takes either a `torch.Generator` or explicit noise:
`noise` for x_T and `step_noise[k]` for the k-th step's Gaussian, so a test
can inject the same draws into both packages.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from . import gaussian
from .schedule import DiffusionSchedule

__all__ = ["p_sample_loop", "ddim_sample_loop"]


def _loop(step_kind: str, model_fn: Callable, shape, sched: DiffusionSchedule, *,
          generator: Optional[torch.Generator] = None, noise=None, step_noise=None,
          clip_denoised: bool = True, eta: float = 0.0, dtype=torch.float32):
    device = sched.timestep_map.device
    if noise is not None:
        x = torch.as_tensor(noise, dtype=dtype, device=device)
        shape = tuple(x.shape)
    elif generator is None:
        raise ValueError("either `noise` or `generator` must be provided")
    else:
        x = torch.randn(tuple(shape), generator=generator, dtype=dtype, device=device)
    T = sched.num_timesteps
    needs_noise = step_kind == "p" or eta != 0.0
    if step_noise is not None:
        step_noise = torch.as_tensor(step_noise, dtype=dtype, device=device)
        if tuple(step_noise.shape) != (T, *shape):
            raise ValueError(f"step_noise must be (T, *shape) = {(T, *shape)}, "
                             f"got {tuple(step_noise.shape)}")
    elif needs_noise and generator is None:
        raise ValueError("stochastic sampling needs `generator` or `step_noise`")

    B = shape[0]
    for k, i in enumerate(range(T - 1, -1, -1)):
        t = torch.full((B,), i, dtype=torch.int64, device=device)
        model_output = model_fn(x, sched.timestep_map[t])
        n = None
        if needs_noise:
            n = (step_noise[k] if step_noise is not None else
                 torch.randn(tuple(shape), generator=generator, dtype=dtype, device=device))
        if step_kind == "p":
            x = gaussian.p_sample_step(sched, model_output, x, t, n,
                                       clip_denoised=clip_denoised).sample
        else:
            x = gaussian.ddim_step(sched, model_output, x, t, n, eta=eta,
                                   clip_denoised=clip_denoised).sample
    return x


def p_sample_loop(model_fn: Callable, shape, sched: DiffusionSchedule, *,
                  generator=None, noise=None, step_noise=None,
                  clip_denoised: bool = True, dtype=torch.float32):
    """DDPM ancestral sampling. `model_fn(x, t_original)` receives
    original-process timesteps: the respacing remap is applied here."""
    return _loop("p", model_fn, shape, sched, generator=generator, noise=noise,
                 step_noise=step_noise, clip_denoised=clip_denoised, dtype=dtype)


def ddim_sample_loop(model_fn: Callable, shape, sched: DiffusionSchedule, *,
                     generator=None, noise=None, step_noise=None,
                     clip_denoised: bool = True, eta: float = 0.0,
                     dtype=torch.float32):
    """DDIM sampling."""
    return _loop("ddim", model_fn, shape, sched, generator=generator, noise=noise,
                 step_noise=step_noise, clip_denoised=clip_denoised, eta=eta,
                 dtype=dtype)
