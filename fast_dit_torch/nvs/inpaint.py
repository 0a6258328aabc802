"""Diffusion inpainting of masked regions (counterpart of
`fast_dit_tpu/nvs/inpaint.py`).

RePaint-style masked resampling with any of the port's diffusion models: at
every reverse step the known region is re-injected from
q_sample(known, t) so the model generates only inside the mask, with
`jump_n` resampling passes per step (re-noised one step back up between
passes, except after the last), and the known region pinned exactly in
the output. `mask_from_black_pixels` is the reference's hole mask.

JAX draws x_T and every step's noises from `fold_in` keys of one rng
(:59,64,71,76,79,85) inside one `lax.scan`; here the loop runs on the host
and takes its draws from a `torch.Generator`, or explicitly: `noise` for
x_T and, per step (in the order visited, from t = T-1 down) and pass,
`known_noise`, `step_noise` and `renoise`, each (T, jump_n, *shape), as
the samplers take `step_noise` (`diffusion/sampling.py`). Every branch
(the final pass, t == 0) is decided on the host.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..diffusion import gaussian
from ..diffusion.schedule import DiffusionSchedule

__all__ = ["mask_from_black_pixels", "inpaint_sample_loop"]


def mask_from_black_pixels(img: np.ndarray, threshold: int = 0) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) bool mask of holes (all-black pixels)."""
    return (np.asarray(img) <= threshold).all(axis=-1)


def _draws(name, draws, shape, T, jump_n, dtype, device):
    if draws is None:
        return None
    draws = torch.as_tensor(draws, dtype=dtype, device=device)
    if tuple(draws.shape) != (T, jump_n, *shape):
        raise ValueError(f"{name} must be (T, jump_n, *shape) = {(T, jump_n, *shape)}, "
                         f"got {tuple(draws.shape)}")
    return draws


def inpaint_sample_loop(model_fn: Callable, known: torch.Tensor, mask, sched: DiffusionSchedule,
                        *, generator: Optional[torch.Generator] = None, noise=None,
                        known_noise=None, step_noise=None, renoise=None,
                        clip_denoised: bool = True, jump_n: int = 1,
                        dtype=torch.float32) -> torch.Tensor:
    """RePaint-style inpainting.

    known: (B, C, H, W) image or latent with valid content outside the holes.
    mask: broadcastable to `known`; 1 = hole to fill, 0 = keep.
    model_fn(x, t_original) -> model output (the samplers' contract).
    jump_n: resampling passes per step (1 = plain masked replacement).
    Draws not given explicitly come from `generator`.
    """
    if jump_n < 1:
        raise ValueError(f"jump_n must be >= 1, got {jump_n}")
    known = torch.as_tensor(known, dtype=dtype)
    device, shape = known.device, tuple(known.shape)
    mask = torch.as_tensor(mask, dtype=dtype, device=device).broadcast_to(shape)
    T = sched.num_timesteps
    explicit = {name: _draws(name, d, shape, T, jump_n, dtype, device)
                for name, d in (("known_noise", known_noise), ("step_noise", step_noise),
                                ("renoise", renoise))}
    if generator is None and (noise is None or any(d is None for d in explicit.values())):
        raise ValueError("inpainting needs `generator` or every explicit draw")

    def draw(name, k, j):
        d = explicit[name]
        return (d[k, j] if d is not None else
                torch.randn(shape, generator=generator, dtype=dtype, device=device))

    if noise is not None:
        x = torch.as_tensor(noise, dtype=dtype, device=device)
    else:
        x = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    for k, i in enumerate(range(T - 1, -1, -1)):
        t = torch.full((shape[0],), i, dtype=torch.int64, device=device)
        for j in range(jump_n):
            # re-inject the known region at this noise level (the clean
            # known content at t == 0)
            kn = draw("known_noise", k, j)
            x_known = known if i == 0 else gaussian.q_sample(sched, known, t, kn)
            x = mask * x + (1.0 - mask) * x_known
            out, _ = gaussian.model_call(model_fn, x, sched.timestep_map_host[i])
            x = gaussian.p_sample_step(sched, out, x, t, draw("step_noise", k, j),
                                       clip_denoised=clip_denoised).sample
            if j < jump_n - 1 and i > 0:
                # jump back up one step before the next pass
                t_prev = torch.full((shape[0],), i - 1, dtype=torch.int64, device=device)
                beta = gaussian.extract(sched.betas, t_prev, x.ndim, x.dtype)
                x = torch.sqrt(1.0 - beta) * x + torch.sqrt(beta) * draw("renoise", k, j)
    return mask * x + (1.0 - mask) * known
