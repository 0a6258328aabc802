"""Flow matching: stochastic-interpolant training and probability-flow ODE
sampling on the same DiT (the SiT-family objective).

Counterpart of `fast_dit_tpu/diffusion/flow.py`. Conventions (SiT's):
t in [0, 1], t = 0 is data and t = 1 noise, x_t = alpha(t) x0 + sigma(t)
eps, with the paths "linear" (alpha = 1 - t, sigma = t) and "gvp" (alpha =
cos(pi t / 2), sigma = sin(pi t / 2)). The model predicts the velocity
d x_t / dt and sees t * t_scale (1000 by default); sampling integrates dx/dt
= v from t = 1 to 0 with Euler (one model call per step) or Heun (two, the
last step included). Build the DiT with `learn_sigma=False`, and guide with
`forward_with_cfg(..., guidance_channels=in_channels)`.

The time grid and its steps are host fp32 numbers, made by the formula
`jnp.linspace` uses with XLA's multiply by the reciprocal of the step count,
so the grid equals JAX's on the CPU at the step counts the CLIs run.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["FLOW_PATHS", "flow_path_coeffs", "flow_training_losses", "flow_sample_loop",
           "flow_reverse_loop", "flow_time_grid"]

FLOW_PATHS = ("linear", "gvp")


def flow_path_coeffs(t, path: str = "linear"):
    """(alpha, sigma, d_alpha, d_sigma) at continuous time t in [0, 1],
    fp32, elementwise, any shape."""
    t = torch.as_tensor(t, dtype=torch.float32)
    if path == "linear":
        return 1.0 - t, t, torch.full_like(t, -1.0), torch.full_like(t, 1.0)
    if path == "gvp":
        h = math.pi / 2.0
        return torch.cos(h * t), torch.sin(h * t), -h * torch.sin(h * t), h * torch.cos(h * t)
    raise NotImplementedError(f"unknown flow path: {path!r}")


def _bcast(c, x):
    return c.reshape(*c.shape, *((1,) * (x.ndim - c.ndim))).to(x.dtype)


def flow_training_losses(model_fn: Callable, x_start, t, noise, *, path: str = "linear",
                         t_scale: float = 1000.0) -> dict:
    """Per-example velocity-matching MSE {"loss", "mse"}, (B,) each.
    model_fn(x_t, t * t_scale) must return the velocity in x_t's shape; t is
    (B,) in [0, 1]."""
    alpha, sigma, d_alpha, d_sigma = flow_path_coeffs(t, path)
    x_t = _bcast(alpha, x_start) * x_start + _bcast(sigma, noise) * noise
    target = _bcast(d_alpha, x_start) * x_start + _bcast(d_sigma, noise) * noise
    v = model_fn(x_t, (t * t_scale).to(x_t.dtype))
    if v.shape != x_t.shape:
        raise ValueError(f"a flow model must predict the velocity in the input's shape, got "
                         f"{tuple(v.shape)} for {tuple(x_t.shape)}: build the DiT with "
                         f"learn_sigma=False")
    mse = ((v.float() - target.float()) ** 2).mean(dim=tuple(range(1, x_t.ndim)))
    return {"loss": mse, "mse": mse}


def flow_time_grid(num_steps: int, start: float, stop: float) -> np.ndarray:
    """num_steps + 1 fp32 times from `start` to `stop`."""
    n = np.float32(num_steps)
    step = np.arange(num_steps, dtype=np.float32) * (np.float32(1.0) / n)
    grid = np.float32(start) * (np.float32(1.0) - step) + np.float32(stop) * step
    return np.append(grid, np.float32(stop)).astype(np.float32)


def _integrate(model_fn, x, ts, *, method: str, t_scale: float, return_intermediates: bool):
    """Euler or Heun steps over the host grid `ts`."""
    if method not in ("euler", "heun"):
        raise NotImplementedError(f"unknown ODE method: {method!r}")
    scale = np.float32(t_scale)

    def model_t(x, t):
        return model_fn(x, torch.full((x.shape[0],), float(t * scale), dtype=x.dtype,
                                      device=x.device))

    xs = []
    for t_cur, t_next in zip(ts[:-1], ts[1:]):
        dt = float(t_next - t_cur)
        v1 = model_t(x, t_cur)
        if method == "euler":
            x = x + dt * v1
        else:
            v2 = model_t(x + dt * v1, t_next)
            x = x + dt * 0.5 * (v1 + v2)
        if return_intermediates:
            xs.append(x)
    return (x, torch.stack(xs)) if return_intermediates else x


def flow_sample_loop(model_fn: Callable, shape, *, num_steps: int = 50, method: str = "heun",
                     noise=None, generator: Optional[torch.Generator] = None,
                     path: str = "linear", t_scale: float = 1000.0,
                     return_intermediates: bool = False, dtype=torch.float32):
    """Integrate the probability-flow ODE from t = 1 (noise) to 0 (data).
    `noise` gives x_1, else it is drawn from `generator`, on its device.
    model_fn(x, t) receives (B,) times already scaled by `t_scale`. Heun
    makes 2 num_steps model calls, Euler num_steps. `path` must be the
    training path; the trained velocity field already encodes it."""
    del path
    if noise is None:
        if generator is None:
            raise ValueError("pass `noise` or `generator`")
        noise = torch.randn(tuple(shape), generator=generator, dtype=dtype,
                            device=generator.device)
    return _integrate(model_fn, noise.to(dtype), flow_time_grid(num_steps, 1.0, 0.0),
                      method=method, t_scale=t_scale,
                      return_intermediates=return_intermediates)


def flow_reverse_loop(model_fn: Callable, x, *, num_steps: int = 50, method: str = "heun",
                      t_scale: float = 1000.0, return_intermediates: bool = False):
    """Encode data to noise by integrating the same ODE from t = 0 to 1."""
    return _integrate(model_fn, x, flow_time_grid(num_steps, 0.0, 1.0), method=method,
                      t_scale=t_scale, return_intermediates=return_intermediates)
