"""Sampling loops: a Python loop over timesteps, one model call per step.

Counterpart of `fast_dit_tpu/diffusion/sampling.py`: `_loop` with its DDPM,
DDIM and reverse-DDIM kinds (`p_sample_loop`, `ddim_sample_loop`,
`ddim_reverse_sample_loop`, :35-180, :496), DPM-Solver++ (:515) and UniPC
(:607). JAX compiles each chain into one `lax.scan`; here every step is
issued from Python. Every loop takes either a `torch.Generator` or explicit
noise: `noise` for x_T and `step_noise[k]` for the k-th step's Gaussian, so a
test can inject the same draws into both packages.

No loop waits for the device: the per-step coefficients are host floats,
and every model call goes through `gaussian.model_call` with the step's
original timestep from the schedule's host map, which it publishes on the
host (`gaussian.host_timestep`) for the guidance interval. The cached
loops pick a full or a cached model call per step from the host refresh
mask, so they read nothing from the device either.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from . import gaussian
from .schedule import DiffusionSchedule

__all__ = ["p_sample_loop", "ddim_sample_loop", "ddim_reverse_sample_loop",
           "p_sample_loop_cached", "ddim_sample_loop_cached", "cache_refresh_mask",
           "dpm_solver_sample_loop", "unipc_sample_loop", "dpm_solver_coefficients",
           "unipc_coefficients"]


def _init_noise(shape, noise, generator, dtype, device):
    if noise is not None:
        return torch.as_tensor(noise, dtype=dtype, device=device)
    if generator is None:
        raise ValueError("either `noise` or `generator` must be provided")
    return torch.randn(tuple(shape), generator=generator, dtype=dtype, device=device)


def _apply_step(step_kind, sched, model_output, x, t, n, *, clip_denoised, denoised_fn,
                cond_grad, eta):
    if step_kind == "p":
        return gaussian.p_sample_step(sched, model_output, x, t, n, clip_denoised=clip_denoised,
                                      denoised_fn=denoised_fn, cond_grad=cond_grad)
    if step_kind == "ddim":
        return gaussian.ddim_step(sched, model_output, x, t, n, eta=eta,
                                  clip_denoised=clip_denoised, denoised_fn=denoised_fn,
                                  cond_grad=cond_grad)
    assert step_kind == "ddim_reverse"
    return gaussian.ddim_reverse_step(sched, model_output, x, t, clip_denoised=clip_denoised,
                                      denoised_fn=denoised_fn, cond_grad=cond_grad)


def _loop(step_kind: str, model_fn: Callable, shape, sched: DiffusionSchedule, *,
          generator: Optional[torch.Generator] = None, noise=None, step_noise=None,
          clip_denoised: bool = True, denoised_fn=None, cond_fn=None, eta: float = 0.0,
          return_intermediates: bool = False, dtype=torch.float32):
    x = _init_noise(shape, noise, generator, dtype, sched.timestep_map.device)
    shape = tuple(x.shape)
    T = sched.num_timesteps
    needs_noise = step_kind == "p" or (step_kind == "ddim" and eta != 0.0)
    if step_noise is not None:
        step_noise = torch.as_tensor(step_noise, dtype=dtype, device=x.device)
        if tuple(step_noise.shape) != (T, *shape):
            raise ValueError(f"step_noise must be (T, *shape) = {(T, *shape)}, "
                             f"got {tuple(step_noise.shape)}")
    elif needs_noise and generator is None:
        raise ValueError("stochastic sampling needs `generator` or `step_noise`")

    visits = range(T) if step_kind == "ddim_reverse" else range(T - 1, -1, -1)
    intermediates = []
    for k, i in enumerate(visits):
        t = torch.full((shape[0],), i, dtype=torch.int64, device=x.device)
        model_output, cond_grad = gaussian.model_call(model_fn, x, sched.timestep_map_host[i],
                                                      cond_fn)
        n = None
        if needs_noise:
            n = (step_noise[k] if step_noise is not None else
                 torch.randn(shape, generator=generator, dtype=dtype, device=x.device))
        x = _apply_step(step_kind, sched, model_output, x, t, n, clip_denoised=clip_denoised,
                        denoised_fn=denoised_fn, cond_grad=cond_grad, eta=eta).sample
        if return_intermediates:
            intermediates.append(x)
    return (x, torch.stack(intermediates)) if return_intermediates else x


def p_sample_loop(model_fn: Callable, shape, sched: DiffusionSchedule, *,
                  generator=None, noise=None, step_noise=None, clip_denoised: bool = True,
                  denoised_fn=None, cond_fn=None, return_intermediates: bool = False,
                  dtype=torch.float32):
    """DDPM ancestral sampling. `model_fn(x, t_original)` receives
    original-process timesteps: the respacing remap is applied here.
    `cond_fn(x, t_original)` gives a classifier gradient that shifts each
    step's mean. With `return_intermediates`, also the (T, *shape) stack of
    every step's sample."""
    return _loop("p", model_fn, shape, sched, generator=generator, noise=noise,
                 step_noise=step_noise, clip_denoised=clip_denoised, denoised_fn=denoised_fn,
                 cond_fn=cond_fn, return_intermediates=return_intermediates, dtype=dtype)


def ddim_sample_loop(model_fn: Callable, shape, sched: DiffusionSchedule, *,
                     generator=None, noise=None, step_noise=None,
                     clip_denoised: bool = True, denoised_fn=None, cond_fn=None,
                     eta: float = 0.0, return_intermediates: bool = False,
                     dtype=torch.float32):
    """DDIM sampling; `cond_fn` conditions the score."""
    return _loop("ddim", model_fn, shape, sched, generator=generator, noise=noise,
                 step_noise=step_noise, clip_denoised=clip_denoised, denoised_fn=denoised_fn,
                 cond_fn=cond_fn, eta=eta, return_intermediates=return_intermediates,
                 dtype=dtype)


def ddim_reverse_sample_loop(model_fn: Callable, x_start, sched: DiffusionSchedule, *,
                             clip_denoised: bool = True, denoised_fn=None, cond_fn=None,
                             return_intermediates: bool = False, dtype=torch.float32):
    """The reverse DDIM ODE: encode x_0 into x_T, t = 0 .. T-1."""
    return _loop("ddim_reverse", model_fn, x_start.shape, sched, noise=x_start,
                 clip_denoised=clip_denoised, denoised_fn=denoised_fn, cond_fn=cond_fn,
                 return_intermediates=return_intermediates, dtype=dtype)


def cache_refresh_mask(sched: DiffusionSchedule, interval: int,
                       schedule: str = "uniform") -> np.ndarray:
    """(T,) bool in step order (k = 0 visits t = T-1): which steps refresh
    the layer cache, JAX's host arithmetic (`sampling.py:183-241`) as it is.
    Every schedule spends the same budget, ceil(T / interval) full
    evaluations: "uniform" every interval-th step, "logsnr" at equal log-SNR
    spacing, "abar" at equal alpha_bar spacing. Step 0 always refreshes."""
    T = sched.num_timesteps
    budget = (T + interval - 1) // interval
    mask = np.zeros(T, dtype=bool)
    if schedule == "uniform":
        mask[::interval] = True
        return mask
    abar = np.asarray(sched.alphas_cumprod_fp64, dtype=np.float64)[::-1]  # step order
    if schedule == "abar":
        delta = np.abs(np.diff(abar, prepend=abar[0]))
    elif schedule == "logsnr":
        lam = 0.5 * (np.log(abar) - np.log1p(-abar))
        delta = np.abs(np.diff(lam, prepend=lam[0]))
    else:
        raise ValueError(f"unknown cache refresh schedule: {schedule!r}")
    cum = np.cumsum(delta)
    total = cum[-1] if cum[-1] > 0 else 1.0
    # refresh where the accumulated signal crosses the next of `budget` equal
    # thresholds, moving on to the next free step where several land in one
    thresholds = np.arange(budget) * (total / budget)
    crossed = np.searchsorted(cum, thresholds, side="left")
    last = -1
    for c in crossed:
        pos = max(int(c), last + 1)
        if pos >= T:
            break
        mask[pos] = True
        last = pos
    mask[0] = True
    # thresholds pushed past T: split the longest unrefreshed runs until the
    # budget is spent exactly
    while mask.sum() < budget:
        runs = np.split(np.flatnonzero(~mask),
                        np.where(np.diff(np.flatnonzero(~mask)) > 1)[0] + 1)
        longest = max(runs, key=len)
        mask[longest[len(longest) // 2]] = True
    return mask


def _cached_loop(step_kind: str, model_full_fn: Callable, model_cached_fn: Callable, shape,
                 sched: DiffusionSchedule, *, refresh_mask, generator=None, noise=None,
                 step_noise=None, clip_denoised: bool = True, denoised_fn=None, cond_fn=None,
                 eta: float = 0.0, dtype=torch.float32):
    """Sampling with a FORA-style layer cache (arXiv:2407.01425): where
    `refresh_mask` (step order) is set, the full model runs and refreshes a
    per-layer cache of its branch outputs; elsewhere the cache is replayed,
    which recomputes only the timestep-dependent adaLN gates.

        model_full_fn(x, t)          -> (model_output, cache)
        model_cached_fn(x, t, cache) -> model_output

    JAX has two loops, a period-tiled scan for the uniform mask
    (`_cached_loop`, :298) and a scan over `lax.cond` for any mask
    (`_cached_loop_masked`, :244); a Python loop needs only the second. Step
    0 always refreshes. All-True is the plain loop: same step math, same
    noise."""
    assert step_kind in ("p", "ddim")
    x = _init_noise(shape, noise, generator, dtype, sched.timestep_map.device)
    shape = tuple(x.shape)
    T = sched.num_timesteps
    refresh = np.asarray(refresh_mask, dtype=bool).copy()
    if refresh.shape != (T,):
        raise ValueError(f"refresh_mask must be ({T},), got {refresh.shape}")
    refresh[0] = True  # the first step fills the cache
    needs_noise = step_kind == "p" or eta != 0.0
    if step_noise is not None:
        step_noise = torch.as_tensor(step_noise, dtype=dtype, device=x.device)
        if tuple(step_noise.shape) != (T, *shape):
            raise ValueError(f"step_noise must be (T, *shape) = {(T, *shape)}, "
                             f"got {tuple(step_noise.shape)}")
    elif needs_noise and generator is None:
        raise ValueError("stochastic sampling needs `generator` or `step_noise`")
    cache = None
    for k in range(T):
        i = T - 1 - k
        t = torch.full((shape[0],), i, dtype=torch.int64, device=x.device)
        t_model = sched.timestep_map_host[i]
        if refresh[k]:
            (model_output, cache), cond_grad = gaussian.model_call(model_full_fn, x, t_model,
                                                                   cond_fn)
        else:
            model_output, cond_grad = gaussian.model_call(
                lambda x_, t_: model_cached_fn(x_, t_, cache), x, t_model, cond_fn)
        n = None
        if needs_noise:
            n = (step_noise[k] if step_noise is not None else
                 torch.randn(shape, generator=generator, dtype=dtype, device=x.device))
        x = _apply_step(step_kind, sched, model_output, x, t, n, clip_denoised=clip_denoised,
                        denoised_fn=denoised_fn, cond_grad=cond_grad, eta=eta).sample
    return x


def _refresh_mask(sched, interval, refresh_schedule, force_refresh_mask):
    if interval < 1:
        raise ValueError(f"interval must be >= 1, got {interval}")
    mask = cache_refresh_mask(sched, interval, refresh_schedule)
    if force_refresh_mask is not None:
        mask = mask | np.asarray(force_refresh_mask, dtype=bool)
    return mask


def p_sample_loop_cached(model_full_fn: Callable, model_cached_fn: Callable, shape,
                         sched: DiffusionSchedule, *, interval: int,
                         refresh_schedule: str = "uniform", force_refresh_mask=None,
                         generator=None, noise=None, step_noise=None,
                         clip_denoised: bool = True, denoised_fn=None, cond_fn=None,
                         dtype=torch.float32):
    """DDPM ancestral sampling with the layer cache (`_cached_loop`): the
    refreshes of `cache_refresh_mask(sched, interval, refresh_schedule)`,
    OR `force_refresh_mask` ((T,) bool, step order; the guidance
    interval's band entry)."""
    return _cached_loop("p", model_full_fn, model_cached_fn, shape, sched,
                        refresh_mask=_refresh_mask(sched, interval, refresh_schedule,
                                                   force_refresh_mask),
                        generator=generator, noise=noise, step_noise=step_noise,
                        clip_denoised=clip_denoised, denoised_fn=denoised_fn, cond_fn=cond_fn,
                        dtype=dtype)


def ddim_sample_loop_cached(model_full_fn: Callable, model_cached_fn: Callable, shape,
                            sched: DiffusionSchedule, *, interval: int,
                            refresh_schedule: str = "uniform", force_refresh_mask=None,
                            generator=None, noise=None, step_noise=None,
                            clip_denoised: bool = True, denoised_fn=None, cond_fn=None,
                            eta: float = 0.0, dtype=torch.float32):
    """DDIM sampling with the layer cache (see `p_sample_loop_cached`)."""
    return _cached_loop("ddim", model_full_fn, model_cached_fn, shape, sched,
                        refresh_mask=_refresh_mask(sched, interval, refresh_schedule,
                                                   force_refresh_mask),
                        generator=generator, noise=noise, step_noise=step_noise,
                        clip_denoised=clip_denoised, denoised_fn=denoised_fn, cond_fn=cond_fn,
                        eta=eta, dtype=dtype)


def dpm_solver_coefficients(sched: DiffusionSchedule) -> dict:
    """DPM-Solver++(2M)'s per-step coefficients in step order (k = 0 visits
    t = T-1), as host floats: "c_x" and "c_d" of the update x' = c_x x +
    c_d D_bar, and "w1" = 1 + w and "w" of the multistep correction D_bar =
    (1 + w) D_k - w D_{k-1}. Computed as the JAX loop computes them on its
    device (`sampling.py:566-582`): in fp32 from the fp32 alphas_cumprod
    table, with log and log1p, here on the CPU, whose fp32 log may round an
    ulp apart from XLA's."""
    abar = torch.tensor(sched.alphas_cumprod_fp64, dtype=torch.float32).flip(0)
    alpha = torch.sqrt(abar)
    sigma = torch.sqrt(1.0 - abar)
    lam = 0.5 * (torch.log(abar) - torch.log1p(-abar))
    one, zero = torch.ones(1), torch.zeros(1)
    # a virtual final target state, clean data (alpha 1, sigma 0)
    a_tgt = torch.cat([alpha[1:], one])
    s_tgt = torch.cat([sigma[1:], zero])
    c_x = s_tgt / sigma
    e_mh = alpha * s_tgt / (a_tgt * sigma)  # e^{-h}; 0 at the final step
    c_d = a_tgt * (1.0 - e_mh)
    # h_k = lambda_{k+1} - lambda_k, 0 at the final step: w there is 0 (the
    # lower-order-final rule), and w is 0 at the first step (no history)
    h = torch.cat([lam[1:] - lam[:-1], zero])
    w = torch.cat([zero, h[1:] / (2.0 * h[:-1])]) if len(abar) > 1 else zero
    return {"c_x": c_x.tolist(), "c_d": c_d.tolist(), "w": w.tolist(),
            "w1": (1.0 + w).tolist()}


def dpm_solver_sample_loop(model_fn: Callable, shape, sched: DiffusionSchedule, *,
                           generator=None, noise=None, order: int = 2,
                           clip_denoised: bool = True, denoised_fn=None,
                           return_intermediates: bool = False, dtype=torch.float32):
    """DPM-Solver++(2M) (Lu et al., arXiv:2211.01095): deterministic
    multistep sampling in the data-prediction parameterization over log-SNR.
    Order 1 is eta = 0 DDIM; order 2 adds the multistep correction, with
    first-order first and last steps. One model call per respaced step;
    `noise` or `generator` only seed x_T."""
    assert order in (1, 2), order
    x = _init_noise(shape, noise, generator, dtype, sched.timestep_map.device)
    T = sched.num_timesteps
    co = dpm_solver_coefficients(sched)
    d_prev = torch.zeros_like(x)
    intermediates = []
    for k in range(T):
        i = T - 1 - k
        t = torch.full((x.shape[0],), i, dtype=torch.int64, device=x.device)
        model_output, _ = gaussian.model_call(model_fn, x, sched.timestep_map_host[i])
        d = gaussian.p_mean_variance(sched, model_output, x, t, clip_denoised=clip_denoised,
                                     denoised_fn=denoised_fn).pred_xstart
        w = co["w"][k] if order == 2 else 0.0
        # (1 + w) d - w d_prev is d itself where w = 0
        d_bar = co["w1"][k] * d.float() - w * d_prev.float() if w else d
        x = (co["c_x"][k] * x.float() + co["c_d"][k] * d_bar.float()).to(dtype)
        d_prev = d
        if return_intermediates:
            intermediates.append(x)
    return (x, torch.stack(intermediates)) if return_intermediates else x


def unipc_coefficients(sched: DiffusionSchedule, order: int = 2, corrector: bool = True,
                       variant: str = "bh2") -> dict:
    """UniPC's per-step coefficient tables in step order, (T,) fp32 numpy:
    built on the host in fp64 from the schedule's fp64 alphas_cumprod and
    rounded to fp32 once, as `sampling.py:659-714` bakes them, so they equal
    the JAX tables bit for bit. Predictor x' = c_x_p x + A_p m + p_res rho_p
    D1p; the corrector at step k (gate 1) rebuilds state k from state k-1
    with c_x_c, A_c, rc0, rc1 and r0c."""
    assert order in (1, 2), order
    assert variant in ("bh1", "bh2"), variant
    T = sched.num_timesteps
    abar = np.asarray(sched.alphas_cumprod_fp64, np.float64)[::-1]
    alpha = np.sqrt(abar)
    sigma = np.sqrt(1.0 - abar)
    lam = 0.5 * (np.log(abar) - np.log1p(-abar))
    a_tgt = np.append(alpha[1:], 1.0)
    s_tgt = np.append(sigma[1:], 0.0)
    c_x_p = s_tgt / sigma
    e_mh = alpha * s_tgt / (a_tgt * sigma)        # e^{-h_k}; 0 at the final step
    A_p = a_tgt * (1.0 - e_mh)
    h = np.append(lam[1:] - lam[:-1], np.inf)     # h[T-1] = inf (to sigma 0)
    rho_p = np.zeros(T)
    if order == 2 and T >= 3:
        rho_p[1:T - 1] = 0.5                       # first order at both ends
    # D1p = (m_prev - m) / r0p, r0p = (lam_{k-1} - lam_k) / h_k = -h_{k-1} / h_k
    r0p = np.ones(T)
    if T >= 3:
        r0p[1:T - 1] = -h[0:T - 2] / h[1:T - 1]
    p_res = A_p if variant == "bh2" else a_tgt * np.where(np.isinf(h), 0.0, h)
    p_res = np.where(rho_p == 0.0, 0.0, p_res)     # no inf or NaN where unused
    r0p = np.where(rho_p == 0.0, 1.0, r0p)
    gate = np.zeros(T)
    if corrector and T >= 2:
        gate[1:] = 1.0
    c_x_c, A_c, rc0, rc1, r0c = np.zeros(T), np.zeros(T), np.zeros(T), np.zeros(T), np.ones(T)
    for k in range(1, T):
        hc = h[k - 1]
        c_x_c[k] = sigma[k] / sigma[k - 1]
        A_c[k] = alpha[k] * -np.expm1(-hc)
        if k == 1 or order == 1:
            rc1[k] = 0.5                           # the simplified order-1 UniC
            continue
        hh = -hc
        phi1 = np.expm1(hh)
        b_h = phi1 if variant == "bh2" else hh
        b1 = (phi1 / hh - 1.0) / b_h
        b2 = 2.0 * ((phi1 / hh - 1.0) / hh - 0.5) / b_h
        r0c[k] = -h[k - 2] / h[k - 1]
        rc0[k] = (b1 - b2) / (1.0 - r0c[k])
        rc1[k] = b1 - rc0[k]
    return {name: np.asarray(v, np.float64).astype(np.float32) for name, v in dict(
        c_x_p=c_x_p, A_p=A_p, rho_p=rho_p, r0p=r0p, p_res=p_res, gate=gate,
        c_x_c=c_x_c, A_c=A_c, rc0=rc0, rc1=rc1, r0c=r0c).items()}


def unipc_sample_loop(model_fn: Callable, shape, sched: DiffusionSchedule, *,
                      generator=None, noise=None, order: int = 2, corrector: bool = True,
                      variant: str = "bh2", clip_denoised: bool = True, denoised_fn=None,
                      return_intermediates: bool = False, dtype=torch.float32):
    """UniPC (Zhao et al., arXiv:2302.04867): the UniP predictor plus the UniC
    corrector, which reuses each step's model evaluation to correct the
    previous update, so one model call per respaced step. `variant` picks
    B(h): "bh2" = expm1(h), "bh1" = h. `corrector=False` with "bh2" is
    DPM-Solver++(2M). The JAX body blends the corrected and the predicted
    state with a 0/1 gate; the gate is known on the host, so the blend is a
    choice here, which gives the same values. `noise` or `generator` only
    seed x_T."""
    x = _init_noise(shape, noise, generator, dtype, sched.timestep_map.device)
    T = sched.num_timesteps
    tab = {k: v.tolist() for k, v in unipc_coefficients(sched, order, corrector, variant).items()}
    x_prev = torch.zeros_like(x)
    m_prev = m_prev2 = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    intermediates = []
    for k in range(T):
        i = T - 1 - k
        t = torch.full((x.shape[0],), i, dtype=torch.int64, device=x.device)
        model_output, _ = gaussian.model_call(model_fn, x, sched.timestep_map_host[i])
        m = gaussian.p_mean_variance(sched, model_output, x, t, clip_denoised=clip_denoised,
                                     denoised_fn=denoised_fn).pred_xstart.float()
        if tab["gate"][k]:
            # UniC: correct the k-1 -> k transition with the fresh evaluation m
            d1c0 = (m_prev2 - m_prev) / tab["r0c"][k]
            d1ct = m - m_prev
            x_used = (tab["c_x_c"][k] * x_prev.float()
                      + tab["A_c"][k] * (m_prev + tab["rc0"][k] * d1c0 + tab["rc1"][k] * d1ct))
        else:
            x_used = x.float()
        # UniP: predict the k -> k+1 transition
        x_next = tab["c_x_p"][k] * x_used + tab["A_p"][k] * m
        if tab["rho_p"][k]:
            d1p = (m_prev - m) / tab["r0p"][k]
            x_next = x_next + tab["p_res"][k] * tab["rho_p"][k] * d1p
        x, x_prev, m_prev2, m_prev = x_next.to(dtype), x_used.to(dtype), m_prev, m
        if return_intermediates:
            intermediates.append(x)
    return (x, torch.stack(intermediates)) if return_intermediates else x
