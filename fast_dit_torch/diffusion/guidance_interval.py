"""Guidance interval (Kynkaanniemi et al., arXiv:2404.07724): classifier-free
guidance only where the noise level lies in a band; elsewhere only the
conditional half of the batch runs.

Counterpart of `fast_dit_tpu/diffusion/guidance_interval.py`
(`guidance_interval_mask` :39, `guidance_interval_fn` :65,
`guided_steps_korder` :105, `guidance_interval_cached_fns` :115). The mask
is fp64 numpy arithmetic on the schedule's host tables, so it equals JAX's.
JAX picks the branch with `lax.cond(table[t[0]])` on the device; reading
`t[0]` here would wait for the card at every step, so the wrappers take the
decision on the host from the timestep the loop publishes
(`gaussian.host_timestep`).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .gaussian import host_timestep
from .schedule import DiffusionSchedule

__all__ = ["guidance_interval_mask", "guidance_interval_fn", "guided_steps_korder",
           "guidance_interval_cached_fns"]


def guidance_interval_mask(sched: DiffusionSchedule, sigma_low: float,
                           sigma_high: float) -> np.ndarray:
    """Boolean table over ORIGINAL-process timesteps: True where the EDM
    noise level sigma(t) = sqrt((1 - abar) / abar), from the fp64
    alphas_cumprod, lies in [sigma_low, sigma_high]. Indexed by the t_model
    values the loops pass to the model."""
    tm = np.asarray(sched.timestep_map_host, dtype=np.int64)
    abar = np.asarray(sched.alphas_cumprod_fp64, dtype=np.float64)
    sigma = np.sqrt((1.0 - abar) / abar)
    table = np.zeros(int(tm.max()) + 1, dtype=bool)
    table[tm] = (sigma >= sigma_low) & (sigma <= sigma_high)
    return table


def guided_steps_korder(sched: DiffusionSchedule, sigma_low: float,
                        sigma_high: float) -> np.ndarray:
    """(T,) bool in sampler step order (k = 0 visits t = T-1): which steps
    of the reverse chain are guided; one contiguous run, since sigma is
    monotone in t."""
    table = guidance_interval_mask(sched, sigma_low, sigma_high)
    return table[np.asarray(sched.timestep_map_host, dtype=np.int64)[::-1]]


def _guided(table) -> bool:
    t_original = host_timestep()
    if t_original is None:
        raise RuntimeError("the guidance interval decides from the loop's host timestep; "
                           "call the model through gaussian.model_call")
    return bool(table[t_original])


def guidance_interval_fn(cfg_fn: Callable, cond_fn: Callable, sched: DiffusionSchedule,
                         sigma_low: float, sigma_high: float) -> Callable:
    """Wrap a doubled-batch CFG model into an interval-guided one.

    cfg_fn(x, t): the doubled-batch `forward_with_cfg`, x = [cond; mirror].
    cond_fn(x, t): the plain conditional forward on the half batch.

    Inside the band the returned model_fn(x, t) calls cfg_fn; outside it
    runs cond_fn on the first half and mirrors the output, which is valid
    because `forward_with_cfg` reads only x[:B] and writes a mirrored
    output. The decision is the same for the whole batch and is taken from
    the host timestep of the loop's current step, so model_fn runs only
    inside a loop of this package (`gaussian.model_call`)."""
    table = guidance_interval_mask(sched, sigma_low, sigma_high)

    def model_fn(x, t):
        if _guided(table):
            return cfg_fn(x, t)
        B = x.shape[0] // 2
        out = cond_fn(x[:B], t[:B])
        return torch.cat([out, out], dim=0)

    return model_fn


def guidance_interval_cached_fns(cfg_fn: Callable, cond_fn: Callable, sched: DiffusionSchedule,
                                 sigma_low: float, sigma_high: float):
    """The guidance interval composed with the FORA layer cache.

    cfg_fn(x, t, *, cache=None, want_cache=False): the doubled-batch CFG
        forward (`DiT.forward_with_cfg`), x = [cond; mirror] of 2B.
    cond_fn(x, t, *, cache=None, want_cache=False): the conditional
        forward on the half batch (B, ...).

    Returns (model_full_fn, model_cached_fn, forced_refresh_korder) for the
    cached loops (`p_sample_loop_cached(force_refresh_mask=...)`). The cache
    keeps the whole doubled batch on axis 1 (axis 0 is the layer). A guided
    step uses both halves; an unguided refresh mirrors its half cache into
    both, and an unguided cached step reads the first half. The mirrored
    unconditional half is stale and never read: `forced_refresh_korder`
    marks each band-entry step, so the first guided step after unguided
    ones refreshes the whole batch."""
    table = guidance_interval_mask(sched, sigma_low, sigma_high)

    def model_full_fn(x, t):
        if _guided(table):
            return cfg_fn(x, t, want_cache=True)
        B = x.shape[0] // 2
        out, half = cond_fn(x[:B], t[:B], want_cache=True)
        return torch.cat([out, out], dim=0), tuple(torch.cat([a, a], dim=1) for a in half)

    def model_cached_fn(x, t, cache):
        if _guided(table):
            return cfg_fn(x, t, cache=cache)
        B = x.shape[0] // 2
        out = cond_fn(x[:B], t[:B], cache=tuple(a[:, :B] for a in cache))
        return torch.cat([out, out], dim=0)

    g = guided_steps_korder(sched, sigma_low, sigma_high)
    forced = g & ~np.concatenate([[False], g[:-1]])
    return model_full_fn, model_cached_fn, forced
