"""Diffusion noise-schedule tables: derived in float64 numpy, stored as fp32
tensors on one device.

Counterpart of `fast_dit_tpu/diffusion/schedule.py` (`_derive_tables`
:119-168, the respacing rebuild :226-240, `timestep_map` and the host fp64
`alphas_cumprod_fp64` :207,252). The JAX package keeps the tables as an fp32
pytree (`table_dtype=float32`); here they are a plain dataclass of fp32
tensors, so the two are bit-equal. Two host tuples sit beside them: the fp64
alphas_cumprod, from which UniPC's coefficients and the guidance-interval
mask are built, and `timestep_map_host`, which lets a sampling loop know on
the host which original timestep each step visits.
"""

from __future__ import annotations

import dataclasses
import enum
import math

import numpy as np
import torch

__all__ = [
    "MeanType",
    "VarType",
    "LossType",
    "get_named_beta_schedule",
    "betas_for_alpha_bar",
    "derive_tables",
    "DiffusionSchedule",
]


class MeanType(str, enum.Enum):
    """What the model predicts (reference `ModelMeanType`)."""

    PREVIOUS_X = "previous_x"
    START_X = "start_x"
    EPSILON = "epsilon"


class VarType(str, enum.Enum):
    """Model variance parameterization (reference `ModelVarType`)."""

    LEARNED = "learned"
    FIXED_SMALL = "fixed_small"
    FIXED_LARGE = "fixed_large"
    LEARNED_RANGE = "learned_range"


class LossType(str, enum.Enum):
    """Training loss flavor (reference `LossType`); chosen by
    `create_diffusion`, read by the training slice."""

    MSE = "mse"
    RESCALED_MSE = "rescaled_mse"
    KL = "kl"
    RESCALED_KL = "rescaled_kl"


def get_named_beta_schedule(schedule_name: str, num_diffusion_timesteps: int) -> np.ndarray:
    """Named fp64 beta schedules ("linear", "squaredcos_cap_v2")."""
    if schedule_name == "linear":
        scale = 1000 / num_diffusion_timesteps
        return np.linspace(scale * 0.0001, scale * 0.02, num_diffusion_timesteps,
                           dtype=np.float64)
    if schedule_name == "squaredcos_cap_v2":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def betas_for_alpha_bar(num_diffusion_timesteps: int, alpha_bar, max_beta: float = 0.999) -> np.ndarray:
    """Discretize a continuous alpha-bar function."""
    betas = []
    for i in range(num_diffusion_timesteps):
        t1 = i / num_diffusion_timesteps
        t2 = (i + 1) / num_diffusion_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas)


def derive_tables(betas: np.ndarray) -> dict:
    """All derived fp64 tables (`fast_dit_tpu/diffusion/schedule.py:119-168`)."""
    betas = np.asarray(betas, dtype=np.float64)
    assert betas.ndim == 1, "betas must be 1-D"
    assert (betas > 0).all() and (betas <= 1).all()
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    alphas_cumprod_next = np.append(alphas_cumprod[1:], 0.0)

    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    # log clipped: posterior variance is 0 at t=0
    if len(posterior_variance) > 1:
        posterior_log_variance_clipped = np.log(
            np.append(posterior_variance[1], posterior_variance[1:]))
    else:
        posterior_log_variance_clipped = np.log(np.maximum(posterior_variance, 1e-20))

    # FIXED_LARGE uses beta_t with the t=0 slot patched to the posterior
    # variance at t=1 for a better decoder likelihood
    fixed_large_variance = (np.append(posterior_variance[1], betas[1:])
                            if len(betas) > 1 else betas)

    return dict(
        betas=betas,
        log_betas=np.log(betas),
        alphas_cumprod=alphas_cumprod,
        alphas_cumprod_prev=alphas_cumprod_prev,
        alphas_cumprod_next=alphas_cumprod_next,
        sqrt_alphas_cumprod=np.sqrt(alphas_cumprod),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - alphas_cumprod),
        log_one_minus_alphas_cumprod=np.log(1.0 - alphas_cumprod),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod - 1),
        posterior_variance=posterior_variance,
        posterior_log_variance_clipped=posterior_log_variance_clipped,
        posterior_mean_coef1=betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod),
        posterior_mean_coef2=(1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod),
        fixed_large_variance=fixed_large_variance,
        log_fixed_large_variance=np.log(fixed_large_variance),
    )


def _respace(betas: np.ndarray, use_timesteps):
    """Rebuild betas over the retained timesteps: new_beta_i =
    1 - abar_i / abar_last_kept. Returns (betas, timestep_map)."""
    use = set(int(t) for t in use_timesteps)
    alphas_cumprod = np.cumprod(1.0 - betas)
    last = 1.0
    new_betas, timestep_map = [], []
    for i, abar in enumerate(alphas_cumprod):
        if i in use:
            new_betas.append(1 - abar / last)
            last = abar
            timestep_map.append(i)
    return np.array(new_betas, dtype=np.float64), timestep_map


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """fp32 `(num_timesteps,)` tables on one device, plus the static process
    configuration. `timestep_map` (int64) maps a respaced index to the
    original-process timestep the model is conditioned on;
    `timestep_map_host` holds the same ints and `alphas_cumprod_fp64` the
    fp64 alphas_cumprod, both as host tuples."""

    tables: dict
    timestep_map: torch.Tensor
    num_timesteps: int
    original_num_steps: int
    mean_type: MeanType
    var_type: VarType
    loss_type: LossType
    alphas_cumprod_fp64: tuple = None
    timestep_map_host: tuple = None

    def __getattr__(self, name):
        tables = self.__dict__.get("tables", {})
        if name in tables:
            return tables[name]
        raise AttributeError(name)

    @classmethod
    def create(cls, betas: np.ndarray, *, mean_type=MeanType.EPSILON,
               var_type=VarType.LEARNED_RANGE, loss_type=LossType.MSE,
               use_timesteps=None, device="cpu") -> "DiffusionSchedule":
        """Build a schedule on `device`, optionally respaced to a subset of
        timesteps."""
        betas = np.asarray(betas, dtype=np.float64)
        original_num_steps = len(betas)
        if use_timesteps is not None:
            betas, timestep_map = _respace(betas, use_timesteps)
        else:
            timestep_map = list(range(original_num_steps))
        fp64 = derive_tables(betas)
        tables = {k: torch.tensor(v, dtype=torch.float32, device=device)
                  for k, v in fp64.items()}
        return cls(
            tables=tables,
            timestep_map=torch.tensor(timestep_map, dtype=torch.int64, device=device),
            num_timesteps=len(betas),
            original_num_steps=original_num_steps,
            mean_type=MeanType(mean_type),
            var_type=VarType(var_type),
            loss_type=LossType(loss_type),
            alphas_cumprod_fp64=tuple(float(a) for a in fp64["alphas_cumprod"]),
            timestep_map_host=tuple(int(t) for t in timestep_map),
        )
