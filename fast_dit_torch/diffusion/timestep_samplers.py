"""Importance sampling over diffusion timesteps.

Counterpart of `fast_dit_tpu/diffusion/timestep_samplers.py`: the uniform
sampler, and the loss-second-moment resampler, a ring buffer of the last
`history_per_term` losses of every timestep that, once every timestep has a
full history, draws t with probability proportional to sqrt(E[loss^2])
(mixed with `uniform_prob` of the uniform distribution). As in JAX the
states are immutable: `update_with_losses` returns a new one.

Two differences from JAX, both held by `tests/test_torch_timestep_samplers.py`,
and one addition:
- `sample_timesteps` draws with `torch.multinomial` from an explicit
  generator, a different stream from `jax.random.choice`; the tests inject t
  and the weights.
- `update_with_losses` folds a whole batch in with a few tensor operations
  (rank within equal t, then one scatter) instead of JAX's sequential scan;
  the result is the same ring buffer, repeated timesteps and wrap included,
  and nothing waits for the device.
- In a world of ranks the trainer passes `update_with_losses` the global
  batch's (t, loss) pairs in global order (t drawn for the global batch,
  the losses all-gathered over the data group, `train/train_lib.py`), as
  the reference gathers them (`timestep_sampler.py:97-98`), so every rank
  keeps the same buffers.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["UniformSamplerState", "LossSecondMomentState", "create_named_schedule_sampler",
           "sample_timesteps", "update_with_losses"]


@dataclasses.dataclass(frozen=True)
class UniformSamplerState:
    """Uniform t ~ U{0, ..., T-1}."""

    num_timesteps: int
    device: torch.device = torch.device("cpu")

    def weights(self) -> torch.Tensor:
        return torch.ones((self.num_timesteps,), dtype=torch.float32, device=self.device)


@dataclasses.dataclass(frozen=True)
class LossSecondMomentState:
    """Ring buffer of recent losses per timestep."""

    loss_history: torch.Tensor  # (T, history_per_term) fp32
    loss_counts: torch.Tensor   # (T,) int64
    num_timesteps: int
    history_per_term: int
    uniform_prob: float

    @classmethod
    def create(cls, num_timesteps: int, history_per_term: int = 10, uniform_prob: float = 0.001,
               device="cpu") -> "LossSecondMomentState":
        return cls(torch.zeros((num_timesteps, history_per_term), dtype=torch.float32,
                               device=device),
                   torch.zeros((num_timesteps,), dtype=torch.int64, device=device),
                   num_timesteps, history_per_term, uniform_prob)

    @property
    def device(self) -> torch.device:
        return self.loss_history.device

    def weights(self) -> torch.Tensor:
        """sqrt(E[loss^2]) per timestep, normalised and mixed with the
        uniform distribution, once every timestep is warmed up; else
        uniform. A device-side choice: nothing waits for the card."""
        w = torch.sqrt((self.loss_history ** 2).mean(dim=-1))
        w = w / w.sum()
        w = w * (1 - self.uniform_prob) + self.uniform_prob / self.num_timesteps
        warmed_up = (self.loss_counts == self.history_per_term).all()
        return torch.where(warmed_up, w, torch.ones_like(w))


def create_named_schedule_sampler(name: str, num_timesteps: int, device="cpu"):
    """"uniform" or "loss-second-moment"."""
    if name == "uniform":
        return UniformSamplerState(num_timesteps, torch.device(device))
    if name == "loss-second-moment":
        return LossSecondMomentState.create(num_timesteps, device=device)
    raise NotImplementedError(f"unknown schedule sampler: {name}")


def sample_timesteps(state, generator: torch.Generator, batch_size: int):
    """(t (B,) int64, weights (B,) fp32) with weights = 1 / (T p[t]), which
    keeps the objective unbiased."""
    w = state.weights()
    p = w / w.sum()
    ts = torch.multinomial(p, batch_size, replacement=True, generator=generator)
    return ts, 1.0 / (state.num_timesteps * p[ts])


def update_with_losses(state, ts: torch.Tensor, losses: torch.Tensor):
    """Fold a batch of (t, loss) pairs into the state, in batch order, as
    the sequential rule does: a timestep with c < H losses appends at c, a
    full one drops its oldest and appends at the end. So the new row of a
    timestep that had c losses and gets k more is the last min(c + k, H) of
    (its c losses, then its k in batch order), left-aligned. Uniform states
    are returned unchanged."""
    if isinstance(state, UniformSamplerState):
        return state
    T, H = state.num_timesteps, state.history_per_term
    ts = ts.to(torch.int64)
    counts = state.loss_counts
    # index_add_, not bincount: on the card bincount reads ts.min() and
    # ts.max() back to the host
    k = torch.zeros((T,), dtype=torch.int64, device=ts.device).index_add_(0, ts,
                                                                         torch.ones_like(ts))
    shift = (counts + k - H).clamp(min=0)                       # entries that fall out
    # the kept old entries move left by `shift`
    src = torch.arange(H, device=ts.device) + shift[:, None]
    history = torch.where(src < H, torch.gather(state.loss_history, 1, src.clamp(max=H - 1)),
                          torch.zeros((), dtype=torch.float32, device=ts.device))
    # each loss's rank among the batch's losses of its timestep, in batch order
    order = torch.argsort(ts, stable=True)
    sorted_t = ts[order]
    rank = torch.empty_like(ts)
    rank[order] = (torch.arange(ts.numel(), device=ts.device)
                   - torch.searchsorted(sorted_t, sorted_t))
    pos = counts[ts] + rank - shift[ts]
    # losses that fall out again within the batch go to a spare column
    pos = torch.where(pos >= 0, pos, H)
    history = torch.cat([history, torch.zeros_like(history[:, :1])], dim=1)
    history[ts, pos] = losses.to(torch.float32)
    return dataclasses.replace(state, loss_history=history[:, :H].contiguous(),
                               loss_counts=(counts + k).clamp(max=H))
