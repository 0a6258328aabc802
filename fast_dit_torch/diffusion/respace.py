"""Timestep-respacing mini-DSL (the port's copy of
`fast_dit_tpu/diffusion/respace.py`: `space_timesteps` and
`karras_timesteps` :68-107).

"250" strides 1000 steps down to 250, "ddimN" uses the fixed DDIM-paper
striding, and "10,15,20" splits the process into equal sections with
per-section counts. "karrasN" (dispatched by `create_diffusion`, which has
the betas it needs) keeps N timesteps at Karras sigma positions. The
respaced tables are built by `DiffusionSchedule.create(use_timesteps=...)`.
"""

from __future__ import annotations

from itertools import accumulate, chain, repeat

import numpy as np

__all__ = ["space_timesteps", "karras_timesteps"]


def space_timesteps(num_timesteps: int, section_counts) -> set:
    """Pick which original-process timesteps a respaced process retains.

    :param num_timesteps: length of the original process.
    :param section_counts: list of ints, or a comma-separated string of ints
        (step count per equal section), or "ddimN" for DDIM-paper striding.
    :return: set of original-process timesteps to keep.
    """
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            want = int(section_counts[4:])
            # DDIM-paper fixed striding: the unique integer stride i with
            # ceil(num_timesteps / i) == want, if one exists
            strides = (i for i in range(1, num_timesteps)
                       if len(range(0, num_timesteps, i)) == want)
            stride = next(strides, None)
            if stride is None:
                raise ValueError(
                    f"cannot create exactly {want} steps with an integer stride")
            return set(range(0, num_timesteps, stride))
        section_counts = [int(x) for x in section_counts.split(",")]

    n_sections = len(section_counts)
    base, extra = divmod(num_timesteps, n_sections)
    sizes = [base + (1 if i < extra else 0) for i in range(n_sections)]
    starts = [sum(sizes[:i]) for i in range(n_sections)]

    kept: set = set()
    for start, size, count in zip(starts, sizes, section_counts):
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        # `count` fractional positions evenly spanning [0, size-1], as a
        # left-to-right float ACCUMULATION (not j*stride): checkpoint
        # compatibility requires the same rounding the original produced.
        stride = 1.0 if count <= 1 else (size - 1) / (count - 1)
        positions = accumulate(chain([0.0], repeat(stride, count - 1)))
        kept.update(start + round(c) for c in positions)
    return kept


def karras_timesteps(alphas_cumprod, n: int, rho: float = 7.0) -> set:
    """Pick `n` original-process timesteps at Karras sigma positions
    (arXiv:2206.00364, eq. 5): sigma_i = (smax^(1/rho) + i/(n-1)
    (smin^(1/rho) - smax^(1/rho)))^rho, each snapped to the nearest
    timestep by VP sigma = sqrt((1 - abar) / abar), collisions nudged to the
    nearest free index so that exactly `n` remain. All in fp64 numpy, so the
    set equals the JAX package's."""
    abar = np.asarray(alphas_cumprod, np.float64)
    T = len(abar)
    if not 1 <= n <= T:
        raise ValueError(f"cannot pick {n} karras steps from {T}")
    sigmas = np.sqrt((1.0 - abar) / abar)  # increasing in t
    smin, smax = sigmas[0], sigmas[-1]
    inv = 1.0 / rho
    grid = (smax ** inv + np.linspace(0.0, 1.0, n) * (smin ** inv - smax ** inv)) ** rho
    pos = np.searchsorted(sigmas, grid)
    lo = np.clip(pos - 1, 0, T - 1)
    hi = np.clip(pos, 0, T - 1)
    ts = np.where(np.abs(sigmas[lo] - grid) <= np.abs(sigmas[hi] - grid), lo, hi)
    kept: set = set()
    for t in ts:  # the grid decreases: large t first; collisions move down
        t = int(t)
        while t in kept and t > 0:
            t -= 1
        while t in kept:  # collided at 0: walk up instead
            t += 1
        kept.add(t)
    assert len(kept) == n and max(kept) < T
    return kept
