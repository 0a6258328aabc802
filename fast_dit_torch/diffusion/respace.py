"""Timestep-respacing mini-DSL (the port's copy of
`fast_dit_tpu/diffusion/respace.py:space_timesteps`).

"250" strides 1000 steps down to 250, "ddimN" uses the fixed DDIM-paper
striding, and "10,15,20" splits the process into equal sections with
per-section counts. The respaced tables are built by
`DiffusionSchedule.create(use_timesteps=...)`.
"""

from __future__ import annotations

from itertools import accumulate, chain, repeat

__all__ = ["space_timesteps"]


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
