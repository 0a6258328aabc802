"""Where a `--ckpt` name points (the port's copy of the name resolution of
`fast_dit_tpu/ckpt/download.py:24-53` and of `sample.py:46-52`).

- The two known pretrained names, `DiT-XL-2-256x256.pt` and
  `DiT-XL-2-512x512.pt`, are files under `pretrained_models/`. JAX
  downloads a missing one; the port never does and raises with JAX's
  advice instead: put the file there.
- A directory is a trainer's `checkpoints/` folder (`CheckpointManager`):
  its latest `{step:07d}.pt`, never an `-ema.pt` export.
- Anything else is a local file, used as given.

`find_model` returns the flat state dict, the EMA where the file holds one
(else "model"), as JAX's `find_model` and its directory branch prefer.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from .checkpoint import CheckpointManager
from .convert import load_torch_checkpoint

__all__ = ["pretrained_models", "resolve_model_path", "find_model"]

pretrained_models = {"DiT-XL-2-512x512.pt", "DiT-XL-2-256x256.pt"}


def resolve_model_path(name: str, cache_dir: str = "pretrained_models") -> str:
    """The local file `name` stands for (see the module docstring)."""
    if name in pretrained_models:
        path = os.path.join(cache_dir, name)
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"{name} is not at {path}; the port never downloads. "
                f"Place the file manually at {path}.")
        return path
    if os.path.isdir(name):
        manager = CheckpointManager(name)
        step = manager.latest_step()
        if step is None:
            raise FileNotFoundError(f"no trainer checkpoint ({{step:07d}}.pt) in {name}")
        return manager.path(step)
    if not os.path.isfile(name):
        raise FileNotFoundError(
            f"could not find DiT checkpoint at {name!r}: the port loads local files only "
            f"and never downloads; pass --ckpt PATH or --ckpt random")
    return name


def find_model(name: str, cache_dir: str = "pretrained_models") -> Dict[str, torch.Tensor]:
    """Name, directory or path -> {name: CPU tensor}, preferring the EMA."""
    return load_torch_checkpoint(resolve_model_path(name, cache_dir), prefer_ema=True)
