"""Checkpoint layer: JAX param trees and local reference `.pt` files into the
port's DiT state dict (`find_model` resolves a `--ckpt` name), local
diffusers SD-VAE checkpoints (or JAX VAE param trees) into the port's
`AutoencoderKL`, and the trainer's own checkpoints (`CheckpointManager`)."""

from .checkpoint import CheckpointManager
from .download import find_model, pretrained_models, resolve_model_path
from .convert import JaxLeaf, flax_params_to_state_dict, jax_leaves, load_torch_checkpoint
from .vae_import import (flax_vae_to_state_dict, import_vae_checkpoint, load_vae,
                         load_vae_state_dict, normalize_vae_state_dict, read_safetensors,
                         resolve_vae_path, vae_widths)

__all__ = ["CheckpointManager", "find_model", "pretrained_models", "resolve_model_path",
           "JaxLeaf", "jax_leaves", "flax_params_to_state_dict",
           "load_torch_checkpoint", "flax_vae_to_state_dict",
           "import_vae_checkpoint", "load_vae", "load_vae_state_dict",
           "normalize_vae_state_dict", "read_safetensors", "resolve_vae_path", "vae_widths"]
