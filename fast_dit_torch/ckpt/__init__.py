"""Checkpoint layer: JAX param trees and local reference `.pt` files into the
port's DiT state dict, and local diffusers SD-VAE checkpoints (or JAX VAE
param trees) into the port's `AutoencoderKL`."""

from .convert import flax_params_to_state_dict, load_torch_checkpoint
from .vae_import import (flax_vae_to_state_dict, import_vae_checkpoint, load_vae,
                         load_vae_state_dict, normalize_vae_state_dict, read_safetensors,
                         resolve_vae_path, vae_widths)

__all__ = ["flax_params_to_state_dict", "load_torch_checkpoint", "flax_vae_to_state_dict",
           "import_vae_checkpoint", "load_vae", "load_vae_state_dict",
           "normalize_vae_state_dict", "read_safetensors", "resolve_vae_path", "vae_widths"]
