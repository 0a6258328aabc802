"""Checkpoint layer: JAX param trees and local reference `.pt` files into the
port's state dict."""

from .convert import flax_params_to_state_dict, load_torch_checkpoint

__all__ = ["flax_params_to_state_dict", "load_torch_checkpoint"]
