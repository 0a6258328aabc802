"""Carry SD-VAE weights into the port's `AutoencoderKL` (counterpart of
`fast_dit_tpu/ckpt/vae_import.py`).

- `load_vae_state_dict` reads a local diffusers checkpoint: a directory
  holding `diffusion_pytorch_model.{safetensors,bin}`, a `.bin` (through
  `torch.load`) or a `.safetensors` file, read by the port's own small
  reader (an 8-byte little-endian header length, a JSON header, raw
  tensors), so no `safetensors` package is needed. Nothing is downloaded.
- `normalize_vae_state_dict` maps the legacy attention names
  (query/key/value/proj_attn) onto to_q/to_k/to_v/to_out.0 and squeezes
  4-D 1x1-conv attention weights, as the JAX importer does.
- `import_vae_checkpoint` loads strictly, raising with the missing, extra
  and mis-shaped names; `load_vae` builds the model, at the widths the
  checkpoint holds unless the caller names them, and loads it.
- `flax_vae_to_state_dict` turns a JAX VAE param tree (numpy) into the
  port's state dict: the inverse of the JAX `vae_state_dict_to_flax`.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.vae import AutoencoderKL

__all__ = ["resolve_vae_path", "load_vae_state_dict", "read_safetensors", "normalize_vae_state_dict",
           "import_vae_checkpoint", "load_vae", "vae_widths", "flax_vae_to_state_dict"]

_SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A `.safetensors` file -> {name: CPU tensor} in the stored dtypes."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {info['dtype']}, which the "
                             f"reader does not take")
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        count = (end - begin) // torch.empty((), dtype=dtype).element_size()
        flat = torch.frombuffer(data, dtype=dtype, count=count, offset=begin)
        out[name] = flat.clone().reshape(info["shape"])
    return out


def resolve_vae_path(vae_ckpt: Optional[str], variant: str) -> str:
    """Where the CLIs look for SD-VAE weights: `--vae-ckpt`, else the
    SD_VAE_PATH environment variable, else pretrained_models/sd-vae-ft-{variant}."""
    return vae_ckpt or os.environ.get("SD_VAE_PATH") or f"pretrained_models/sd-vae-ft-{variant}"


def load_vae_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A diffusers VAE checkpoint file (or directory) -> {name: CPU tensor}."""
    if os.path.isdir(path):
        for fname in ("diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin"):
            cand = os.path.join(path, fname)
            if os.path.isfile(cand):
                path = cand
                break
        else:
            raise FileNotFoundError(f"no VAE weights found under {path}")
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    # the caller's own local file; old checkpoints pickle more than tensors
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: torch.as_tensor(v).detach().cpu() for k, v in sd.items()}


_ATTN = re.compile(r"^(.*\.mid_block\.attentions\.0\.)(query|key|value|proj_attn|to_q|to_k|"
                   r"to_v|to_out\.0)\.(weight|bias)$")
_ATTN_ALIASES = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}


def normalize_vae_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Legacy attention names -> to_q/to_k/to_v/to_out.0, 4-D attention
    projections -> 2-D, every tensor fp32."""
    out = {}
    for name, t in sd.items():
        m = _ATTN.match(name)
        if m:
            prefix, mod, leaf = m.groups()
            name = f"{prefix}{_ATTN_ALIASES.get(mod, mod)}.{leaf}"
            if leaf == "weight" and t.ndim == 4:  # legacy 1x1-conv projections
                t = t[:, :, 0, 0]
        out[name] = t.to(torch.float32).contiguous()
    return out


def import_vae_checkpoint(path: str, vae: AutoencoderKL = None) -> Dict[str, torch.Tensor]:
    """Load + normalise a checkpoint; with `vae`, check its names and shapes
    against the model and load it strictly (ValueError on a mismatch)."""
    sd = normalize_vae_state_dict(load_vae_state_dict(path))
    if vae is not None:
        _load_strict(vae, sd)
    return sd


def _load_strict(vae: AutoencoderKL, sd: Dict[str, torch.Tensor]) -> None:
    ref = {k: tuple(v.shape) for k, v in vae.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in sd.items()}
    if ref != got:
        missing = sorted(set(ref) - set(got))
        extra = sorted(set(got) - set(ref))
        bad = {k: (ref[k], got[k]) for k in sorted(set(ref) & set(got)) if ref[k] != got[k]}
        raise ValueError(f"VAE checkpoint mismatch: missing={missing} extra={extra} shapes={bad}")
    vae.load_state_dict(sd, strict=True)


def vae_widths(sd: Dict[str, torch.Tensor]) -> Tuple[Tuple[int, ...], int]:
    """(block_out_channels, latent_channels) of a normalised state dict: the
    output widths of each encoder stage's first resnet, and the latent
    channels of `post_quant_conv`."""
    stages = sorted({int(m.group(1)) for m in map(re.compile(
        r"^encoder\.down_blocks\.(\d+)\.").match, sd) if m})
    if not stages or "post_quant_conv.weight" not in sd:
        raise ValueError("not an AutoencoderKL state dict: no encoder stages or "
                         "post_quant_conv")
    return (tuple(sd[f"encoder.down_blocks.{i}.resnets.0.conv1.weight"].shape[0]
                  for i in stages), sd["post_quant_conv.weight"].shape[0])


def load_vae(path: str, block_out_channels: Optional[Sequence[int]] = None, device="cuda",
             dtype=torch.float32) -> AutoencoderKL:
    """An `AutoencoderKL` on `device`, in eval mode, with the weights at
    `path` loaded strictly; its widths are the checkpoint's unless
    `block_out_channels` names them (and then must match)."""
    sd = normalize_vae_state_dict(load_vae_state_dict(path))
    channels, latent = vae_widths(sd)
    vae = AutoencoderKL(block_out_channels or channels, latent, dtype=dtype, device=device)
    _load_strict(vae, sd)
    return vae.eval()


def _flax_module_to_torch(path: str) -> str:
    """`encoder/down_0_resnet_1/norm1` -> `encoder.down_blocks.0.resnets.1.norm1`."""
    for pattern, repl in (
            (r"(down|up)_(\d+)_resnet_(\d+)", r"\1_blocks.\2.resnets.\3"),
            (r"down_(\d+)_downsample", r"down_blocks.\1.downsamplers.0"),
            (r"up_(\d+)_upsample", r"up_blocks.\1.upsamplers.0"),
            (r"mid_resnet_(\d+)", r"mid_block.resnets.\1"),
            (r"mid_attn/to_out$", r"mid_block.attentions.0.to_out.0"),
            (r"mid_attn", r"mid_block.attentions.0")):
        path = re.sub(pattern, repl, path)
    return path.replace("/", ".")


def flax_vae_to_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """JAX VAE param tree (numpy leaves, with or without the "params" level)
    -> the port's fp32 state dict: conv kernels (kh, kw, I, O) -> (O, I, kh,
    kw), Dense kernels transposed, GroupNorm scale -> weight."""
    p = params["params"] if "params" in params else params
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{path}/{k}" if path else k)
                continue
            a = np.asarray(v, np.float32)
            if k == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            name = f"{_flax_module_to_torch(path)}.{'bias' if k == 'bias' else 'weight'}"
            out[name] = torch.from_numpy(np.array(a, order="C"))

    walk(p, "")
    return out
