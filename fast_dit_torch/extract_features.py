"""Encode an ImageNet-style folder into SD-VAE latent features: the port's
dataset-prep CLI.

    python -m fast_dit_torch.extract_features --data-path IMAGES --features-path features \\
        --vae-ckpt VAE

Counterpart of the repository's `extract_features.py`, with its flags and
outputs: the ADM centre crop, a horizontal flip with probability 1/2 drawn
per image from `np.random.default_rng(global_seed * 1_000_003 + index)` (so
the port flips exactly the images the JAX CLI flips), [-1, 1] inputs, a
batched encode, one sample of the latent distribution x 0.18215, and one
`{index}.npy` feature of shape (1, 4, h, w) and one label per image under
`{features_path}/imagenet{size}_features` and `_labels`, files named by the
global dataset index. Each process takes every world-th index from its
rank; world and rank come from `torch.distributed` when `RANK` and
`WORLD_SIZE` are set, else 1 and 0, and the process seed is
`global_seed * world + rank`. The latent draws come from one
`torch.Generator` seeded with it, batch after batch (JAX folds its key per
batch instead). The VAE takes the widths its checkpoint holds. The encode
is fp32 with TF32 off, as the JAX VAE computes.
Runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .ckpt import load_vae, resolve_vae_path
from .data import ImageFolderIndex, load_image
from .models import encode_to_latents
from .utils.device import resolve_device, tf32, world_and_rank

__all__ = ["encode_images", "write_features", "feature_dirs", "main", "build_parser"]


@torch.inference_mode()
def encode_images(vae, x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """(B, 3, H, W) images in [-1, 1] -> (B, 4, H/8, W/8) scaled latents,
    with TF32 off whatever the caller's setting, as the JAX VAE computes."""
    with tf32(False):
        return encode_to_latents(vae, x.to(next(vae.parameters()).device), generator)


def feature_dirs(features_path: str, image_size: int):
    return (os.path.join(features_path, f"imagenet{image_size}_features"),
            os.path.join(features_path, f"imagenet{image_size}_labels"))


def write_features(feat_dir: str, label_dir: str, indices, z, labels) -> None:
    """One `{index}.npy` feature (1, 4, h, w) and one label (1,) per image."""
    z = np.asarray(z.cpu() if isinstance(z, torch.Tensor) else z, np.float32)
    for j, gi in enumerate(indices):
        np.save(os.path.join(feat_dir, f"{gi}.npy"), z[j: j + 1])
        np.save(os.path.join(label_dir, f"{gi}.npy"), np.array([labels[j]]))


def main(args) -> None:
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"fast_dit_torch.extract_features: {e}") from None
    world, rank, device = world_and_rank(device)
    seed = args.global_seed * world + rank
    print(f"Starting rank={rank}, seed={seed}, world_size={world}.")

    feat_dir, label_dir = feature_dirs(args.features_path, args.image_size)
    os.makedirs(feat_dir, exist_ok=True)
    os.makedirs(label_dir, exist_ok=True)
    vae_path = resolve_vae_path(args.vae_ckpt, args.vae)
    if not os.path.exists(vae_path):
        raise FileNotFoundError(
            f"SD-VAE weights not found at {vae_path}; pass --vae-ckpt or set "
            "SD_VAE_PATH to a local diffusers-format checkpoint "
            "(the port never downloads weights).")
    dataset = ImageFolderIndex(args.data_path)
    print(f"Dataset contains {len(dataset):,} images ({args.data_path})")

    vae = load_vae(vae_path, device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    B = args.batch_size
    my_indices = list(range(rank, len(dataset), world))  # global-index stride
    for s in range(0, len(my_indices), B):
        chunk = my_indices[s: s + B]
        imgs, labels = [], []
        for gi in chunk:
            path, label = dataset[gi]
            img_rng = np.random.default_rng(args.global_seed * 1_000_003 + gi)
            imgs.append(load_image(path, args.image_size, hflip=True, rng=img_rng))
            labels.append(label)
        z = encode_images(vae, torch.from_numpy(np.stack(imgs)), generator)
        write_features(feat_dir, label_dir, chunk, z, labels)
        if rank == 0 and (s // B) % args.log_every == 0:
            print(f"[rank 0] encoded {s + len(chunk)}/{len(my_indices)}")
    print(f"rank {rank} done.")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # reference-compatible flags
    parser.add_argument("--data-path", type=str, required=True)
    parser.add_argument("--features-path", type=str, default="features")
    parser.add_argument("--results-dir", type=str, default="results")
    parser.add_argument("--model", type=str, default="DiT-XL/2")
    parser.add_argument("--image-size", type=int, choices=[256, 512], default=256)
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--epochs", type=int, default=1400)
    parser.add_argument("--global-batch-size", type=int, default=256)
    parser.add_argument("--global-seed", type=int, default=0)
    parser.add_argument("--vae", type=str, choices=["ema", "mse"], default="ema")
    parser.add_argument("--num-workers", type=int, default=4)
    parser.add_argument("--log-every", type=int, default=100)
    parser.add_argument("--ckpt-every", type=int, default=50_000)
    # the JAX CLI's extensions
    parser.add_argument("--vae-ckpt", type=str, default=None,
                        help="local diffusers-format SD-VAE weights (file or directory)")
    parser.add_argument("--batch-size", type=int, default=32,
                        help="per-process VAE encode batch (the reference used 1)")
    # the port's own
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
