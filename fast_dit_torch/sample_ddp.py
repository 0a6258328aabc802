"""Sample many images for FID evaluation: the port's ADM-npz harness.

    python -m fast_dit_torch.sample_ddp --ckpt DiT-XL-2-256x256.pt --vae-ckpt VAE
    torchrun --nproc-per-node 4 -m fast_dit_torch.sample_ddp ...   # one card per rank

Counterpart of the repository's `sample_ddp.py`, with its flags and outputs:
per-process seed `global_seed * world + rank`, the total rounded up to a
multiple of the global batch, labels drawn uniformly in [0, num_classes),
CFG only when `--cfg-scale` > 1 (doubled batch, null label `num_classes`),
the chain of `--sampler` (DDPM, DDIM, DPM-Solver++, UniPC, or the flow ODE
for a flow checkpoint; `--time-spacing`, `--cfg-interval`, and the layer
cache `--cache-interval`/`--cache-schedule` for DDPM and DDIM) with
`clip_denoised=False`, as `sample.py` runs it, the SD-VAE decode at /0.18215,
uint8 quantisation `clamp(127.5 x + 128, 0, 255)`, rank-strided
`{index:06d}.png` files written on a thread pool, and after a barrier rank
0 packs the first `--num-fid-samples` PNGs into `{sample_dir}.npz` (one
(num, H, W, 3) uint8 array under `arr_0`), the evaluator's input.

World and rank come from `torch.distributed` when `RANK` and `WORLD_SIZE`
are set (the group joins at `MASTER_ADDR:MASTER_PORT`; gloo on the CPU,
NCCL on the cards, card `LOCAL_RANK`), else 1 and 0. Each process draws its
noise, labels and step noise from one `torch.Generator` seeded with its
seed, in that order, batch after batch. `--tf32` (on by default, as in the
reference) sets TF32 for both matmuls and convolutions. Without VAE weights
the first three latent channels are quantised instead, as `sample_ddp.py`
does. `--ckpt random` is the sampler's seeded init plus its 0.02
perturbation, the same weights on every rank.

`--tome-ratio`, `--tome-mlp`, `--quantize w8a8` and the `DiT-MoE-*` models
build the model as `sample` does (`sample.build_model`); `check_args`
refuses only what JAX refuses. Runs on the card unless `--device cpu` is
given.
"""

from __future__ import annotations

import argparse
import math
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from .models import DiT_models, decode_from_latents
from .ops.attention import BACKENDS
from .sample import (add_sampler_flags, build_diffusion, build_model, build_vae,
                     make_model_fn, run_chain)
from .sample import check_args as check_sampler_args
from .utils.device import resolve_device, tf32, world_and_rank
from .utils.image import decode_png, encode_png

__all__ = ["build_parser", "check_args", "quantize", "generate",
           "create_npz_from_sample_folder", "main"]


def check_args(args) -> None:
    """Raise SystemExit with JAX's message for flags that do not fit
    together."""
    check_sampler_args(args, prog="fast_dit_torch.sample_ddp")
    if args.cfg_scale < 1.0:
        raise SystemExit("fast_dit_torch.sample_ddp: --cfg-scale must be >= 1.0")


def quantize(x: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) floats -> (B, H, W, 3) uint8: clamp(127.5 x + 128, 0, 255),
    truncated."""
    return torch.clamp(127.5 * x + 128.0, 0, 255).to(torch.uint8).permute(0, 2, 3, 1)


@torch.inference_mode()
def generate(args, model, diffusion, vae, generator: torch.Generator) -> torch.Tensor:
    """One batch of `--per-proc-batch-size` uint8 (B, H, W, 3) images on the
    model's device: noise, labels, the chain, the decode, quantisation."""
    device = model.pos_embed.device
    n = args.per_proc_batch_size
    latent = args.image_size // 8
    z = torch.randn(n, model.in_channels, latent, latent, generator=generator, device=device)
    y = torch.randint(0, args.num_classes, (n,), generator=generator, device=device)
    if args.cfg_scale > 1.0:
        z = torch.cat([z, z], dim=0)
    model_fn = make_model_fn(args, model, diffusion, y)
    samples = run_chain(args, diffusion, model_fn, z, generator)[:n]
    samples = decode_from_latents(vae, samples) if vae is not None else samples[:, :3]
    return quantize(samples)


def _write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def create_npz_from_sample_folder(sample_dir: str, num: int) -> str:
    """Pack `{i:06d}.png`, i < num, into `{sample_dir}.npz`: one (num, H, W, 3)
    uint8 array under `arr_0`."""
    stack = None
    for i in range(num):
        with open(f"{sample_dir}/{i:06d}.png", "rb") as f:
            img = decode_png(f.read())
        if stack is None:
            stack = np.empty((num, *img.shape), np.uint8)
        stack[i] = img
    if stack.ndim != 4 or stack.shape[-1] != 3:
        raise ValueError(f"samples must be RGB images, got shape {stack.shape}")
    npz_path = f"{sample_dir}.npz"
    np.savez(npz_path, arr_0=stack)
    print(f"Saved .npz file to {npz_path} [shape={stack.shape}].")
    return npz_path


def main(args) -> dict:
    """Sample, write the PNGs and (rank 0) the npz; returns this process's
    {"sample_dir", "npz", "images", "seconds"} (seconds: the sampling loop
    with every PNG written)."""
    check_args(args)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"fast_dit_torch.sample_ddp: {e}") from None
    world, rank, device = world_and_rank(device)
    seed = args.global_seed * world + rank
    print(f"Starting rank={rank}, seed={seed}, world_size={world}.")

    with tf32(args.tf32):
        # one set of weights on every rank: the init seed is fixed
        model = build_model(args, device, seed=0)
        diffusion = build_diffusion(args, device)
        vae = build_vae(args, device, tuple(int(c) for c in args.vae_channels.split(",")))
        if vae is None:
            print("WARNING: no SD-VAE weights found; saving latent-preview PNGs "
                  "(set --vae-ckpt or SD_VAE_PATH for real images)")

        model_string_name = args.model.replace("/", "-")
        ckpt_string_name = (os.path.basename(args.ckpt).replace(".pt", "") if args.ckpt
                            else "pretrained")
        folder_name = (f"{model_string_name}-{ckpt_string_name}-size-{args.image_size}-"
                       f"vae-{args.vae}-cfg-{args.cfg_scale}-seed-{args.global_seed}")
        sample_folder_dir = f"{args.sample_dir}/{folder_name}"
        if rank == 0:
            os.makedirs(sample_folder_dir, exist_ok=True)
            print(f"Saving .png samples at {sample_folder_dir}")
        if world > 1:
            dist.barrier()

        n = args.per_proc_batch_size
        global_batch_size = n * world
        total_samples = int(math.ceil(args.num_fid_samples / global_batch_size)
                            * global_batch_size)
        if rank == 0:
            print(f"Total number of images that will be sampled: {total_samples}")
        iterations = total_samples // world // n
        generator = torch.Generator(device=device).manual_seed(seed)
        t0 = time.perf_counter()
        total = 0
        with ThreadPoolExecutor(max_workers=args.io_threads) as pool:
            futures = []
            for it in range(iterations):
                samples = generate(args, model, diffusion, vae, generator).cpu().numpy()
                for i, sample in enumerate(samples):
                    index = i * world + rank + total
                    futures.append(pool.submit(_write_png,
                                               f"{sample_folder_dir}/{index:06d}.png", sample))
                total += global_batch_size
                if rank == 0:
                    print(f"[rank 0] batch {it + 1}/{iterations}", flush=True)
            for f in futures:
                f.result()
        seconds = time.perf_counter() - t0

    if world > 1:
        dist.barrier()
    npz = None
    if rank == 0:
        npz = create_npz_from_sample_folder(sample_folder_dir, args.num_fid_samples)
        print("Done.")
    return {"sample_dir": sample_folder_dir, "npz": npz, "images": iterations * n,
            "seconds": seconds}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # reference-compatible flags
    parser.add_argument("--model", type=str, choices=list(DiT_models), default="DiT-XL/2")
    parser.add_argument("--vae", type=str, choices=["ema", "mse"], default="ema")
    parser.add_argument("--sample-dir", type=str, default="samples")
    parser.add_argument("--per-proc-batch-size", type=int, default=32)
    parser.add_argument("--num-fid-samples", type=int, default=50_000)
    parser.add_argument("--image-size", type=int, choices=[256, 512], default=256)
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--cfg-scale", type=float, default=1.5)
    parser.add_argument("--num-sampling-steps", type=int, default=250)
    parser.add_argument("--global-seed", type=int, default=0)
    parser.add_argument("--tf32", action=argparse.BooleanOptionalAction, default=True,
                        help="TF32 matmuls and convolutions on the card")
    parser.add_argument("--ckpt", type=str, default=None,
                        help="local reference .pt file, a trainer's checkpoints/ folder, or a "
                             "known name under pretrained_models/ (default "
                             "DiT-XL-2-{size}x{size}.pt; never downloaded), or 'random'")
    # the JAX harness's extensions
    parser.add_argument("--vae-ckpt", type=str, default=None,
                        help="local diffusers-format SD-VAE weights (file or directory)")
    parser.add_argument("--vae-channels", type=str, default="128,256,512,512",
                        help="AutoencoderKL block_out_channels (the SD default); narrow "
                             "configs serve drills with random VAE weights")
    parser.add_argument("--attn-backend", type=str, default="auto", choices=BACKENDS,
                        help="auto: the CUDA kernel on the card; einsum: the plain twin")
    parser.add_argument("--io-threads", type=int, default=16)
    parser.add_argument("--bf16", action="store_true", help="bf16 DiT activations")
    add_sampler_flags(parser)
    # the port's own
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
    if dist.is_initialized():
        dist.destroy_process_group()
