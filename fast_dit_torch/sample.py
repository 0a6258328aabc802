"""Sample images from a DiT: the port's single-device sampler CLI.

    python -m fast_dit_torch.sample --model DiT-XL/2 --ckpt random --bf16 --vae-ckpt VAE
    python -m fast_dit_torch.sample --ckpt random --sampler dpm --num-sampling-steps 20

Counterpart of the repository's `sample.py`, with its flags: fixed seed,
registry model, `create_diffusion(str(steps))` (or "karrasN" with
`--time-spacing karras`), the CFG doubled batch ([z; z] with labels [y;
null]) over `forward_with_cfg`, `clip_denoised=False`, then the conditional
half is kept, decoded by the SD-VAE at /0.18215 and saved as a 2 x 4 grid,
`sample.png`, in the working directory. `--sampler` picks DDPM, DDIM,
DPM-Solver++(2M) (`dpm`), UniPC (`unipc`), or, for a flow-matching
checkpoint (built with `learn_sigma=False`, CFG over all channels), the
Euler or Heun flow ODE. `--cfg-interval LO HI` guides only the steps whose
noise level lies in [LO, HI] and runs the conditional half alone elsewhere.
`--cache-interval K` (> 1, DDPM and DDIM) runs the FORA layer cache: a full
model call on ceil(steps / K) refresh steps placed by `--cache-schedule`
(uniform, logsnr or abar), cached calls that skip attention and the MLP in
between; with `--cfg-interval` one doubled-batch cache serves both halves
and every band entry refreshes.
The VAE weights are local diffusers files: `--vae-ckpt`, else
`SD_VAE_PATH`, else `pretrained_models/sd-vae-ft-{--vae}`. Without them the
latents go to `sample.npy` and a latent preview to `sample.png`, as
`sample.py` does. The decode is fp32 with TF32 off, as the JAX VAE
computes.

Weights (`ckpt.download.find_model`, the EMA where there is one): a local
reference-format `.pt` (`--ckpt PATH`); a trainer's `checkpoints/` folder
(`--ckpt DIR`: its latest step); the two known names, the default
`DiT-XL-2-{size}x{size}.pt` among them, under `pretrained_models/`; or
`--ckpt random`: the seeded init plus a 0.02 N(0, 1) perturbation of every
parameter, since the zero-initialised heads would otherwise make every
output zero. Nothing is ever downloaded.

`--tome-ratio R` merges that fraction of the tokens inside every block's
attention (`ops/tome.py`; `--tome-mlp` also its MLP), `--quantize w8a8`
runs the block projections as int8 products (`ops/quant.py`), and a
`DiT-MoE-*` model routes each token to 2 of 8 expert MLPs; each composes
with every sampler and the layer cache, as in JAX. `check_args` refuses
only what JAX refuses, with JAX's messages. Runs on the card unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import functools
import os
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .ckpt import find_model, load_vae, resolve_vae_path
from .diffusion import (create_diffusion, flow_sample_loop, guidance_interval_cached_fns,
                        guidance_interval_fn)
from .models import DiT_models, decode_from_latents
from .ops.attention import BACKENDS
from .utils.device import resolve_device, tf32
from .utils.image import save_image

# the reference demo's labels
CLASS_LABELS = [207, 360, 387, 974, 88, 979, 417, 279]
# samplers of a flow-matching checkpoint; the others run the DDPM process
FLOW_SAMPLERS = ("euler", "heun")


def check_args(args, prog: str = "fast_dit_torch.sample") -> None:
    """Raise SystemExit with JAX's message for flags that contradict each
    other."""
    if args.quantize and DiT_models[args.model].keywords.get("moe_experts", 0):
        raise SystemExit(f"{prog}: int8 quant + MoE is untested")
    if args.cache_interval > 1 and args.sampler in FLOW_SAMPLERS:
        raise SystemExit(f"{prog}: --sampler euler/heun integrate the flow ODE "
                         f"(diffusion/flow.py); the layer cache and the DDPM sigma band are "
                         f"discrete-chain features")
    if args.cache_interval > 1 and args.sampler in ("dpm", "unipc"):
        raise SystemExit(f"{prog}: --cache-interval composes with ddpm/ddim; dpm/unipc are "
                         f"already the honest-compute fast path (use fewer steps instead)")
    if args.cfg_interval is not None and args.sampler in FLOW_SAMPLERS:
        raise SystemExit(f"{prog}: --cfg-interval is a band of the DDPM noise levels; "
                         f"--sampler {args.sampler} integrates the flow ODE")
    if args.cfg_interval is not None and args.cfg_scale <= 1.0:
        raise SystemExit(f"{prog}: --cfg-interval needs --cfg-scale > 1")


def perturb_(model: torch.nn.Module, seed: int = 1, std: float = 0.02) -> None:
    """Add std * N(0, 1) to every trainable parameter (pos_embed is frozen
    and stays), drawn from a CPU generator so every device sees the same
    weights."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            if p.requires_grad:
                p.add_(std * torch.randn(p.shape, generator=g).to(p.device))


def load_dit(ctor, sd, device):
    """`ctor(device=...)`'s model with the state dict `sd` loaded strictly,
    in eval mode: built on the meta device and filled from `sd`, so the
    init of weights that the file replaces is never computed (at DiT-XL/2
    it takes seconds on the host)."""
    with torch.device("meta"):
        model = ctor(device="meta")
    model = model.to_empty(device=device)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def build_model(args, device, seed):
    """The DiT of `args` (--model, --image-size, --num-classes, --bf16,
    --attn-backend, --quantize, --tome-ratio, --tome-mlp, --ckpt; a flow
    --sampler means no learned-sigma channels) on `device`, in eval mode,
    weights loaded through `find_model`; `--ckpt random` is the init from
    `seed` plus `perturb_`."""
    ctor = functools.partial(
        DiT_models[args.model], input_size=args.image_size // 8, num_classes=args.num_classes,
        learn_sigma=args.sampler not in FLOW_SAMPLERS,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        attn_backend=args.attn_backend, quant=args.quantize, tome_ratio=args.tome_ratio,
        tome_mlp=args.tome_mlp, seed=seed)
    if args.ckpt != "random":
        name = args.ckpt or f"DiT-XL-2-{args.image_size}x{args.image_size}.pt"
        return load_dit(ctor, find_model(name), device)
    model = ctor(device=device)
    perturb_(model)
    return model.eval()


def build_diffusion(args, device):
    """The respaced sampling process of --num-sampling-steps and
    --time-spacing."""
    spacing = "karras" if args.time_spacing == "karras" else ""
    return create_diffusion(f"{spacing}{args.num_sampling_steps}", device=device)


def build(args):
    """(model, diffusion) on `args.device`, weights loaded."""
    device = resolve_device(args.device)
    return build_model(args, device, args.seed), build_diffusion(args, device)


def build_vae(args, device, block_out_channels=None):
    """The fp32 SD-VAE on `device` from the local weights (at the widths
    they hold, or at `block_out_channels`), or None when there are none."""
    path = resolve_vae_path(args.vae_ckpt, args.vae)
    if not os.path.exists(path):
        return None
    return load_vae(path, block_out_channels, device=device)


@torch.inference_mode()
def decode(vae, latents: torch.Tensor) -> torch.Tensor:
    """Scaled latents -> fp32 images in about [-1, 1]: decode(z / 0.18215),
    with TF32 off whatever the caller's setting, as the JAX VAE computes."""
    with tf32(False):
        return decode_from_latents(vae, latents.to(next(vae.parameters()).device))


class CachedModelFns(NamedTuple):
    """The model of a layer-cached chain: a full call that returns the
    cache, a cached call that replays it, and the steps that must refresh
    besides the schedule's (the guidance interval's band entries), or None."""

    full: Callable
    cached: Callable
    forced: Optional[object]


def make_model_fn(args, model, diffusion, y: torch.Tensor):
    """model_fn(x, t) of the chain for the conditional labels y (n,): at
    --cfg-scale <= 1 the model itself on n latents; else `forward_with_cfg`
    on the doubled batch with labels [y; null] (a flow model guides all its
    channels), and with --cfg-interval only inside the band, the
    conditional half alone elsewhere. With --cache-interval > 1, the
    `CachedModelFns` of the same model."""
    cond_fn = lambda x, t, **kw: model(x, t, y, **kw)
    if args.cfg_scale <= 1.0:
        apply = cond_fn
    else:
        yy = torch.cat([y, torch.full_like(y, args.num_classes)])
        gkw = {"guidance_channels": model.in_channels} if args.sampler in FLOW_SAMPLERS else {}
        apply = lambda x, t, **kw: model.forward_with_cfg(x, t, yy, args.cfg_scale, **gkw, **kw)
    if args.cache_interval > 1:
        if args.cfg_interval is not None:
            return CachedModelFns(*guidance_interval_cached_fns(
                apply, cond_fn, diffusion.schedule, *args.cfg_interval))
        return CachedModelFns(lambda x, t: apply(x, t, want_cache=True),
                              lambda x, t, cache: apply(x, t, cache=cache), None)
    if args.cfg_interval is None:
        return apply
    return guidance_interval_fn(apply, cond_fn, diffusion.schedule, *args.cfg_interval)


def run_chain(args, diffusion, model_fn, z: torch.Tensor, generator: torch.Generator):
    """--sampler's chain from x_T = z; DDPM and DDIM draw their step noise
    from `generator`, the others are deterministic. A `CachedModelFns`
    runs the layer-cached DDPM or DDIM loop."""
    if isinstance(model_fn, CachedModelFns):
        loop = (diffusion.p_sample_loop_cached if args.sampler == "ddpm"
                else diffusion.ddim_sample_loop_cached)
        return loop(model_fn.full, model_fn.cached, z.shape, interval=args.cache_interval,
                    refresh_schedule=args.cache_schedule, force_refresh_mask=model_fn.forced,
                    noise=z, generator=generator, clip_denoised=False)
    if args.sampler in FLOW_SAMPLERS:
        return flow_sample_loop(model_fn, z.shape, num_steps=args.num_sampling_steps,
                                method=args.sampler, noise=z)
    if args.sampler == "dpm":
        return diffusion.dpm_solver_sample_loop(model_fn, z.shape, noise=z,
                                                clip_denoised=False)
    if args.sampler == "unipc":
        return diffusion.unipc_sample_loop(model_fn, z.shape, noise=z, clip_denoised=False)
    loop = diffusion.p_sample_loop if args.sampler == "ddpm" else diffusion.ddim_sample_loop
    return loop(model_fn, z.shape, noise=z, generator=generator, clip_denoised=False)


def sampling_inputs(args, model):
    """(z, y, generator): x_T of the chain (doubled under CFG), the
    conditional labels and the generator seeded with --seed that drew z."""
    device = model.pos_embed.device
    g = torch.Generator(device=device).manual_seed(args.seed)
    n = len(CLASS_LABELS)
    latent = args.image_size // 8
    z = torch.randn(n, model.in_channels, latent, latent, generator=g, device=device)
    if args.cfg_scale > 1.0:
        z = torch.cat([z, z], dim=0)
    return z, torch.tensor(CLASS_LABELS, device=device), g


@torch.inference_mode()
def sample_latents(args, model, diffusion) -> torch.Tensor:
    """The sampling chain: (len(CLASS_LABELS), C, L, L) fp32 latents on the
    model's device."""
    z, y, g = sampling_inputs(args, model)
    model_fn = make_model_fn(args, model, diffusion, y)
    return run_chain(args, diffusion, model_fn, z, g)[:len(CLASS_LABELS)]


def main(args) -> None:
    check_args(args)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"fast_dit_torch.sample: {e}") from None
    with tf32(False):
        model, diffusion = build(args)
        vae = build_vae(args, model.pos_embed.device)
        latents = sample_latents(args, model, diffusion)
        images = None if vae is None else decode(vae, latents).cpu().numpy()
    if images is not None:
        save_image(images, "sample.png", nrow=4, value_range=(-1, 1))
        print("Saved sample.png")
        return
    out = latents.cpu().numpy()
    np.save("sample.npy", out)
    save_image(out[:, :3], "sample.png", nrow=4,
               value_range=(float(out.min()), float(out.max())))
    print("No VAE weights found (set --vae-ckpt or SD_VAE_PATH); "
          "saved raw latents to sample.npy and a latent preview to sample.png")


def add_sampler_flags(parser) -> None:
    """The JAX samplers' flags, shared with `sample_ddp`."""
    parser.add_argument("--sampler", type=str, default="ddpm",
                        choices=["ddpm", "ddim", "dpm", "unipc", *FLOW_SAMPLERS],
                        help="dpm: DPM-Solver++(2M), unipc: UniPC (both deterministic, for "
                             "10-25 steps); euler/heun: the flow ODE of an --objective flow "
                             "checkpoint")
    parser.add_argument("--time-spacing", type=str, default="uniform",
                        choices=["uniform", "karras"],
                        help="karras: the retained timesteps at Karras sigma positions")
    parser.add_argument("--cfg-interval", type=float, nargs=2, default=None,
                        metavar=("SIGMA_LO", "SIGMA_HI"),
                        help="guide only where sigma(t) = sqrt((1-abar)/abar) is in "
                             "[LO, HI]; elsewhere the conditional half alone")
    parser.add_argument("--cache-interval", type=int, default=1,
                        help="FORA layer caching (ddpm/ddim): a full model call every K-th "
                             "step, cached adaLN-only calls between; 1 is off")
    parser.add_argument("--cache-schedule", type=str, default="uniform",
                        choices=["uniform", "logsnr", "abar"],
                        help="placement of the cache refreshes, same budget: every K-th step, "
                             "equal log-SNR or equal alpha_bar spacing (no effect at "
                             "--cache-interval 1)")
    parser.add_argument("--tome-ratio", type=float, default=0.0,
                        help="token merging: the fraction of tokens merged inside every "
                             "block's attention (0 = off, exact; at most 0.75)")
    parser.add_argument("--tome-mlp", action="store_true",
                        help="token-merge the MLP branch too")
    parser.add_argument("--quantize", type=str, default=None, choices=["w8a8"],
                        help="int8 W8A8 block projections (qkv, proj, fc1, fc2)")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # reference-compatible flags
    parser.add_argument("--model", type=str, choices=list(DiT_models), default="DiT-XL/2")
    parser.add_argument("--vae", type=str, choices=["ema", "mse"], default="mse",
                        help="SD-VAE variant: names pretrained_models/sd-vae-ft-{vae}")
    parser.add_argument("--image-size", type=int, choices=[256, 512], default=256)
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--cfg-scale", type=float, default=4.0)
    parser.add_argument("--num-sampling-steps", type=int, default=250)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--ckpt", type=str, default=None,
                        help="local reference .pt file, a trainer's checkpoints/ folder, a "
                             "known name under pretrained_models/ (never downloaded), or "
                             "'random'")
    parser.add_argument("--vae-ckpt", type=str, default=None,
                        help="local diffusers-format SD-VAE weights (file or directory)")
    # the port's own
    parser.add_argument("--attn-backend", type=str, default="auto", choices=BACKENDS,
                        help="auto: the CUDA kernel on the card; einsum: the plain twin")
    parser.add_argument("--bf16", action="store_true", help="bf16 activations")
    add_sampler_flags(parser)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
