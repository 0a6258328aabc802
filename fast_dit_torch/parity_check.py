"""Replay a latent-parity bundle recorded from the reference sampler.

    CFG=$(python -c "import json; print(json.dumps(json.load(open(
        'tests/fixtures/ref_bundle_ddpm_T10.json'))['model_config']))")
    python -m fast_dit_torch.parity_check --bundle tests/fixtures/ref_bundle_ddpm_T10.npz \
        --ckpt tests/fixtures/ref_bundle_model.pt --model-config "$CFG" --sampler ddpm \
        --atol 2e-4 --diffusion-steps 10 --noise-schedule squaredcos_cap_v2 --clip-denoised \
        [--device cpu]

Counterpart of `tools/parity_check.py`. A bundle is an npz with `x_T`
(the initial noise, (B, 4, h, w)), `step_noise` ((T, B, 4, h, w), the
per-step Gaussian draws in loop order t = T-1 .. 0), `y` (labels) and
`expected` (the reference's final latents). The DiT is loaded from a
reference-layout `.pt` (`ckpt.find_model`, which reads it with
`ckpt.convert.load_torch_checkpoint`), built from `--model-config` (JSON
DiT kwargs; JAX's `attn_backend` name is dropped: the port takes kernel 1
on the card and the plain attention on the CPU) or from `--model`, and the
recorded noise is replayed through the port's `p_sample_loop` or
`ddim_sample_loop` in fp32 with TF32 off. torch and JAX generators cannot
be matched from seeds, so the noise is injected (`noise=`, `step_noise=`).
Prints `latent parity: max|Δ|=...`, then `PARITY OK` (exit 0) when max|Δ| <=
atol + rtol * max|expected|, else `PARITY FAILED` (exit 1). Runs on the card
unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .ckpt import find_model
from .diffusion import create_diffusion
from .models import DiT, DiT_models
from .utils.device import resolve_device, tf32

__all__ = ["build_parser", "replay", "main"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bundle", required=True, help="npz with x_T, step_noise, y, expected")
    ap.add_argument("--ckpt", required=True, help=".pt checkpoint path or pretrained name")
    ap.add_argument("--model", default="DiT-XL/2", choices=list(DiT_models))
    ap.add_argument("--image-size", type=int, default=256)
    ap.add_argument("--cfg-scale", type=float, default=0.0,
                    help="0 disables CFG; >1 uses forward_with_cfg (the bundle's x_T and y "
                         "must then be the doubled batch)")
    ap.add_argument("--sampler", default="ddpm", choices=["ddpm", "ddim"])
    ap.add_argument("--atol", type=float, default=1e-4)
    ap.add_argument("--rtol", type=float, default=0.0,
                    help="additional relative tolerance: pass if max|Δ| <= atol + rtol * "
                         "max|expected|")
    ap.add_argument("--model-config", default=None,
                    help="JSON kwargs of a custom DiT config (overrides --model)")
    ap.add_argument("--diffusion-steps", type=int, default=1000,
                    help="original process length (respaced down to the bundle's step count)")
    ap.add_argument("--noise-schedule", default="linear",
                    choices=["linear", "squaredcos_cap_v2"])
    ap.add_argument("--clip-denoised", action="store_true",
                    help="clip x0 predictions to [-1, 1] (the reference's latent sampling "
                         "uses clip_denoised=False)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def _model(args, device) -> DiT:
    if args.model_config:
        kw = json.loads(args.model_config)
        kw.pop("attn_backend", None)  # JAX's backend names; the port picks by device
        return DiT(**kw, device=device)
    return DiT_models[args.model](input_size=args.image_size // 8, device=device)


def replay(args) -> dict:
    """The bundle's chain through the port: {"max_abs", "mean_abs",
    "bound", "ok", "latents"} (latents on the device)."""
    device = resolve_device(args.device)
    bundle = np.load(args.bundle)
    x_T = torch.from_numpy(bundle["x_T"]).to(device)
    step_noise = torch.from_numpy(bundle["step_noise"]).to(device)
    y = torch.from_numpy(bundle["y"]).to(device)
    expected = np.asarray(bundle["expected"], np.float64)
    T = step_noise.shape[0]
    with tf32(False), torch.inference_mode():
        model = _model(args, device)
        model.load_state_dict(find_model(args.ckpt), strict=True)
        model.eval()
        diffusion = create_diffusion(str(T) if args.sampler == "ddpm" else f"ddim{T}",
                                     diffusion_steps=args.diffusion_steps,
                                     noise_schedule=args.noise_schedule, device=device)
        if args.cfg_scale > 1.0:
            model_fn = lambda x, t: model.forward_with_cfg(x, t, y, args.cfg_scale)
        else:
            model_fn = lambda x, t: model(x, t, y)
        loop = diffusion.p_sample_loop if args.sampler == "ddpm" else diffusion.ddim_sample_loop
        got = loop(model_fn, tuple(x_T.shape), noise=x_T, step_noise=step_noise,
                   clip_denoised=args.clip_denoised)
    diff = np.abs(got.double().cpu().numpy() - expected)
    bound = args.atol + args.rtol * np.abs(expected).max()
    return {"max_abs": float(diff.max()), "mean_abs": float(diff.mean()), "bound": float(bound),
            "ok": bool(diff.max() <= bound), "latents": got}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"fast_dit_torch.parity_check: {e}") from None
    res = replay(args)
    print(f"latent parity: max|Δ|={res['max_abs']:.3e} mean|Δ|={res['mean_abs']:.3e} "
          f"(bound {res['bound']:.3e})")
    print("PARITY OK" if res["ok"] else "PARITY FAILED")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
