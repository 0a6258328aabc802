"""One-command validation of pretrained DiT and SD-VAE weights on the port.

    python -m fast_dit_torch.validate_pretrained --dit DiT-XL-2-256x256.pt \
        --vae pretrained_models/sd-vae-ft-mse [--fid-reference VIRTUAL_imagenet256.npz]
    python -m fast_dit_torch.validate_pretrained --dry-run --device cpu

Counterpart of `tools/validate_pretrained.py`, with its steps, messages and
summary file. Each step prints one OK or FAIL line:

  A. import the reference-layout `.pt` into the port's DiT and hold its
     output to an independent functional-torch oracle driven by the same
     state dict (`torch_oracle_forward`), within `--parity-atol`; both run
     in fp32 with TF32 off on the same device;
  B. import the SD-VAE (`ckpt.load_vae`) and check that an encode -> decode
     round trip is finite and of the right shape;
  C. sample the reference demo labels (207, 360, 387, 974, 88, 979, 417,
     279) with CFG `--cfg-scale` through the port's DDPM loop, decode and
     write `validate_grid.png` (no Pillow needed); x_T comes from a seeded
     `torch.Generator`, not JAX's key;
  D. a quick FID through the real `sample_ddp` harness (its own parser with
     JAX's overrides, the `arr_0` npz) and `evaluate_samples`' features,
     against `--fid-reference` when given, else between two halves of the
     generated set (a mechanism check, not a quality number).

`--dry-run` runs every step with a tiny random DiT (`random_state_dict`)
and, without `--vae`, a randomly initialised VAE. The summary goes to
`<out-dir>/validate_summary.json`; the last line is `ALL CHECKS PASSED`
(exit 0) or `VALIDATION FAILED` (exit 1). Runs on the card unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import shutil
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from . import sample_ddp
from .ckpt import find_model, load_vae
from .diffusion import create_diffusion
from .evaluate_samples import load_images, make_inception_fns, make_random_projection_fns
from .models import VAE_SCALE, AutoencoderKL, DiT, DiT_models, decode_from_latents
from .models.pos_embed import get_2d_sincos_pos_embed
from .nvs import metrics
from .sample import load_dit
from .utils.device import resolve_device, tf32
from .utils.image import save_image

__all__ = ["DEMO_LABELS", "torch_oracle_forward", "random_state_dict", "build_parser", "run",
           "main"]

DEMO_LABELS = [207, 360, 387, 974, 88, 979, 417, 279]  # the reference sample.py's
VAE_CONFIGS = {"sd": (128, 256, 512, 512), "f8-small": (32, 32, 64, 64)}
DRY_RUN_MODEL = "DiT-dry-run"  # the tiny config's name in the model table during a dry run


def torch_oracle_forward(sd, x, t, y, num_heads):
    """The reference DiT forward in functional torch, read straight off a
    reference-layout state dict (any config: the shapes come from `sd`),
    independent of the port's modules. sd: {name: tensor}; x (B, C, H, W),
    t, y (B,) tensors, all on one device; fp32. Returns the (B, C_out, H,
    W) output."""
    g = sd
    D = g["t_embedder.mlp.0.weight"].shape[0]
    P = g["x_embedder.proj.weight"].shape[2]
    depth = 1 + max(int(k.split(".")[1]) for k in g if k.startswith("blocks."))
    out_dim = g["final_layer.linear.weight"].shape[0]
    c_out = out_dim // (P * P)
    img = x.shape[-1]

    tok = F.conv2d(x, g["x_embedder.proj.weight"], g["x_embedder.proj.bias"], stride=P)
    tok = tok.flatten(2).transpose(1, 2) + g["pos_embed"]

    half = 128  # frequency_embedding_size 256 // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=x.device) / half)
    targs = t.float()[:, None] * freqs[None]
    tf = torch.cat([torch.cos(targs), torch.sin(targs)], dim=-1)
    temb = F.linear(tf, g["t_embedder.mlp.0.weight"], g["t_embedder.mlp.0.bias"])
    temb = F.linear(F.silu(temb), g["t_embedder.mlp.2.weight"], g["t_embedder.mlp.2.bias"])
    c = temb + g["y_embedder.embedding_table.weight"][y]

    def ln(v):
        return F.layer_norm(v, (D,), eps=1e-6)

    hd = D // num_heads
    for i in range(depth):
        mods = F.linear(F.silu(c), g[f"blocks.{i}.adaLN_modulation.1.weight"],
                        g[f"blocks.{i}.adaLN_modulation.1.bias"]).chunk(6, dim=1)
        s_msa, sc_msa, gate_msa, s_mlp, sc_mlp, gate_mlp = mods
        h = ln(tok) * (1 + sc_msa[:, None]) + s_msa[:, None]
        qkv = F.linear(h, g[f"blocks.{i}.attn.qkv.weight"], g[f"blocks.{i}.attn.qkv.bias"])
        B, N, _ = qkv.shape
        q, k, v = qkv.reshape(B, N, 3, num_heads, hd).unbind(2)
        q, k, v = (u.permute(0, 2, 1, 3) for u in (q, k, v))
        att = torch.softmax(q @ k.transpose(-1, -2) * hd ** -0.5, dim=-1)
        h = (att @ v).permute(0, 2, 1, 3).reshape(B, N, D)
        h = F.linear(h, g[f"blocks.{i}.attn.proj.weight"], g[f"blocks.{i}.attn.proj.bias"])
        tok = tok + gate_msa[:, None] * h
        h = ln(tok) * (1 + sc_mlp[:, None]) + s_mlp[:, None]
        h = F.linear(h, g[f"blocks.{i}.mlp.fc1.weight"], g[f"blocks.{i}.mlp.fc1.bias"])
        h = F.gelu(h, approximate="tanh")
        h = F.linear(h, g[f"blocks.{i}.mlp.fc2.weight"], g[f"blocks.{i}.mlp.fc2.bias"])
        tok = tok + gate_mlp[:, None] * h

    shift, scale = F.linear(F.silu(c), g["final_layer.adaLN_modulation.1.weight"],
                            g["final_layer.adaLN_modulation.1.bias"]).chunk(2, dim=1)
    tok = ln(tok) * (1 + scale[:, None]) + shift[:, None]
    tok = F.linear(tok, g["final_layer.linear.weight"], g["final_layer.linear.bias"])
    gh = img // P
    out = tok.reshape(-1, gh, gh, P, P, c_out)
    return torch.einsum("nhwpqc->nchpwq", out).reshape(-1, c_out, img, img)


def random_state_dict(depth, hidden, patch, in_ch, num_classes, input_size, seed=0):
    """A reference-layout random state dict (numpy fp32) of any config, for
    --dry-run."""
    rs = np.random.RandomState(seed)
    w = lambda *s: (rs.randn(*s) * 0.15).astype(np.float32)
    sd = {
        "x_embedder.proj.weight": w(hidden, in_ch, patch, patch),
        "x_embedder.proj.bias": w(hidden),
        "t_embedder.mlp.0.weight": w(hidden, 256),
        "t_embedder.mlp.0.bias": w(hidden),
        "t_embedder.mlp.2.weight": w(hidden, hidden),
        "t_embedder.mlp.2.bias": w(hidden),
        "y_embedder.embedding_table.weight": w(num_classes + 1, hidden),
        "final_layer.adaLN_modulation.1.weight": w(2 * hidden, hidden),
        "final_layer.adaLN_modulation.1.bias": w(2 * hidden),
        "final_layer.linear.weight": w(patch * patch * 2 * in_ch, hidden),
        "final_layer.linear.bias": w(patch * patch * 2 * in_ch),
        "pos_embed": get_2d_sincos_pos_embed(hidden, input_size // patch).astype(np.float32)[None],
    }
    for i in range(depth):
        sd[f"blocks.{i}.adaLN_modulation.1.weight"] = w(6 * hidden, hidden)
        sd[f"blocks.{i}.adaLN_modulation.1.bias"] = w(6 * hidden)
        sd[f"blocks.{i}.attn.qkv.weight"] = w(3 * hidden, hidden)
        sd[f"blocks.{i}.attn.qkv.bias"] = w(3 * hidden)
        sd[f"blocks.{i}.attn.proj.weight"] = w(hidden, hidden)
        sd[f"blocks.{i}.attn.proj.bias"] = w(hidden)
        sd[f"blocks.{i}.mlp.fc1.weight"] = w(4 * hidden, hidden)
        sd[f"blocks.{i}.mlp.fc1.bias"] = w(4 * hidden)
        sd[f"blocks.{i}.mlp.fc2.weight"] = w(hidden, 4 * hidden)
        sd[f"blocks.{i}.mlp.fc2.bias"] = w(hidden)
    return sd


@contextlib.contextmanager
def _registered(name, ctor):
    """`ctor` in the model table under `name` for the duration (the
    sample_ddp parser's --model choices are read from it)."""
    DiT_models[name] = ctor
    try:
        yield name
    finally:
        del DiT_models[name]


def check(name, ok, detail=""):
    print(f"[{'OK' if ok else 'FAIL'}] {name}" + (f" — {detail}" if detail else ""), flush=True)
    return bool(ok)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dit", default=None, help=".pt path or pretrained name")
    ap.add_argument("--vae", default=None, help="diffusers SD-VAE weights (file or directory)")
    ap.add_argument("--model", default="DiT-XL/2", choices=list(DiT_models))
    ap.add_argument("--image-size", type=int, default=256)
    ap.add_argument("--num-sampling-steps", type=int, default=250)
    ap.add_argument("--cfg-scale", type=float, default=4.0)
    ap.add_argument("--num-fid-samples", type=int, default=5000)
    ap.add_argument("--fid-reference", default=None,
                    help="ADM reference-batch npz (VIRTUAL_imagenet256_labeled.npz); without "
                         "it FID is a split-half mechanism check")
    ap.add_argument("--parity-atol", type=float, default=1e-3,
                    help="max|Δ| bound of step A (model-output units; the port and the "
                         "oracle accumulate in other orders across the layers)")
    ap.add_argument("--skip-fid", action="store_true")
    ap.add_argument("--vae-config", default="sd", choices=list(VAE_CONFIGS),
                    help="'sd' = the SD-VAE architecture (day-one default); 'f8-small' = a "
                         "narrow 4-stage kl-f8 config for drills with synthetic weights")
    ap.add_argument("--out-dir", default="validate_out")
    ap.add_argument("--dry-run", action="store_true",
                    help="tiny random-weight DiT + random-init VAE: every step with no "
                         "downloaded weights")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"fast_dit_torch.validate_pretrained: {e}") from None
    return run(args, device)["exit_code"]


def run(args, device) -> dict:
    """The four steps; returns the summary (also written to the out dir)
    with "exit_code" and the steps' timings."""
    os.makedirs(args.out_dir, exist_ok=True)
    ok = True
    timing = {}

    # -- model + state dict ------------------------------------------------
    if args.dry_run:
        args.image_size = 64
        args.num_sampling_steps = min(args.num_sampling_steps, 8)
        args.num_fid_samples = min(args.num_fid_samples, 16)
        latent = args.image_size // 8
        ctor = functools.partial(DiT, input_size=latent, patch_size=2, in_channels=4,
                                 hidden_size=32, depth=2, num_heads=4, num_classes=1000)
        sd = {k: torch.from_numpy(v) for k, v in
              random_state_dict(2, 32, 2, 4, 1000, latent).items()}
        dit_path = os.path.join(args.out_dir, "dry_run_dit.pt")
        torch.save(sd, dit_path)
        model_name = DRY_RUN_MODEL
    else:
        if not args.dit:
            raise SystemExit("fast_dit_torch.validate_pretrained: --dit is required "
                             "(or use --dry-run)")
        latent = args.image_size // 8
        ctor = functools.partial(DiT_models[args.model], input_size=latent)
        sd = find_model(args.dit)
        dit_path = args.dit
        model_name = args.model

    t0 = time.perf_counter()
    model = load_dit(ctor, sd, device)
    with tf32(False), torch.inference_mode():
        # -- A: import + activation parity --------------------------------
        rs = np.random.RandomState(0)
        x = rs.randn(2, model.in_channels, model.input_size,
                     model.input_size).astype(np.float32)
        t = np.array([37, 999], np.int64)
        y = np.array([DEMO_LABELS[0], DEMO_LABELS[1]], np.int64)
        xt, tt, yt = (torch.from_numpy(a).to(device) for a in (x, t, y))
        got = model(xt, tt, yt)
        sd_dev = {k: v.to(device=device, dtype=torch.float32) for k, v in sd.items()}
        expected = torch_oracle_forward(sd_dev, xt, tt, yt, model.num_heads)
        dmax = (got.double() - expected.double()).abs().max().item()
        del sd_dev, expected, got
        _sync(device)
        timing["A_s"] = time.perf_counter() - t0
        ok &= check("A activation parity (port import vs torch oracle)",
                    dmax <= args.parity_atol, f"max|Δ|={dmax:.2e} (bound {args.parity_atol:.0e})")

        # -- B: VAE import + roundtrip ------------------------------------
        t0 = time.perf_counter()
        channels = VAE_CONFIGS[args.vae_config]
        vae_path = args.vae or os.environ.get("SD_VAE_PATH") or ""
        vae = None
        if args.dry_run and not (vae_path and os.path.exists(vae_path)):
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)
                vae = AutoencoderKL(channels, device="cpu").to(device).eval()
            vae_src = "random-init (dry run)"
        elif vae_path and os.path.exists(vae_path):
            vae = load_vae(vae_path, channels, device=device)
            vae_src = vae_path
        else:
            vae_src = "none"
        if vae is not None:
            img = torch.from_numpy(rs.rand(1, 3, args.image_size, args.image_size)
                                   .astype(np.float32) * 2 - 1).to(device)
            moments = vae.encode_moments(img)
            z = moments[:, :4] * VAE_SCALE
            rec = vae.decode(z / VAE_SCALE)
            ok &= check("B VAE import + encode/decode roundtrip",
                        rec.shape == img.shape and bool(torch.isfinite(rec).all()),
                        f"{vae_src}: latents {tuple(z.shape)} -> {tuple(rec.shape)}")
        else:
            check("B VAE", True, "skipped (no weights; pass --vae or SD_VAE_PATH)")
        _sync(device)
        timing["B_s"] = time.perf_counter() - t0

        # -- C: demo-label sample grid --------------------------------------
        diffusion = create_diffusion(str(args.num_sampling_steps), device=device)
        n = len(DEMO_LABELS)
        yy = torch.tensor(DEMO_LABELS + [model.num_classes] * n, device=device)
        gen = torch.Generator(device=device).manual_seed(0)
        z = torch.randn((n, model.in_channels, latent, latent), generator=gen, device=device)
        z = torch.cat([z, z], 0)
        apply = lambda xx, ts: model.forward_with_cfg(xx, ts, yy, args.cfg_scale)
        _sync(device)
        t0 = time.perf_counter()
        out = diffusion.p_sample_loop(apply, z.shape, noise=z, generator=gen,
                                      clip_denoised=False)[:n]
        _sync(device)
        timing["C_s_per_step"] = (time.perf_counter() - t0) / args.num_sampling_steps
        grid = (decode_from_latents(vae, out) if vae is not None else out[:, :3]).cpu().numpy()
        grid_path = os.path.join(args.out_dir, "validate_grid.png")
        vr = (-1, 1) if vae is not None else (float(grid.min()), float(grid.max()))
        save_image(grid, grid_path, nrow=4, value_range=vr)
        ok &= check("C demo-label sample grid",
                    bool(np.isfinite(grid).all()) and grid.shape[0] == n,
                    f"{grid_path} (labels {DEMO_LABELS}, cfg {args.cfg_scale}, "
                    f"{args.num_sampling_steps} steps)")
        del model, vae, out, z

    # -- D: quick FID through the real sample_ddp harness ------------------
    fid = None
    if args.skip_fid:
        check("D FID", True, "skipped (--skip-fid)")
    else:
        sample_dir = os.path.join(args.out_dir, "fid_samples")
        shutil.rmtree(sample_dir, ignore_errors=True)
        os.makedirs(sample_dir, exist_ok=True)
        registry = _registered(DRY_RUN_MODEL, ctor) if args.dry_run else contextlib.nullcontext()
        with registry:
            # the namespace comes from sample_ddp's own parser, so every flag
            # it gains arrives here with its default; only these are set
            overrides = [
                "--model", model_name, "--vae", "mse", "--sample-dir", sample_dir,
                "--per-proc-batch-size", str(min(8, args.num_fid_samples)),
                "--num-fid-samples", str(args.num_fid_samples),
                "--cfg-scale", "1.5",
                "--num-sampling-steps", str(args.num_sampling_steps),
                "--ckpt", dit_path, "--io-threads", "8", "--device", args.device,
            ]
            if vae_path and os.path.exists(vae_path):
                overrides += ["--vae-ckpt", vae_path]
            overrides += ["--vae-channels", ",".join(map(str, channels))]
            if not args.dry_run:
                overrides += ["--bf16"]
            ns = sample_ddp.build_parser().parse_args(overrides)
            # the CLI takes --image-size 256 or 512; the dry run's config is 64
            ns.image_size = args.image_size
            ddp = sample_ddp.main(ns)
        timing["D_images_per_s"] = ddp["images"] / ddp["seconds"]
        npzs = [os.path.join(r, f) for r, _, fs in os.walk(sample_dir)
                for f in fs if f.endswith(".npz")]
        ok &= check("D1 sample_ddp npz contract", len(npzs) == 1,
                    npzs[0] if npzs else "no npz written")
        if npzs:
            gen_imgs = load_images(npzs[0])
            feature_fn, _ = make_inception_fns()
            label = "inception"
            if feature_fn is None:
                feature_fn, _ = make_random_projection_fns()
                label = "random-projection (offline stand-in)"
            if args.fid_reference:
                ref = load_images(args.fid_reference, limit=len(gen_imgs))
                fid = metrics.compute_fid(ref, gen_imgs, feature_fn)
                ok &= check("D2 quick FID vs reference batch", np.isfinite(fid),
                            f"FID={fid:.3f} [{label}] ({len(gen_imgs)} samples — quote "
                            f"FID-50K for parity)")
            else:
                h = len(gen_imgs) // 2
                fid = metrics.compute_fid(gen_imgs[:h], gen_imgs[h:], feature_fn)
                ok &= check("D2 FID pipeline (split-half mechanism check)", np.isfinite(fid),
                            f"FID={fid:.3f} [{label}] — pass --fid-reference for a real "
                            f"number")

    summary_path = os.path.join(args.out_dir, "validate_summary.json")
    summary = {"ok": bool(ok), "parity_max_abs": dmax, "dit": str(dit_path), "vae": vae_src,
               "image_size": args.image_size, "fid": fid, "timing": timing}
    with open(summary_path, "w") as f:
        json.dump(summary, f, indent=1)
    print(("ALL CHECKS PASSED" if ok else "VALIDATION FAILED") + f" (summary: {summary_path})",
          flush=True)
    return {**summary, "exit_code": 0 if ok else 1}


if __name__ == "__main__":
    sys.exit(main())
