"""End-to-end novel-view-synthesis demo: warp -> mask -> inpaint -> metrics
(counterpart of `tools/nvs_demo.py`).

    python -m fast_dit_torch.nvs_demo --device cpu --size 32 --num-sampling-steps 6 [--nvs-model]

On a synthetic two-view scene (a textured plane at constant depth, two
pinhole cameras):

  1. the ground-truth target view through the exact planar homography
     (`nvs.warp.homography_from_pose`, `warp_image_homography`);
  2. the depth-based forward warp of the source into the target view
     (`nvs.warp.warp_image_by_depth`), which leaves disocclusion holes;
  3. the hole mask from black pixels (`nvs.inpaint.mask_from_black_pixels`);
  4. RePaint inpainting of the holes (`nvs.inpaint.inpaint_sample_loop`)
     with a small image-space DiT or, with `--nvs-model`, a `DiTNVS`
     conditioned on stub source features (average-pooled source patches
     under a fixed random projection stand in for DINO);
  5. the report: PSNR and SSIM against the homography ground truth (full
     image and warped region), coverage, hole fraction, and seven PNGs.

Random weights (the seeded init plus `sample.perturb_`) fill the holes with
structured noise: the run proves the pipeline. `--ckpt` takes a port `.pt`
state dict of the same model. Both models use attn_backend="einsum", as the
JAX demo does: the DiTNVS's 256 image tokens attend to 16 feature tokens,
which the packed attention kernel does not take. Runs on the card unless
`--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from .ckpt.convert import load_torch_checkpoint
from .diffusion import create_diffusion
from .models import DiT
from .nvs import geometry, inpaint, metrics, warp
from .nvs.conditioning import DiTNVS
from .sample import perturb_
from .utils.device import resolve_device
from .utils.image import encode_png, save_image
from .utils.viz import depth_to_color, error_heatmap

__all__ = ["make_scene", "make_stub_features", "main"]


def make_scene(size):
    """A textured plane at constant depth and two cameras -> (src image
    (H, W, 3) float in [0, 1], depth (H, W), K, (R1, t1), (R2, t2), plane
    depth), numpy images and fp32 CPU tensors."""
    h = w = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    checker = ((xx // (size // 8) + yy // (size // 8)) % 2)
    img = np.stack([0.15 + 0.7 * checker, 0.2 + 0.6 * (xx / w), 0.25 + 0.6 * (yy / h)],
                   axis=-1).astype(np.float32)
    rs = np.random.RandomState(0)  # a few coloured squares for structure
    for _ in range(6):
        cy, cx = rs.randint(4, h - 12, 2)
        s = rs.randint(3, max(4, size // 6))
        img[cy:cy + s, cx:cx + s] = rs.rand(3) * 0.8 + 0.1
    d0 = 2.0
    depth = np.full((h, w), d0, np.float32)
    f = 1.2 * size
    K = torch.tensor([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], dtype=torch.float32)
    ang = 0.06
    R2 = torch.tensor([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                       [-np.sin(ang), 0, np.cos(ang)]], dtype=torch.float32)
    t2 = torch.tensor([0.12, 0.03, 0.0])
    return img, depth, K, (torch.eye(3), torch.zeros(3)), (R2, t2), d0


def make_stub_features(src_img, grid, dim, seed=0):
    """Offline stand-in for DINO: the source image average-pooled to
    (grid, grid) and lifted 3 -> dim channels by a fixed random projection:
    (1, dim, grid, grid), `DiTNVS`'s `dino_feat`."""
    h, w, _ = src_img.shape
    ph, pw = h // grid, w // grid
    pooled = src_img[:grid * ph, :grid * pw].reshape(grid, ph, grid, pw, 3).mean(axis=(1, 3))
    proj = np.random.RandomState(seed).randn(3, dim).astype(np.float32) * 0.5
    return np.transpose(pooled @ proj, (2, 0, 1))[None]


def _build_model(args, src, device):
    """(model_fn(x, t), the report's model name) for the demo's model."""
    size = args.size
    y = torch.zeros((1,), dtype=torch.int64, device=device)
    common = dict(input_size=size, patch_size=4, in_channels=3, hidden_size=64, depth=4,
                  num_heads=4, num_classes=1, attn_backend="einsum", device=device, seed=1)
    if args.nvs_model:
        dino_dim, dino_grid = 32, 4
        model = DiTNVS(**common, dino_dim=dino_dim, dino_patch_grid=dino_grid,
                       cross_layers=(1, 3))
        feat = torch.from_numpy(make_stub_features(src, dino_grid, dino_dim)).to(device)
        fn = lambda x, t: model(x, t, feat, y)  # noqa: E731
        name = "DiTNVS (stub DINO features, cross layers (1, 3))"
    else:
        model = DiT(**common)
        fn = lambda x, t: model(x, t, y)  # noqa: E731
        name = "DiT (image-space)"
    if args.ckpt:
        model.load_state_dict(load_torch_checkpoint(args.ckpt), strict=True)
    else:
        # the zero-init adaLN and head make a fresh model output ~0
        perturb_(model, seed=2)
    model.eval()
    return fn, name


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=64,
                    help="scene/image side (pixels); the DiT runs in image space")
    ap.add_argument("--num-sampling-steps", type=int, default=50)
    ap.add_argument("--nvs-model", action="store_true",
                    help="inpaint with DiTNVS (DINO cross-attention on stub source "
                         "features) instead of the plain DiT")
    ap.add_argument("--ckpt", default=None,
                    help="optional port .pt state dict of the model (default: random "
                         "init, a pipeline proof)")
    ap.add_argument("--jump-n", type=int, default=1, help="RePaint resampling passes per step")
    ap.add_argument("--out-dir", default="nvs_demo_out")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    size = args.size

    # 1: scene and the exact planar ground truth
    src, depth, K, (R1, t1), (R2, t2), d0 = make_scene(size)
    R_rel, t_rel = geometry.relative_pose(R1, t1, R2, t2)
    H = warp.homography_from_pose(K, K, R_rel, t_rel, plane_normal=torch.tensor([0.0, 0.0, 1.0]),
                                  plane_distance=d0)
    gt, gt_mask = warp.warp_image_homography(torch.from_numpy(src), H)
    gt, gt_mask = gt.numpy(), gt_mask.numpy()

    # 2: the depth-based forward warp, which leaves the holes
    warped, cover = warp.warp_image_by_depth(torch.from_numpy(src), torch.from_numpy(depth),
                                             K, K, R_rel, t_rel)
    warped = warped.numpy()
    coverage = float(warp.valid_pixel_ratio(cover))

    # 3: the hole mask as the reference builds it
    holes = inpaint.mask_from_black_pixels(np.clip(warped * 255, 0, 255).astype(np.uint8))

    # 4: diffusion inpainting
    steps = args.num_sampling_steps
    diffusion = create_diffusion(str(steps), noise_schedule="squaredcos_cap_v2", device=device)
    known = torch.from_numpy(warped.transpose(2, 0, 1)[None] * 2 - 1).to(device)
    mask = torch.from_numpy(holes[None, None].astype(np.float32)).to(device)
    model_fn, model_name = _build_model(args, src, device)
    g = torch.Generator(device=device).manual_seed(0)
    with torch.inference_mode():
        filled = inpaint.inpaint_sample_loop(model_fn, known, mask, diffusion.schedule,
                                             generator=g, clip_denoised=True,
                                             jump_n=args.jump_n)
    out = np.clip(filled[0].float().cpu().numpy().transpose(1, 2, 0) * 0.5 + 0.5, 0, 1)

    # 5: metrics and report
    gt_u8 = np.clip(gt * 255, 0, 255).astype(np.uint8)
    out_u8 = np.clip(out * 255, 0, 255).astype(np.uint8)
    keep = ~holes & gt_mask
    report = {
        "model": model_name,
        "steps": steps,
        "coverage": round(coverage, 4),
        "hole_fraction": round(float(holes.mean()), 4),
        "psnr_full": round(metrics.psnr(gt_u8, out_u8), 3),
        "ssim_full": round(metrics.ssim(gt_u8, out_u8), 4),
        # outside the holes the depth warp must agree with the exact
        # homography up to the rounding of pixel positions
        "psnr_warped_region": round(float(-10 * np.log10(np.maximum(
            np.mean((gt[keep] - warped[keep]) ** 2), 1e-12))), 3),
    }
    for name, img in (("src", src), ("gt_target", gt), ("warped_holes", warped),
                      ("inpainted", out)):
        save_image(img.transpose(2, 0, 1)[None], f"{args.out_dir}/{name}.png", nrow=1,
                   value_range=(0, 1))
    save_image(holes[None, None].astype(np.float32), f"{args.out_dir}/hole_mask.png", nrow=1,
               value_range=(0, 1))
    for name, img in (("depth", depth_to_color(depth)),
                      ("error_heatmap", error_heatmap(gt_u8, out_u8))):
        with open(f"{args.out_dir}/{name}.png", "wb") as f:
            f.write(encode_png(img))
    with open(f"{args.out_dir}/report.json", "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    ok = (np.isfinite([v for v in report.values() if isinstance(v, float)]).all()
          and report["psnr_warped_region"] > 25.0)
    print("NVS DEMO " + ("OK" if ok else "FAILED") + f" (outputs in {args.out_dir}/)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
