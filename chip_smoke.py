"""Drive the PyTorch port on one NVIDIA card and hold its kernels against
their plain versions.

    python3 chip_smoke.py              # DiT-XL/2 256², bf16, CFG 4.0, 50 DDPM steps
    python3 chip_smoke.py --steps 250  # the reference step count
    python3 chip_smoke.py --profile out/profile.txt  # also a torch.profiler
                                       # breakdown of four steps, table to that file

Phases, one JSON line each; any failure raises and the exit code is nonzero:
 1. device:   CUDA must be present; the card's name and power limit; TF32 off.
 2. build:    nvcc builds every kernel of the path from `fast_dit_torch/csrc`.
 3. kernel:   the attention kernel against its plain twin, fp32 and bf16, at
              the sampling shape, at 1024 tokens and at a ragged S, with its
              time, the twin's, SDPA's (timed only) and the bound.
 4. model:    full DiT-XL/2 fp32, one forward_with_cfg through the kernel and
              through the einsum twin on the card.
 5. sample:   a small model sampled on the card and on the CPU with the same
              noise must agree; then the main path, the CLI's own functions
              at full DiT-XL/2 width and depth, with the kernel's launch count
              checked at exactly depth x steps.
Then the `kernels` line, the nvidia-smi line, and the final status line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from fast_dit_torch.models import DiT_models  # noqa: E402
from fast_dit_torch.ops import _build  # noqa: E402
from fast_dit_torch.ops.flash_attention import (  # noqa: E402
    _attention_qkv_plain, flash_attention_qkv_flat)
from fast_dit_torch import sample as cli  # noqa: E402
from fast_dit_torch.diffusion import create_diffusion  # noqa: E402

# H100 SXM data sheet: HBM bytes/s, dense peak FLOP/s by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
KERNEL_SHAPES = [(16, 256, 16, 72), (16, 1024, 16, 72), (2, 200, 6, 64)]
MAIN_SHAPE = (16, 256, 16, 72)  # DiT-XL/2 256², CFG batch of 8 labels


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(B, S, H, hd, dtype):
    """(least time, what bounds it): read 3D and write D per token once;
    4*B*S^2*D flops of the two products at the input type's peak."""
    D = H * hd
    nbytes = 4 * B * S * D * torch.tensor([], dtype=dtype).element_size()
    flops = 4 * B * S * S * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32})
    return smi


def phase_build():
    t0 = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: os.path.basename(v) for k, v in libs.items()}})


def phase_kernel():
    """Kernel vs twin at every shape and dtype; returns the main-shape bf16 row."""
    g = torch.Generator(device="cuda").manual_seed(0)
    main = None
    for B, S, H, hd in KERNEL_SHAPES:
        D = H * hd
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn(B, S, 3 * D, generator=g, device="cuda").to(dtype)
            scale = hd ** -0.5
            out = flash_attention_qkv_flat(qkv, H)
            torch.cuda.synchronize()
            ref = _attention_qkv_plain(qkv, H, scale)
            err = (out.float() - ref.float()).abs().max().item()
            if not err <= TOL[dtype]:
                raise AssertionError(f"attention kernel vs twin at {(B, S, H, hd)} {dtype}: "
                                     f"max abs err {err} > {TOL[dtype]}")
            q, k, v = (qkv[..., i * D:(i + 1) * D].view(B, S, H, hd).transpose(1, 2)
                       for i in range(3))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            bound, bound_by = attention_bound_ms(B, S, H, hd, dtype)
            row = {"phase": "kernel", "name": "attention_fwd", "shape": [B, S, H, hd],
                   "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
                   "tol": TOL[dtype],
                   "kernel_ms": cuda_ms(lambda: flash_attention_qkv_flat(qkv, H)),
                   "plain_ms": cuda_ms(lambda: _attention_qkv_plain(qkv, H, scale)),
                   "library_ms": cuda_ms(lambda: sdpa(q, k, v, scale=scale)),
                   "bound_ms": bound, "bound_us": bound * 1e3, "bound_by": bound_by}
            emit(row)
            if (B, S, H, hd) == MAIN_SHAPE and dtype == torch.bfloat16:
                main = row
    return main


def phase_model():
    """Full DiT-XL/2 in fp32: the kernel path against the einsum twin."""
    model = DiT_models["DiT-XL/2"](input_size=32, device="cuda", seed=0)
    cli.perturb_(model)
    model.eval()
    g = torch.Generator(device="cuda").manual_seed(1)
    n = len(cli.CLASS_LABELS)
    z = torch.randn(n, 4, 32, 32, generator=g, device="cuda")
    x = torch.cat([z, z])
    t = torch.full((2 * n,), 500, device="cuda")
    y = torch.tensor(cli.CLASS_LABELS + [1000] * n, device="cuda")
    outs = {}
    with torch.inference_mode():
        for backend in ("auto", "einsum"):
            for blk in model.blocks:
                blk.attn.attn_backend = backend
            outs[backend] = model.forward_with_cfg(x, t, y, 4.0)
    torch.cuda.synchronize()
    err = (outs["auto"] - outs["einsum"]).abs().max().item()
    peak = outs["einsum"].abs().max().item()
    # 28 fp32 blocks of random weights: kernel and twin sum in other orders
    tol = 1e-4 * peak
    if not (torch.isfinite(outs["auto"]).all() and err <= tol):
        raise AssertionError(f"DiT-XL/2 fp32 kernel vs einsum: max abs err {err} > {tol}")
    emit({"phase": "model", "model": "DiT-XL/2", "dtype": "float32", "batch": 2 * n,
          "max_abs_err": err, "max_abs_out": peak, "tol": tol})
    del model, outs


def phase_sample(steps, profile_table):
    # the main path's result against the CPU on a small input: same weights,
    # same noise, kernel on the card vs plain twin on the CPU
    small = []
    rs = torch.Generator().manual_seed(3)
    noise = torch.randn(4, 4, 8, 8, generator=rs)
    step_noise = torch.randn(10, 4, 4, 8, 8, generator=rs)
    y = [1, 7, 1000, 1000]
    for device in ("cuda", "cpu"):
        model = DiT_models["DiT-S/2"](input_size=8, depth=2, device=device, seed=0)
        cli.perturb_(model)
        diffusion = create_diffusion("10", device=device)
        yy = torch.tensor(y, device=device)
        with torch.inference_mode():
            small.append(diffusion.p_sample_loop(
                lambda x, t: model.forward_with_cfg(x, t, yy, 4.0), noise.shape,
                noise=noise.to(device), step_noise=step_noise.to(device),
                clip_denoised=False).cpu())
    small_err = (small[0] - small[1]).abs().max().item()
    small_tol = 1e-4 * small[1].abs().max().item()
    if not small_err <= small_tol:
        raise AssertionError(f"small-model sampling card vs CPU: {small_err} > {small_tol}")

    args = cli.parse_args(["--model", "DiT-XL/2", "--ckpt", "random", "--bf16",
                           "--cfg-scale", "4.0", "--num-sampling-steps", str(steps)])
    t0 = time.perf_counter()
    model, diffusion = cli.build(args)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    latents = cli.sample_latents(args, model, diffusion)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = dict(_build.launch_counts)

    n = len(cli.CLASS_LABELS)
    want = model.depth * steps
    if launches["attention_fwd"] != want:
        raise AssertionError(f"attention kernel launched {launches['attention_fwd']} times "
                             f"on the main path, expected depth x steps = {want}")
    if tuple(latents.shape) != (n, 4, 32, 32) or not torch.isfinite(latents).all():
        raise AssertionError(f"bad latents: shape {tuple(latents.shape)}, "
                             f"finite {bool(torch.isfinite(latents).all())}")
    row = {"phase": "sample", "model": "DiT-XL/2", "image_size": 256, "dtype": "bfloat16",
           "cfg_scale": 4.0, "labels": n, "batch": 2 * n, "sampler": "ddpm", "steps": steps,
           "setup_s": build_s, "loop_s": loop_s, "s_per_step": loop_s / steps,
           "images_per_s": n / loop_s, "launches": launches,
           "latents_mean_abs": latents.abs().mean().item(),
           "small_check_max_abs_err": small_err, "small_check_tol": small_tol,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if profile_table:
        row["profile"] = profile_steps(args, model, profile_table)
    emit(row)
    return launches


def profile_steps(args, model, table_path, steps=4):
    """Device time by kernel over `steps` sampling steps (torch.profiler),
    against the wall time of the same steps run without the profiler; the
    profiler's full table goes to `table_path`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    diffusion = create_diffusion(str(steps), device="cuda")
    cli.sample_latents(args, model, diffusion)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli.sample_latents(args, model, diffusion)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cli.sample_latents(args, model, diffusion)
        torch.cuda.synchronize()
    # device-side kernel events only: a CPU op's device total repeats its kernels'
    rows = sorted(((e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)
    if not rows:
        raise RuntimeError("torch.profiler recorded no device time")
    busy_ms = sum(r[0] for r in rows) / 1e3
    os.makedirs(os.path.dirname(os.path.abspath(table_path)), exist_ok=True)
    with open(table_path, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    return {"steps": steps, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms,
            "top": [{"kernel": k[:80], "ms": us / 1e3, "count": c} for us, k, c in rows[:10]]}


def main():
    ap = argparse.ArgumentParser(description="Drive the PyTorch port on one card.")
    ap.add_argument("--steps", type=int, default=50, help="DDPM steps of the main path")
    ap.add_argument("--profile", metavar="TABLE", default=None,
                    help="profile four sampling steps; write the kernel table to TABLE")
    a = ap.parse_args()

    smi = phase_device()
    phase_build()
    main_row = phase_kernel()
    phase_model()
    launches = phase_sample(a.steps, a.profile)
    emit({"kernels": [{
        "name": "attention_fwd", "route": "cuda",
        "source": "fast_dit_torch/csrc/flash_attention_fwd.cu",
        "replaces": "fast_dit_tpu/ops/flash_attention.py:119",
        "launches": launches["attention_fwd"], "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
