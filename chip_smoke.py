"""Drive the PyTorch port on one NVIDIA card and hold its kernels against
their plain versions.

    python3 chip_smoke.py              # sampling: DiT-XL/2 256², bf16, CFG 4.0, 50 DDPM
                                       # steps; training: DiT-XL/2, batch 32, 10 steps
    python3 chip_smoke.py --steps 250  # the reference sampling step count
    python3 chip_smoke.py --profile out/profile.txt  # also torch.profiler breakdowns of
                                       # four sampling steps (table to that file) and two
                                       # training steps (table to out/profile_train.txt)

Phases, one JSON line each or more; any failure raises and the exit code is
nonzero:
 1. device:       CUDA must be present; the card's name and power limit; TF32 off.
 2. build:        nvcc builds every kernel of both paths from `fast_dit_torch/csrc`.
 3. kernel:       the attention forward against its plain version, fp32 and bf16,
                  at the sampling and training shapes, at 1024 tokens and at a
                  ragged S, with its
                  time, the plain version's, SDPA's (timed only) and the bound.
 4. kernel_bwd:   the attention backward against its plain version, fp32 and bf16,
                  at the training shape, at 1024 tokens and at a ragged S, with
                  SDPA's backward timed beside it.
 5. fused_update: the fused AdamW + EMA kernel against `_update_math` over the
                  whole DiT-XL/2 parameter tree for 3 steps, with the fused
                  `torch.optim.AdamW` step timed beside it.
 6. model:        full DiT-XL/2 fp32, one forward_with_cfg through the kernel and
                  through the einsum plain version on the card.
 7. sample:       a small model sampled on the card and on the CPU with the same
                  noise must agree; then the sampling main path, the sampler CLI's
                  own functions at full DiT-XL/2 width and depth, with the forward
                  kernel's launch count checked at exactly depth x steps.
 8. train:        a small model trained 2 steps on the card and on the CPU with the
                  same weights and draws must agree; then the training main path,
                  the trainer CLI's own functions at full DiT-XL/2 width and depth
                  (batch 32, bf16, remat), with the launch counts checked at exactly
                  2 x depth x steps (forward, run again by remat) and depth x steps
                  (backward); then the same with --fused-optimizer, one fused-update
                  launch per parameter leaf per step.
Then the `kernels` line, the nvidia-smi line, and the final status line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from fast_dit_torch.models import DiT_models  # noqa: E402
from fast_dit_torch.ops import _build  # noqa: E402
from fast_dit_torch.ops.flash_attention import (  # noqa: E402
    _attention_qkv_bwd_plain, _attention_qkv_plain, _launch_bwd, _launch_fwd,
    flash_attention_qkv_flat)
from fast_dit_torch.ops import fused_update as fu  # noqa: E402
from fast_dit_torch import sample as cli  # noqa: E402
from fast_dit_torch.train import cli as train_cli  # noqa: E402
from fast_dit_torch.train import create_train_state, make_train_step  # noqa: E402
from fast_dit_torch.diffusion import create_diffusion  # noqa: E402

# H100 SXM data sheet: HBM bytes/s, dense peak FLOP/s by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
KERNEL_SHAPES = [(16, 256, 16, 72), (32, 256, 16, 72), (16, 1024, 16, 72), (2, 200, 6, 64)]
MAIN_SHAPE = (16, 256, 16, 72)  # DiT-XL/2 256², CFG batch of 8 labels
# the backward against its plain version, relative to max |dqkv|: fp32, sums
# of up to 1024 fp32 terms taken in other orders; bf16, one bf16 rounding of
# the output (2^-8) and delta formed from the bf16-rounded forward output
BWD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
BWD_SHAPES = [(32, 256, 16, 72), (16, 1024, 16, 72), (2, 200, 6, 64)]
TRAIN_SHAPE = (32, 256, 16, 72)  # DiT-XL/2 256², batch 32
TRAIN_ARGS = ["--model", "DiT-XL/2", "--synthetic-data", "--global-batch-size", "32",
              "--global-seed", "0"]
TRAIN_STEPS, FUSED_TRAIN_STEPS = 10, 3  # timed steps of the two training runs
LR = 1e-4


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


def phase_kernel_bwd():
    """Backward kernel vs plain at every shape and dtype; returns the
    training-shape bf16 row."""
    g = torch.Generator(device="cuda").manual_seed(2)
    main = None
    for B, S, H, hd in BWD_SHAPES:
        D = H * hd
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn(B, S, 3 * D, generator=g, device="cuda").to(dtype)
            dout = torch.randn(B, S, D, generator=g, device="cuda").to(dtype)
            scale = hd ** -0.5
            out, lse = _launch_fwd(qkv, H, hd, scale, with_lse=True)
            dqkv = _launch_bwd(qkv, out, dout, lse, H, hd, scale)
            torch.cuda.synchronize()
            ref = _attention_qkv_bwd_plain(qkv, dout, H, scale).float()
            peak = ref.abs().max().item()
            err = (dqkv.float() - ref).abs().max().item()
            if not (torch.isfinite(dqkv).all() and err <= BWD_RTOL[dtype] * peak):
                raise AssertionError(f"attention backward vs plain at {(B, S, H, hd)} {dtype}: "
                                     f"max abs err {err} > {BWD_RTOL[dtype]} x {peak}")
            # SDPA's backward alone: the graph is kept, only the backward is timed
            q, k, v = (qkv[..., i * D:(i + 1) * D].view(B, S, H, hd).transpose(1, 2)
                       .contiguous().requires_grad_() for i in range(3))
            o = torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=scale)
            do_l = dout.view(B, S, H, hd).transpose(1, 2).contiguous()
            nbytes = 8 * B * S * D * qkv.element_size()
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = 10 * B * S * S * D / PEAK_FLOPS[dtype] * 1e3
            row = {"phase": "kernel_bwd", "name": "attention_bwd", "shape": [B, S, H, hd],
                   "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
                   "max_abs_dqkv": peak, "tol": BWD_RTOL[dtype] * peak,
                   "kernel_ms": cuda_ms(lambda: _launch_bwd(qkv, out, dout, lse, H, hd, scale)),
                   "plain_ms": cuda_ms(lambda: _attention_qkv_bwd_plain(qkv, dout, H, scale)),
                   "library_ms": cuda_ms(lambda: torch.autograd.grad(
                       o, (q, k, v), do_l, retain_graph=True)),
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            emit(row)
            if (B, S, H, hd) == TRAIN_SHAPE and dtype == torch.bfloat16:
                main = row
            del qkv, dout, out, lse, dqkv, ref, q, k, v, o, do_l
    torch.cuda.empty_cache()
    return main


def phase_fused_update(steps=3):
    """The fused kernel vs `_update_math` over DiT-XL/2's parameter tree
    (bf16 params and mu, fp32 nu, master and EMA); returns the row."""
    with torch.device("meta"):
        shapes = [p.shape for p in DiT_models["DiT-XL/2"](device="meta").parameters()]
    g = torch.Generator(device="cuda").manual_seed(3)
    init = [(0.02 * torch.randn(s, generator=g, device="cuda")).to(torch.bfloat16)
            for s in shapes]
    kp, pp = [t.clone() for t in init], [t.clone() for t in init]
    kstate, pstate = fu.fused_adamw_ema_init(kp), fu.fused_adamw_ema_init(pp)
    kema, pema = [w.clone() for w in kstate.master], [w.clone() for w in pstate.master]
    hyper = dict(lr=LR, b1=0.9, b2=0.999, eps=1e-8, wd=0.0, ema_decay=0.9999)
    apply_kw = dict(lr=LR, weight_decay=0.0, ema_decay=0.9999)
    grads = None
    _build.reset_launch_counts()
    for _ in range(steps):
        grads = [(0.01 * torch.randn(s, generator=g, device="cuda")).to(torch.bfloat16)
                 for s in shapes]
        fu.fused_adamw_ema_apply(kstate, grads, kp, kema, **apply_kw)
        fu._apply_plain(pstate, grads, pp, pema, hyper)
    torch.cuda.synchronize()
    launches = _build.launch_counts["fused_adamw_ema"]
    if launches != steps * len(shapes):
        raise AssertionError(f"fused update launched {launches} times, expected one per "
                             f"leaf per step = {steps * len(shapes)}")
    # both round op for op in fp32, each op correctly rounded (no fused
    # multiply-add in the kernel): every state must equal the plain version's
    # in every element
    errs = {}
    for name, a, b in (("param", kp, pp), ("mu", kstate.mu, pstate.mu),
                       ("nu", kstate.nu, pstate.nu), ("master", kstate.master, pstate.master),
                       ("ema", kema, pema)):
        errs[name] = max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"fused update vs _update_math: {name} differs, "
                                 f"max abs err {errs[name]}")
    n = sum(math.prod(s) for s in shapes)
    # each element: read g, m, v, w, e and write p, m, v, w, e once; ~15 flops
    nbytes = n * (2 * 2 + 2 * 2 + 24)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 15 * n / PEAK_FLOPS[torch.float32] * 1e3
    kernel_ms = cuda_ms(lambda: fu.fused_adamw_ema_apply(kstate, grads, kp, kema, **apply_kw),
                        iters=5, warmup=1)
    plain_ms = cuda_ms(lambda: fu._apply_plain(pstate, grads, pp, pema, hyper),
                       iters=5, warmup=1)
    del pp, pstate, pema
    # the library yardstick: torch's fused AdamW over fp32 copies of the tree
    masters = [w.clone() for w in kstate.master]
    for w, gr in zip(masters, grads):
        w.grad = gr.float()
    opt = torch.optim.AdamW(masters, lr=LR, weight_decay=0.0, fused=True)
    library_ms = cuda_ms(opt.step, iters=5, warmup=1)
    row = {"phase": "fused_update", "name": "fused_adamw_ema", "leaves": len(shapes),
           "elements": n, "steps": steps, "param_dtype": "bfloat16", "mu_dtype": "bfloat16",
           "max_abs_err": errs, "tol": 0,
           "launches_per_step": len(shapes), "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "library": "torch.optim.AdamW(fused=True).step(), fp32: AdamW only, no EMA or cast",
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    emit(row)
    del kp, kstate, kema, masters, opt, grads, init
    torch.cuda.empty_cache()
    return row


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
    torch.cuda.reset_peak_memory_stats()
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
        diffusion4 = create_diffusion("4", device="cuda")
        row["profile"] = profile_device(lambda: cli.sample_latents(args, model, diffusion4),
                                        profile_table, "4 sampling steps")
    emit(row)
    return launches


def profile_device(run, table_path, what):
    """Device time by kernel over one `run()` (torch.profiler), against the
    wall time of the same run without the profiler; the profiler's full
    table goes to `table_path`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    # device-side kernel events only: a CPU op's device total repeats its
    # kernels', and so does a user annotation's device range (the optimizer's
    # `Optimizer.step#AdamW.step`)
    rows = sorted(((e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                   and not getattr(e, "is_user_annotation", False)),
                  reverse=True)
    if not rows:
        raise RuntimeError("torch.profiler recorded no device time")
    busy_ms = sum(r[0] for r in rows) / 1e3
    attn_ms = sum(r[0] for r in rows if "attention_" in r[1]) / 1e3
    os.makedirs(os.path.dirname(os.path.abspath(table_path)), exist_ok=True)
    with open(table_path, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    return {"what": what, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms, "attention_kernels_ms": attn_ms,
            "attention_share_of_busy": attn_ms / busy_ms,
            "top": [{"kernel": k[:80], "ms": us / 1e3, "count": c} for us, k, c in rows[:12]]}


def _small_train_check(steps=2):
    """A small model trained on the card (kernels) and on the CPU (plain
    versions) from the same weights with the same draws: the last loss, the
    last gradients, the parameters and the EMA must agree."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(4, 4, 8, 8, generator=g)
    y = torch.tensor([1, 7, 3, 999])
    draws = [{"t": torch.randint(0, 1000, (4,), generator=g),
              "noise": torch.randn(4, 4, 8, 8, generator=g),
              "force_drop_ids": torch.tensor([0, 1, 0, 0])} for _ in range(steps)]
    res = {}
    for device in ("cuda", "cpu"):
        model = DiT_models["DiT-S/2"](input_size=8, depth=2, remat=True, device=device, seed=0)
        cli.perturb_(model)
        diffusion = create_diffusion("", device=device)
        state = create_train_state(model, lr=LR)
        step = make_train_step(model, diffusion.schedule, lr=LR)
        batch = {"x": x.to(device), "y": y.to(device)}
        losses = [step(state, batch, draws=[{k: v.to(device) for k, v in d.items()}])["loss"]
                  .item() for d in draws]
        res[device] = {"loss": losses,
                       "grad": torch.cat([p.grad.flatten() for p in model.parameters()]).cpu(),
                       "param": torch.cat([p.detach().flatten() for p in model.parameters()]).cpu(),
                       "ema": torch.cat([e.flatten() for e in state.ema.values()]).cpu()}
    card, cpu = res["cuda"], res["cpu"]
    loss_err = max(abs(a - b) for a, b in zip(card["loss"], cpu["loss"]))
    grad_err = (card["grad"] - cpu["grad"]).abs().max().item()
    param_err = (card["param"] - cpu["param"]).abs().max().item()
    ema_err = (card["ema"] - cpu["ema"]).abs().max().item()
    # fp32 on both sides, sums in other orders: the loss and the gradients
    # agree closely; Adam moves a parameter by about +-lr whatever the size
    # of its gradient, so where a gradient sits near 0 the two may step apart
    # by up to 2 lr a step; the EMA moves (1 - decay) of that
    tols = {"loss": 1e-5 * abs(cpu["loss"][-1]), "grad": 1e-4 * cpu["grad"].abs().max().item(),
            "param": 2 * LR * steps, "ema": 2 * LR * steps * 1e-4 + 1e-6}
    errs = {"loss": loss_err, "grad": grad_err, "param": param_err, "ema": ema_err}
    for k in errs:
        if not errs[k] <= tols[k]:
            raise AssertionError(f"small-model training card vs CPU: {k} max abs err "
                                 f"{errs[k]} > {tols[k]}")
    return {"max_abs_err": errs, "tol": tols, "losses": card["loss"]}


def _train_run(flags, warmup, steps, profile_table=None):
    """The trainer CLI's own functions: build, one batch of synthetic
    latents, `warmup` steps, then `steps` timed steps with the launch counts
    set to 0 just before and read just after, and every parameter and EMA
    leaf checked to have moved."""
    args = train_cli.parse_args(TRAIN_ARGS + flags)
    train_cli.check_args(args)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, diffusion, state, train_step = train_cli.build(args)
    batch = next(next(train_cli.device_batches(args, torch.device("cuda"))))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    for _ in range(warmup):
        train_step(state, batch)
    torch.cuda.synchronize()
    leaves = {**{f"param {n}": p for n, p in model.named_parameters()},
              **{f"ema {n}": e for n, e in state.ema.items()}}
    before = {n: t.detach().cpu() for n, t in leaves.items()}
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [train_step(state, batch)["loss"] for _ in range(steps)]
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    losses = [v.item() for v in losses]
    # every parameter and every EMA leaf must have moved over the timed steps
    still = [n for n, t in leaves.items() if torch.equal(before[n], t.detach().cpu())]
    if still:
        raise AssertionError(f"{len(still)} leaves did not move in {steps} training steps "
                             f"with {flags}: {still[:5]}")
    del before
    depth = model.depth
    want = {"attention_fwd": 2 * depth * steps, "attention_bwd": depth * steps,
            "fused_adamw_ema": (len(list(model.parameters())) * steps
                                if args.fused_optimizer else 0)}
    if launches != want:
        raise AssertionError(f"training launches {launches}, expected {want}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    row = {"model": "DiT-XL/2", "image_size": 256, "batch": args.global_batch_size,
           "dtype": "bfloat16", "remat": "nothing", "flags": flags,
           "params": sum(p.numel() for p in model.parameters()),
           "warmup_steps": warmup, "steps": steps, "setup_s": setup_s, "loop_s": loop_s,
           "s_per_step": loop_s / steps,
           "images_per_s": args.global_batch_size * steps / loop_s,
           "losses": losses, "launches": launches,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if profile_table:
        row["profile"] = profile_device(lambda: [train_step(state, batch) for _ in range(2)],
                                        profile_table, "2 training steps")
    del model, diffusion, state, train_step, batch
    torch.cuda.empty_cache()
    return row, launches


def phase_train(profile_table):
    small = _small_train_check()
    table = None
    if profile_table:
        root, ext = os.path.splitext(profile_table)
        table = f"{root}_train{ext}"
    main, main_launches = _train_run([], warmup=3, steps=TRAIN_STEPS,
                                       profile_table=table)
    fused, fused_launches = _train_run(["--fused-optimizer"], warmup=2,
                                         steps=FUSED_TRAIN_STEPS)
    emit({"phase": "train", "small_check": small, "main": main, "fused_optimizer": fused})
    return main_launches, fused_launches


def main():
    ap = argparse.ArgumentParser(description="Drive the PyTorch port on one card.")
    ap.add_argument("--steps", type=int, default=50, help="DDPM steps of the sampling path")
    ap.add_argument("--profile", metavar="TABLE", default=None,
                    help="profile four sampling steps and two training steps; write the "
                         "kernel tables to TABLE and TABLE's name + _train")
    a = ap.parse_args()

    smi = phase_device()
    phase_build()
    fwd = phase_kernel()
    bwd = phase_kernel_bwd()
    fused = phase_fused_update()
    phase_model()
    sample_launches = phase_sample(a.steps, a.profile)
    train_launches, fused_launches = phase_train(a.profile)
    by_path = {k: {"sample": sample_launches.get(k, 0), "train": train_launches[k],
                   "train_fused_optimizer": fused_launches[k]} for k in _build.launch_counts}
    for name, runs in by_path.items():
        if not sum(runs.values()):
            raise AssertionError(f"kernel {name} was launched no time on the main paths")

    def entry(name, source, replaces, row, err=None):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path[name].values()), "launches_by_path": by_path[name],
                "max_abs_err": row["max_abs_err"] if err is None else err,
                "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"]}

    emit({"kernels": [
        entry("attention_fwd", "fast_dit_torch/csrc/flash_attention_fwd.cu",
              "fast_dit_tpu/ops/flash_attention.py:119", fwd),
        entry("attention_bwd", "fast_dit_torch/csrc/flash_attention_bwd.cu",
              "fast_dit_tpu/ops/flash_attention.py:185", bwd),
        entry("fused_adamw_ema", "fast_dit_torch/csrc/fused_update.cu",
              "fast_dit_tpu/ops/fused_update.py:138", fused,
              err=max(fused["max_abs_err"].values())),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
