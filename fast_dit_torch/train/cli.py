"""Train a DiT on pre-extracted latent features: the port's trainer CLI.

    python -m fast_dit_torch.train --synthetic-data --model DiT-XL/2 --global-batch-size 32
    python -m fast_dit_torch.train --device cpu --synthetic-data --model DiT-S/2 --max-steps 2
    torchrun --nproc_per_node 8 -m fast_dit_torch.train --fsdp --tp 2 --model DiT-XL/2

Counterpart of the repository's `train.py`, with its flags (`:252-335`) and
its log line "(step=...) Train Loss: ..., Train Steps/Sec: ...". Defaults
are the reference trainer's: bf16 activations over fp32 parameters, remat
on (the "nothing" policy), the 1000-step learned-sigma eps objective,
uniform t, label dropout 0.1, AdamW lr 1e-4 wd 0, EMA 0.9999 warm-started
as a copy. `--mixed-precision` stores bf16 parameters behind an fp32 master;
`--fused-optimizer` adds bf16 mu and runs the fused AdamW + EMA kernel;
with it, `--nu-dtype bf16` stores nu in bf16 and `--factored-nu` factors
it per JAX leaf. `--remat-policy` picks what the checkpointed blocks keep
("nothing", "attn", "attn_mlp"). `--objective flow` trains the
velocity-matching loss on `--flow-path` with a DiT built with
`learn_sigma=False`; `--schedule-sampler loss-second-moment` draws eps
timesteps by their loss history (not with flow, which draws continuous t).
A `DiT-MoE-*` model adds its router's load-balance and z-losses to the loss
(`--moe-aux-weight`, `--moe-z-weight`) and logs them with the share of
dropped (token, choice) slots. `--native-loader` reads the feature files
through the C++ loader (`data/native_loader.py`), with the same batches.

Checkpoints are `torch.save` files in the reference trainer's layout,
`{"model", "ema", "opt", "args"}` under the reference torch names, plus the
step, the timestep sampler's state and the generator's
(`ckpt/checkpoint.py`), every `--ckpt-every` steps and at the end;
`--export-pt` also writes the EMA state dict alone. `--resume` re-enters the
latest experiment dir of the model, restores its latest checkpoint and
continues the step count; as in JAX (`train.py:126-156`), the data
iterator starts again at epoch 0 and no batch is skipped. Runs on the card
unless `--device cpu` is given.

Under `torchrun` (RANK, WORLD_SIZE, LOCAL_RANK: one rank per card, NCCL;
gloo with `--device cpu`) the trainer runs on a mesh of the ranks, as
`train.py:56-82` does: `--tp N` makes a ('data', 'model') mesh and splits
the blocks' attention heads and MLP width over N ranks, `--ep N` a ('data',
'expert') mesh that splits a DiT-MoE model's experts, `--fsdp` shards every
parameter and its optimizer state over the data axis
(`parallel/mesh.py`); the data axis has world / max(tp, ep) ranks, and
the global batch must split over data x grad_accum. Each rank reads its data
index's rows (the loaders' process index and count are the data rank and
size; synthetic latents are the global batch's rows). Rank 0 alone makes
the experiment directory, logs to files and writes the checkpoints (every
rank takes part in gathering them); a SIGTERM on any rank stops every rank
at the same step boundary, through a flag all-reduced on a gloo group of
its own. `--export-pt` is skipped in a world of more than one, with JAX's
warning. `--scan-unroll` is accepted and has no effect (the blocks are a
Python loop, not a scan).
"""

from __future__ import annotations

import argparse
import math
import os
import signal
import time

import torch
import torch.distributed as dist

from ..ckpt import CheckpointManager
from ..data import FeatureDataset, NativeFeatureLoader, feature_batches, synthetic_features
from ..diffusion import create_diffusion, create_named_schedule_sampler
from ..models import REMAT_POLICIES, DiT_models
from ..ops.attention import BACKENDS
from ..parallel.collectives import all_reduce
from ..parallel.mesh import batch_rows, create_expert_mesh, create_mesh, shard_params
from ..utils.device import resolve_device
from ..utils.logging import create_logger, find_latest_experiment_dir, make_experiment_dir
from ..utils.platform import broadcast_string, destroy_distributed, maybe_initialize_distributed
from .train_lib import create_train_state, ema_state_dict, make_sharded_train_step

__all__ = ["parse_args", "check_args", "make_mesh", "build", "device_batches", "main"]


def check_args(args, world: int = 1) -> None:
    """Raise SystemExit with JAX's message for flags that contradict each
    other or do not fit a world of `world` ranks."""
    if args.ep > 1:
        if args.tp != 1:
            raise SystemExit("fast_dit_torch.train: --tp and --ep are mutually exclusive meshes")
        experts = DiT_models[args.model].keywords.get("moe_experts", 0)
        if experts % args.ep or experts < args.ep:
            raise SystemExit(f"fast_dit_torch.train: --ep {args.ep} must divide the model's "
                             f"expert count ({experts}); pick a DiT-MoE-* model")
    inner = max(args.tp, args.ep)
    if world % inner:
        axis = "expert" if args.ep > 1 else "model"
        raise SystemExit(f"fast_dit_torch.train: {world} ranks not divisible by "
                         f"{axis}={inner}")
    n_data = world // inner
    if args.global_batch_size % (n_data * args.grad_accum):
        raise SystemExit(f"fast_dit_torch.train: global batch {args.global_batch_size} must be "
                         f"divisible by data-axis size {n_data} x grad_accum {args.grad_accum}")
    if (args.nu_dtype != "fp32" or args.factored_nu) and not args.fused_optimizer:
        raise SystemExit("fast_dit_torch.train: --nu-dtype and --factored-nu are "
                         "fused-optimizer features; add --fused-optimizer")
    if args.objective == "flow" and args.schedule_sampler != "uniform":
        raise SystemExit("fast_dit_torch.train: --schedule-sampler is discrete-time; "
                         "--objective flow draws continuous t")
    if args.image_size % 8:
        raise SystemExit("fast_dit_torch.train: image size must be divisible by 8")


def make_mesh(args):
    """The mesh of `train.py:70-82` over this process's world (one rank
    when there is no `torch.distributed` world)."""
    if args.ep > 1:
        return create_expert_mesh(args.ep)
    return create_mesh(model=args.tp)


def build(args, mesh=None, device=None):
    """(model, diffusion, state, train_step) on `device` (default
    `args.device`): the seeded model (a flow model predicts the velocity,
    with no learned-sigma channels), sharded on `mesh` (default: the world's,
    `make_mesh`), the 1000-step training process, the optimizer route, the
    timestep sampler and the step, whose draws come from a generator seeded
    with --global-seed (the state carries it)."""
    device = resolve_device(args.device) if device is None else device
    mesh = make_mesh(args) if mesh is None else mesh
    model = DiT_models[args.model](
        input_size=args.image_size // 8, num_classes=args.num_classes,
        learn_sigma=args.objective == "eps",
        dtype=torch.float32 if args.fp32 else torch.bfloat16,
        attn_backend=args.attn_backend, remat=not args.no_remat,
        remat_policy=args.remat_policy, device=device, seed=args.global_seed)
    shard_params(model, mesh, tp=args.tp > 1, fsdp=args.fsdp)
    model.train()
    diffusion = create_diffusion("", device=device)
    sampler_state = (None if args.schedule_sampler == "uniform" else
                     create_named_schedule_sampler(args.schedule_sampler,
                                                   diffusion.num_timesteps, device))
    generator = torch.Generator(device=device).manual_seed(args.global_seed)
    state = create_train_state(model, lr=None if args.fused_optimizer else args.lr,
                               mixed_precision=args.mixed_precision,
                               fused_optimizer=args.fused_optimizer,
                               nu_dtype=torch.bfloat16 if args.nu_dtype == "bf16" else None,
                               factored_nu=args.factored_nu, sampler_state=sampler_state,
                               generator=generator)
    train_step = make_sharded_train_step(
        model, diffusion.schedule, mesh, ema_decay=args.ema_decay, grad_accum=args.grad_accum,
        lr=args.lr, objective=args.objective, flow_path=args.flow_path, generator=generator,
        moe_aux_weight=args.moe_aux_weight, moe_z_weight=args.moe_z_weight)
    return model, diffusion, state, train_step


def device_batches(args, device, logger=None, mesh=None):
    """One iterator of {"x", "y"} batches on `device` per epoch: synthetic
    latents (one endless epoch) or the feature files, read by the Python
    loader or, with --native-loader, the C++ one; on a `mesh`, the rows of
    this rank's data index."""
    latent_size = args.image_size // 8
    part = {} if mesh is None else {"process_index": mesh.data_rank,
                                    "process_count": mesh.data}
    if args.synthetic_data:
        rows = slice(None) if mesh is None else batch_rows(mesh, args.global_batch_size)
        epochs = [({k: v[rows] for k, v in b.items()} for b in synthetic_features(
            args.global_batch_size, latent_size=latent_size, num_classes=args.num_classes,
            seed=args.global_seed))]
        if logger:
            logger.info("Using synthetic latent features")
    else:
        feat_dir = f"{args.feature_path}/imagenet{args.image_size}_features"
        label_dir = f"{args.feature_path}/imagenet{args.image_size}_labels"
        dataset = FeatureDataset(feat_dir, label_dir)
        if logger:
            logger.info(f"Dataset contains {len(dataset):,} features ({args.feature_path})")
        if args.native_loader:
            epochs = (NativeFeatureLoader(feat_dir, label_dir, args.global_batch_size,
                                          seed=args.global_seed + e, num_epochs=1,
                                          num_threads=args.num_workers, **part)
                      for e in range(args.epochs))
            if logger:
                logger.info("Using the native C++ feature loader")
        else:
            epochs = [feature_batches(dataset, args.global_batch_size,
                                      seed=args.global_seed + e, num_epochs=1, **part)
                      for e in range(args.epochs)]
    for batches in epochs:
        yield ({"x": torch.from_numpy(b["x"]).to(device, non_blocking=True),
                "y": torch.from_numpy(b["y"]).long().to(device, non_blocking=True)}
               for b in batches)


def main(args) -> None:
    try:
        device = resolve_device(args.device)
        world, rank, device = maybe_initialize_distributed(device)
    except RuntimeError as e:
        raise SystemExit(f"fast_dit_torch.train: {e}") from None
    try:
        _train(args, world, rank, device)
    finally:
        destroy_distributed()


def _train(args, world: int, rank: int, device: torch.device) -> None:
    check_args(args, world)
    if args.matmul_precision != "default":
        torch.set_float32_matmul_precision(args.matmul_precision)
    is_main = rank == 0
    # rank 0 makes the dir (--resume re-enters the latest one instead); every
    # rank learns the same path
    experiment_dir = None
    if is_main:
        experiment_dir = ((find_latest_experiment_dir(args.results_dir, args.model)
                           if args.resume else None)
                          or make_experiment_dir(args.results_dir, args.model))
    experiment_dir = broadcast_string(experiment_dir)
    checkpoint_dir = f"{experiment_dir}/checkpoints"
    logger = create_logger(experiment_dir if is_main else None, is_main=is_main)
    logger.info(f"Experiment directory created at {experiment_dir}")

    mesh = make_mesh(args)
    model, diffusion, state, train_step = build(args, mesh, device)
    n_params = sum(math.prod(s.full_shape) for s in model.sharding.shards)
    logger.info(f"DiT Parameters: {n_params:,}")
    if world > 1:
        logger.info(f"Mesh: {mesh.shape} over {world} ranks (tp={args.tp}, ep={args.ep}, "
                    f"fsdp={args.fsdp})")
    ckpt = CheckpointManager(checkpoint_dir)
    if args.resume and ckpt.latest_step() is not None:
        ckpt.restore(state)
        logger.info(f"Resumed from checkpoint at step {state.step}")
    # the data starts again at epoch 0 after a resume, as in JAX
    epochs = device_batches(args, device, logger, mesh)
    # the ranks agree on stopping at a step boundary through a CPU flag, so
    # that no rank waits in a collective another has left
    control = dist.new_group(backend="gloo") if world > 1 else None

    profiler = None
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                         else [])
        profiler = profile(activities=acts)
        profiler.__enter__()

    train_steps, log_steps = state.step, 0
    running_loss = torch.zeros((), device=device)
    moe_keys = ("moe_load_balance", "moe_router_z", "moe_dropped_frac")
    running_moe = torch.zeros(len(moe_keys), device=device)
    start_time = time.time()
    logger.info(f"Training for {args.epochs} epochs...")

    # a SIGTERM or SIGINT mid-run checkpoints before the process exits
    preempted = {"flag": False}

    def _on_signal(signum, frame):
        logger.info(f"Received signal {signum}; checkpointing before exit...")
        preempted["flag"] = True

    old_handlers = {s: signal.signal(s, _on_signal) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        done = False
        for epoch, batches in enumerate(epochs):
            logger.info(f"Beginning epoch {epoch}...")
            for batch in batches:
                metrics = train_step(state, batch)
                running_loss += metrics["loss"]
                if moe_keys[0] in metrics:
                    running_moe += torch.stack([metrics[k] for k in moe_keys])
                train_steps += 1
                log_steps += 1
                if train_steps % args.log_every == 0:
                    avg_loss = running_loss.item() / log_steps  # waits for the card
                    end_time = time.time()
                    steps_per_sec = log_steps / (end_time - start_time)
                    logger.info(f"(step={train_steps:07d}) Train Loss: {avg_loss:.4f}, "
                                f"Train Steps/Sec: {steps_per_sec:.2f}")
                    if moe_keys[0] in metrics:
                        lb, zl, dropped = (running_moe / log_steps).tolist()
                        logger.info(f"(step={train_steps:07d}) MoE Load Balance: {lb:.4f}, "
                                    f"Router Z: {zl:.4f}, Dropped Frac: {dropped:.4f}")
                        running_moe.zero_()
                    running_loss.zero_()
                    log_steps = 0
                    start_time = time.time()
                if train_steps % args.ckpt_every == 0:
                    logger.info(f"Saved checkpoint to {ckpt.save(train_steps, state, args)}")
                stop = preempted["flag"]
                if control is not None:
                    stop = all_reduce(torch.tensor([float(stop)]), control).item() > 0
                if stop or (args.max_steps and train_steps >= args.max_steps):
                    done = True
                    break
            if done:
                break
    finally:
        for s, h in old_handlers.items():
            signal.signal(s, h)

    if profiler is not None:
        profiler.__exit__(None, None, None)
        os.makedirs(args.profile_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(args.profile_dir,
                                                  f"trace{'' if is_main else rank}.json"))
        logger.info(f"Wrote profiler trace to {args.profile_dir}")
    logger.info(f"Saved checkpoint to {ckpt.save(train_steps, state, args)}")
    if args.export_pt and world > 1:
        logger.warning("--export-pt skipped: the export needs a full local copy of the EMA "
                       "and runs in a world of one process; the step's checkpoint holds "
                       "the full EMA under \"ema\"")
    elif args.export_pt:
        torch.save(ema_state_dict(state), f"{checkpoint_dir}/{train_steps:07d}-ema.pt")
        logger.info(f"Exported the EMA state dict at step {train_steps}")
    logger.info("Done!")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # reference-compatible flags
    parser.add_argument("--feature-path", type=str, default="features")
    parser.add_argument("--results-dir", type=str, default="results")
    parser.add_argument("--model", type=str, choices=list(DiT_models), default="DiT-XL/2")
    parser.add_argument("--image-size", type=int, choices=[256, 512], default=256)
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--epochs", type=int, default=1400)
    parser.add_argument("--global-batch-size", type=int, default=256)
    parser.add_argument("--global-seed", type=int, default=0)
    parser.add_argument("--vae", type=str, choices=["ema", "mse"], default="ema")
    parser.add_argument("--num-workers", type=int, default=4)
    parser.add_argument("--log-every", type=int, default=100)
    parser.add_argument("--ckpt-every", type=int, default=50_000)
    # the JAX trainer's extensions
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--ema-decay", type=float, default=0.9999)
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel ranks per data index (a ('data', 'model') mesh)")
    parser.add_argument("--moe-aux-weight", type=float, default=1e-2,
                        help="load-balance aux-loss weight (DiT-MoE-* models)")
    parser.add_argument("--moe-z-weight", type=float, default=1e-3,
                        help="router z-loss weight (DiT-MoE-* models)")
    parser.add_argument("--ep", type=int, default=1,
                        help="expert-parallel ranks per data index (DiT-MoE-* models; a "
                             "('data', 'expert') mesh)")
    parser.add_argument("--fsdp", action="store_true",
                        help="shard parameters and optimizer state over the data axis")
    parser.add_argument("--grad-accum", type=int, default=1)
    parser.add_argument("--fp32", action="store_true", help="disable bf16 activations")
    parser.add_argument("--no-remat", action="store_true",
                        help="disable per-block gradient checkpointing")
    parser.add_argument("--remat-policy", type=str, default="nothing",
                        choices=list(REMAT_POLICIES),
                        help="what the backward keeps instead of recomputing: nothing, the "
                             "attention branch output (attn), or both branch outputs "
                             "(attn_mlp)")
    parser.add_argument("--attn-backend", type=str, default="auto", choices=BACKENDS,
                        help="auto: the CUDA kernels on the card; einsum: the plain version")
    parser.add_argument("--scan-unroll", type=int, default=1,
                        help="accepted for compatibility; no effect in the port")
    parser.add_argument("--objective", type=str, default="eps", choices=["eps", "flow"],
                        help="eps: the learned-sigma DDPM loss; flow: velocity matching "
                             "(a learn_sigma=False DiT, sampled with euler/heun)")
    parser.add_argument("--flow-path", type=str, default="linear", choices=["linear", "gvp"])
    parser.add_argument("--synthetic-data", action="store_true")
    parser.add_argument("--schedule-sampler", type=str, default="uniform",
                        choices=["uniform", "loss-second-moment"],
                        help="timestep draw of the eps objective: uniform, or by each "
                             "timestep's loss history")
    parser.add_argument("--mixed-precision", action="store_true",
                        help="bf16 params + fp32 master weights")
    parser.add_argument("--fused-optimizer", action="store_true",
                        help="bf16 params, bf16 mu, fp32 nu/master/EMA updated by the "
                             "fused AdamW + EMA kernel")
    parser.add_argument("--nu-dtype", type=str, default="fp32", choices=["fp32", "bf16"],
                        help="Adam second-moment storage under --fused-optimizer (bf16 "
                             "halves it)")
    parser.add_argument("--factored-nu", action="store_true",
                        help="Adafactor-style factored second moment for the large leaves "
                             "(--fused-optimizer)")
    parser.add_argument("--max-steps", type=int, default=0)
    parser.add_argument("--resume", action="store_true",
                        help="continue the latest experiment dir of --model from its latest "
                             "checkpoint")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="write a torch.profiler chrome trace here")
    parser.add_argument("--matmul-precision", type=str, default="default",
                        choices=["default", "high", "highest"],
                        help="fp32 matmul precision: 'high' allows TF32; 'default' "
                             "leaves torch's setting")
    parser.add_argument("--native-loader", action="store_true",
                        help="read the feature files with the C++ loader "
                             "(native/dataloader.cc, built with g++ at first use)")
    parser.add_argument("--export-pt", action="store_true",
                        help="also save the EMA state dict alone at the end")
    # the port's own
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)
