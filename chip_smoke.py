"""Drive the PyTorch port on one NVIDIA card and hold its kernels against
their plain versions.

    python3 chip_smoke.py              # sampling: DiT-XL/2 256², bf16, CFG 4.0, 50 DDPM
                                       # steps; training: DiT-XL/2, batch 32, 10 steps
    python3 chip_smoke.py --steps 250  # the reference sampling step count
    python3 chip_smoke.py --profile out/profile.txt  # also torch.profiler breakdowns of
                                       # four sampling steps (table to that file), the fp32
                                       # decode of 8 latents (out/profile_vae.txt), two
                                       # training steps (out/profile_train.txt), two
                                       # sequence-parallel sampling steps (out/profile_seq.txt)
                                       # and one sequence-parallel gradient step
                                       # (out/profile_seq_grad.txt), and each fast-sampler
                                       # chain (out/profile_<chain>.txt: _dpm, ...)

Phases, one JSON line each or more; any failure raises and the exit code is
nonzero:
 1. device:       CUDA must be present; the card's name and power limit; TF32 off.
 2. build:        nvcc builds every kernel of both paths from `fast_dit_torch/csrc`;
                  ptxas's spill bytes per library, and the registers and spills
                  of the bf16 attention kernels at hd 72.
 3. kernel:       the attention forward against its plain version, fp32 and bf16,
                  at the sampling and training shapes, at 1024 tokens, at a
                  ragged S and at large logits (past 50), with its time, the
                  plain version's, SDPA's (timed only), the bound, and the
                  kernel's time over SDPA's (x_library) and over the bound (x_bound).
 4. kernel_bwd:   the attention backward the same way, at the training shape, at
                  1024 tokens, at a ragged S and at large logits, with the fused
                  SDPA backward op alone timed beside it (flash attention's in
                  bf16, the memory-efficient one in fp32, given one forward's
                  output and LSE).
 5. fused_update: the fused AdamW + EMA kernel against `_update_math` over the
                  whole DiT-XL/2 parameter tree for 3 steps, with the fused
                  `torch.optim.AdamW` step timed beside it; then its bf16-nu
                  instantiation the same way.
 6. model:        full DiT-XL/2 fp32, one forward_with_cfg through the kernel and
                  through the einsum plain version on the card.
 7. vae:          the full-width SD-VAE (83.7 M parameters) from a random diffusers
                  `.bin` through the port's importer: encode moments and decode card
                  vs CPU in fp32 with TF32 off; then device times of the decode of 8
                  latents to 256² (fp32, fp32 with TF32, bf16), of 4 to 512² and of
                  the encode of 8 256² images, each with its FLOPs (counted from the
                  layer shapes), TFLOP/s, bound and peak memory.
 8. sample:       a small model sampled on the card and on the CPU with the same
                  noise must agree; then the sampling main path, the sampler CLI's
                  own functions at full DiT-XL/2 width and depth, with the forward
                  kernel's launch count checked at exactly depth x steps, then the
                  fp32 decode of the 8 latents and the PNG grid.
 9. samplers:     the fast samplers at the sampling path's width (DiT-XL/2 256², bf16,
                  CFG 4.0, 8 labels): DPM-Solver++ at 20 steps, UniPC at 10 with Karras
                  spacing, DDPM at 50 with the guidance interval [0.28, 5.42], and a
                  flow model (learn_sigma=False, cut to CUT_DEPTH = 7 blocks) with Euler
                  at 20 and Heun at 10, each
                  chain run through the sampler CLI's functions under
                  torch.cuda.set_sync_debug_mode("error") (no host sync in a step),
                  with s/step, images/s, model evaluations, kernel-1 launches exactly
                  depth x evaluations and, for the interval, the guided steps exactly
                  `guided_steps_korder`'s; the FORA layer cache: DDPM 50 with
                  --cache-interval 2, DDIM 50 with interval 3 and --cache-schedule
                  logsnr, DDPM 50 with the guidance interval and interval 2, kernel-1
                  launches exactly depth x refresh steps; the DPM chain also through
                  `sample_latents` and the fp32 decode; and first each new loop on a
                  small fp32 model, card against CPU.
9b. tome:         token merging: kernel 1 against its plain version at the ragged S
                  ToMe makes at 256² (180 at ratio 0.3, 128 at 0.5), fp32 and bf16; small
                  fp32 ToMe models card vs CPU (1e-4 x max); then DiT-XL/2 cut to 7
                  blocks at cell 1's shape with --tome-ratio 0.3, 0.5, 0.5 --tome-mlp
                  and 0.5 --cache-interval 2 through the sampler CLI's functions (sync
                  debug mode "error", kernel-1 launches exactly depth x refresh steps),
                  each profiled, with max |delta| of the final latents against the
                  exact chain of the same cut model, run once before 9b (same weights
                  and noise): recorded, not bounded.
9c. quant:        W8A8: the int8 GEMM at DiT-XL/2's four projection shapes equal to an
                  fp32 matmul of its int8 operands (every partial sum below 2^24) and
                  timed against the bf16 F.linear; small fp32 quantised models card vs
                  CPU (1e-2 x max: a one-ulp difference before a quantiser may move an
                  int8 code by one step); then DiT-XL/2 with --quantize w8a8, alone and
                  with --cache-interval 2, as in 9b, with the drift against the bf16 chain.
10. sample_ddp:   the FID harness's own main at full width (XL/2 256² cut to 7 blocks,
                  the random VAE, 16 images, 10 steps, CFG 1.5): the npz equals its PNGs, the
                  forward kernel launches exactly depth x steps x batches times.
11. extract:      feature extraction's per-batch functions on 16 seeded 256² images:
                  (1, 4, 32, 32) finite features that the trainer's dataset reads.
12. train:        a small model trained 2 steps on the card and on the CPU with the
                  same weights and draws must agree, with the eps and the flow
                  objective; then the training main path, the trainer CLI's own
                  functions at full DiT-XL/2 width and depth (batch 32, bf16, remat),
                  with the launch counts checked at exactly 2 x depth x steps
                  (forward, run again by remat) and depth x steps (backward); then,
                  cut to 7 blocks, the same with --fused-optimizer, one fused-update
                  launch per
                  parameter leaf per step, with --objective flow and with
                  --schedule-sampler loss-second-moment, with --no-remat, with the remat
                  policies attn and attn_mlp, and with --fused-optimizer and a bf16 or a
                  factored nu, these seven under torch.cuda.set_sync_debug_mode("error")
                  (no host sync in a step); each with the optimizer's device time and
                  the peak of allocated memory; first a small model card vs CPU under
                  each remat policy and nu kind; last --native-loader on the feature
                  folder phase `extract` wrote: every batch equal to the Python loader's,
                  then 2 steps after 1 on it (7 blocks).
12a. moe:         the DiT-MoE family: a small fp32 MoE model card vs CPU (a chain, 1e-4
                  x max; two train steps: loss 1e-5 relative, gradients 1e-4 of max, the
                  same kept (choice, token) masks); kernel 3 against `_update_math` over
                  the MoE tree at full width and depth 4, both nu dtypes, every element
                  equal; DiT-MoE-XL/2-8E2A (8 experts, top-2; 2.76 G parameters at its
                  28 blocks) cut to 7 blocks sampling cell 1's chain through the sampler
                  CLI's functions (launches exact, profiled, the capacity's dropped
                  share) and `sample_latents`; then the trainer CLI's functions at
                  batch 32, bf16, remat "nothing", 3 steps after 2 under sync debug mode
                  "error", cut to 7 blocks: with --fused-optimizer (one fused-update
                  launch per parameter leaf per step) and the default AdamW route (24
                  bytes a parameter: 62 GiB at full depth before AdamW's temporaries).
12b. resume:      DiT-XL/2's width at depth 4, every optimizer route and nu kind with
                  warmed-up loss-second-moment t: 2 steps, save, 2 more, against a
                  state from another seed that restores the file and runs the same 2
                  batches (every tensor equal); file size, save and restore seconds;
                  then the trainer CLI's own --resume (DiT-S/2).
12c. train_parallel: the parallel trainer, its ranks processes on cuda:0 joined over
                  gloo (NCCL refuses two ranks on one GPU): kernel 3 over the local
                  leaves of an FSDP-2 rank of DiT-XL/2, every element equal to
                  `_update_math`; small fp32 routes (DiT-S/2, DiT-MoE-S/2-8E2A at 256²,
                  depth 4, batch 8, 2 steps: DP 2 with AdamW, fused fp32, bf16 and factored nu,
                  loss-second-moment t and grad-accum 2, FSDP 2, TP 2, EP 2; TP 2 + FSDP
                  and EP 2 + FSDP on 4 ranks; the small DiTNVS of the CPU tests, 2 heads
                  of 16, with the fused optimizer: DP 2 with grad-accum 2 and the
                  dino_feat key, FSDP 2, TP 2, kernels 1, 2 and 3 launched exactly on
                  every rank, under the path train_parallel_nvs) against one process
                  on the card, to the CPU tests' limits, ranks that hold the same part
                  of a parameter holding the same bytes (the worlds of 2 and 4 at once,
                  beside their references); the trainer CLI's functions at DiT-XL/2 cut to 4
                  blocks, batch 32, bf16, remat "nothing", --fused-optimizer, 2 steps
                  after 1 under sync debug mode "error" (the gloo collectives exempt),
                  with DP 2, FSDP 2, TP 2, and DiT-MoE-XL/2-8E2A cut to 4 with EP 2: losses
                  within 2e-2 of one process, launches exact per rank, s/step, peak
                  memory, collective ms, DP 2's step profiled; then the CLI's main at world
                  1 over NCCL (4 blocks). Kernels 1 and 2 at the ranks' shapes, (16,256,16,72) and
                  (32,256,8,72), are in phases 3 and 4.
13. ring_kernel:  the ring-attention hop forward against its plain version, fp32 and
                  bf16, at the sequence-parallel 512² shape, at a 4096-token ring's
                  shard, at a ragged Sq != Sk and at logits past the clamp, with its
                  time, the plain version's, the flash attention call's (timed only)
                  and the bound; bf16 rows also time the fp32-core body on the same
                  inputs (parent_ms, dtype code 2, which no wrapper passes).
14. ring_kernel_bwd: the hop backward the same way, with the fused SDPA backward op
                  alone timed beside it, as in kernel_bwd.
15. seq_parallel: sequence-parallel DiT-XL/2 at 512², cut to 14 blocks, over
                  LocalRing(4): a small model
                  on the card against the CPU; the full model's forward against its
                  unsharded forward, fp32 and bf16; DDPM sampling over the sharded
                  forward; the gradient of sum(out^2) against the unsharded model's;
                  the hop kernels' launch counts checked exactly.
16. pipeline:     GPipe over the block stack: a small fp32 DiT-S/2 (depth 4) through
                  LocalStages(2) on the card against the CPU, forward and gradient;
                  DiT-XL/2 256², bf16, batch 32 in 4 microbatches over LocalStages(4)
                  (7 blocks a stage): the forward against `model(x, t, y)` (2e-2 x max),
                  the gradient of a mean-squared loss against the unpipelined model's
                  (2e-2 x max per leaf), kernel 1 launched exactly 28 x 4 times by a
                  forward and kernel 2 28 x 4 times by its backward; wall and device ms
                  per forward and per forward + backward against the unpipelined model,
                  peak memory, kernels 1 and 2 at the microbatch shape (8,256,16,72);
                  two ProcessGroupStages ranks (processes on the one card over gloo,
                  started first and run beside the above) drive a small fp32 DiT-S/2
                  256² (depth 4, 2 blocks each, each rank holding only its own blocks):
                  forward, gradient and a PipeFusion chain against LocalStages(2) in
                  one process (1e-5 x max, gradient leaves 1e-4 x max), launches exact
                  per rank, with the transport's seconds; no scaling number; the same
                  ranks rotate CUDA tensors around ProcessGroupRing (host buffers:
                  gloo's send and recv fail on CUDA tensors).
17. pipefusion:   PipeFusion sampling: the CPU tests' tiny model chunked with CFG on the
                  card against the CPU; DiT-XL/2 256², bf16, CFG 4.0, 8 labels, DDIM 50,
                  LocalStages(4), under sync debug mode "error": the one-chunk forward
                  against the model's (2e-2 x max), the one-chunk chain against
                  `ddim_sample_loop` over `forward_with_cfg` (relative distance 2e-2: two
                  exact bf16 chains with other attention ops part by about that much over
                  50 guided steps, measured beside it with the plain attention), 4
                  chunks of 64 tokens (warmup 1) with their relative distance from the
                  exact chain (recorded, not bounded; the chunks read the step's input
                  cache, as JAX's code does); s/step, images/s, the K/V cache's bytes,
                  peak memory; the pipeline ranks' chunked chains of their small model
                  (1 exact step, 3 chunked) against LocalStages(2)'s.
18. nvs:          the NVS model, DiTNVS-XL/2 (DiT-XL/2 with a gated cross-attention
                  against 16 x 16 DINO tokens of 768 dims at layers 13 and 15, random
                  seeded weights, `random_dino_features` as the context): a small fp32
                  DiTNVS card vs CPU (forward_with_cfg, DDPM and RePaint chains, 1e-4 x
                  max); at 256², bf16, CFG 4.0, 8 labels (batch 16): one evaluation
                  through the kernels against the plain attention (2e-2 x max) launching
                  kernel 1 exactly 28 + 2 times (the cross-attention packs q, k, v,
                  256 tokens each); the separate-q/k/v call timed against the packed
                  kernel; DDPM sampling (nvs_sample) and RePaint inpainting of (16, 4, 32,
                  32) latents with a seeded hole mask and jump_n 2 (nvs_inpaint, the
                  known region equal in every element), both under sync debug mode
                  "error", kernel 1 exactly 30 a model evaluation; training through
                  make_train_step(model_call=...) with a dino_feat batch key, batch 32,
                  bf16 over fp32 masters, the fused optimizer with weight decay, 2 steps
                  after 1 (nvs_train: kernels 1 and 2 exactly 30 a step, kernel 3 once a
                  tensor of JAX's leaves a step), an unused cross layer's to_q weight
                  equal in every state to `_update_math` with its zero gradient; then a
                  256² depth warp and epipolar attention on (2, 64, 32, 32) maps card vs
                  CPU (masks equal, values within 1e-5).
19. kernel_check: `fast_dit_torch.kernel_check` on the card: kernels 1 and 2 at S =
                  256, 512, 1024, 2048 and 4096 (B = 2 up to 1024, then 1; 16 heads of 72;
                  fp32 and bf16; at 256 also the inference call) and kernels 4 and 5 on one
                  shard at 1024, 2048 and 4096 (fp32 and bf16), forward and input gradients
                  against softmax attention in float64 on the card: fp32 within 2e-5, bf16
                  within 5e-2, absolute; one line a case with the kernels' ms.
20. parity:       `fast_dit_torch.parity_check` replays both bundles recorded from the
                  reference sampler (tests/fixtures: DDPM and DDIM, 10 steps, depth 2, 4
                  heads of 8) through kernel 1 in fp32: within 2e-4 of the recorded
                  latents (JAX's limit), kernel 1 launched exactly depth x steps = 20 each.
21. validate:     `fast_dit_torch.validate_pretrained` at DiT-XL/2 256², full width and
                  depth, on a reference-layout `.pt` of the sampling path's weights (the
                  seeded init plus `sample.perturb_`, written after phase 8) and the random
                  full-width VAE: A (the port's forward against the functional oracle,
                  fp32, TF32 off) within 1e-3; B the VAE round trip; C the demo labels,
                  CFG 4.0, fp32, 50 DDPM steps (cut from 250: steps, not width); D
                  `sample_ddp` in bf16, 16 images in batches of 8, 50 steps, the npz of 16
                  256² images, the split-half FID of random weights (a mechanism check);
                  kernel 1 launched exactly 28 x (1 + 50 + 2 x 50) times.
Every phase line carries t_s (seconds since the start) and phase_s (seconds since
its phase of `main` began). Then the `timing` line, {"timing": {phase: wall
seconds}, "total_s": s}; the `kernels` line, the nvidia-smi line, and the final
status line. The whole script is held to 600 s on the H100 (PERF.md, Cells):
depth is cut where a run repeats a shape that another run drives at full depth
(CUT_DEPTH, MOE_TRAIN_DEPTH, PAR_DEPTH, PAR_EP_DEPTH, SEQ_DEPTH). Kernel,
plain and library times are device times: `cuda_ms` queues the timed calls behind
a spin of the device, so the host's time per call does not show in them.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from fast_dit_torch.models import DiT_models  # noqa: E402
from fast_dit_torch.ops import _build  # noqa: E402
from fast_dit_torch.ops.flash_attention import (  # noqa: E402
    _attention_qkv_bwd_plain, _attention_qkv_plain, _launch_bwd, _launch_fwd,
    flash_attention_qkv_flat)
from fast_dit_torch.ops import fused_update as fu  # noqa: E402
from fast_dit_torch.ops.quant import int8_matmul, int8_mm, quantize_cols, quantize_rows  # noqa: E402
from fast_dit_torch.ops.ring_attention import (  # noqa: E402
    _BWD_ARGS, _FWD_ARGS, _hop_backward_plain, _hop_forward_plain, _launch_hop_bwd,
    _launch_hop_fwd)
from fast_dit_torch.parallel import LocalRing, dit_sequence_parallel_forward  # noqa: E402
from fast_dit_torch import sample as cli  # noqa: E402
from fast_dit_torch import sample_ddp  # noqa: E402
from fast_dit_torch import kernel_check, parity_check, validate_pretrained  # noqa: E402
from fast_dit_torch.ckpt import CheckpointManager, load_vae  # noqa: E402
from fast_dit_torch.data import FeatureDataset, feature_batches  # noqa: E402
from fast_dit_torch.extract_features import encode_images, feature_dirs, write_features  # noqa: E402
from fast_dit_torch.models.vae import AttnBlock  # noqa: E402
from fast_dit_torch.utils.device import tf32  # noqa: E402
from fast_dit_torch.utils.image import decode_png, save_image  # noqa: E402
from fast_dit_torch.train import cli as train_cli  # noqa: E402
from fast_dit_torch.train import create_train_state, make_train_step  # noqa: E402
from fast_dit_torch.train import get_master_params, update_ema  # noqa: E402
from fast_dit_torch.diffusion.gaussian import training_losses  # noqa: E402
from fast_dit_torch.ckpt import jax_leaves  # noqa: E402
from fast_dit_torch.diffusion.sampling import p_sample_loop  # noqa: E402
from fast_dit_torch.nvs import DiTNVS, epipolar_attention, inpaint_sample_loop  # noqa: E402
from fast_dit_torch.nvs.dino import random_dino_features  # noqa: E402
from fast_dit_torch.models.pos_embed import get_2d_sincos_pos_embed  # noqa: E402
from fast_dit_torch.nvs import geometry as nvs_geometry  # noqa: E402
from fast_dit_torch.nvs import warp as nvs_warp  # noqa: E402
from fast_dit_torch.ops.attention import dot_product_attention  # noqa: E402
from fast_dit_torch.diffusion import (LossSecondMomentState, cache_refresh_mask,  # noqa: E402
                                      create_diffusion, flow_sample_loop,
                                      guidance_interval_cached_fns, guidance_interval_fn,
                                      guided_steps_korder)

# H100 SXM data sheet: HBM bytes/s, dense peak FLOP/s by input type ("tf32":
# fp32 inputs on the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12, "tf32": 495e12}
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# (8, 256, ...): the conditional half alone, an unguided step of the guidance interval
# (16, 256, 16, 72) is also a rank's shape under DP 2 and FSDP 2 at batch 32,
# (32, 256, 8, 72) a rank's under TP 2
KERNEL_SHAPES = [(16, 256, 16, 72), (8, 256, 16, 72), (32, 256, 16, 72), (16, 1024, 16, 72),
                 (2, 200, 6, 64), (32, 256, 8, 72)]
MAIN_SHAPE = (16, 256, 16, 72)  # DiT-XL/2 256², CFG batch of 8 labels
# the backward against its plain version, relative to max |dqkv|: fp32, sums
# of up to 1024 fp32 terms taken in other orders; bf16, one bf16 rounding of
# the output (2^-8) and delta formed from the bf16-rounded forward output
BWD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
BWD_SHAPES = [(32, 256, 16, 72), (16, 1024, 16, 72), (2, 200, 6, 64), (16, 256, 16, 72),
              (32, 256, 8, 72), (8, 256, 16, 72)]
TRAIN_SHAPE = (32, 256, 16, 72)  # DiT-XL/2 256², batch 32
# the large-logit case, at MAIN_SHAPE (forward) and TRAIN_SHAPE (backward): q
# and k scaled by 4, so the logits reach about 100, past the TPU's bf16 clamp
# at 50, and the row max decides the rows; v scaled by 1/4, so the output
# stays below 2 and the absolute limits stay the measure (see
# tests/test_torch_cuda.py::_qkv)
LARGE_QK, LARGE_V = 4.0, 0.25
TRAIN_ARGS = ["--model", "DiT-XL/2", "--synthetic-data", "--global-batch-size", "32",
              "--global-seed", "0"]
TRAIN_STEPS, FUSED_TRAIN_STEPS = 10, 3  # timed steps of the two training runs
# the depth of a run that repeats, at full width, a shape that another run of
# the script drives at full depth: the training routes beside the main one,
# the ToMe, W8A8 and MoE sampling chains, the flow samplers, sample_ddp's
# harness. Each DiT-XL/2 build takes about 10 s of host time (its init on the
# CPU), so depth, not the device, set most of the script's wall time
CUT_DEPTH = 7
LR = 1e-4
# the ring hop (B' = shards x batch, Sq, Sk, H, hd); errors relative to the
# largest output, fp32 and bf16 (the plain version computes in fp32 too)
RING_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
RING_SHAPES = [(16, 256, 256, 16, 72),    # DiT-XL/2 512², 4 shards, batch 4 (sampling)
               (8, 1024, 1024, 16, 72),   # 1024² over a 4-card ring: 4096 tokens
               (2, 200, 136, 6, 64)]      # ragged, Sq != Sk
RING_BWD_SHAPES = [(8, 256, 256, 16, 72)] + RING_SHAPES  # first: 512², batch 2 (gradient)
RING_CLAMP_SHAPE = (2, 200, 136, 6, 64)  # integer q, k: some logits pass 50, exactly
SEQ_N = 4                      # shards of the ring, the per-card shape of a 4-card ring
SEQ_SAMPLE_BATCH, SEQ_GRAD_BATCH, SEQ_GRAD_STEPS = 4, 2, 3
SEQ_SAMPLE_STEPS = 10           # DDPM steps of the sequence-parallel sampling path
SEQ_DEPTH = 14                  # DiT-XL/2 at 512² cut from 28 blocks: two builds a run
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
VAE_CHANNELS = (128, 256, 512, 512)  # the SD kl-f8 VAE (sd-vae-ft-ema / -mse)
# the VAE card vs CPU, fp32 with TF32 off, relative to the largest output
VAE_RTOL = 5e-4
DDP_ARGS = ["--model", "DiT-XL/2", "--ckpt", "random", "--per-proc-batch-size", "8",
            "--num-fid-samples", "16", "--num-sampling-steps", "10", "--cfg-scale", "1.5"]
EXTRACT_IMAGES, EXTRACT_BATCH = 16, 8
SAMPLER_ARGS = ["--model", "DiT-XL/2", "--ckpt", "random", "--bf16", "--cfg-scale", "4.0"]
CFG_INTERVAL = (0.28, 5.42)
# (name, the sampler CLI's flags, model evaluations of the chain)
SAMPLER_CHAINS = [
    ("dpm", ["--sampler", "dpm", "--num-sampling-steps", "20"], 20),
    ("unipc_karras", ["--sampler", "unipc", "--num-sampling-steps", "10",
                      "--time-spacing", "karras"], 10),
    ("ddpm_interval", ["--sampler", "ddpm", "--num-sampling-steps", "50", "--cfg-interval",
                       *map(str, CFG_INTERVAL)], 50),
    # the FORA layer cache: kernel 1 runs on the refresh steps only
    ("ddpm_cache2", ["--sampler", "ddpm", "--num-sampling-steps", "50",
                     "--cache-interval", "2"], 50),
    ("ddim_cache3_logsnr", ["--sampler", "ddim", "--num-sampling-steps", "50",
                            "--cache-interval", "3", "--cache-schedule", "logsnr"], 50),
    ("ddpm_interval_cache2", ["--sampler", "ddpm", "--num-sampling-steps", "50",
                              "--cfg-interval", *map(str, CFG_INTERVAL),
                              "--cache-interval", "2"], 50),
    ("flow_euler", ["--sampler", "euler", "--num-sampling-steps", "20"], 20),
    ("flow_heun", ["--sampler", "heun", "--num-sampling-steps", "10"], 20),  # 2 per step
]
FLOW_TRAIN_STEPS = LSM_TRAIN_STEPS = 3
# token merging at cell 1's shape: kernel 1 at S = 256 - r (r = 76 at ratio
# 0.3, 128 at 0.5), and the ToMe chains (name, the sampler CLI's flags)
TOME_SHAPES = [(16, 180, 16, 72), (16, 128, 16, 72)]
TOME_CHAINS = [("tome_0.3", ["--tome-ratio", "0.3"]), ("tome_0.5", ["--tome-ratio", "0.5"]),
               ("tome_0.5_mlp", ["--tome-ratio", "0.5", "--tome-mlp"]),
               ("tome_0.5_cache2", ["--tome-ratio", "0.5", "--cache-interval", "2"])]
QUANT_CHAINS = [("quant_w8a8", ["--quantize", "w8a8"]),
                ("quant_w8a8_cache2", ["--quantize", "w8a8", "--cache-interval", "2"])]
# the four W8A8 projections of DiT-XL/2 at cell 1's batch: (rows, in, out)
QUANT_GEMMS = {"qkv": (4096, 1152, 3456), "proj": (4096, 1152, 1152),
               "fc1": (4096, 1152, 4608), "fc2": (4096, 4608, 1152)}
# the MoE family at full width: 8 experts, top-2 (2.76 G parameters at its 28
# blocks); sampling and both training routes at CUT_DEPTH (the AdamW route's
# 24 bytes a parameter make 62 GiB at 28; the fused route took about 50 GiB
# and a minute of the script there; at 14 both took 23 s of the script's 600);
# kernel 3's check over the tree at depth 4 (depth repeats the same leaves)
MOE_MODEL = "DiT-MoE-XL/2-8E2A"
MOE_TRAIN_STEPS, MOE_TRAIN_DEPTH, MOE_ADAMW_DEPTH, MOE_FU_DEPTH = 3, CUT_DEPTH, CUT_DEPTH, 4
# (name, the trainer CLI's flags): the remat policies (and none, for peak
# memory) and the fused route's bf16 and factored nu, 3 timed steps after 2,
# each under sync debug mode "error"
TRAIN_MORE = [("no_remat", ["--no-remat"]),
              ("remat_attn", ["--remat-policy", "attn"]),
              ("remat_attn_mlp", ["--remat-policy", "attn_mlp"]),
              ("fused_nu_bf16", ["--fused-optimizer", "--nu-dtype", "bf16"]),
              ("fused_factored_nu", ["--fused-optimizer", "--factored-nu"])]
MORE_TRAIN_STEPS = 3
# the resume check: DiT-XL/2's width at depth 4 (28 blocks of fp32 model, EMA,
# mu and nu make an 11 GB file per route), batch 16, every route and nu kind
RESUME_DEPTH, RESUME_BATCH = 4, 16
# train_parallel: ranks are processes on cuda:0 over gloo. The small fp32
# checks (DiT-S/2 and DiT-MoE-S/2-8E2A at 256² cut to depth 4, and the small
# DiTNVS, batch 8, 2 steps, by world size; the worlds of 2 and 4 run at once,
# beside their one-process references); then DiT-XL/2 at full width cut to PAR_DEPTH,
# batch 32, bf16, remat "nothing", the fused optimizer, PAR_STEPS timed steps
# after PAR_WARMUP, with DP 2, FSDP 2 and TP 2, and the MoE cut to
# PAR_EP_DEPTH with EP 2; the main path's route (PAR_PROFILED) also profiled.
# gloo's host transport scales with the parameters' bytes: at full depth the
# routes took 231 s of the script's 808 on the H100, at depth 7 46 s of 528
# (PERF.md section 5)
PAR_TIMEOUT = 900
PAR_SMALL_BATCH, PAR_SMALL_STEPS = 8, 2
_S2, _MOE_S2 = ("DiT-S/2", {"depth": 4}), ("DiT-MoE-S/2-8E2A", {"depth": 4})
_NVS_S = ("DiTNVS", dict(input_size=8, patch_size=2, hidden_size=32, depth=3, num_heads=2,
                         num_classes=10, dino_dim=24, dino_patch_grid=4, cross_layers=(1,)))
PAR_SMALL = {
    2: [{"name": "dp2_adamw", "model": _S2, "mesh": ("model", 1)},
        {"name": "dp2_fused_nu_fp32", "model": _S2, "mesh": ("model", 1),
         "state": {"fused_optimizer": True}},
        {"name": "dp2_fused_nu_bf16", "model": _S2, "mesh": ("model", 1),
         "state": {"fused_optimizer": True, "nu_dtype": torch.bfloat16}},
        {"name": "dp2_fused_factored_nu", "model": _S2, "mesh": ("model", 1),
         "state": {"fused_optimizer": True, "factored_nu": True}},
        {"name": "dp2_loss_second_moment", "model": _S2, "mesh": ("model", 1), "lsm": True},
        {"name": "dp2_grad_accum_2", "model": _S2, "mesh": ("model", 1),
         "step": {"grad_accum": 2}},
        {"name": "fsdp2", "model": _S2, "mesh": ("model", 1), "fsdp": True},
        {"name": "tp2", "model": _S2, "mesh": ("model", 2), "tp": True},
        {"name": "ep2", "model": _MOE_S2, "mesh": ("expert", 2)},
        # the small DiTNVS of the CPU tests (2 heads of 16; cross-attention at
        # layer 1, 16 query and 16 DINO tokens), with the fused optimizer
        *({"name": f"nvs_{name}", "model": _NVS_S, "state": {"fused_optimizer": True}, **kw}
          for name, kw in (("dp2_grad_accum_2", {"mesh": ("model", 1),
                                                 "step": {"grad_accum": 2}}),
                           ("fsdp2", {"mesh": ("model", 1), "fsdp": True}),
                           ("tp2", {"mesh": ("model", 2), "tp": True})))],
    4: [{"name": "tp2_fsdp", "model": _S2, "mesh": ("model", 2), "tp": True, "fsdp": True},
        {"name": "ep2_fsdp", "model": _MOE_S2, "mesh": ("expert", 2), "fsdp": True}],
}
PAR_FULL = [("dp2", ["--fused-optimizer"]), ("fsdp2", ["--fused-optimizer", "--fsdp"]),
            ("tp2", ["--fused-optimizer", "--tp", "2"])]
PAR_DEPTH, PAR_EP_DEPTH = 4, 4
PAR_WARMUP, PAR_STEPS = 1, 2
PAR_PROFILED = ("dp2",)
PAR_LOSS_RTOL = 2e-2   # bf16 activations: one process and the world sum in other orders
# the pipeline: DiT-XL/2 256², bf16, batch 32 in 4 microbatches of 8 rows (the
# kernels' shape, PIPE_SHAPE) over 4 local stages, forward and gradient within
# 2e-2 x max (per leaf); PIPE_RANKS process stages on the one card drive a
# small fp32 DiT-S/2 256² (depth PIPE_RANK_DEPTH, PIPE_RANK_BATCH rows in
# PIPE_MICRO microbatches) against one process; PipeFusion: DDIM 50 with CFG
# 4.0 over 8 labels, 4 local stages, 4 chunks of 64 tokens after 1 exact step;
# the ranks' chains take PF_RANK_STEPS steps, the first exact
PIPE_STAGES, PIPE_BATCH, PIPE_MICRO, PIPE_RANKS = 4, 32, 4, 2
PIPE_SHAPE = (8, 256, 16, 72)
PIPE_ITERS = 2
PIPE_GRAD_RTOL = 2e-2
PIPE_RANK_DEPTH, PIPE_RANK_BATCH, PIPE_RANK_GRAD_RTOL = 4, 8, 1e-4
PF_STAGES, PF_CHUNKS, PF_STEPS, PF_WARMUP, PF_RANK_STEPS = 4, 4, 50, 1, 4
RESUME_ROUTES = [("adamw", {}), ("mixed_precision", {"mixed_precision": True}),
                 ("fused", {"fused_optimizer": True}),
                 ("fused_nu_bf16", {"fused_optimizer": True, "nu_dtype": torch.bfloat16}),
                 ("fused_factored_nu", {"fused_optimizer": True, "factored_nu": True})]


_T0 = time.perf_counter()
# DiTNVS-XL/2 (the NVS model at DiT-XL/2 width and depth): DINOv2 ViT-B/14 at
# 224² gives a 16 x 16 grid of 768-d tokens, as many as the image's at 256²/p2
NVS_CFG = dict(input_size=32, patch_size=2, in_channels=4, hidden_size=1152, depth=28,
               num_heads=16, num_classes=1000, dino_dim=768, dino_patch_grid=16,
               cross_layers=(13, 15))
NVS_BATCH = 16           # CFG batch of 8 labels
NVS_SAMPLE_STEPS = 10    # DDPM steps of the sampling chain
NVS_INPAINT_STEPS = 5    # RePaint steps, each of NVS_JUMP_N passes
NVS_JUMP_N = 2
NVS_TRAIN_BATCH, NVS_TRAIN_WARMUP, NVS_TRAIN_STEPS = 32, 1, 2
NVS_WD = 1e-2            # weight decay, so the unused cross layers' leaves move
# the validation kit: both committed reference bundles within
# JAX's parity limit (tests/test_parity_harness.py); validate_pretrained's C
# and D chains cut from 250 DDPM steps to VALIDATE_STEPS (depth, not width),
# D over VALIDATE_FID images
PARITY_BUNDLES = ("ddpm", "ddim")
PARITY_ATOL = 2e-4
VALIDATE_STEPS, VALIDATE_FID = 50, 16
REPO_DIR = os.path.dirname(os.path.abspath(__file__))
TIMING = {}  # phase of main -> its wall seconds, for the timing line
_PHASE_T0 = [_T0]  # when the phase of main now running began


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the seconds since start
    (t_s) and since the phase of main that emits it began (phase_s)."""
    if "phase" in obj:
        now = time.perf_counter()
        obj = {**obj, "t_s": now - _T0, "phase_s": now - _PHASE_T0[0]}
    print(json.dumps(obj), flush=True)


def timed(name, fn, *args, **kwargs):
    """`fn(*args, **kwargs)` as the phase `name` of main: its lines carry
    phase_s, and its wall seconds go into TIMING[name]."""
    _PHASE_T0[0] = time.perf_counter()
    out = fn(*args, **kwargs)
    TIMING[name] = time.perf_counter() - _PHASE_T0[0]
    return out


@contextlib.contextmanager
def cut_depth(model_name, depth):
    """`model_name` at full width cut to `depth` blocks, registered for the
    duration as `<model_name>-depth<depth>` in the model table the CLIs'
    `--model` reads; yields that name."""
    name = f"{model_name}-depth{depth}"
    DiT_models[name] = functools.partial(DiT_models[model_name], depth=depth)
    try:
        yield name
    finally:
        del DiT_models[name]


_spin_cycles_per_ms = None


def spin(ms) -> None:
    """Keep the device busy for about `ms` (torch.cuda._sleep, its clock
    calibrated on the first call)."""
    global _spin_cycles_per_ms
    if _spin_cycles_per_ms is None:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for _ in range(2):  # the second is timed
            start.record()
            torch.cuda._sleep(1 << 20)
            end.record()
            end.synchronize()
        _spin_cycles_per_ms = (1 << 20) / start.elapsed_time(end)
    torch.cuda._sleep(int(ms * _spin_cycles_per_ms))


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls. The timed
    calls are queued behind a spin of the device, twice as long as the host
    took to issue them, so the events time the device and not the host's
    own time per call (Python, checks, the allocator), which exceeds the
    device's for small calls."""
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    spin(min(2 * host_ms * iters + 1, 1000))
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


def ptxas_report(log):
    """Per kernel of one library's `ptxas -v` log: registers and spill bytes;
    and the library's total spill bytes (stores + loads)."""
    kernels, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            kernels[name] = {"registers": None, "spill_stores": 0, "spill_loads": 0}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            kernels[name]["spill_stores"] = int(m.group(1))
            kernels[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            kernels[name]["registers"] = int(m.group(1))
    spill = sum(k["spill_stores"] + k["spill_loads"] for k in kernels.values())
    return kernels, spill


def phase_build():
    t0 = time.perf_counter()
    libs = _build.build_all()
    seconds = time.perf_counter() - t0
    spill, bf16_hd72 = {}, {}
    for lib, path in libs.items():
        kernels, spill[lib] = ptxas_report(path.with_suffix(".log").read_text())
        # the attention kernels' bf16 bodies at the main path's head dim
        bf16_hd72.update({k: v for k, v in kernels.items() if "bf16" in k and "Li72E" in k})
    if not bf16_hd72:
        raise AssertionError("ptxas reported no bf16 attention kernel at hd 72")
    emit({"phase": "build", "seconds": seconds,
          "libraries": {k: os.path.basename(v) for k, v in libs.items()},
          "spill_bytes": spill, "bf16_hd72": bf16_hd72})


def attention_qkv(B, S, H, hd, dtype, g, large):
    """A random packed qkv in `dtype`, and its largest logit q.k * scale;
    `large` scales q and k by LARGE_QK and v by LARGE_V."""
    D = H * hd
    qkv = torch.randn(B, S, 3 * D, generator=g, device="cuda")
    if large:
        qkv[..., :2 * D] *= LARGE_QK
        qkv[..., 2 * D:] *= LARGE_V
    qkv = qkv.to(dtype)
    q, k = (qkv[..., i * D:(i + 1) * D].float().view(B, S, H, hd) for i in range(2))
    max_logit = max(torch.einsum("qhd,khd->hqk", q[b], k[b]).max().item()
                    for b in range(B)) * hd ** -0.5
    if large and not max_logit > 50:
        raise AssertionError(f"the large-logit inputs stayed below 50: {max_logit}")
    return qkv, max_logit


KERNEL_ROWS = {}  # (name, shape, dtype, large) -> the row phases kernel and kernel_bwd emitted


def _ratios(row):
    row["x_library"] = row["kernel_ms"] / row["library_ms"]
    row["x_bound"] = row["kernel_ms"] / row["bound_ms"]
    return row


def sdpa_backward(q, k, v, do, scale):
    """(a call of the fused SDPA backward op alone, the op's name), on
    (B, H, S, hd) tensors: flash attention's in bf16, the memory-efficient
    one in fp32 (flash takes no fp32), given the output and LSE of one
    forward of the same op. Nothing of autograd runs in the call, so it
    times the card and not the host."""
    aten = torch.ops.aten
    if q.dtype == torch.bfloat16:
        out, lse, cq, ck, mq, mk, seed, offset, _ = aten._scaled_dot_product_flash_attention(
            q, k, v, 0.0, False, False, scale=scale)
        return (lambda: aten._scaled_dot_product_flash_attention_backward(
            do, q, k, v, out, lse, cq, ck, mq, mk, 0.0, False, seed, offset, scale=scale),
            "aten._scaled_dot_product_flash_attention_backward")
    out, lse, seed, offset = aten._scaled_dot_product_efficient_attention(
        q, k, v, None, True, 0.0, False, scale=scale)
    return (lambda: aten._scaled_dot_product_efficient_attention_backward(
        do, q, k, v, None, out, lse, seed, offset, 0.0, [True, True, True, False], False,
        scale=scale), "aten._scaled_dot_product_efficient_attention_backward")


def _kernel_row(phase, B, S, H, hd, dtype, g, large=False):
    """Kernel 1 against its plain version at one shape and dtype, with its
    time, the plain version's, SDPA's (timed only) and the bound."""
    D = H * hd
    qkv, max_logit = attention_qkv(B, S, H, hd, dtype, g, large)
    scale = hd ** -0.5
    out = flash_attention_qkv_flat(qkv, H)
    torch.cuda.synchronize()
    ref = _attention_qkv_plain(qkv, H, scale)
    err = (out.float() - ref.float()).abs().max().item()
    if not (torch.isfinite(out).all() and err <= TOL[dtype]):
        raise AssertionError(f"attention kernel vs twin at {(B, S, H, hd)} {dtype} "
                             f"large={large}: max abs err {err} > {TOL[dtype]}")
    q, k, v = (qkv[..., i * D:(i + 1) * D].view(B, S, H, hd).transpose(1, 2)
               for i in range(3))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bound, bound_by = attention_bound_ms(B, S, H, hd, dtype)
    row = {"phase": phase, "name": "attention_fwd", "shape": [B, S, H, hd],
           "dtype": str(dtype).replace("torch.", ""), "large_logits": large,
           "max_logit": max_logit, "max_abs_err": err, "tol": TOL[dtype],
           "kernel_ms": cuda_ms(lambda: flash_attention_qkv_flat(qkv, H)),
           "plain_ms": cuda_ms(lambda: _attention_qkv_plain(qkv, H, scale)),
           "library_ms": cuda_ms(lambda: sdpa(q, k, v, scale=scale)),
           "bound_ms": bound, "bound_us": bound * 1e3, "bound_by": bound_by}
    return _ratios(row)


def phase_kernel():
    """Kernel vs twin at every shape and dtype, and at large logits; returns
    the main-shape bf16 row."""
    g = torch.Generator(device="cuda").manual_seed(0)
    main = None
    for (B, S, H, hd), large in ([(shape, False) for shape in KERNEL_SHAPES]
                                 + [(MAIN_SHAPE, True)]):
        for dtype in (torch.float32, torch.bfloat16):
            row = _kernel_row("kernel", B, S, H, hd, dtype, g, large)
            KERNEL_ROWS["attention_fwd", (B, S, H, hd), dtype, large] = row
            emit(row)
            if (B, S, H, hd) == MAIN_SHAPE and dtype == torch.bfloat16 and not large:
                main = row
    return main


def phase_kernel_bwd():
    """Backward kernel vs plain at every shape and dtype, and at large
    logits; returns the training-shape bf16 row."""
    g = torch.Generator(device="cuda").manual_seed(2)
    main = None
    for (B, S, H, hd), large in ([(shape, False) for shape in BWD_SHAPES]
                                 + [(TRAIN_SHAPE, True)]):
        D = H * hd
        for dtype in (torch.float32, torch.bfloat16):
            qkv, max_logit = attention_qkv(B, S, H, hd, dtype, g, large)
            dout = torch.randn(B, S, D, generator=g, device="cuda").to(dtype)
            scale = hd ** -0.5
            out, lse = _launch_fwd(qkv, H, hd, scale, with_lse=True)
            dqkv = _launch_bwd(qkv, out, dout, lse, H, hd, scale)
            torch.cuda.synchronize()
            ref = _attention_qkv_bwd_plain(qkv, dout, H, scale).float()
            peak = ref.abs().max().item()
            err = (dqkv.float() - ref).abs().max().item()
            if not (torch.isfinite(dqkv).all() and err <= BWD_RTOL[dtype] * peak):
                raise AssertionError(f"attention backward vs plain at {(B, S, H, hd)} {dtype} "
                                     f"large={large}: max abs err {err} > "
                                     f"{BWD_RTOL[dtype]} x {peak}")
            # SDPA's backward alone: the fused op
            q, k, v = (qkv[..., i * D:(i + 1) * D].view(B, S, H, hd).transpose(1, 2)
                       .contiguous() for i in range(3))
            do_l = dout.view(B, S, H, hd).transpose(1, 2).contiguous()
            lib, library = sdpa_backward(q, k, v, do_l, scale)
            nbytes = 8 * B * S * D * qkv.element_size()
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = 10 * B * S * S * D / PEAK_FLOPS[dtype] * 1e3
            row = {"phase": "kernel_bwd", "name": "attention_bwd", "shape": [B, S, H, hd],
                   "dtype": str(dtype).replace("torch.", ""), "large_logits": large,
                   "max_logit": max_logit, "max_abs_err": err,
                   "max_abs_dqkv": peak, "tol": BWD_RTOL[dtype] * peak,
                   "kernel_ms": cuda_ms(lambda: _launch_bwd(qkv, out, dout, lse, H, hd, scale)),
                   "plain_ms": cuda_ms(lambda: _attention_qkv_bwd_plain(qkv, dout, H, scale)),
                   "library_ms": cuda_ms(lib), "library": library,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            emit(_ratios(row))
            KERNEL_ROWS["attention_bwd", (B, S, H, hd), dtype, large] = row
            if (B, S, H, hd) == TRAIN_SHAPE and dtype == torch.bfloat16 and not large:
                main = row
            del qkv, dout, out, lse, dqkv, ref, q, k, v, do_l, lib
    torch.cuda.empty_cache()
    return main


def phase_fused_update(steps=3, nu_dtype=torch.float32, library_ms=None, model="DiT-XL/2",
                       depth=None, library=True, phase="fused_update", make_model=None):
    """The fused kernel vs `_update_math` over the parameter tree of
    `model` (DiT-XL/2's, or at `depth`; `make_model` builds a model not in the
    registry) (bf16 params and mu, fp32 or bf16 nu, fp32 master and EMA);
    returns the row. The fp32-nu run also times the library yardstick, which
    the bf16 run reuses (`library_ms`); with `library` False none is timed."""
    kw = {} if depth is None else {"depth": depth}
    with torch.device("meta"):
        build = make_model or DiT_models[model]
        shapes = [p.shape for p in build(device="meta", **kw).parameters()]
    g = torch.Generator(device="cuda").manual_seed(3)
    init = [(0.02 * torch.randn(s, generator=g, device="cuda")).to(torch.bfloat16)
            for s in shapes]
    kp, pp = [t.clone() for t in init], [t.clone() for t in init]
    kstate = fu.fused_adamw_ema_init(kp, nu_dtype=nu_dtype)
    pstate = fu.fused_adamw_ema_init(pp, nu_dtype=nu_dtype)
    kema, pema = [w.clone() for w in kstate.master], [w.clone() for w in pstate.master]
    hyper = dict(lr=LR, b1=0.9, b2=0.999, eps=1e-8, wd=0.0, ema_decay=0.9999)
    apply_kw = dict(lr=LR, weight_decay=0.0, ema_decay=0.9999)
    name = fu._COUNTS[nu_dtype]
    grads = None
    _build.reset_launch_counts()
    for _ in range(steps):
        grads = [(0.01 * torch.randn(s, generator=g, device="cuda")).to(torch.bfloat16)
                 for s in shapes]
        fu.fused_adamw_ema_apply(kstate, grads, kp, kema, **apply_kw)
        fu._apply_plain(pstate, grads, pp, pema, hyper)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    want = {**{k: 0 for k in launches}, name: steps * len(shapes)}
    if launches != want:
        raise AssertionError(f"fused update launched {launches}, expected one {name} per "
                             f"leaf per step: {want}")
    # both round op for op in fp32, each op correctly rounded (no fused
    # multiply-add in the kernel), and vhat comes from the unrounded v in
    # both: every state must equal the plain version's in every element
    errs = {}
    for what, a, b in (("param", kp, pp), ("mu", kstate.mu, pstate.mu),
                       ("nu", kstate.nu, pstate.nu), ("master", kstate.master, pstate.master),
                       ("ema", kema, pema)):
        errs[what] = max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"fused update ({name}) vs _update_math: {what} differs, "
                                 f"max abs err {errs[what]}")
    n = sum(math.prod(s) for s in shapes)
    # each element: read g, m, v, w, e and write p, m, v, w, e once; ~15 flops
    nu_bytes = torch.tensor([], dtype=nu_dtype).element_size()
    nbytes = n * (2 * 2 + 2 * 2 + 2 * nu_bytes + 16)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 15 * n / PEAK_FLOPS[torch.float32] * 1e3
    kernel_ms = cuda_ms(lambda: fu.fused_adamw_ema_apply(kstate, grads, kp, kema, **apply_kw),
                        iters=5, warmup=1)
    plain_ms = cuda_ms(lambda: fu._apply_plain(pstate, grads, pp, pema, hyper),
                       iters=5, warmup=1)
    del pp, pstate, pema
    if library_ms is None and library:
        # the library yardstick: torch's fused AdamW over fp32 copies of the tree
        masters = [w.clone() for w in kstate.master]
        for w, gr in zip(masters, grads):
            w.grad = gr.float()
        opt = torch.optim.AdamW(masters, lr=LR, weight_decay=0.0, fused=True)
        library_ms = cuda_ms(opt.step, iters=5, warmup=1)
        del masters, opt
    row = {"phase": phase, "name": name, "model": model, "depth": depth, "leaves": len(shapes),
           "max_leaf_shape": list(max(shapes, key=math.prod)),
           "elements": n, "steps": steps, "param_dtype": "bfloat16", "mu_dtype": "bfloat16",
           "nu_dtype": _dtype_name(nu_dtype), "bytes_per_element": nbytes // n,
           "max_abs_err": errs, "tol": 0,
           "launches_per_step": len(shapes), "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "library": ("torch.optim.AdamW(fused=True).step(), fp32: AdamW only, no EMA or cast"
                       if library_ms is not None else None),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    emit(row)
    del kp, kstate, kema, grads, init
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


def phase_sample(steps, profile_table, vae_bin):
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
                           "--cfg-scale", "4.0", "--num-sampling-steps", str(steps),
                           "--vae-ckpt", vae_bin])
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
    # the decode, as the CLI does it (fp32, TF32 off), then the 2 x 4 grid
    t0 = time.perf_counter()
    vae = cli.build_vae(args, torch.device("cuda"))
    torch.cuda.synchronize()
    vae_setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    images = cli.decode(vae, latents)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    if tuple(images.shape) != (n, 3, 256, 256) or not torch.isfinite(images).all():
        raise AssertionError(f"bad decoded images: shape {tuple(images.shape)}")
    png = os.path.join(OUT_DIR, "sample.png")
    save_image(images.cpu().numpy(), png, nrow=4, value_range=(-1, 1))
    with open(png, "rb") as f:
        grid = decode_png(f.read())
    if grid.shape != (2 * 258 + 2, 4 * 258 + 2, 3):
        raise AssertionError(f"sample.png is {grid.shape}")
    row = {"phase": "sample", "model": "DiT-XL/2", "image_size": 256, "dtype": "bfloat16",
           "cfg_scale": 4.0, "labels": n, "batch": 2 * n, "sampler": "ddpm", "steps": steps,
           "setup_s": build_s, "loop_s": loop_s, "s_per_step": loop_s / steps,
           "images_per_s": n / loop_s, "launches": launches,
           "vae_setup_s": vae_setup_s, "decode_s": decode_s, "decode_dtype": "float32",
           "decode_share": decode_s / (loop_s + decode_s),
           "images_per_s_decoded": n / (loop_s + decode_s), "png": os.path.relpath(png),
           "images_mean_abs": images.abs().mean().item(),
           "latents_mean_abs": latents.abs().mean().item(),
           "small_check_max_abs_err": small_err, "small_check_tol": small_tol,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if profile_table:
        diffusion4 = create_diffusion("4", device="cuda")
        row["profile"] = profile_device(lambda: cli.sample_latents(args, model, diffusion4),
                                        profile_table, "4 sampling steps")
    emit(row)
    return launches, model


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
    attn_ms = sum(r[0] for r in rows if "attention_" in r[1] or "ring_hop_" in r[1]) / 1e3
    os.makedirs(os.path.dirname(os.path.abspath(table_path)), exist_ok=True)
    with open(table_path, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    return {"what": what, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms, "attention_kernels_ms": attn_ms,
            "attention_share_of_busy": attn_ms / busy_ms,
            "top": [{"kernel": k[:80], "ms": us / 1e3, "count": c} for us, k, c in rows[:12]]}


def _sampler_small_checks():
    """Each new loop (the cached ones too) on a small fp32 model (DiT-S/2,
    depth 2, 8² latents, CFG 4.0), on the card (kernel 1) and on the CPU (its
    plain version),
    with the same weights and noise: the final latents agree within 1e-4 of
    max, the limit of phase `sample`'s small check."""
    g = torch.Generator().manual_seed(14)
    noise = torch.randn(4, 4, 8, 8, generator=g)
    noise = torch.cat([noise[:2], noise[:2]])
    step_noise = torch.randn(10, 4, 4, 8, 8, generator=g)
    x0 = torch.randn(4, 4, 8, 8, generator=g).clamp(-1, 1)
    y = [1, 7, 1000, 1000]
    cases = {  # name: (learn_sigma, respacing, run(diffusion, cfg_fn, cond_fn, model))
        "dpm": (True, "6", lambda d, cfg, cond, m, dev: d.dpm_solver_sample_loop(
            cfg, noise.shape, noise=noise.to(dev), clip_denoised=False)),
        "unipc_karras": (True, "karras6", lambda d, cfg, cond, m, dev: d.unipc_sample_loop(
            cfg, noise.shape, noise=noise.to(dev), clip_denoised=False)),
        "ddpm_interval": (True, "10", lambda d, cfg, cond, m, dev: d.p_sample_loop(
            guidance_interval_fn(cfg, cond, d.schedule, *CFG_INTERVAL), noise.shape,
            noise=noise.to(dev), step_noise=step_noise.to(dev), clip_denoised=False)),
        "ddim_reverse": (True, "6", lambda d, cfg, cond, m, dev: d.ddim_reverse_sample_loop(
            cfg, x0.to(dev))),
        "ddpm_cache2": (True, "10", lambda d, cfg, cond, m, dev: d.p_sample_loop_cached(
            lambda x, t: cfg(x, t, want_cache=True), lambda x, t, c: cfg(x, t, cache=c),
            noise.shape, interval=2, noise=noise.to(dev), step_noise=step_noise.to(dev),
            clip_denoised=False)),
        "ddim_cache3_logsnr": (True, "10", lambda d, cfg, cond, m, dev: d.ddim_sample_loop_cached(
            lambda x, t: cfg(x, t, want_cache=True), lambda x, t, c: cfg(x, t, cache=c),
            noise.shape, interval=3, refresh_schedule="logsnr", noise=noise.to(dev),
            clip_denoised=False)),
        "ddpm_interval_cache2": (True, "10", lambda d, cfg, cond, m, dev: (lambda full, cached,
            forced: d.p_sample_loop_cached(full, cached, noise.shape, interval=2,
                                           force_refresh_mask=forced, noise=noise.to(dev),
                                           step_noise=step_noise.to(dev), clip_denoised=False))(
            *guidance_interval_cached_fns(cfg, cond, d.schedule, *CFG_INTERVAL))),
        "flow_euler": (False, "6", lambda d, cfg, cond, m, dev: flow_sample_loop(
            cfg, noise.shape, num_steps=6, method="euler", noise=noise.to(dev))),
        "flow_heun": (False, "4", lambda d, cfg, cond, m, dev: flow_sample_loop(
            cfg, noise.shape, num_steps=4, method="heun", noise=noise.to(dev))),
    }
    res = {}
    for name, (learn_sigma, respacing, run) in cases.items():
        outs = []
        for device in ("cuda", "cpu"):
            model = DiT_models["DiT-S/2"](input_size=8, depth=2, learn_sigma=learn_sigma,
                                          device=device, seed=0)
            cli.perturb_(model)
            d = create_diffusion(respacing, device=device)
            yy = torch.tensor(y, device=device)
            kw = {} if learn_sigma else {"guidance_channels": 4}
            cfg = lambda x, t, **ck: model.forward_with_cfg(x, t, yy, 4.0, **kw, **ck)
            cond = lambda x, t, **ck: model(x, t, yy[:2], **ck)
            with torch.inference_mode():
                outs.append(run(d, cfg, cond, model, device).cpu())
        err, peak = (outs[0] - outs[1]).abs().max().item(), outs[1].abs().max().item()
        if not (torch.isfinite(outs[0]).all() and err <= 1e-4 * peak):
            raise AssertionError(f"small-model {name} card vs CPU: {err} > 1e-4 x {peak}")
        res[name] = {"max_abs_err": err, "max_abs_out": peak, "tol": 1e-4 * peak}
    return res


def _sampler_chain(args, model, diffusion, evals, profile_table=None, refreshes=None):
    """One chain of the sampler CLI's functions (`sampling_inputs`,
    `make_model_fn`, `run_chain`) with the launch counts set to 0 just
    before and read just after, under sync debug mode "error": a step that
    waits for the device raises. Model calls are counted by batch: 16 is
    a guided (CFG) call, 8 the conditional half alone. A cached chain calls
    the model every step but runs attention (kernel 1) on its `refreshes`
    full calls only."""
    refreshes = evals if refreshes is None else refreshes
    z, y, g = cli.sampling_inputs(args, model)
    fn = cli.make_model_fn(args, model, diffusion, y)
    calls = collections.Counter()
    hook = model.register_forward_pre_hook(lambda m, a: calls.update([a[0].shape[0]]))
    try:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            with torch.inference_mode():
                latents = cli.run_chain(args, diffusion, fn, z, g)[:len(cli.CLASS_LABELS)]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
    finally:
        hook.remove()
    launches = dict(_build.launch_counts)
    want = {**{k: 0 for k in launches}, "attention_fwd": model.depth * refreshes}
    if launches != want:
        raise AssertionError(f"{args.sampler} chain launches {launches}, expected {want}")
    n = len(cli.CLASS_LABELS)
    if tuple(latents.shape) != (n, 4, 32, 32) or not torch.isfinite(latents).all():
        raise AssertionError(f"{args.sampler} chain: bad latents {tuple(latents.shape)}")
    if sum(calls.values()) != evals:
        raise AssertionError(f"{args.sampler} chain made {dict(calls)} model calls, "
                             f"expected {evals}")
    steps = args.num_sampling_steps
    row = {"sampler": args.sampler, "steps": steps, "time_spacing": args.time_spacing,
           "cfg_interval": args.cfg_interval, "cache_interval": args.cache_interval,
           "cache_schedule": args.cache_schedule, "refresh_steps": refreshes,
           "model_evals": evals, "loop_s": loop_s,
           "s_per_step": loop_s / steps, "s_per_eval": loop_s / evals,
           "images_per_s": n / loop_s, "guided_calls": calls[2 * n],
           "conditional_only_calls": calls[n], "launches": launches,
           "sync_debug_mode": "error", "latents_mean_abs": latents.abs().mean().item()}
    if profile_table:
        def run():
            with torch.inference_mode():
                cli.run_chain(args, diffusion, fn, z, g)
        row["profile"] = profile_device(run, profile_table, f"{args.sampler} chain, {steps} steps")
    return row, launches, latents


def _refresh_steps(args, diffusion):
    """The refresh steps of a layer-cached chain (kernel 1 runs on those
    only), as the host mask decides them; None for an uncached chain."""
    if args.cache_interval <= 1:
        return None
    mask = cache_refresh_mask(diffusion.schedule, args.cache_interval, args.cache_schedule)
    if args.cfg_interval is not None:
        mask = mask | guidance_interval_cached_fns(None, None, diffusion.schedule,
                                                   *args.cfg_interval)[2]
    mask[0] = True
    return int(mask.sum())


def phase_samplers(profile_table, vae_bin, models):
    """The fast samplers at the sampling path's width: see the module's
    docstring, item 9. `models` holds phase `sample`'s DiT, built from the
    same flags; it is taken out, so that it is freed where the flow chains
    build their own. Returns {chain name: launches}."""
    small = _sampler_small_checks()
    chains, launches, decode = {}, {}, None
    model = models.pop()
    root, ext = os.path.splitext(profile_table) if profile_table else (None, None)
    for name, flags, evals in SAMPLER_CHAINS:
        # the flow model is a model of its own: cut to CUT_DEPTH
        flow = flags[flags.index("--sampler") + 1] in cli.FLOW_SAMPLERS
        with cut_depth("DiT-XL/2", CUT_DEPTH) as cut:
            args = cli.parse_args(["--model", cut if flow else "DiT-XL/2", *SAMPLER_ARGS[2:],
                                   *flags, "--vae-ckpt", vae_bin])
            cli.check_args(args)
            build_s = None
            if (model.out_channels == 4) != flow:
                del model
                torch.cuda.empty_cache()
                t0 = time.perf_counter()
                model = cli.build_model(args, torch.device("cuda"), args.seed)
                torch.cuda.synchronize()
                build_s = time.perf_counter() - t0
        diffusion = cli.build_diffusion(args, torch.device("cuda"))
        refreshes = _refresh_steps(args, diffusion)
        row, launches[name], _ = _sampler_chain(args, model, diffusion, evals,
                                                profile_table and f"{root}_{name}{ext}",
                                                refreshes=refreshes)
        row.update(model_build_s=build_s, depth=model.depth)
        if args.cfg_interval is not None:
            guided = int(guided_steps_korder(diffusion.schedule, *args.cfg_interval).sum())
            if (row["guided_calls"], row["conditional_only_calls"]) != (guided, evals - guided):
                raise AssertionError(f"interval chain guided {row['guided_calls']} of {evals} "
                                     f"steps, guided_steps_korder says {guided}")
            row["guided_steps_korder"] = guided
        elif row["guided_calls"] != evals:
            raise AssertionError(f"{name}: {row['guided_calls']} of {evals} calls guided")
        if name == "dpm":
            # the CLI's own sample_latents, then the fp32 decode
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lat = cli.sample_latents(args, model, diffusion)
            torch.cuda.synchronize()
            chain_s = time.perf_counter() - t0
            vae = cli.build_vae(args, torch.device("cuda"))
            t0 = time.perf_counter()
            images = cli.decode(vae, lat)
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
            if tuple(images.shape) != (len(cli.CLASS_LABELS), 3, 256, 256) or \
                    not torch.isfinite(images).all():
                raise AssertionError(f"dpm decoded images: {tuple(images.shape)}")
            decode = {"chain_s": chain_s, "decode_s": decode_s,
                      "images_per_s_decoded": len(cli.CLASS_LABELS) / (chain_s + decode_s)}
            del vae, images, lat
        chains[name] = row
    del model
    torch.cuda.empty_cache()
    emit({"phase": "samplers", "model": "DiT-XL/2", "image_size": 256, "dtype": "bfloat16",
          "cfg_scale": 4.0, "labels": len(cli.CLASS_LABELS), "batch": 2 * len(cli.CLASS_LABELS),
          "small_check": small, "chains": chains, "dpm_cli_with_decode": decode})
    return launches


def _small_train_check(steps=2, objective="eps", policy="nothing", nu=None):
    """A small model trained on the card (kernels) and on the CPU (plain
    versions) from the same weights with the same draws: the last loss, the
    last gradients, the parameters and the EMA must agree. The flow
    objective draws t in [0, 1) and has no learned-sigma channels. `policy`
    is the remat policy; `nu` ("bf16" or "factored") takes the fused route,
    whose parameters and gradients are bf16: its parameters are compared
    through the fp32 master, its gradients to one bf16 ulp of their largest
    (the two devices sum the fp32 gradient in other orders, then round it)."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(4, 4, 8, 8, generator=g)
    y = torch.tensor([1, 7, 3, 999])
    draws = [{"t": (torch.rand((4,), generator=g) if objective == "flow"
                    else torch.randint(0, 1000, (4,), generator=g)),
              "noise": torch.randn(4, 4, 8, 8, generator=g),
              "force_drop_ids": torch.tensor([0, 1, 0, 0])} for _ in range(steps)]
    fused = nu is not None
    res = {}
    for device in ("cuda", "cpu"):
        # width 384, depth 2: the factored route has factored and dense leaves
        model = DiT_models["DiT-S/2"](input_size=8, depth=2, remat=True, remat_policy=policy,
                                      learn_sigma=objective == "eps", device=device, seed=0)
        cli.perturb_(model)
        diffusion = create_diffusion("", device=device)
        state = create_train_state(model, lr=None if fused else LR, fused_optimizer=fused,
                                   nu_dtype=torch.bfloat16 if nu == "bf16" else None,
                                   factored_nu=nu == "factored")
        step = make_train_step(model, diffusion.schedule, lr=LR, objective=objective)
        batch = {"x": x.to(device), "y": y.to(device)}
        losses = [step(state, batch, draws=[{k: v.to(device) for k, v in d.items()}])["loss"]
                  .item() for d in draws]
        params = state.opt.master if fused else list(model.parameters())
        res[device] = {"loss": losses,
                       "grad": torch.cat([p.grad.float().flatten()
                                          for p in model.parameters()]).cpu(),
                       "param": torch.cat([p.detach().flatten() for p in params]).cpu(),
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
    grad_rtol = 2 ** -8 if fused else 1e-4
    tols = {"loss": 1e-5 * abs(cpu["loss"][-1]),
            "grad": grad_rtol * cpu["grad"].abs().max().item(),
            "param": 2 * LR * steps, "ema": 2 * LR * steps * 1e-4 + 1e-6}
    errs = {"loss": loss_err, "grad": grad_err, "param": param_err, "ema": ema_err}
    for k in errs:
        if not errs[k] <= tols[k]:
            raise AssertionError(f"small-model training ({objective}, remat {policy}, nu "
                                 f"{nu}) card vs CPU: {k} max abs err {errs[k]} > {tols[k]}")
    return {"max_abs_err": errs, "tol": tols, "losses": card["loss"]}


def _optimizer_ms(state, ema_decay=0.9999):
    """Device ms of the step's optimizer and EMA update alone, on the
    gradients the last step left (the state is stepped further)."""
    params = state.params()
    grads, ema = [p.grad for p in params], list(state.ema.values())
    if isinstance(state.opt, fu.FusedAdamWEmaState):
        def run():
            fu.fused_adamw_ema_apply(state.opt, grads, [p.data for p in params], ema, lr=LR,
                                     ema_decay=ema_decay)
    else:
        def run():
            state.opt.step()
            update_ema(ema, get_master_params(state.opt) or params, ema_decay)
    return cuda_ms(run, iters=3, warmup=1)


def _fwd_bwd_gib(model, diffusion, batch):
    """GiB that one forward and backward of the eps loss adds on top of what
    is allocated before it (the gradients exist already): the activations
    the remat policy keeps, and the recompute's transients."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    g = torch.Generator(device="cuda").manual_seed(0)
    x, y = batch["x"], batch["y"]
    t = torch.randint(0, diffusion.num_timesteps, (x.shape[0],), generator=g, device="cuda")
    noise = torch.randn(x.shape, generator=g, device="cuda")
    training_losses(diffusion.schedule, lambda xt, tm: model(xt, tm, y, train=True,
                                                             generator=g),
                    x, t, noise)["loss"].mean().backward()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def _train_run(flags, warmup, steps, profile_table=None, no_sync=False, base=TRAIN_ARGS):
    """The trainer CLI's own functions: build, one batch of synthetic
    latents, `warmup` steps, then `steps` timed steps with the launch counts
    set to 0 just before and read just after, and every parameter and EMA
    leaf checked to have moved; then the optimizer's device time alone and
    the peak of allocated memory. With `no_sync` the timed steps run under
    torch.cuda.set_sync_debug_mode("error"): a step that waits for the
    device raises."""
    args = train_cli.parse_args(base + flags)
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
    if no_sync:
        torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = [train_step(state, batch) for _ in range(steps)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    losses, last = [m["loss"] for m in metrics], metrics[-1]
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    losses = [v.item() for v in losses]
    # every parameter and every EMA leaf must have moved over the timed steps
    still = [n for n, t in leaves.items() if torch.equal(before[n], t.detach().cpu())]
    sampler = state.sampler_state
    if still:
        raise AssertionError(f"{len(still)} leaves did not move in {steps} training steps "
                             f"with {flags}: {still[:5]}")
    del before
    depth = model.depth
    # the forward kernel runs once a block, and again in the backward under
    # every remat policy; the fused update once per dense leaf, by nu dtype
    dense = collections.Counter(
        fu._COUNTS[v.dtype] for v in (state.opt.nu if args.fused_optimizer else [])
        if not isinstance(v, fu.FactoredNu))
    want = {**{k: 0 for k in launches},
            "attention_fwd": (1 if args.no_remat else 2) * depth * steps,
            "attention_bwd": depth * steps, **{k: n * steps for k, n in dense.items()}}
    if launches != want:
        raise AssertionError(f"training launches {launches}, expected {want}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    optimizer_ms = _optimizer_ms(state, args.ema_decay)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    row = {"model": args.model, "depth": depth, "image_size": 256,
           "batch": args.global_batch_size,
           "dtype": "bfloat16", "remat": None if args.no_remat else args.remat_policy,
           "flags": flags, "optimizer_ms": optimizer_ms,
           "fwd_bwd_gib": (_fwd_bwd_gib(model, diffusion, batch) if args.objective == "eps"
                           else None),
           "params": sum(p.numel() for p in model.parameters()),
           "warmup_steps": warmup, "steps": steps, "setup_s": setup_s, "loop_s": loop_s,
           "s_per_step": loop_s / steps,
           "images_per_s": args.global_batch_size * steps / loop_s,
           "losses": losses, "launches": launches,
           "sync_debug_mode": "error" if no_sync else None, "peak_mem_gib": peak_gib,
           "native_loader": args.native_loader}
    if model.moe_experts:  # the last timed step's MoE metrics
        row["moe_metrics"] = {k: v.item() for k, v in last.items() if k.startswith("moe_")}
    if args.fused_optimizer:
        nus = {id(v): v for v in state.opt.nu}.values()
        row["nu"] = fu.nu_kind(state.opt)
        row["nu_bytes"] = sum((v.row.numel() + v.col.numel()) * 4 if isinstance(v, fu.FactoredNu)
                              else v.numel() * v.element_size() for v in nus)
        row["factored_tensors"] = sum(isinstance(v, fu.FactoredNu) for v in state.opt.nu)
        row["factored_jax_leaves"] = sum(isinstance(v, fu.FactoredNu) for v in nus)
    if sampler is not None:  # every step folded its batch into the loss history
        counted = sampler.loss_counts.sum().item()
        if counted != min(args.global_batch_size * (warmup + steps),
                          sampler.num_timesteps * sampler.history_per_term):
            raise AssertionError(f"the loss-second-moment state counted {counted} losses")
        row["sampler_losses_counted"] = counted
    if profile_table:
        row["profile"] = profile_device(lambda: [train_step(state, batch) for _ in range(2)],
                                        profile_table, "2 training steps")
    del model, diffusion, state, train_step, batch
    torch.cuda.empty_cache()
    return row, launches


def _native_loader_run(model_name):
    """--native-loader on the feature folder phase `extract` wrote (16
    features, batch 8, 2 epochs): every batch equals the Python loader's;
    then `model_name` trains 2 steps after 1 on its first batch."""
    base = ["--model", model_name, "--feature-path", os.path.join(OUT_DIR, "features"),
            "--global-batch-size", "8", "--global-seed", "0", "--epochs", "2"]

    def read(flags):
        return [[{k: v.cpu() for k, v in b.items()} for b in epoch] for epoch in
                train_cli.device_batches(train_cli.parse_args(base + flags),
                                         torch.device("cuda"))]
    got, want = read(["--native-loader"]), read([])
    if not (len(got) == len(want) == 2 and all(
            len(g) == len(w) == EXTRACT_IMAGES // 8
            and all(torch.equal(a[k], b[k]) for a, b in zip(g, w) for k in ("x", "y"))
            for g, w in zip(got, want))):
        raise AssertionError("the native loader's batches differ from the Python loader's")
    row, launches = _train_run(["--native-loader"], warmup=1, steps=2, no_sync=True, base=base)
    row["batches_equal_python_loader"] = sum(len(e) for e in got)
    return row, launches


def phase_train(profile_table):
    """Returns {path: launches} of the training runs."""
    small = _small_train_check()
    small_flow = _small_train_check(objective="flow")
    small_more = {**{f"remat_{p}": _small_train_check(policy=p) for p in ("attn", "attn_mlp")},
                  **{f"nu_{nu}": _small_train_check(nu=nu) for nu in ("bf16", "factored")}}
    table = None
    if profile_table:
        root, ext = os.path.splitext(profile_table)
        table = f"{root}_train{ext}"
    main, main_launches = _train_run([], warmup=3, steps=TRAIN_STEPS,
                                       profile_table=table)
    with cut_depth("DiT-XL/2", CUT_DEPTH) as cut:
        base = ["--model", cut, *TRAIN_ARGS[2:]]
        fused, fused_launches = _train_run(["--fused-optimizer"], warmup=2,
                                           steps=FUSED_TRAIN_STEPS, base=base)
        flow, flow_launches = _train_run(["--objective", "flow"], warmup=2,
                                         steps=FLOW_TRAIN_STEPS, no_sync=True, base=base)
        lsm, lsm_launches = _train_run(["--schedule-sampler", "loss-second-moment"], warmup=2,
                                       steps=LSM_TRAIN_STEPS, no_sync=True, base=base)
        more, more_launches = {}, {}
        for name, flags in TRAIN_MORE:
            more[name], more_launches[f"train_{name}"] = _train_run(
                flags, warmup=2, steps=MORE_TRAIN_STEPS, no_sync=True, base=base)
        native, native_launches = _native_loader_run(cut)
    # the remat policies' memory at one depth: the fused route's policy is
    # "nothing", as the main route's, and the optimizer does not touch fwd_bwd_gib
    peak = {"nothing": (fused["peak_mem_gib"], fused["fwd_bwd_gib"]),
            **{k: (more[k]["peak_mem_gib"], more[k]["fwd_bwd_gib"])
               for k in ("no_remat", "remat_attn", "remat_attn_mlp")}}
    emit({"phase": "train", "small_check": small, "small_check_flow": small_flow,
          "small_check_more": small_more, "main": main, "fused_optimizer": fused,
          "flow": flow, "loss_second_moment": lsm, **more, "native_loader": native,
          "peak_and_fwd_bwd_gib_by_remat": {"depth": CUT_DEPTH, **peak}})
    return {"train": main_launches, "train_fused_optimizer": fused_launches,
            "train_flow": flow_launches, "train_loss_second_moment": lsm_launches,
            **more_launches, "train_native_loader": native_launches}


def _state_tensors(state) -> dict:
    """Every tensor of a train state by a name: parameters, EMA, optimizer
    state, the loss-second-moment buffers and the generator's state."""
    out = {f"param {n}": p for n, p in state.model.named_parameters()}
    out.update({f"ema {n}": e for n, e in state.ema.items()})
    opt = state.opt
    if isinstance(opt, fu.FusedAdamWEmaState):
        for i, (m, v, w) in enumerate(zip(opt.mu, opt.nu, opt.master)):
            out[f"mu {i}"], out[f"master {i}"] = m, w
            if isinstance(v, fu.FactoredNu):
                out[f"nu {v.leaf.path} row"], out[f"nu {v.leaf.path} col"] = v.row, v.col
            else:
                out[f"nu {i}"] = v
    else:
        for i, st in enumerate(getattr(opt, "inner", opt).state.values()):
            out.update({f"adam {i} {k}": v for k, v in st.items()})
        out.update({f"master {i}": w for i, w in enumerate(getattr(opt, "master", []))})
    out["sampler history"] = state.sampler_state.loss_history
    out["sampler counts"] = state.sampler_state.loss_counts
    out["generator"] = state.generator.get_state()
    return out


def _resume_build(flags, seed):
    """A DiT-XL/2-wide train state of depth RESUME_DEPTH on the card (bf16
    activations, remat), with a warmed-up loss-second-moment sampler and the
    step's generator, all from `seed`."""
    model = DiT_models["DiT-XL/2"](input_size=32, depth=RESUME_DEPTH, dtype=torch.bfloat16,
                                   remat=True, device="cuda", seed=seed)
    cli.perturb_(model, seed=seed + 1)
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    sampler = LossSecondMomentState.create(1000, device="cuda")
    sampler = dataclasses.replace(sampler, loss_history=torch.rand(
        sampler.loss_history.shape, generator=g, device="cuda"),
        loss_counts=torch.full_like(sampler.loss_counts, sampler.history_per_term))
    fused = bool(flags.get("fused_optimizer"))
    state = create_train_state(model, lr=None if fused else LR, sampler_state=sampler,
                               generator=g, **flags)
    step = make_train_step(model, create_diffusion("", device="cuda").schedule, lr=LR,
                           generator=g)
    return state, step


def phase_resume():
    """Checkpoints at full width: for each optimizer route and kind of nu,
    2 steps, save, 2 more as the reference; then a state built from another
    seed restores the file and runs the same 2 batches: every tensor of the
    two states must be equal. Then the trainer CLI's own --resume (DiT-S/2):
    it re-enters the latest dir and continues from its latest step."""
    rs = np.random.RandomState(5)
    batches = [{"x": torch.from_numpy(rs.randn(RESUME_BATCH, 4, 32, 32).astype(np.float32))
                .cuda(), "y": torch.from_numpy(rs.randint(0, 1000, RESUME_BATCH)).cuda()}
               for _ in range(4)]
    ckpt_dir = os.path.join(OUT_DIR, "resume")
    routes = {}
    for name, flags in RESUME_ROUTES:
        ref, ref_step = _resume_build(flags, seed=0)
        for b in batches[:2]:
            ref_step(ref, b)
        mgr = CheckpointManager(os.path.join(ckpt_dir, name), max_to_keep=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = mgr.save(2, ref)
        save_s = time.perf_counter() - t0
        ref_losses = [ref_step(ref, b)["loss"].item() for b in batches[2:]]
        want = {k: v.clone() for k, v in _state_tensors(ref).items()}
        del ref, ref_step
        state, step = _resume_build(flags, seed=7)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored_step = mgr.restore(state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        losses = [step(state, b)["loss"].item() for b in batches[2:]]
        got = _state_tensors(state)
        differ = [k for k in want if not torch.equal(got[k], want[k].to(got[k].device))]
        if restored_step != 2 or state.step != 4 or losses != ref_losses or differ:
            worst = max(((got[k].float() - want[k].float().to(got[k].device)).abs().max()
                         .item(), k) for k in differ) if differ else None
            raise AssertionError(f"resume {name}: 2 + restore + 2 steps differ from 4 steps: "
                                 f"losses {losses} vs {ref_losses}, {len(differ)} tensors "
                                 f"differ, the largest {worst}")
        routes[name] = {"flags": {k: str(v) for k, v in flags.items()},
                        "file_bytes": os.path.getsize(path), "save_s": save_s,
                        "restore_s": restore_s, "tensors_equal": len(want), "losses": losses}
        del state, step, want, got
        shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
        torch.cuda.empty_cache()
    # the CLI: a run, then --resume, which finds the latest dir and step
    results = os.path.join(ckpt_dir, "results")
    base = ["--model", "DiT-S/2", "--synthetic-data", "--global-batch-size", "8",
            "--results-dir", results, "--log-every", "1", "--schedule-sampler",
            "loss-second-moment", "--fused-optimizer", "--factored-nu"]
    train_cli.main(train_cli.parse_args(base + ["--max-steps", "1"]))
    train_cli.main(train_cli.parse_args(base + ["--max-steps", "2", "--resume"]))
    (exp,) = os.listdir(results)
    with open(os.path.join(results, exp, "log.txt")) as f:
        log = f.read()
    latest = CheckpointManager(os.path.join(results, exp, "checkpoints")).latest_step()
    if "Resumed from checkpoint at step 1" not in log or latest != 2:
        raise AssertionError(f"the CLI's --resume: latest step {latest}, log:\n{log}")
    emit({"phase": "resume", "model": f"DiT-XL/2 width, depth {RESUME_DEPTH}",
          "batch": RESUME_BATCH, "schedule_sampler": "loss-second-moment (warmed up)",
          "routes": routes, "cli_resume": {"model": "DiT-S/2", "dir": exp,
                                           "latest_step": latest, "resumed_at": 1}})


# -- 12c. train_parallel: the parallel trainer, its ranks on one card --------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_ranks(n, fn, timeout=PAR_TIMEOUT, **kwargs):
    """Run chip_smoke's `fn(**kwargs)` in n processes on cuda:0, each joining
    the world through the port's own bring-up (`utils.platform`, torchrun's
    environment with LOCAL_RANK 0 for all, a free local port) over gloo:
    NCCL refuses two ranks on one GPU. Returns the ranks' results. Every
    kernel is built before (phase `build`), so no rank runs nvcc."""
    return _wait_ranks(_start_ranks(n, fn, timeout, **kwargs))


def _start_ranks(n, fn, timeout=PAR_TIMEOUT, **kwargs):
    """`_spawn_ranks`' processes started; `_wait_ranks` collects them."""
    d = os.path.join(OUT_DIR, f"ranks-{fn}-{n}-{time.time_ns()}")
    os.makedirs(d)
    job = os.path.join(d, "job.pt")
    torch.save(kwargs, job)
    boot = (f"import os, sys\nsys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})\n"
            "import torch, torch.distributed as dist\n"
            "torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False\n"
            "from fast_dit_torch.utils.platform import maybe_initialize_distributed\n"
            "maybe_initialize_distributed(torch.device('cuda'), backend='gloo')\n"
            "import chip_smoke\n"
            f"res = chip_smoke.{fn}(**torch.load({job!r}, weights_only=False))\n"
            f"torch.save(res, os.path.join({d!r}, f'out{{dist.get_rank()}}.pt'))\n"
            "dist.barrier()\n"
            "dist.destroy_process_group()\n")
    port = str(_free_port())
    logs = [open(os.path.join(d, f"log{r}.txt"), "w") for r in range(n)]
    procs = [subprocess.Popen([sys.executable, "-c", boot],
                              env={**os.environ, "RANK": str(r), "WORLD_SIZE": str(n),
                                   "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
                                   "MASTER_PORT": port},
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in range(n)]
    return n, fn, d, procs, logs, time.monotonic() + timeout


def _kill_ranks(started):
    """Kill those of `_start_ranks`' processes still running."""
    for p in started[3]:
        if p.poll() is None:
            p.kill()
            p.wait()


def _wait_ranks(started):
    n, fn, d, procs, logs, deadline = started
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = "\n".join(f"--- rank {r} (rc {procs[r].returncode}):\n"
                          + open(os.path.join(d, f"log{r}.txt")).read()[-3000:] for r in bad)
        raise RuntimeError(f"{n} ranks of {fn} failed:\n{tails}")
    out = [torch.load(os.path.join(d, f"out{r}.pt"), weights_only=False) for r in range(n)]
    shutil.rmtree(d, ignore_errors=True)
    return out


def _par_small_route(route, world):
    """One small fp32 route (a dict of PAR_SMALL) for 2 steps on the card:
    on the route's mesh when `world`, else as one process on the global
    batch. Returns the losses, the gathered checkpoint tree on the host
    (rank 0; None elsewhere) and each parameter's local bytes' digest."""
    import hashlib

    from fast_dit_torch.ckpt.checkpoint import checkpoint_tree
    from fast_dit_torch.parallel.mesh import (batch_rows, create_expert_mesh, create_mesh,
                                              shard_params)
    from fast_dit_torch.train import make_sharded_train_step
    name, kw = route["model"]
    nvs = name == "DiTNVS"
    model = (DiTNVS(**kw, device="cuda", seed=0) if nvs else
             DiT_models[name](input_size=32, remat=True, device="cuda", seed=0, **kw))
    cli.perturb_(model)
    mesh = None
    if world:
        inner, m = route["mesh"]
        mesh = create_expert_mesh(m) if inner == "expert" else create_mesh(model=m)
        shard_params(model, mesh, tp=route.get("tp", False), fsdp=route.get("fsdp", False))
    g = torch.Generator(device="cuda").manual_seed(0)
    sampler = None
    if route.get("lsm"):
        sampler = LossSecondMomentState.create(1000, device="cuda")
        sampler = dataclasses.replace(
            sampler, loss_history=torch.rand(sampler.loss_history.shape, device="cuda",
                                             generator=torch.Generator(device="cuda")
                                             .manual_seed(1)),
            loss_counts=torch.full_like(sampler.loss_counts, sampler.history_per_term))
    state_kw = route.get("state", {})
    fused = state_kw.get("fused_optimizer", False)
    state = create_train_state(model, lr=None if fused else LR, generator=g,
                               sampler_state=sampler, **state_kw)
    kw = dict(lr=LR, log_grad_norm=True, generator=g, **route.get("step", {}))
    if nvs:  # the DINO features ride in the batch, split by rows with x and y
        kw["model_call"] = lambda x_t, t, b, force, gen: model(
            x_t, t, b["dino_feat"], b["y"], train=True, force_drop_ids=force, generator=gen)
    schedule = create_diffusion("", device="cuda").schedule
    step = (make_sharded_train_step(model, schedule, mesh, **kw) if world else
            make_train_step(model, schedule, **kw))
    rs = np.random.RandomState(1)
    size = model.input_size
    batch = {"x": rs.randn(PAR_SMALL_BATCH, 4, size, size).astype(np.float32),
             "y": rs.randint(0, model.num_classes, PAR_SMALL_BATCH)}
    if nvs:
        grid = model.dino_patch_grid
        batch["dino_feat"] = rs.randn(PAR_SMALL_BATCH, model.dino_dim, grid,
                                      grid).astype(np.float32)
    rows = batch_rows(mesh, PAR_SMALL_BATCH) if world else slice(None)
    batch = {k: torch.from_numpy(v[rows]).cuda() for k, v in batch.items()}
    _build.reset_launch_counts()
    metrics = [step(state, batch) for _ in range(PAR_SMALL_STEPS)]
    torch.cuda.synchronize()
    out = {"metrics": [{k: v.item() for k, v in m.items()} for m in metrics],
           "launches": dict(_build.launch_counts)}
    if nvs and world:
        # every block's self-attention and the cross-attention, forward and
        # backward (no remat), each microbatch; kernel 3 once a local tensor
        calls = (model.depth + len(model.cross_layers)) * kw.get("grad_accum", 1) * PAR_SMALL_STEPS
        dense = collections.Counter(fu._COUNTS[v.dtype] for v in state.opt.nu
                                    if not isinstance(v, fu.FactoredNu) and v.numel())
        want = {**{k: 0 for k in out["launches"]}, "attention_fwd": calls,
                "attention_bwd": calls, **{k: n * PAR_SMALL_STEPS for k, n in dense.items()}}
        if out["launches"] != want:
            raise AssertionError(f"train_parallel {route['name']} rank {mesh.rank}: launches "
                                 f"{out['launches']}, expected {want}")
    tree = checkpoint_tree(state)
    out["tree"] = None if tree is None else _to_host(tree)
    if world:
        out["digest"] = {s.name: hashlib.sha1(p.detach().cpu().view(torch.uint8).numpy()
                                              .tobytes()).hexdigest()
                         for s, p in zip(model.sharding.shards, model.parameters())}
        out["keys"] = {s.name: (s.data_sharded, s.inner_sharded)
                       for s in model.sharding.shards}
        out["coords"] = (mesh.data_rank, mesh.inner_rank)
    return out


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree.cpu() if torch.is_tensor(tree) else tree


def par_small_ranks(routes):
    """A rank's side of the small checks: every route, in order."""
    return {r["name"]: _par_small_route(r, True) for r in routes}


def _par_tree_err(got, want, bf16_grads, path=""):
    """The largest violation of the CPU tests' limits
    (tests/test_torch_data_parallel.py) over two checkpoint trees: 0 when
    every element is within them, else the worst excess (and its path)."""
    if isinstance(want, dict):
        return max((_par_tree_err(got[k], want[k], bf16_grads, f"{path}.{k}" if path else k)
                    for k in want), default=(0.0, ""))
    if isinstance(want, (list, tuple)):
        return max((_par_tree_err(a, b, bf16_grads, f"{path}.{i}")
                    for i, (a, b) in enumerate(zip(got, want))), default=(0.0, ""))
    if not torch.is_tensor(want) or not want.is_floating_point() or not want.numel():
        return (0.0, "")
    w = want.double()
    err = (got.double() - w).abs()
    lim = 2e-5 + 2e-3 * w.abs()
    if bf16_grads and path.startswith(("model", "opt.master")):
        lim = torch.clamp(lim, min=2 * LR * PAR_SMALL_STEPS)
    elif bf16_grads and path.startswith("ema"):
        lim = lim + 2 * LR * PAR_SMALL_STEPS * 1e-4
    elif bf16_grads:
        lim = 2e-5 + 2 * 2.0 ** (torch.floor(torch.log2(w.abs().max() + 1e-30)) - 7)
    return ((err - lim).max().item() if bool((err > lim).any()) else 0.0, path)


def _par_small_checks():
    """Each small route in a world of 2 or 4 ranks on the card against one
    process on the card: losses and gradient norm, and every tensor of the
    gathered checkpoint tree, to the CPU tests' limits; ranks holding the
    same part of a parameter hold the same bytes. The worlds run at once,
    and beside them the references; world_<n>_s is the seconds from their
    start to world n's results."""
    out, worlds, results, wants = {}, {}, {}, {}
    t0 = time.perf_counter()
    try:
        for n, routes in PAR_SMALL.items():
            worlds[n] = _start_ranks(n, "par_small_ranks", routes=routes)
        for routes in PAR_SMALL.values():  # the one-process references meanwhile
            for r in routes:
                wants[r["name"]] = _par_small_route(r, False)
                wants[r["name"]]["tree"] = _to_host(wants[r["name"]]["tree"])
        for n in PAR_SMALL:
            results[n] = _wait_ranks(worlds[n])
            out[f"world_{n}_s"] = time.perf_counter() - t0
    finally:
        for started in worlds.values():
            _kill_ranks(started)
    for n, routes in PAR_SMALL.items():
        ranks = results[n]
        for r in routes:
            want = wants.pop(r["name"])
            res = [rk[r["name"]] for rk in ranks]
            bf16_grads = bool(r.get("state"))
            loss_err = 0.0
            for got in res:
                for a, b in zip(got["metrics"], want["metrics"]):
                    for k in b:
                        rtol = 2 ** -8 if bf16_grads and k == "grad_norm" else 2e-4
                        excess = abs(a[k] - b[k]) - (2e-5 + rtol * abs(b[k]))
                        if excess > 0:
                            raise AssertionError(f"train_parallel {r['name']}: {k} {a[k]} vs "
                                                 f"one process {b[k]}")
                        loss_err = max(loss_err, abs(a[k] - b[k]) / max(abs(b[k]), 1e-12))
            excess, where = _par_tree_err(
                {k: res[0]["tree"][k] for k in ("model", "ema", "opt")},
                {k: want["tree"][k] for k in ("model", "ema", "opt")}, bf16_grads)
            if excess > 0:
                raise AssertionError(f"train_parallel {r['name']}: {where} past the limit by "
                                     f"{excess}")
            worst = max((res[0]["tree"][k][name].double() - want["tree"][k][name].double())
                        .abs().max().item() for k in ("model", "ema")
                        for name in want["tree"][k] if want["tree"][k][name].is_floating_point())
            differ = []
            for pname, (data_sharded, inner_sharded) in res[0]["keys"].items():
                groups = {}
                for got in res:
                    d, i = got["coords"]
                    key = (d if data_sharded else None, i if inner_sharded else None)
                    groups.setdefault(key, set()).add(got["digest"][pname])
                differ += [pname for v in groups.values() if len(v) > 1]
            if differ:
                raise AssertionError(f"train_parallel {r['name']}: replicas differ in "
                                     f"{differ[:5]}")
            out[r["name"]] = {"ranks": n, "metric_max_rel_err": loss_err,
                              "param_ema_max_abs_err": worst,
                              "losses": [m["loss"] for m in res[0]["metrics"]],
                              "launches": [got["launches"] for got in res]}
    return out


def _par_full_run(name, flags):
    """A rank's side of one full-width route: the trainer CLI's own
    functions on the world's mesh, PAR_WARMUP steps, then PAR_STEPS timed
    steps under sync debug mode "error" (the gloo collectives exempt) with
    the launch counts set to 0 just before and read just after; then, for
    the routes of PAR_PROFILED, one more step profiled on rank 0."""
    import torch.distributed as dist

    from fast_dit_torch.parallel import collectives
    world = dist.get_world_size()
    args = train_cli.parse_args(flags)
    train_cli.check_args(args, world)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mesh = train_cli.make_mesh(args)
    model, _, state, train_step = train_cli.build(args, mesh, torch.device("cuda", 0))
    batch = next(next(train_cli.device_batches(args, torch.device("cuda", 0), mesh=mesh)))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    warm = [train_step(state, batch)["loss"] for _ in range(PAR_WARMUP)]
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    collectives.exempt_ranges.update(count=0, seconds=0.0)
    dist.barrier()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = [train_step(state, batch)["loss"] for _ in range(PAR_STEPS)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    exempt = dict(collectives.exempt_ranges)
    dense = collections.Counter(
        fu._COUNTS[v.dtype] for v in state.opt.nu
        if not isinstance(v, fu.FactoredNu) and v.numel()) if args.fused_optimizer else {}
    want = {**{k: 0 for k in launches}, "attention_fwd": 2 * model.depth * PAR_STEPS,
            "attention_bwd": model.depth * PAR_STEPS,
            **{k: n * PAR_STEPS for k, n in dense.items()}}
    if launches != want:
        raise AssertionError(f"train_parallel {name} rank {dist.get_rank()}: launches "
                             f"{launches}, expected {want}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # each parameter's bits summed as integers: ranks that hold the same part
    # of it must agree (a gradient left unreduced would part them)
    checksum = {s.name: (s.data_sharded, s.inner_sharded,
                         p.detach().view(torch.int16 if p.element_size() == 2 else torch.int32)
                         .to(torch.int64).sum().item())
                for s, p in zip(model.sharding.shards, model.parameters())}
    state_gib = sum(t.numel() * t.element_size() for t in
                    [*model.parameters(), *state.ema.values(), *state.opt.mu,
                     *state.opt.master, *[v for v in state.opt.nu if torch.is_tensor(v)]]
                    ) / 2 ** 30
    profile = None
    if name in PAR_PROFILED and dist.get_rank() == 0:
        profile = profile_device(lambda: train_step(state, batch),
                                 os.path.join(OUT_DIR, f"profile_train_parallel_{name}.txt"),
                                 f"1 training step, rank 0 of {world}")
    elif name in PAR_PROFILED:  # the other ranks take the same three steps with rank 0
        for _ in range(3):
            train_step(state, batch)
    torch.cuda.synchronize()
    row = {"flags": flags, "rank": dist.get_rank(), "world": world, "mesh": mesh.shape,
           "depth": model.depth, "local_batch": batch["x"].shape[0],
           "params_local": sum(p.numel() for p in model.parameters()),
           "setup_s": setup_s, "warmup_losses": [v.item() for v in warm],
           "losses": [v.item() for v in losses], "s_per_step": loop_s / PAR_STEPS,
           "launches": launches, "sync_debug_mode": "error",
           "sync_exempt_collectives_per_step": exempt["count"] / PAR_STEPS,
           "collective_ms_per_step": exempt["seconds"] * 1e3 / PAR_STEPS,
           "peak_mem_gib": peak, "state_gib": state_gib, "profile": profile,
           "checksum": checksum, "coords": (mesh.data_rank, mesh.axis_rank(mesh.inner))}
    del model, state, train_step, batch
    torch.cuda.empty_cache()
    return row


def par_full_ranks(routes):
    """A rank's side of the full-width routes, in order, each (name, flags,
    (model, depth)) with its model cut to that depth."""
    out = {}
    for name, flags, cut in routes:
        with cut_depth(*cut) as model_name:
            out[name] = _par_full_run(name, ["--model", model_name, *flags])
    return out


def _par_cli_nccl():
    """The trainer CLI's `main` in a world of one rank over NCCL (RANK=0,
    WORLD_SIZE=1, a free local port): DiT-XL/2 cut to PAR_DEPTH, 2 steps,
    with its final checkpoint."""
    port = _free_port()
    results = os.path.join(OUT_DIR, "par_cli")
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    t0 = time.perf_counter()
    _build.reset_launch_counts()
    try:
        with cut_depth("DiT-XL/2", PAR_DEPTH) as model_name:
            train_cli.main(train_cli.parse_args(["--model", model_name, *TRAIN_ARGS[2:],
                                                 "--max-steps", "2", "--log-every", "1",
                                                 "--results-dir", results]))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    seconds = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    (exp,) = os.listdir(results)
    with open(os.path.join(results, exp, "log.txt")) as f:
        log = f.read()
    if log.count("Train Loss") != 2 or not os.path.exists(
            os.path.join(results, exp, "checkpoints", "0000002.pt")):
        raise AssertionError(f"the CLI over NCCL at world 1: log\n{log}")
    shutil.rmtree(results, ignore_errors=True)
    return {"backend": "nccl", "world": 1, "model": "DiT-XL/2", "depth": PAR_DEPTH, "steps": 2,
            "seconds": seconds, "launches": launches}, launches


def phase_train_parallel():
    """The parallel trainer: kernels 1 and 2 at the per-rank shapes ride in
    phases `kernel` and `kernel_bwd` (KERNEL_SHAPES, BWD_SHAPES); kernel 3
    over an FSDP rank's sharded leaves here; the small fp32 routes against
    one process; the full-width routes (DiT-XL/2, and the MoE at depth
    PAR_EP_DEPTH for EP) against one process's losses; the CLI over NCCL.
    Two ranks on one card share it: no scaling number comes from here.
    Returns {path: launches summed over the ranks}."""
    fu_row = _fused_update_sharded()
    small = _par_small_checks()
    # the DiTNVS routes' launches, summed over their ranks (each checked
    # exact on its rank)
    nvs_launches = sum((collections.Counter(n) for name, row in small.items()
                        if name.startswith("nvs_") for n in row["launches"]),
                       collections.Counter())
    # the one-process references of the full-width routes (same seed, batch)
    refs = {}
    for key, cut in [("xl2", ("DiT-XL/2", PAR_DEPTH)), ("moe", (MOE_MODEL, PAR_EP_DEPTH))]:
        with cut_depth(*cut) as model_name:
            refs[key], _ = _train_run(["--fused-optimizer"], warmup=PAR_WARMUP, steps=PAR_STEPS,
                                      base=["--model", model_name, *TRAIN_ARGS[2:]])
    routes = [(name, TRAIN_ARGS[2:] + flags, ("DiT-XL/2", PAR_DEPTH)) for name, flags in PAR_FULL]
    routes.append(("ep2", [*TRAIN_ARGS[2:], "--fused-optimizer", "--ep", "2"],
                   (MOE_MODEL, PAR_EP_DEPTH)))
    t0 = time.perf_counter()
    ranks = _spawn_ranks(2, "par_full_ranks", routes=routes)
    full_s = time.perf_counter() - t0
    full, launches = {}, {}
    for name, _, cut in routes:
        rows = [r[name] for r in ranks]
        ref = refs["moe" if cut[0] == MOE_MODEL else "xl2"]
        rel = max(abs(a - b) / abs(b) for row in rows for a, b in zip(row["losses"],
                                                                      ref["losses"]))
        if not rel <= PAR_LOSS_RTOL:
            raise AssertionError(f"train_parallel {name}: losses {rows[0]['losses']} vs one "
                                 f"process {ref['losses']} (rel err {rel})")
        differ = _replicas_differ(rows)
        if differ:
            raise AssertionError(f"train_parallel {name}: replicas differ in {differ[:5]}")
        for r in rows:
            del r["checksum"]
        launches[f"train_parallel_{name}"] = dict(sum((collections.Counter(r["launches"])
                                                       for r in rows), collections.Counter()))
        full[name] = {"ranks": rows, "loss_rel_err_vs_one_process": rel,
                      "one_process": {k: ref[k] for k in ("losses", "s_per_step",
                                                          "peak_mem_gib", "params")}}
    launches["train_parallel_nvs"] = dict(nvs_launches)
    cli_row, launches["train_parallel_cli_nccl"] = _par_cli_nccl()
    emit({"phase": "train_parallel", "kernel3_sharded": fu_row, "small_check": small,
          "full": full, "full_world_s": full_s, "cli_nccl": cli_row,
          "note": "two ranks share one card over gloo: no scaling number"})
    return launches


def _replicas_differ(rows):
    """Parameters whose checksums differ between ranks that hold the same
    part of them."""
    differ = []
    for pname, (data_sharded, inner_sharded, _) in rows[0]["checksum"].items():
        groups = {}
        for r in rows:
            d, i = r["coords"]
            key = (d if data_sharded else None, i if inner_sharded else None)
            groups.setdefault(key, set()).add(r["checksum"][pname][2])
        differ += [pname for v in groups.values() if len(v) > 1]
    return differ


def _fused_update_sharded():
    """Kernel 3 against `_update_math` over the local leaves of rank 0 of
    DiT-XL/2 under FSDP 2 (every leaf halved on its largest axis), 3 steps:
    every element equal."""
    from fast_dit_torch.parallel.mesh import Mesh, Sharding
    with torch.device("meta"):
        model = DiT_models["DiT-XL/2"](device="meta")
        sharding = Sharding(model, Mesh(2, 1, "model", 0), fsdp=True)
        shapes = [sharding.local(i, p).shape for i, p in enumerate(model.parameters())]
    del model
    g = torch.Generator(device="cuda").manual_seed(5)
    init = [(0.02 * torch.randn(s, generator=g, device="cuda")).to(torch.bfloat16)
            for s in shapes]
    kp, pp = [t.clone() for t in init], [t.clone() for t in init]
    ks, ps = fu.fused_adamw_ema_init(kp), fu.fused_adamw_ema_init(pp)
    ke, pe = [w.clone() for w in ks.master], [w.clone() for w in ps.master]
    hyper = dict(lr=LR, b1=0.9, b2=0.999, eps=1e-8, wd=0.0, ema_decay=0.9999)
    for _ in range(3):
        grads = [(0.01 * torch.randn(s, generator=g, device="cuda")).to(torch.bfloat16)
                 for s in shapes]
        fu.fused_adamw_ema_apply(ks, grads, kp, ke, lr=LR, weight_decay=0.0, ema_decay=0.9999)
        fu._apply_plain(ps, grads, pp, pe, hyper)
    torch.cuda.synchronize()
    for what, a, b in (("param", kp, pp), ("mu", ks.mu, ps.mu), ("nu", ks.nu, ps.nu),
                       ("master", ks.master, ps.master), ("ema", ke, pe)):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"kernel 3 over FSDP-sharded leaves: {what} differs")
    n = sum(math.prod(s) for s in shapes)
    del kp, pp, ks, ps, ke, pe, grads, init
    torch.cuda.empty_cache()
    return {"model": "DiT-XL/2, FSDP 2, rank 0", "leaves": len(shapes), "elements": n,
            "steps": 3, "max_abs_err": 0.0, "equal": True}


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def _hop_inputs(B, Sq, Sk, H, hd, dtype, g, clamp=False):
    """q, k, v in `dtype`; do, dl fp32. With `clamp`, q and k are integers in
    [-8, 8]: about 2 % of the logits pass 50, and q k^T and u / sqrt(64) stay
    exact in fp32 in any order (near 50, exp turns a rounding of s into |s|
    times that relative error in p_u, which the check would measure)."""
    D = H * hd
    if clamp:
        q = torch.randint(-8, 9, (B, Sq, D), generator=g, device="cuda").float()
        k = torch.randint(-8, 9, (B, Sk, D), generator=g, device="cuda").float()
    else:
        q = torch.randn(B, Sq, D, generator=g, device="cuda")
        k = torch.randn(B, Sk, D, generator=g, device="cuda")
    v = torch.randn(B, Sk, D, generator=g, device="cuda")
    do = torch.randn(B, Sq, D, generator=g, device="cuda")
    dl = torch.randn(B, Sq, H, generator=g, device="cuda")
    return q.to(dtype), k.to(dtype), v.to(dtype), do, dl


def _ring_cases(shapes):
    return [(shape, False) for shape in shapes] + [(RING_CLAMP_SHAPE, True)]


def fp32_core_hops(q, k, v, do, dl, scale, H):
    """(forward, backward): calls of the two hop kernels' fp32-core bodies on
    bf16 q, k, v (dtype code 2, which no wrapper passes): the bf16 bodies
    before the tensor-core redesign, timed beside it as `parent_ms`."""
    B, Sq, D = q.shape
    Sk, hd = k.shape[1], D // H
    strides = [s for t in (q, k, v) for s in (t.stride(0), t.stride(1))]
    o = torch.empty(B, Sq, D, device="cuda")
    l = torch.empty(B, Sq, H, device="cuda")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fwd = _build.function("ring_hop_fwd", "fdt_ring_hop_fwd", _FWD_ARGS)
    bwd = _build.function("ring_hop_bwd", "fdt_ring_hop_bwd", _BWD_ARGS)
    stream = torch.cuda.current_stream().cuda_stream

    def run_fwd():
        _build.check_status("ring_hop_fwd", fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), l.data_ptr(), *strides,
            B, Sq, Sk, H, hd, scale, 2, stream), "fp32-core ring_hop_fwd")

    def run_bwd():
        _build.check_status("ring_hop_bwd", bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dl.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *strides, B, Sq, Sk, H, hd, scale, 2,
            stream), "fp32-core ring_hop_bwd")
    return run_fwd, run_bwd


def phase_ring_kernel():
    """Kernel 4 vs its plain version at every shape and dtype; returns the
    sampling-shape bf16 row. The library yardstick is the flash attention
    call that also returns the rows' LSE (the efficient one in fp32, which
    flash does not take): it computes the normalised softmax, where the hop
    returns unnormalised partials, and is timed only."""
    g = torch.Generator(device="cuda").manual_seed(5)
    main = None
    for (B, Sq, Sk, H, hd), clamp in _ring_cases(RING_SHAPES):
        D = H * hd
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, _, _ = _hop_inputs(B, Sq, Sk, H, hd, dtype, g, clamp)
            scale = hd ** -0.5
            o, l = _launch_hop_fwd(q, k, v, scale, H)
            torch.cuda.synchronize()
            want_o, want_l = _hop_forward_plain(q, k, v, scale, H)
            errs = {"o_u": _rel_err(o, want_o), "l": _rel_err(l, want_l)}
            if not (torch.isfinite(o).all() and max(errs.values()) <= RING_RTOL[dtype]):
                raise AssertionError(f"ring hop forward vs plain at {(B, Sq, Sk, H, hd)} "
                                     f"{dtype} clamp={clamp}: {errs} > {RING_RTOL[dtype]}")
            if clamp and not want_l.max().item() > math.exp(50.0):
                raise AssertionError("the clamp-crossing inputs stayed below the clamp")
            q4, k4, v4 = (t.view(B, t.shape[1], H, hd).transpose(1, 2) for t in (q, k, v))
            if dtype == torch.bfloat16:
                library = "aten._scaled_dot_product_flash_attention (normalised, with LSE)"
                lib = lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                    q4, k4, v4, 0.0, False, False, scale=scale)
            else:
                library = "aten._scaled_dot_product_efficient_attention (normalised, with LSE)"
                lib = lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
                    q4, k4, v4, None, True, 0.0, False, scale=scale)
            # read q once and k, v once, write o_u and l (fp32) once
            nbytes = (B * Sq * D + 2 * B * Sk * D) * q.element_size() + 4 * (B * Sq * D + B * Sq * H)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = 4 * B * Sq * Sk * D / PEAK_FLOPS[dtype] * 1e3
            row = {"phase": "ring_kernel", "name": "ring_hop_fwd", "shape": [B, Sq, Sk, H, hd],
                   "dtype": _dtype_name(dtype), "clamp_crossing": clamp, "max_rel_err": errs,
                   "max_abs_err": max((o - want_o).abs().max().item(),
                                      (l - want_l).abs().max().item()),
                   "rtol": RING_RTOL[dtype],
                   "kernel_ms": cuda_ms(lambda: _launch_hop_fwd(q, k, v, scale, H)),
                   "plain_ms": cuda_ms(lambda: _hop_forward_plain(q, k, v, scale, H)),
                   "library_ms": cuda_ms(lib), "library": library,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            if dtype == torch.bfloat16:
                row["parent_ms"] = cuda_ms(fp32_core_hops(q, k, v, None, None, scale, H)[0])
            emit(_ratios(row))
            if (B, Sq, Sk, H, hd) == RING_SHAPES[0] and dtype == torch.bfloat16 and not clamp:
                main = row
            del q, k, v, o, l, want_o, want_l, q4, k4, v4
    torch.cuda.empty_cache()
    return main


def phase_ring_kernel_bwd():
    """Kernel 5 vs its plain version at every shape and dtype; returns the
    gradient-shape bf16 row. SDPA's backward alone is timed beside it."""
    g = torch.Generator(device="cuda").manual_seed(6)
    main = None
    for (B, Sq, Sk, H, hd), clamp in _ring_cases(RING_BWD_SHAPES):
        D = H * hd
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do, dl = _hop_inputs(B, Sq, Sk, H, hd, dtype, g, clamp)
            scale = hd ** -0.5
            got = _launch_hop_bwd(q, k, v, do, dl, scale, H)
            torch.cuda.synchronize()
            want = _hop_backward_plain(q, k, v, do, dl, scale, H)
            errs = {n: _rel_err(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, want)}
            if not (all(torch.isfinite(t).all() for t in got)
                    and max(errs.values()) <= RING_RTOL[dtype]):
                raise AssertionError(f"ring hop backward vs plain at {(B, Sq, Sk, H, hd)} "
                                     f"{dtype} clamp={clamp}: {errs} > {RING_RTOL[dtype]}")
            # SDPA's backward alone: the fused op
            q4, k4, v4 = (t.view(B, t.shape[1], H, hd).transpose(1, 2).contiguous()
                          for t in (q, k, v))
            do4 = do.to(dtype).view(B, Sq, H, hd).transpose(1, 2).contiguous()
            lib, library = sdpa_backward(q4, k4, v4, do4, scale)
            # read q, k, v and write dq, dk, dv in the input dtype; read do, dl fp32
            nbytes = (2 * (B * Sq * D + 2 * B * Sk * D) * q.element_size()
                      + 4 * (B * Sq * D + B * Sq * H))
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = 10 * B * Sq * Sk * D / PEAK_FLOPS[dtype] * 1e3
            row = {"phase": "ring_kernel_bwd", "name": "ring_hop_bwd",
                   "shape": [B, Sq, Sk, H, hd], "dtype": _dtype_name(dtype),
                   "clamp_crossing": clamp, "max_rel_err": errs,
                   "max_abs_err": max((a.float() - b.float()).abs().max().item()
                                      for a, b in zip(got, want)),
                   "rtol": RING_RTOL[dtype],
                   "kernel_ms": cuda_ms(lambda: _launch_hop_bwd(q, k, v, do, dl, scale, H)),
                   "plain_ms": cuda_ms(lambda: _hop_backward_plain(q, k, v, do, dl, scale, H)),
                   "library_ms": cuda_ms(lib), "library": library + " (normalised softmax)",
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            if dtype == torch.bfloat16:
                row["parent_ms"] = cuda_ms(fp32_core_hops(q, k, v, do, dl, scale, H)[1])
            emit(_ratios(row))
            if (B, Sq, Sk, H, hd) == RING_BWD_SHAPES[0] and dtype == torch.bfloat16 and not clamp:
                main = row
            del q, k, v, do, dl, got, want, q4, k4, v4, do4, lib
    torch.cuda.empty_cache()
    return main


def _seq_small_check():
    """A small bf16 model run sequence-parallel on the card (hop kernels) and
    on the CPU (plain hops), same weights and inputs."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(4, 4, 16, 16, generator=g)
    t = torch.tensor([999, 500, 250, 3])
    y = torch.tensor([1, 7, 1000, 3])
    outs, launches = [], None
    for device in ("cuda", "cpu"):
        model = DiT_models["DiT-S/2"](input_size=16, depth=2, dtype=torch.bfloat16,
                                      device=device, seed=0)
        cli.perturb_(model)
        _build.reset_launch_counts()
        with torch.inference_mode():
            outs.append(dit_sequence_parallel_forward(
                model, x.to(device), t.to(device), y.to(device), LocalRing(SEQ_N)).cpu())
        if device == "cuda":
            torch.cuda.synchronize()
            launches = _build.launch_counts["ring_hop_fwd"]
    err, peak = (outs[0] - outs[1]).abs().max().item(), outs[1].abs().max().item()
    if not (launches == 2 * SEQ_N and err <= 2e-2 * peak):
        raise AssertionError(f"small sequence-parallel model card vs CPU: err {err} > "
                             f"2e-2 x {peak}, or {launches} hop launches != {2 * SEQ_N}")
    return {"max_abs_err": err, "tol": 2e-2 * peak}


def _seq_model(dtype):
    model = DiT_models["DiT-XL/2"](input_size=64, depth=SEQ_DEPTH, dtype=dtype, device="cuda",
                                   seed=0)
    cli.perturb_(model)
    return model.eval()


def _seq_inputs(batch):
    g = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn(batch, 4, 64, 64, generator=g, device="cuda")
    t = torch.randint(0, 1000, (batch,), generator=g, device="cuda")
    y = torch.tensor(cli.CLASS_LABELS[:batch], device="cuda")
    return x, t, y


def phase_seq_parallel(steps, profile_table):
    """Sequence-parallel DiT-XL/2 at 512² (64² latents, 1024 tokens) over
    LocalRing(4): 4 shards of 256 tokens, stacked on the batch axis.

    Launch counts, checked exactly: a bf16 forward launches `ring_hop_fwd`
    depth x n times (one hop per ring step per block), and its backward
    launches `ring_hop_bwd` depth x n times; the dense kernels are not
    launched. So DDPM sampling of `steps` steps launches depth x n x steps
    hop forwards, and `SEQ_GRAD_STEPS` forward + backward steps launch
    depth x n x SEQ_GRAD_STEPS of each."""
    ring = LocalRing(SEQ_N)
    small = _seq_small_check()

    # 1. the forward against the unsharded forward, fp32 (the streaming
    # ring against kernel 1 in fp32) and bf16 (the hop kernels against it)
    x, t, y = _seq_inputs(SEQ_SAMPLE_BATCH)
    fwd = {}
    for dtype, rtol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        t0 = time.perf_counter()
        model = _seq_model(dtype)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        with torch.inference_mode():
            _build.reset_launch_counts()
            got = dit_sequence_parallel_forward(model, x, t, y, ring)
            torch.cuda.synchronize()
            launches = dict(_build.launch_counts)
            want = model(x, t, y)
        err, peak = (got - want).abs().max().item(), want.abs().max().item()
        want_launches = model.depth * SEQ_N if dtype == torch.bfloat16 else 0
        if not (tuple(got.shape) == (SEQ_SAMPLE_BATCH, 8, 64, 64) and torch.isfinite(got).all()
                and err <= rtol * peak):
            raise AssertionError(f"sequence-parallel XL/2 512² {dtype} vs unsharded: "
                                 f"max abs err {err} > {rtol} x {peak}")
        if (launches["ring_hop_fwd"] != want_launches or launches["attention_fwd"]
                or launches["ring_hop_bwd"]):
            raise AssertionError(f"sequence-parallel forward {dtype} launches {launches}, "
                                 f"expected ring_hop_fwd = depth x n = {want_launches}")
        fwd[_dtype_name(dtype)] = {"max_abs_err": err, "max_abs_out": peak, "tol": rtol * peak,
                                   "launches": launches, "build_s": build_s}
        del got, want
        if dtype == torch.float32:
            del model
            torch.cuda.empty_cache()

    # 2. the sampling path: DDPM over the sharded forward, batch 4, no CFG
    diffusion = create_diffusion(str(steps), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(9)
    z = torch.randn(SEQ_SAMPLE_BATCH, 4, 64, 64, generator=g, device="cuda")
    model_fn = lambda xs, ts: dit_sequence_parallel_forward(model, xs, ts, y, ring)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        latents = diffusion.p_sample_loop(model_fn, z.shape, noise=z, generator=g,
                                          clip_denoised=False)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    sample_launches = dict(_build.launch_counts)
    want = {k: 0 for k in sample_launches}
    want["ring_hop_fwd"] = model.depth * SEQ_N * steps
    if sample_launches != want:
        raise AssertionError(f"sequence-parallel sampling launches {sample_launches}, "
                             f"expected {want}")
    if not (tuple(latents.shape) == (SEQ_SAMPLE_BATCH, 4, 64, 64)
            and torch.isfinite(latents).all()):
        raise AssertionError(f"bad sequence-parallel latents: {tuple(latents.shape)}")
    sample = {"batch": SEQ_SAMPLE_BATCH, "sampler": "ddpm", "steps": steps, "cfg": None,
              "loop_s": loop_s, "s_per_step": loop_s / steps,
              "images_per_s": SEQ_SAMPLE_BATCH / loop_s, "launches": sample_launches,
              "latents_mean_abs": latents.abs().mean().item(),
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if profile_table:
        diffusion2 = create_diffusion("2", device="cuda")
        with torch.inference_mode():
            sample["profile"] = profile_device(
                lambda: diffusion2.p_sample_loop(model_fn, z.shape, noise=z, generator=g,
                                                 clip_denoised=False),
                profile_table, "2 sequence-parallel sampling steps")
    del latents, diffusion

    # 3. the gradient path: d sum(out^2) / d every parameter, batch 2, bf16
    xb, tb, yb = x[:SEQ_GRAD_BATCH], t[:SEQ_GRAD_BATCH], y[:SEQ_GRAD_BATCH]
    params = dict(model.named_parameters())

    def grads(forward):
        model.zero_grad(set_to_none=True)
        (forward(xb, tb, yb) ** 2).sum().backward()
        return {n: p.grad.detach().clone() for n, p in params.items()}

    _build.reset_launch_counts()
    g_sp = grads(lambda *a: dit_sequence_parallel_forward(model, *a, ring))
    torch.cuda.synchronize()
    one_step = dict(_build.launch_counts)
    g_ref = grads(lambda *a: model(*a))
    bad = []
    worst = (0.0, None)
    for n in params:
        a, b = g_sp[n], g_ref[n]
        peak = b.abs().max().item()
        err = (a - b).abs().max().item()
        if peak > 0:
            worst = max(worst, (err / peak, n))
        if (not torch.isfinite(a).all() or err > 5e-2 * peak
                or (peak > 0 and not a.abs().max().item() > 0)):
            bad.append((n, err, peak))
    if bad:
        raise AssertionError(f"sequence-parallel gradient vs unsharded, {len(bad)} leaves "
                             f"off (name, max abs err, max |g|): {bad[:5]}")
    del g_sp, g_ref
    depth = model.depth
    if one_step != {**{k: 0 for k in one_step}, "ring_hop_fwd": depth * SEQ_N,
                    "ring_hop_bwd": depth * SEQ_N}:
        raise AssertionError(f"sequence-parallel forward + backward launches {one_step}, "
                             f"expected depth x n = {depth * SEQ_N} of each hop kernel")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(SEQ_GRAD_STEPS):
        model.zero_grad(set_to_none=True)
        (dit_sequence_parallel_forward(model, xb, tb, yb, ring) ** 2).sum().backward()
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    grad_launches = dict(_build.launch_counts)
    want = {**{k: 0 for k in grad_launches}, "ring_hop_fwd": depth * SEQ_N * SEQ_GRAD_STEPS,
            "ring_hop_bwd": depth * SEQ_N * SEQ_GRAD_STEPS}
    if grad_launches != want:
        raise AssertionError(f"sequence-parallel gradient steps launch {grad_launches}, "
                             f"expected {want}")
    if profile_table:
        root, ext = os.path.splitext(profile_table)

        def grad_step():
            model.zero_grad(set_to_none=True)
            (dit_sequence_parallel_forward(model, xb, tb, yb, ring) ** 2).sum().backward()

        grad_profile = profile_device(grad_step, f"{root}_grad{ext}",
                                      "1 sequence-parallel forward + backward")
    grad = {"batch": SEQ_GRAD_BATCH, "dtype": "bfloat16", "leaves": len(params),
            "worst_leaf_rel_err": worst[0], "worst_leaf": worst[1], "tol_rel": 5e-2,
            "steps": SEQ_GRAD_STEPS, "s_per_step": grad_s / SEQ_GRAD_STEPS,
            "images_per_s": SEQ_GRAD_BATCH * SEQ_GRAD_STEPS / grad_s,
            "launches": grad_launches,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if profile_table:
        grad["profile"] = grad_profile
    emit({"phase": "seq_parallel", "model": "DiT-XL/2", "depth": SEQ_DEPTH, "image_size": 512,
          "tokens": 1024,
          "ring": f"LocalRing({SEQ_N})", "shard_tokens": 1024 // SEQ_N, "small_check": small,
          "forward": fwd, "sample": sample, "grad": grad})
    model.zero_grad(set_to_none=True)
    del model, params
    torch.cuda.empty_cache()
    return sample_launches, grad_launches


# -- 16, 17. pipeline and pipefusion: GPipe and patch-pipelined sampling -----

def _grad_leaves(model, forward):
    """{name: gradient} of mean(out^2) through `forward(model)`."""
    model.zero_grad(set_to_none=True)
    forward(model).float().square().mean().backward()
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _leaf_errors(got, want, rtol):
    """(worst error over max |g| and its leaf, the leaves past `rtol` x
    max |g| or not finite or all zero where the reference is not)."""
    worst, bad = (0.0, None), []
    for n, b in want.items():
        a, peak = got[n], b.abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        if peak > 0 and err / peak >= worst[0]:
            worst = (err / peak, n)
        if (not torch.isfinite(a).all() or err > rtol * peak
                or (peak > 0 and not a.abs().max().item() > 0)):
            bad.append((n, err, peak))
    return worst, bad


def _pipeline_small_check():
    """A small fp32 DiT-S/2 (depth 4) through LocalStages(2), 2 microbatches,
    on the card (kernels 1 and 2) and the CPU (their plain versions): output
    and every gradient within 1e-4 of max, launches exact."""
    from fast_dit_torch.parallel import LocalStages, dit_pipeline_forward
    g = torch.Generator().manual_seed(11)
    x, t = torch.randn(8, 4, 16, 16, generator=g), torch.tensor([1, 50, 500, 999] * 2)
    y = torch.tensor([1, 7, 1000, 3] * 2)
    res = {}
    for device in ("cuda", "cpu"):
        model = DiT_models["DiT-S/2"](input_size=16, depth=4, device=device, seed=0)
        cli.perturb_(model)
        fwd = lambda m: dit_pipeline_forward(m, x.to(device), t.to(device), y.to(device),
                                             LocalStages(2), 2)
        _build.reset_launch_counts()
        with torch.inference_mode():
            out = fwd(model).cpu()
        grads = _grad_leaves(model, fwd)
        if device == "cuda":
            torch.cuda.synchronize()
        res[device] = (out, {n: v.cpu() for n, v in grads.items()}, dict(_build.launch_counts))
    (out, grads, launches), (want, want_grads, _) = res["cuda"], res["cpu"]
    err, peak = (out - want).abs().max().item(), want.abs().max().item()
    worst, bad = _leaf_errors(grads, want_grads, 1e-4)
    if not (err <= 1e-4 * peak and not bad and launches["attention_fwd"] == 2 * 4 * 2
            and launches["attention_bwd"] == 4 * 2):
        raise AssertionError(f"small pipelined DiT card vs CPU: output err {err} > 1e-4 x "
                             f"{peak}, leaves off {bad[:3]}, or launches {launches} != 16 "
                             "forward (inference, then the gradient's) and 8 backward")
    return {"max_abs_err": err, "tol": 1e-4 * peak, "worst_leaf_rel_err": worst[0]}


def _xl_bf16():
    """DiT-XL/2 256², bf16 compute over fp32 parameters, seed 0 and the
    sampler's perturbation: the same weights in every process."""
    model = DiT_models["DiT-XL/2"](input_size=32, dtype=torch.bfloat16, device="cuda", seed=0)
    cli.perturb_(model)
    return model


def _pipe_inputs():
    g = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn(PIPE_BATCH, 4, 32, 32, generator=g, device="cuda")
    t = torch.randint(0, 1000, (PIPE_BATCH,), generator=g, device="cuda")
    y = torch.randint(0, 1000, (PIPE_BATCH,), generator=g, device="cuda")
    return x, t, y


def _wall_ms(fn, iters=PIPE_ITERS):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _pipeline_full(model):
    """DiT-XL/2 bf16 over LocalStages(PIPE_STAGES): forward and gradient
    against the unpipelined model, launches, times, peak memory."""
    from fast_dit_torch.parallel import LocalStages, dit_pipeline_forward
    x, t, y = _pipe_inputs()
    stages = LocalStages(PIPE_STAGES)
    pipe = lambda m: dit_pipeline_forward(m, x, t, y, stages, PIPE_MICRO)
    plain = lambda m: m(x, t, y)
    n = model.depth * PIPE_MICRO
    with torch.inference_mode():
        _build.reset_launch_counts()
        got = pipe(model)
        torch.cuda.synchronize()
        fwd_launches = dict(_build.launch_counts)
        want = plain(model)
    err, peak = (got - want).abs().max().item(), want.abs().max().item()
    if not (tuple(got.shape) == (PIPE_BATCH, 8, 32, 32) and torch.isfinite(got).all()
            and err <= 2e-2 * peak):
        raise AssertionError(f"pipelined XL/2 forward vs unpipelined: {err} > 2e-2 x {peak}")
    if fwd_launches != {**{k: 0 for k in fwd_launches}, "attention_fwd": n}:
        raise AssertionError(f"pipelined forward launches {fwd_launches}, expected "
                             f"attention_fwd = depth x M = {n}")
    del got, want
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    g_pipe = _grad_leaves(model, pipe)
    torch.cuda.synchronize()
    grad_launches = dict(_build.launch_counts)
    pipe_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if grad_launches != {**{k: 0 for k in grad_launches}, "attention_fwd": n,
                         "attention_bwd": n}:
        raise AssertionError(f"pipelined forward + backward launches {grad_launches}, "
                             f"expected depth x M = {n} of kernels 1 and 2")
    torch.cuda.reset_peak_memory_stats()
    g_plain = _grad_leaves(model, plain)
    plain_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    worst, bad = _leaf_errors(g_pipe, g_plain, PIPE_GRAD_RTOL)
    leaves = len(g_plain)
    if bad or len(g_pipe) != leaves:
        raise AssertionError(f"pipelined XL/2 gradient vs unpipelined, {len(bad)} leaves off "
                             f"(name, max abs err, max |g|): {bad[:5]}")
    del g_pipe, g_plain

    def step(forward):
        def run():
            model.zero_grad(set_to_none=True)
            forward(model).float().square().mean().backward()
        return run

    def infer(forward):
        def run():
            with torch.inference_mode():
                forward(model)
        return run

    # wall ms (the mean of PIPE_ITERS runs) and the profiler's device busy ms
    # and idle share of one run: a step issues thousands of launches, more
    # than the device's queue holds, so cuda_ms's spin cannot hide the host
    times = {}
    for name, run in (("forward", infer(pipe)), ("plain_forward", infer(plain)),
                      ("step", step(pipe)), ("plain_step", step(plain))):
        prof = profile_device(run, os.path.join(OUT_DIR, f"profile_pipeline_{name}.txt"), name)
        times[name] = {"wall_ms": _wall_ms(run), "device_busy_ms": prof["device_busy_ms"],
                       "idle_share": prof["idle_share"],
                       "attention_kernels_ms": prof["attention_kernels_ms"],
                       "top": prof["top"][:4]}
    model.zero_grad(set_to_none=True)
    return fwd_launches, grad_launches, {
        "forward": {"max_abs_err": err, "max_abs_out": peak, "tol": 2e-2 * peak,
                    "launches": fwd_launches},
        "grad": {"loss": "mean(out^2)", "leaves": leaves, "worst_leaf_rel_err": worst[0],
                 "worst_leaf": worst[1], "tol_rel": PIPE_GRAD_RTOL, "launches": grad_launches},
        "peak_mem_gib": pipe_peak, "plain_peak_mem_gib": plain_peak, "times": times}


def _small_pipe_model():
    """The process stages' model: DiT-S/2 256² (256 tokens, hd 64), fp32,
    depth PIPE_RANK_DEPTH, seed 0 and the sampler's perturbation: the same
    weights in every process."""
    model = DiT_models["DiT-S/2"](input_size=32, depth=PIPE_RANK_DEPTH, device="cuda", seed=0)
    cli.perturb_(model)
    return model


def stage_rank():
    """A rank's side of the process stages (PIPE_RANKS ranks on cuda:0 over
    gloo, `_small_pipe_model`): the references first, with every block, over
    LocalStages of the world's size (the pipelined forward and gradient of
    PIPE_RANK_BATCH rows in PIPE_MICRO microbatches; the PipeFusion chain,
    PF_RANK_STEPS DDIM steps with CFG 4.0 over 4 labels, PF_CHUNKS chunks
    after PF_WARMUP exact); then the other stages' blocks are dropped and
    the same paths run over ProcessGroupStages, their launches counted from
    0 and their transport timed; returns the errors against the references,
    the counts and times."""
    import torch.distributed as dist

    from fast_dit_torch.parallel import (LocalStages, ProcessGroupStages, collectives,
                                         dit_pipeline_forward, pipefusion_sample_loop)
    from fast_dit_torch.parallel.pipeline import keep_own_blocks, stage_slice
    stages = ProcessGroupStages()
    local = LocalStages(stages.size)
    model = _small_pipe_model()
    g = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn(PIPE_RANK_BATCH, 4, 32, 32, generator=g, device="cuda")
    t = torch.randint(0, 1000, (PIPE_RANK_BATCH,), generator=g, device="cuda")
    y = torch.randint(0, 1000, (PIPE_RANK_BATCH,), generator=g, device="cuda")
    z = torch.randn(4, 4, 32, 32, generator=g, device="cuda")
    labels = torch.tensor([0, 3, 7, 999], device="cuda")
    sched = create_diffusion(f"ddim{PF_RANK_STEPS}", device="cuda").schedule
    chain = lambda st: pipefusion_sample_loop(model, z.shape, sched, labels, st, PF_CHUNKS,
                                              warmup=PF_WARMUP, noise=z, cfg_scale=4.0)
    pipe = lambda m, st: dit_pipeline_forward(m, x, t, y, st, PIPE_MICRO)
    with torch.inference_mode():
        want = pipe(model, local)
        want_chain = chain(local)
    g_want = _grad_leaves(model, lambda m: pipe(m, local))
    own = range(model.depth)[stage_slice(model.depth, stages, stages.rank)]
    g_want = {n: v for n, v in g_want.items()
              if not n.startswith("blocks.") or int(n.split(".")[1]) in own}
    model.zero_grad(set_to_none=True)
    keep_own_blocks(model, stages)

    def timed_run(run):
        collectives.exempt_ranges.update(count=0, seconds=0.0)
        _build.reset_launch_counts()
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return (out, (time.perf_counter() - t0) * 1e3, dict(_build.launch_counts),
                dict(collectives.exempt_ranges))

    with torch.inference_mode():
        got, fwd_ms, fwd_launches, fwd_transport = timed_run(lambda: pipe(model, stages))
    g_got, step_ms, step_launches, step_transport = timed_run(
        lambda: _grad_leaves(model, lambda m: pipe(m, stages)))
    with torch.inference_mode():
        got_chain, chain_ms, chain_launches, chain_transport = timed_run(lambda: chain(stages))
    worst, bad = _leaf_errors(g_got, g_want, PIPE_RANK_GRAD_RTOL)
    return {"rank": stages.rank, "blocks": [own.start, own.stop], "ring": _ring_rotate(),
            "forward_err": (got - want).abs().max().item(), "forward_peak": want.abs().max().item(),
            "grad_leaves": len(g_got), "grad_leaves_want": len(g_want),
            "grad_worst_rel_err": worst[0], "grad_worst_leaf": worst[1], "grad_bad": bad[:5],
            "chain": got_chain.cpu(), "chain_err": (got_chain - want_chain).abs().max().item(),
            "chain_peak": want_chain.abs().max().item(),
            "forward_ms": fwd_ms, "step_ms": step_ms, "chain_ms": chain_ms,
            "forward_launches": fwd_launches, "step_launches": step_launches,
            "chain_launches": chain_launches, "forward_transport": fwd_transport,
            "step_transport": step_transport, "chain_transport": chain_transport}


def _ring_rotate():
    """The sequence-parallel ring's hand-off on CUDA tensors over gloo (host
    buffers): rank r gets rank r - 1's block, and the backward hands the
    cotangent back; fp32 and bf16. {dtype: equal}."""
    from fast_dit_torch.parallel import ProcessGroupRing
    ring = ProcessGroupRing()
    ok = {}
    for dtype in (torch.float32, torch.bfloat16):
        v = torch.full((4, 256, 1152), ring.rank + 1.0, dtype=dtype, device="cuda",
                       requires_grad=True)
        got = ring.rotate(v)
        (got.float() * (ring.rank + 1)).sum().backward()
        ok[_dtype_name(dtype)] = bool(
            torch.equal(got, torch.full_like(v, (ring.rank - 1) % ring.size + 1.0))
            and torch.equal(v.grad, torch.full_like(v, (ring.rank + 1) % ring.size + 1.0)))
    return ok


def _check_stage_rows(rows):
    """The process stages' rows (`stage_rank`), checked against one process
    at fp32 limits: forward and chain within 1e-5 x max and the chain equal
    between the ranks, every gradient leaf a rank holds within
    PIPE_RANK_GRAD_RTOL x max of LocalStages' (blocks on their own rank
    only); launches exact per rank (kernel 1 depth / P x M in the forward
    and again in the gradient's forward, kernel 2 depth / P x M; none in the
    chain), the ring's hand-off exact."""
    n = PIPE_RANK_DEPTH // PIPE_RANKS * PIPE_MICRO
    for r in rows:
        zero = lambda d: {k: 0 for k in d}
        r["chain_rank0_err"] = (r["chain"] - rows[0]["chain"]).abs().max().item()
        if not (r["forward_err"] <= 1e-5 * r["forward_peak"] and not r["grad_bad"]
                and r["grad_leaves"] == r["grad_leaves_want"]
                and r["chain_err"] <= 1e-5 * r["chain_peak"]
                and r["chain_rank0_err"] <= 1e-5 * r["chain_peak"]):
            raise AssertionError(f"process stage {r['rank']} vs LocalStages: forward "
                                 f"{r['forward_err']}, leaves off {r['grad_bad']} "
                                 f"({r['grad_leaves']} of {r['grad_leaves_want']}), chain "
                                 f"{r['chain_err']} or unequal between ranks")
        want = [{**zero(r["forward_launches"]), "attention_fwd": n},
                {**zero(r["step_launches"]), "attention_fwd": n, "attention_bwd": n},
                zero(r["chain_launches"])]
        if not all(r["ring"].values()):
            raise AssertionError(f"ProcessGroupRing's hand-off on rank {r['rank']}: {r['ring']}")
        got = [r["forward_launches"], r["step_launches"], r["chain_launches"]]
        if got != want:
            raise AssertionError(f"process stage {r['rank']} launches {got}, expected {want}")
    for r in rows:
        r["chain_abs_mean"] = r.pop("chain").abs().mean().item()
    return rows


def phase_pipeline():
    """GPipe over the block stack; see the module docstring (16). The
    process stages start first and run beside the small check and the
    DiT-XL/2 build; the timed part runs after they end. Returns (the XL/2
    model, the forward's and the gradient's launches, the ranks' launches
    summed, the ranks' rows)."""
    t0 = time.perf_counter()
    started = _start_ranks(PIPE_RANKS, "stage_rank")
    try:
        small = _pipeline_small_check()
        t1 = time.perf_counter()
        model = _xl_bf16()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t1
        rows = _check_stage_rows(_wait_ranks(started))
    finally:
        _kill_ranks(started)
    ranks_s = time.perf_counter() - t0
    fwd_launches, grad_launches, full = _pipeline_full(model)
    kernels = {name: {k: KERNEL_ROWS[name, PIPE_SHAPE, torch.bfloat16, False][k]
                      for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
               for name in ("attention_fwd", "attention_bwd")}
    rank_launches = collections.Counter()
    for r in rows:
        rank_launches.update(r["forward_launches"])
        rank_launches.update(r["step_launches"])
    emit({"phase": "pipeline", "model": "DiT-XL/2", "image_size": 256, "dtype": "bfloat16",
          "batch": PIPE_BATCH, "microbatches": PIPE_MICRO,
          "stages": f"LocalStages({PIPE_STAGES})", "blocks_per_stage": model.depth // PIPE_STAGES,
          "small_check": small, "build_s": build_s, **full,
          "kernels_at_microbatch_shape": {"shape": list(PIPE_SHAPE), **kernels},
          "ranks": {"stages": f"ProcessGroupStages over {PIPE_RANKS} gloo ranks on one card",
                    "model": f"DiT-S/2 256², fp32, depth {PIPE_RANK_DEPTH}",
                    "batch": PIPE_RANK_BATCH, "microbatches": PIPE_MICRO,
                    "scaling": "no scaling number: the ranks share one card and gloo's "
                               "host transport", "seconds_to_results": ranks_s,
                    "rows": [{k: v for k, v in r.items() if not k.startswith("chain")}
                             for r in rows]}})
    return model, fwd_launches, grad_launches, dict(rank_launches), rows


def _pf_inputs():
    g = torch.Generator(device="cuda").manual_seed(13)
    n = len(cli.CLASS_LABELS)
    return (torch.randn(n, 4, 32, 32, generator=g, device="cuda"),
            torch.tensor(cli.CLASS_LABELS, device="cuda"))


def _pipefusion_small_check():
    """The CPU tests' tiny DiT (depth 8, width 32, fp32), a chunked DDIM 5
    chain with CFG over LocalStages(4), 4 chunks after 1 exact step, on the
    card and the CPU: within 1e-4 of max."""
    from fast_dit_torch.models import DiT
    from fast_dit_torch.parallel import LocalStages, pipefusion_sample_loop
    z = torch.randn(4, 4, 8, 8, generator=torch.Generator().manual_seed(14))
    outs = []
    for device in ("cuda", "cpu"):
        model = DiT(input_size=8, patch_size=2, hidden_size=32, depth=8, num_heads=4,
                    num_classes=10, device=device, seed=0)
        cli.perturb_(model, std=0.05)
        with torch.inference_mode():
            outs.append(pipefusion_sample_loop(
                model, z.shape, create_diffusion("ddim5", device=device).schedule,
                torch.tensor([0, 3, 7, 9], device=device), LocalStages(4), 4, warmup=1,
                noise=z.to(device), cfg_scale=4.0).cpu())
    err, peak = (outs[0] - outs[1]).abs().max().item(), outs[1].abs().max().item()
    if not (torch.isfinite(outs[0]).all() and err <= 1e-4 * peak):
        raise AssertionError(f"small PipeFusion chain card vs CPU: {err} > 1e-4 x {peak}")
    return {"max_abs_err": err, "tol": 1e-4 * peak}


def phase_pipefusion(model, rank_rows):
    """PipeFusion sampling; see the module docstring (17). `rank_rows` are
    the process stages' rows of phase `pipeline`, whose chains ran there.
    Returns the PipeFusion chains' launches, summed."""
    from fast_dit_torch.parallel import (LocalStages, init_kv_cache, pipefusion_forward,
                                         pipefusion_sample_loop)
    small = _pipefusion_small_check()
    model.eval()
    z, y = _pf_inputs()
    n = len(y)
    diffusion = create_diffusion(f"ddim{PF_STEPS}", device="cuda")
    yy = torch.cat([y, torch.full_like(y, model.num_classes)])
    stages = LocalStages(PF_STAGES)
    chains = {}

    def run(name, fn, sync_free=True):
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        if sync_free:
            torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            with torch.inference_mode():
                out = fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        loop_s = time.perf_counter() - t0
        chains[name] = {"loop_s": loop_s, "s_per_step": loop_s / PF_STEPS,
                        "images_per_s": n / loop_s, "launches": dict(_build.launch_counts),
                        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        return out

    ddim = lambda: diffusion.ddim_sample_loop(
        lambda x, t: model.forward_with_cfg(x, t, yy, 4.0), (2 * n, 4, 32, 32),
        noise=torch.cat([z, z]))[:n]
    exact = run("ddim_forward_with_cfg", ddim)
    # the yardstick of two exact bf16 chains: the same chain with the plain
    # attention (fp32 softmax) in place of kernel 1
    for blk in model.blocks:
        blk.attn.attn_backend = "einsum"
    plain = run("ddim_forward_with_cfg_plain_attention", ddim)
    for blk in model.blocks:
        blk.attn.attn_backend = "auto"
    pf = lambda chunks: pipefusion_sample_loop(model, z.shape, diffusion.schedule, y, stages,
                                               chunks, warmup=PF_WARMUP, noise=z, cfg_scale=4.0)
    one = run("pipefusion_1_chunk", lambda: pf(1))
    chunked = run(f"pipefusion_{PF_CHUNKS}_chunks", lambda: pf(PF_CHUNKS))
    # the one-chunk forward itself against the model's, at the first step
    xx = torch.cat([z, z])
    tt = torch.full((2 * n,), diffusion.schedule.timestep_map_host[-1], device="cuda")
    with torch.inference_mode():
        f_one = pipefusion_forward(model, xx, tt, yy, init_kv_cache(model, 2 * n), stages, 1)[0]
        f_model = model(xx, tt, yy)
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    fwd_err, fwd_peak = (f_one - f_model).abs().max().item(), f_model.abs().max().item()
    one_rel, plain_rel, chunked_rel = rel(one, exact), rel(plain, exact), rel(chunked, exact)
    del f_one, f_model
    want_exact = model.depth * PF_STEPS
    launches = {k: c["launches"] for k, c in chains.items()}
    kv = init_kv_cache(model, 2 * n)
    rank_rows = [{k: r[k] for k in ("rank", "chain_err", "chain_peak", "chain_rank0_err",
                                    "chain_ms", "chain_transport", "chain_abs_mean")}
                 for r in rank_rows]
    emit({"phase": "pipefusion", "model": "DiT-XL/2", "image_size": 256, "dtype": "bfloat16",
          "cfg_scale": 4.0, "labels": n, "batch": 2 * n, "sampler": "ddim", "steps": PF_STEPS,
          "stages": f"LocalStages({PF_STAGES})", "chunks": PF_CHUNKS,
          "chunk_tokens": 256 // PF_CHUNKS, "warmup": PF_WARMUP, "small_check": small,
          "one_chunk_forward": {"max_abs_err": fwd_err, "max_abs_out": fwd_peak,
                                "tol": 2e-2 * fwd_peak},
          "one_chunk_chain": {"max_abs_err": (one - exact).abs().max().item(),
                              "rel_distance": one_rel, "tol_rel": 2e-2},
          "plain_attention_chain_rel_distance": plain_rel,
          "chunked_rel_distance": chunked_rel, "kv_cache_shape": list(kv.shape),
          "kv_cache_gib": kv.numel() * kv.element_size() / 2 ** 30, "chains": chains,
          "ranks": {"stages": f"ProcessGroupStages over {PIPE_RANKS} gloo ranks on one card",
                    "steps": PF_RANK_STEPS, "rows": rank_rows}})
    if not (torch.isfinite(one).all() and torch.isfinite(chunked).all()
            and tuple(chunked.shape) == (n, 4, 32, 32) and fwd_err <= 2e-2 * fwd_peak
            and one_rel <= 2e-2):
        raise AssertionError(f"PipeFusion XL/2, one chunk vs the model: forward {fwd_err} > "
                             f"2e-2 x {fwd_peak}, or the chain's relative distance from DDIM "
                             f"over forward_with_cfg {one_rel} > 2e-2, or a chain not finite")
    if (launches["ddim_forward_with_cfg"]["attention_fwd"] != want_exact
            or any(v for k, c in launches.items() if k.startswith("pipefusion")
                   for v in c.values())):
        raise AssertionError(f"launches {launches}: expected kernel 1 depth x steps = "
                             f"{want_exact} in the DDIM chain and none in PipeFusion's (SDPA)")
    del kv
    # the path's launches, summed over its chains: 0 of every kernel
    return {k: sum(c[k] for name, c in launches.items() if name.startswith("pipefusion"))
            for k in launches["ddim_forward_with_cfg"]}


# -- the NVS model (DiTNVS: DiT-XL/2 with DINO cross-attention) ---------------

def _nvs_model(cfg, device, dtype=torch.float32, seed=0):
    """A DiTNVS of `cfg` on `device`: the seeded init plus `sample.perturb_`
    (a fresh model's zeroed adaLN and head would output 0)."""
    model = DiTNVS(**cfg, dtype=dtype, device=device, seed=seed)
    cli.perturb_(model)
    return model.eval()


def _set_attention_backend(model, backend):
    for blk in model.blocks:
        blk.attn.attn_backend = blk.cross_attn.attn_backend = backend


def _nvs_inputs(cfg, batch, device, seed):
    """Seeded latents, labels ([cond ; null] halves), `random_dino_features`
    and a hole mask (1 = fill, about 40 % of the latent's pixels)."""
    g = torch.Generator().manual_seed(seed)
    n = cfg["input_size"]
    x = torch.randn(batch, cfg.get("in_channels", 4), n, n, generator=g)
    y = torch.randint(0, cfg["num_classes"], (batch // 2,), generator=g)
    y = torch.cat([y, torch.full_like(y, cfg["num_classes"])])
    feat = torch.from_numpy(random_dino_features(batch, cfg["dino_patch_grid"],
                                                 cfg["dino_dim"], seed=seed))
    mask = (torch.rand(batch, 1, n, n, generator=g) < 0.4).float()
    return [a.to(device) for a in (x, y, feat, mask)]


def _inpaint_draws(shape, steps, jump_n, device, seed):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn((steps, jump_n, *shape), generator=g).to(device)
            for k in ("known_noise", "step_noise", "renoise")}


def _nvs_small_check():
    """A small fp32 DiTNVS (cross-attention of 64 image tokens over 64 DINO
    tokens, kernel 1 on the card): forward_with_cfg, a DDPM chain and a
    RePaint chain with the same draws on the card and the CPU, within 1e-4
    of max."""
    cfg = dict(input_size=16, hidden_size=128, depth=3, num_heads=2, num_classes=10,
               dino_dim=48, dino_patch_grid=8, cross_layers=(0, 2))
    outs = {}
    for device in ("cuda", "cpu"):
        model = _nvs_model(cfg, device)
        x, y, feat, mask = _nvs_inputs(cfg, 4, device, seed=21)
        sched = create_diffusion("4", device=device).schedule
        fn = lambda xx, tt: model.forward_with_cfg(xx, tt, feat, y, 4.0)  # noqa: E731
        g = torch.Generator().manual_seed(22)
        step_noise = torch.randn((4, *x.shape), generator=g).to(device)
        with torch.inference_mode():
            outs[device] = [
                fn(x, torch.full((4,), 500, device=device)),
                p_sample_loop(fn, x.shape, sched, noise=x, step_noise=step_noise),
                inpaint_sample_loop(fn, x.clamp(-1, 1), mask, sched, noise=x, jump_n=2,
                                    **_inpaint_draws(x.shape, 4, 2, device, 23))]
    errs = {}
    for name, a, b in zip(("forward_with_cfg", "ddpm_4", "inpaint_4_jump_2"), outs["cuda"],
                          outs["cpu"]):
        err, peak = (a.cpu() - b).abs().max().item(), b.abs().max().item()
        errs[name] = {"max_abs_err": err, "tol": 1e-4 * peak}
        if not (torch.isfinite(a).all() and err <= 1e-4 * peak):
            raise AssertionError(f"small DiTNVS {name} card vs CPU: {err} > 1e-4 x {peak}")
    return errs


def _nvs_leaf_state(state, i):
    """(param, mu, nu, master, EMA) of parameter i, copied."""
    return [list(state.model.parameters())[i].detach().clone(), state.opt.mu[i].clone(),
            state.opt.nu[i].clone(), state.opt.master[i].clone(),
            list(state.ema.values())[i].clone()]


def _nvs_train(model, batch_size, warmup, steps):
    """`make_train_step(model_call=...)` with the `dino_feat` batch key and
    `--fused-optimizer`'s kernel 3 (bf16 parameters over fp32 masters, fp32
    nu, weight decay NVS_WD), `warmup` steps and then `steps` timed ones
    under sync debug mode "error", the launch counts set to 0 just before
    them; an unused cross
    layer's to_q weight, whose gradient is zero, is held against
    `_update_math` over the last step in every state. Returns (row, launches)."""
    cfg = dict(input_size=model.input_size, num_classes=model.num_classes,
               dino_dim=model.dino_dim, dino_patch_grid=model.dino_patch_grid)
    g = torch.Generator(device="cuda").manual_seed(31)
    state = create_train_state(model, fused_optimizer=True)
    diffusion = create_diffusion("", device="cuda")
    step = make_train_step(model, diffusion.schedule, lr=LR, weight_decay=NVS_WD,
                           generator=g, model_call=lambda x_t, t, b, force, gen: model(
                               x_t, t, b["dino_feat"], b["y"], train=True,
                               force_drop_ids=force, generator=gen))
    x, y, feat, _ = _nvs_inputs(cfg, batch_size, "cuda", seed=32)
    batch = {"x": x, "y": y, "dino_feat": feat}
    unused = min(set(range(model.depth)) - set(model.cross_layers))
    names = [n for n, _ in model.named_parameters()]
    leaf = names.index(f"blocks.{unused}.cross_attn.to_q.weight")
    for _ in range(warmup):
        step(state, batch)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    losses, before = [], None
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(steps):
            if i == steps - 1:
                before = _nvs_leaf_state(state, leaf)
            losses.append(step(state, batch)["loss"])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    launches = dict(_build.launch_counts)
    members = sum(len(lf.members) for lf in jax_leaves(model))
    per_step = {"attention_fwd": model.depth + len(model.cross_layers),
                "attention_bwd": model.depth + len(model.cross_layers),
                "fused_adamw_ema": members}
    want = {**{k: 0 for k in launches}, **{k: v * steps for k, v in per_step.items()}}
    if launches != want:
        raise AssertionError(f"DiTNVS training launches {launches}, expected {want}")
    grad = list(model.parameters())[leaf].grad
    bc1, bc2 = fu.bias_corrections(state.opt.count, 0.9, 0.999)
    p0, m0, v0, w0, e0 = before
    want_leaf = fu._update_math(grad, m0, v0, w0, e0, bc1.to(grad.device), bc2.to(grad.device), lr=LR,
                                b1=0.9, b2=0.999, eps=1e-8, wd=NVS_WD, ema_decay=0.9999,
                                mu_dtype=m0.dtype, p_dtype=p0.dtype)
    got_leaf = _nvs_leaf_state(state, leaf)
    losses = [l_.item() for l_ in losses]
    if not (grad is not None and not grad.any()
            and all(torch.equal(a, b) for a, b in zip(got_leaf, want_leaf))
            and not torch.equal(got_leaf[3], w0) and all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"DiTNVS training: the unused cross layer {unused}'s to_q leaf "
                             f"is not _update_math's with a zero gradient and weight decay, or "
                             f"a loss is not finite: {losses}")
    row = {"batch": batch_size, "warmup_steps": warmup, "steps": steps, "s_per_step": step_s,
           "losses": losses, "launches": launches, "launches_per_step": per_step,
           "jax_leaves": len(jax_leaves(model)), "jax_leaf_members": members,
           "unused_cross_leaf": f"blocks.{unused}.cross_attn.to_q.weight",
           "unused_cross_leaf_equal_update_math": True, "weight_decay": NVS_WD,
           "sync_debug_mode": "error"}
    return row, launches


def _xl_nvs_model(cfg, seed):
    """DiTNVS at `cfg`, bf16 compute over fp32 parameters, built on the meta
    device and filled on the card from a seeded CUDA generator: N(0, 0.02)
    for the adaLN, the head, the embedders' tables and MLP and every bias
    (the init's zeros and N(0, 0.02), plus `sample.perturb_`'s 0.02),
    xavier-normal for the other matrices; the sin-cos `pos_embed` as built.
    The host init of 0.94 G parameters on the CPU took 19 s."""
    with torch.device("meta"):
        model = DiTNVS(**cfg, dtype=torch.bfloat16, device="meta")
    model = model.to_empty(device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    small = ("adaLN", "final_layer.linear", "embedding", "t_embedder")
    with torch.no_grad():
        for name, p in model.named_parameters():
            std = 0.02
            if p.dim() >= 2 and not any(k in name for k in small):
                fan_out, fan_in = p.shape[0], p[0].numel()
                std = (2.0 / (fan_in + fan_out)) ** 0.5
            p.normal_(0.0, std, generator=g)
        model.pos_embed.copy_(torch.from_numpy(get_2d_sincos_pos_embed(
            cfg["hidden_size"], cfg["input_size"] // cfg["patch_size"])[None]))
    return model.eval()


def _set_compute_dtype(model, dtype):
    for m in model.modules():
        if "dtype" in m.__dict__:
            m.dtype = dtype


def _nvs_evaluation_check(model, x, feat, y, per_eval):
    """One model evaluation (batch 16 at t = 500) through the kernels
    against the plain attention on the same weights, bf16: within 2e-2 x
    max, kernel 1 launched exactly `per_eval` times. The guided output
    (CFG 4.0) is held against the fp32 plain model instead: CFG scales the
    cond - uncond difference by 4, so two bf16 paths part there by 3-6 %
    of max (DiT-XL/2 measured 6.1 % on the card), and the kernels' bf16
    output must be as near the fp32 one as the plain bf16 output is (its
    relative L2 distance within 1.1 x)."""
    t = torch.full((x.shape[0],), 500, device="cuda")
    fwd, cfg_out = {}, {}
    for dtype, backend in ((torch.bfloat16, "einsum"), (torch.float32, "einsum"),
                           (torch.bfloat16, "auto")):
        _set_compute_dtype(model, dtype)
        _set_attention_backend(model, backend)
        _build.reset_launch_counts()
        with torch.inference_mode():
            key = (str(dtype).replace("torch.", ""), backend)
            fwd[key] = model(x, t, feat, y)
            launches = dict(_build.launch_counts)
            cfg_out[key] = model.forward_with_cfg(x, t, feat, y, 4.0)
        torch.cuda.synchronize()
    kern, plain, truth = (("bfloat16", "auto"), ("bfloat16", "einsum"), ("float32", "einsum"))
    err = (fwd[kern] - fwd[plain]).abs().max().item()
    peak = fwd[plain].abs().max().item()
    l2 = {k: ((cfg_out[k] - cfg_out[truth]).norm() / cfg_out[truth].norm()).item()
          for k in (kern, plain)}
    cfg_rel = ((cfg_out[kern] - cfg_out[plain]).abs().max()
               / cfg_out[plain].abs().max()).item()
    if not (torch.isfinite(fwd[kern]).all() and err <= 2e-2 * peak
            and launches.get("attention_fwd") == per_eval and l2[kern] <= 1.1 * l2[plain]):
        raise AssertionError(f"DiTNVS-XL/2 bf16 evaluation: kernel vs plain {err} > 2e-2 x "
                             f"{peak}, launches {launches} != {per_eval}, or the guided output's "
                             f"distance from fp32 {l2[kern]} > 1.1 x the plain bf16's {l2[plain]}")
    return {"launches": launches, "max_abs_err": err, "max_abs_out": peak, "tol": 2e-2 * peak,
            "cfg_max_rel_kernel_vs_plain": cfg_rel,
            "cfg_l2_rel_from_fp32": {"kernel_bf16": l2[kern], "plain_bf16": l2[plain],
                                     "tol": 1.1 * l2[plain]}}


def phase_nvs():
    """The NVS model at DiTNVS-XL/2 width; see the module docstring (18).
    Returns the launches of the paths nvs_sample, nvs_inpaint, nvs_train."""
    small = _nvs_small_check()
    cfg = NVS_CFG
    model = _xl_nvs_model(cfg, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    per_eval = model.depth + len(model.cross_layers)
    x, y, feat, mask = _nvs_inputs(cfg, NVS_BATCH, "cuda", seed=24)
    fn = lambda xx, tt: model.forward_with_cfg(xx, tt, feat, y, 4.0)  # noqa: E731
    evaluation = _nvs_evaluation_check(model, x, feat, y, per_eval)
    # the cross-attention call (q, k, v packed, kernel 1) at its shape
    g = torch.Generator(device="cuda").manual_seed(25)
    q, k, v = (torch.randn(NVS_BATCH, 256, 1152, generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    qkv = torch.cat([q, k, v], dim=-1)
    cross_ms = cuda_ms(lambda: dot_product_attention(q, k, v, 16))
    packed_ms = cuda_ms(lambda: flash_attention_qkv_flat(qkv, 16))
    del q, k, v, qkv

    def chain(name, run, evals):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            with torch.inference_mode():
                out = run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        launches = dict(_build.launch_counts)
        want = {**{kk: 0 for kk in launches}, "attention_fwd": per_eval * evals}
        if launches != want or not torch.isfinite(out).all():
            raise AssertionError(f"DiTNVS {name}: launches {launches}, expected {want}, or "
                                 f"not finite")
        return out, launches, {"loop_s": loop_s, "model_evals": evals,
                               "s_per_eval": loop_s / evals, "launches": launches,
                               "sync_debug_mode": "error"}

    diffusion = create_diffusion(str(NVS_SAMPLE_STEPS), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(26)
    latents, sample_launches, sample_row = chain(
        "sampling", lambda: diffusion.p_sample_loop(fn, x.shape, noise=x, generator=gen),
        NVS_SAMPLE_STEPS)
    sample_row.update(steps=NVS_SAMPLE_STEPS, s_per_step=sample_row["loop_s"] / NVS_SAMPLE_STEPS,
                      images_per_s=(NVS_BATCH // 2) / sample_row["loop_s"])
    known = latents.clamp(-1, 1)
    sched = create_diffusion(str(NVS_INPAINT_STEPS), device="cuda").schedule
    gen = torch.Generator(device="cuda").manual_seed(27)
    filled, inpaint_launches, inpaint_row = chain(
        "inpainting", lambda: inpaint_sample_loop(fn, known, mask, sched, generator=gen,
                                                  jump_n=NVS_JUMP_N),
        NVS_INPAINT_STEPS * NVS_JUMP_N)
    keep = mask.expand_as(known) == 0
    if not (tuple(filled.shape) == tuple(known.shape)
            and torch.equal(filled[keep], known[keep])):
        raise AssertionError("DiTNVS inpainting: the known region is not kept exactly")
    inpaint_row.update(steps=NVS_INPAINT_STEPS, jump_n=NVS_JUMP_N,
                       hole_fraction=mask.mean().item(), known_region_equal=True,
                       s_per_step=inpaint_row["loop_s"] / NVS_INPAINT_STEPS)
    del latents, filled, known, x, feat
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train_row, train_launches = _nvs_train(model, NVS_TRAIN_BATCH, NVS_TRAIN_WARMUP,
                                           NVS_TRAIN_STEPS)
    train_row["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del model
    torch.cuda.empty_cache()
    # kernel 3 over the DiTNVS tree alone (its launches are this check's)
    fused = phase_fused_update(steps=2, model="DiTNVS-XL/2", library=False,
                               phase="nvs_fused_update",
                               make_model=functools.partial(DiTNVS, **NVS_CFG))
    geo = _nvs_geometry_check()
    emit({"phase": "nvs", "model": "DiTNVS-XL/2", "image_size": 256, "dtype": "bfloat16",
          "parameters": n_params, **{k: v for k, v in cfg.items() if k.startswith(("dino",
                                                                                  "cross"))},
          "small_check": small, "cfg_scale": 4.0, "batch": NVS_BATCH,
          "evaluation": evaluation,
          "cross_attention": {"shape": [NVS_BATCH, 256, 256, 16, 72], "dtype": "bfloat16",
                              "separate_qkv_ms": cross_ms, "packed_qkv_kernel_ms": packed_ms},
          "sample": sample_row, "inpaint": inpaint_row, "train": train_row,
          "fused_update_ms": fused["kernel_ms"], "fused_update_bound_ms": fused["bound_ms"],
          **geo})
    return {"nvs_sample": sample_launches, "nvs_inpaint": inpaint_launches,
            "nvs_train": train_launches}


def _nvs_geometry_check():
    """A 256² depth warp (seeded random depth and pose) and epipolar
    attention on (2, 64, 32, 32) maps, card against CPU: masks equal, values
    within 1e-5 (of max for the attention), with the card's ms."""
    rs = np.random.RandomState(28)
    h = w = 256
    depth = torch.from_numpy((1.0 + 2.0 * rs.rand(h, w)).astype(np.float32))
    img = torch.from_numpy(rs.rand(h, w, 3).astype(np.float32))
    K = torch.tensor([[240.0, 0, 128], [0, 240.0, 128], [0, 0, 1]])
    R = nvs_geometry.quaternion_to_rotation_matrix(torch.tensor([1.0, 0.02, -0.04, 0.01]))
    t = torch.tensor([0.15, -0.05, 0.02])
    f_tar, f_src = (torch.from_numpy(rs.randn(2, 64, 32, 32).astype(np.float32))
                    for _ in range(2))
    F = torch.stack([nvs_geometry.fundamental_matrix(K, K, R, t),
                     nvs_geometry.fundamental_matrix(K, K, R.T, -t)])
    res = {}
    for device in ("cuda", "cpu"):
        args = [a.to(device) for a in (img, depth, K, K, R, t)]
        warped, cover = nvs_warp.warp_image_by_depth(*args)
        attn = epipolar_attention(*(a.to(device) for a in (f_tar, f_src, F)), threshold=0.5,
                                  use_affinity=True)
        res[device] = (warped.cpu(), cover.cpu(), attn.cpu())
        if device == "cuda":
            warp_ms = cuda_ms(lambda: nvs_warp.warp_image_by_depth(*args), iters=5, warmup=1)
            epi_ms = cuda_ms(lambda: epipolar_attention(
                *(a.to(device) for a in (f_tar, f_src, F)), threshold=0.5, use_affinity=True),
                iters=5, warmup=1)
    (wc, cc, ac), (wp, cp, ap) = res["cuda"], res["cpu"]
    warp_err = (wc - wp).abs().max().item()
    attn_err, attn_peak = (ac - ap).abs().max().item(), ap.abs().max().item()
    if not (torch.equal(cc, cp) and warp_err <= 1e-5 and attn_err <= 1e-5 * attn_peak
            and cp.float().mean().item() > 0.5):
        raise AssertionError(f"warp/epipolar card vs CPU: masks equal {torch.equal(cc, cp)}, "
                             f"warp {warp_err} > 1e-5 or attention {attn_err} > 1e-5 x "
                             f"{attn_peak}")
    return {"warp": {"size": [h, w], "coverage": cp.float().mean().item(),
                     "masks_equal": True, "max_abs_err": warp_err, "tol": 1e-5,
                     "card_ms": warp_ms},
            "epipolar": {"shape": [2, 64, 32, 32], "use_affinity": True,
                         "max_abs_err": attn_err, "tol": 1e-5 * attn_peak, "card_ms": epi_ms}}


def random_vae_state_dict(channels=VAE_CHANNELS, latent=4, seed=0):
    """Random weights in the diffusers AutoencoderKL layout (the names and
    shapes of sd-vae-ft-*), numpy fp32, from `seed`: the stand-in for the
    real weights, which are not in the repository. Conv and linear weights
    are N(0, 1 / fan-in), so activations keep their scale; norm scales
    1 + 0.1 N(0, 1); biases 0.05 N(0, 1)."""
    rs = np.random.RandomState(seed)
    sd = {}

    def param(name, *shape, fan_in=None):
        if fan_in:
            sd[f"{name}.weight"] = (rs.randn(*shape) / math.sqrt(fan_in)).astype(np.float32)
        else:
            sd[f"{name}.weight"] = (1 + 0.1 * rs.randn(*shape)).astype(np.float32)
        sd[f"{name}.bias"] = (0.05 * rs.randn(shape[0])).astype(np.float32)

    def conv(name, cout, cin, k):
        param(name, cout, cin, k, k, fan_in=cin * k * k)

    def resnet(name, cin, cout):
        param(f"{name}.norm1", cin)
        conv(f"{name}.conv1", cout, cin, 3)
        param(f"{name}.norm2", cout)
        conv(f"{name}.conv2", cout, cout, 3)
        if cin != cout:
            conv(f"{name}.conv_shortcut", cout, cin, 1)

    def mid_block(name, c):
        resnet(f"{name}.resnets.0", c, c)
        param(f"{name}.attentions.0.group_norm", c)
        for proj in ("to_q", "to_k", "to_v", "to_out.0"):
            param(f"{name}.attentions.0.{proj}", c, c, fan_in=c)
        resnet(f"{name}.resnets.1", c, c)

    ch = list(channels)
    conv("encoder.conv_in", ch[0], 3, 3)
    for i, c in enumerate(ch):
        for j in range(2):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", ch[max(i - 1, 0)] if j == 0 else c, c)
        if i < len(ch) - 1:
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", c, c, 3)
    mid_block("encoder.mid_block", ch[-1])
    param("encoder.conv_norm_out", ch[-1])
    conv("encoder.conv_out", 2 * latent, ch[-1], 3)
    conv("quant_conv", 2 * latent, 2 * latent, 1)
    conv("post_quant_conv", latent, latent, 1)
    rev = ch[::-1]
    conv("decoder.conv_in", rev[0], latent, 3)
    mid_block("decoder.mid_block", rev[0])
    for i, c in enumerate(rev):
        for j in range(3):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", rev[max(i - 1, 0)] if j == 0 else c, c)
        if i < len(rev) - 1:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", c, c, 3)
    param("decoder.conv_norm_out", rev[-1])
    conv("decoder.conv_out", 3, rev[-1], 3)
    return sd


def write_random_vae(path, channels=VAE_CHANNELS, seed=0):
    """`random_vae_state_dict` saved as a diffusers-style `.bin` at `path`."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: torch.from_numpy(v) for k, v in
                random_vae_state_dict(channels, seed=seed).items()}, path)
    return path


def vae_flops(run, model):
    """FLOPs of one `run()` of `model`: 2 x the multiply-adds of every
    convolution and linear and of the two attention products, from the
    shapes they see (forward hooks)."""
    total = [0]

    def conv(m, inp, out):
        total[0] += 2 * out.numel() * (m.in_channels // m.groups) * math.prod(m.kernel_size)

    def linear(m, inp, out):
        total[0] += 2 * out.numel() * m.in_features

    def attention(m, inp, out):
        B, C, H, W = inp[0].shape
        total[0] += 4 * B * (H * W) ** 2 * C

    hooks = []
    for m in model.modules():
        hook = (conv if isinstance(m, torch.nn.Conv2d) else
                linear if isinstance(m, torch.nn.Linear) else
                attention if isinstance(m, AttnBlock) else None)
        if hook is not None:
            hooks.append(m.register_forward_hook(hook))
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def phase_vae(vae_bin, profile_table=None):
    """The full-width SD-VAE from a random diffusers `.bin` through the
    port's importer: card vs CPU in fp32 with TF32 off, then device times of
    the decode and the encode at the sampling paths' shapes, each with its
    counted FLOPs, TFLOP/s, bound and peak memory; with `profile_table`, a
    device breakdown of the fp32 decode of 8 latents. Returns the fp32 VAE."""
    t0 = time.perf_counter()
    vae = load_vae(vae_bin, VAE_CHANNELS, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in vae.parameters())
    if not 83_000_000 < n_params < 84_000_000:
        raise AssertionError(f"full-width VAE has {n_params} parameters, not 83.7 M")

    # card vs CPU, fp32, TF32 off
    cpu_vae = load_vae(vae_bin, VAE_CHANNELS, device="cpu")
    g = torch.Generator().manual_seed(10)
    x = torch.rand(2, 3, 64, 64, generator=g) * 2 - 1
    z = torch.randn(2, 4, 8, 8, generator=g)
    check = {}
    with torch.inference_mode(), tf32(False):
        for name, method, inp in (("moments", "encode_moments", x), ("images", "decode", z)):
            got = getattr(vae, method)(inp.cuda()).cpu()
            want = getattr(cpu_vae, method)(inp)
            err, peak = (got - want).abs().max().item(), want.abs().max().item()
            if not (torch.isfinite(got).all() and err <= VAE_RTOL * peak):
                raise AssertionError(f"VAE {name} card vs CPU: max abs err {err} > "
                                     f"{VAE_RTOL} x {peak}")
            check[name] = {"shape": list(got.shape), "max_abs_err": err, "max_abs_out": peak,
                           "tol": VAE_RTOL * peak}
    del cpu_vae

    vae_bf16 = load_vae(vae_bin, VAE_CHANNELS, device="cuda", dtype=torch.bfloat16)
    gc = torch.Generator(device="cuda").manual_seed(11)
    z256 = torch.randn(8, 4, 32, 32, generator=gc, device="cuda")
    z512 = torch.randn(4, 4, 64, 64, generator=gc, device="cuda")
    x256 = torch.rand(8, 3, 256, 256, generator=gc, device="cuda") * 2 - 1
    dec_params = sum(p.numel() for m in (vae.post_quant_conv, vae.decoder) for p in m.parameters())
    enc_params = sum(p.numel() for m in (vae.encoder, vae.quant_conv) for p in m.parameters())
    cases = [  # name, model, TF32, peak key, method, input, parameters read
        ("decode_256_fp32", vae, False, torch.float32, "decode", z256, dec_params),
        ("decode_256_tf32", vae, True, "tf32", "decode", z256, dec_params),
        ("decode_256_bf16", vae_bf16, False, torch.bfloat16, "decode", z256, dec_params),
        ("decode_512_fp32", vae, False, torch.float32, "decode", z512, dec_params),
        ("encode_256_fp32", vae, False, torch.float32, "encode_moments", x256, enc_params),
    ]
    runs, exact = [], {}
    for name, model, use_tf32, peak_key, method, inp, params in cases:
        fn = lambda: getattr(model, method)(inp)
        with torch.inference_mode(), tf32(use_tf32):
            flops = vae_flops(lambda: getattr(model, method)(inp[:1]), model) * inp.shape[0]
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = fn()
            torch.cuda.synchronize()
            peak_mem = torch.cuda.max_memory_allocated()
            ms = cuda_ms(fn, iters=3, warmup=1)
        if not torch.isfinite(out).all():
            raise AssertionError(f"VAE {name}: non-finite output")
        # read the input and the fp32 parameters once, write the fp32 output once
        t_bytes = 4 * (inp.numel() + out.numel() + params) / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[peak_key] * 1e3
        bound = max(t_bytes, t_ops)
        row = {"name": name, "batch": inp.shape[0], "in_shape": list(inp.shape),
               "out_shape": list(out.shape), "dtype": _dtype_name(model.dtype), "tf32": use_tf32,
               "ms": ms, "s_per_image": ms / 1e3 / inp.shape[0],
               "gflop_per_image": flops / inp.shape[0] / 1e9, "tflops": flops / ms / 1e9,
               "bound_ms": bound, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "peak_tflops": (PEAK_FLOPS[peak_key] / 1e12), "x_bound": ms / bound,
               "peak_mem_gib": peak_mem / 2 ** 30,
               "activation_peak_gib": (peak_mem - before) / 2 ** 30}
        key = (method, tuple(inp.shape))
        if key in exact:  # TF32 and bf16 against the fp32 exact output, reported
            ref = exact[key]
            row["max_abs_err_vs_fp32"] = (out - ref).abs().max().item()
            row["max_abs_fp32"] = ref.abs().max().item()
        else:
            exact[key] = out
        runs.append(row)
        del out
    row = {"phase": "vae", "block_out_channels": list(VAE_CHANNELS), "params": n_params,
           "load_s": load_s, "check": check, "tol_rel": VAE_RTOL, "runs": runs}
    if profile_table:
        with torch.inference_mode(), tf32(False):
            row["profile"] = profile_device(lambda: vae.decode(z256), profile_table,
                                            "fp32 decode of 8 latents to 256²")
    emit(row)
    del vae_bf16, exact, z256, z512, x256
    torch.cuda.empty_cache()
    return vae


def _small_chain_check(model_name, model_kw, cached=False, rtol=1e-4):
    """A small fp32 model of `model_name` (8² latents, depth 2) with the
    options `model_kw`, DDPM 10 steps at CFG 4.0 (with `cached`, the layer
    cache at interval 2), on the card and on the CPU with the same weights
    and noise: the final latents agree within `rtol` of max."""
    g = torch.Generator().manual_seed(15)
    noise = torch.randn(2, 4, 8, 8, generator=g)
    noise = torch.cat([noise, noise])
    step_noise = torch.randn(10, 4, 4, 8, 8, generator=g)
    y = [1, 7, 1000, 1000]
    outs = []
    for device in ("cuda", "cpu"):
        model = DiT_models[model_name](input_size=8, depth=2, device=device, seed=0, **model_kw)
        cli.perturb_(model)
        d = create_diffusion("10", device=device)
        yy = torch.tensor(y, device=device)
        cfg = lambda x, t, **ck: model.forward_with_cfg(x, t, yy, 4.0, **ck)
        kw = dict(noise=noise.to(device), step_noise=step_noise.to(device), clip_denoised=False)
        with torch.inference_mode():
            if cached:
                out = d.p_sample_loop_cached(lambda x, t: cfg(x, t, want_cache=True),
                                             lambda x, t, c: cfg(x, t, cache=c), noise.shape,
                                             interval=2, **kw)
            else:
                out = d.p_sample_loop(cfg, noise.shape, **kw)
        outs.append(out.cpu())
    err, peak = (outs[0] - outs[1]).abs().max().item(), outs[1].abs().max().item()
    if not (torch.isfinite(outs[0]).all() and err <= rtol * peak):
        raise AssertionError(f"small {model_name} {model_kw} cached={cached} chain card vs "
                             f"CPU: {err} > {rtol} x {peak}")
    return {"max_abs_err": err, "max_abs_out": peak, "tol": rtol * peak}


PROFILE_STEPS = 4  # steps of the profiled run of a ToMe, W8A8 or MoE chain


def _profile_chain(args, model, table_path):
    """Device busy ms and idle share of `PROFILE_STEPS` steps of the chain of
    `args` (the profiler's cost grows with the run; 4 steps hold a full and
    a cached step of an interval-2 cache)."""
    short = argparse.Namespace(**{**vars(args), "num_sampling_steps": PROFILE_STEPS})
    diffusion = cli.build_diffusion(short, torch.device("cuda"))
    z, y, g = cli.sampling_inputs(short, model)
    fn = cli.make_model_fn(short, model, diffusion, y)

    def run():
        with torch.inference_mode():
            cli.run_chain(short, diffusion, fn, z, g)
    return profile_device(run, table_path, f"{args.sampler} chain, {PROFILE_STEPS} steps")


def _exact_chain(steps, model_name):
    """The final latents of `model_name`'s exact chain at cell 1's shape
    (256², bf16, CFG 4.0, 8 labels, DDPM `steps`) through the sampler CLI's
    functions: the yardstick of the ToMe and W8A8 chains of that model."""
    args = cli.parse_args(["--model", model_name, *SAMPLER_ARGS[2:],
                           "--num-sampling-steps", str(steps)])
    cli.check_args(args)
    model = cli.build_model(args, torch.device("cuda"), args.seed)
    _, _, latents = _sampler_chain(args, model, cli.build_diffusion(args, torch.device("cuda")),
                                   steps)
    del model
    torch.cuda.empty_cache()
    return latents


def _option_chains(chains, steps, exact, profile_root, model_name):
    """Each (name, flags) chain of `model_name` (DiT-XL/2 cut to CUT_DEPTH)
    at cell 1's shape (256², bf16, CFG 4.0, 8 labels, DDPM `steps`) through
    the sampler CLI's functions, model built by `build_model`, launches
    exact (depth x refresh steps), profiled over `PROFILE_STEPS` steps (busy
    ms, idle share), and its final latents against `exact`, the exact
    chain of the same model with the same weights and noise."""
    rows, launches = {}, {}
    for name, flags in chains:
        args = cli.parse_args(["--model", model_name, *SAMPLER_ARGS[2:],
                               "--num-sampling-steps", str(steps)] + flags)
        cli.check_args(args)
        t0 = time.perf_counter()
        model = cli.build_model(args, torch.device("cuda"), args.seed)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        diffusion = cli.build_diffusion(args, torch.device("cuda"))
        row, launches[name], latents = _sampler_chain(
            args, model, diffusion, steps, refreshes=_refresh_steps(args, diffusion))
        row.update(profile=_profile_chain(args, model, f"{profile_root}_{name}.txt"),
                   depth=model.depth, model_build_s=build_s, tome_r=model.tome_r,
                   quant=model.quant,
                   tome_mlp=model.tome_mlp,
                   max_abs_diff_vs_exact=(latents - exact).abs().max().item(),
                   exact_max_abs=exact.abs().max().item())
        rows[name] = row
        del model, latents
        torch.cuda.empty_cache()
    return rows, launches


def phase_tome(steps, exact, profile_root, model_name):
    """Token merging: kernel 1 against its plain version at the ragged
    lengths ToMe makes (S = 256 - r: 180 at ratio 0.3, 128 at 0.5), fp32
    and bf16; small fp32 models card vs CPU; then the ToMe chains of
    `model_name` (`TOME_CHAINS`). ToMe approximates: the drift against the
    exact chain is recorded, not bounded. Returns {chain: launches}."""
    g = torch.Generator(device="cuda").manual_seed(9)
    kernel = [_kernel_row("tome", *shape, dtype, g) for shape in TOME_SHAPES
              for dtype in (torch.float32, torch.bfloat16)]
    small = {f"ratio_{r}{'_mlp' * m}{'_cache2' * c}": _small_chain_check(
        "DiT-S/2", {"tome_ratio": r, "tome_mlp": m}, cached=c)
        for r, m, c in ((0.3, False, False), (0.5, False, False), (0.5, True, False),
                        (0.5, False, True))}
    rows, launches = _option_chains(TOME_CHAINS, steps, exact, profile_root, model_name)
    emit({"phase": "tome", "kernel": kernel, "small_check": small, "model": "DiT-XL/2",
          "depth": CUT_DEPTH, "chains": rows})
    return launches


def _int8_gemms():
    """The int8 GEMM at the four projections of DiT-XL/2 at cell 1's batch
    (16 x 256 rows): its int32 products equal an fp32 matmul of the int8
    operands (exact: every partial sum stays below 2^24, checked), and its
    device time against the bf16 `F.linear` of the same shape, and the whole
    W8A8 product (row quantiser, GEMM, dequantisation)."""
    g = torch.Generator(device="cuda").manual_seed(16)
    rows = {}
    for name, (M, K, N) in QUANT_GEMMS.items():
        x = torch.randn(M, K, generator=g, device="cuda")
        w = 0.02 * torch.randn(N, K, generator=g, device="cuda")  # a Linear's weight
        xq, _ = quantize_rows(x)
        wq, ws = quantize_cols(w.t())
        acc = int8_mm(xq, wq)
        ref = xq.float() @ wq.float()
        bound = (xq.float().abs() @ wq.float().abs()).max().item()
        if not (bound < 2 ** 24 and torch.equal(acc.float(), ref)):
            raise AssertionError(f"int8 GEMM {name} {(M, K, N)} differs from the fp32 matmul "
                                 f"of its operands (largest |partial sum| {bound})")
        xb, wb = x.bfloat16(), w.bfloat16()
        rows[name] = {"shape": [M, K, N], "exact": True, "max_abs_sum": bound,
                      "int8_gemm_ms": cuda_ms(lambda: int8_mm(xq, wq)),
                      "bf16_linear_ms": cuda_ms(lambda: torch.nn.functional.linear(xb, wb)),
                      "w8a8_matmul_ms": cuda_ms(lambda: int8_matmul(xb, w.t(), None,
                                                                    wq=(wq, ws)))}
        rows[name]["int8_over_bf16"] = rows[name]["int8_gemm_ms"] / rows[name]["bf16_linear_ms"]
        del x, w, xq, wq, acc, ref, xb, wb
    return rows


def phase_quant(steps, exact, profile_root, model_name):
    """W8A8: the int8 GEMM exact and timed (`_int8_gemms`); small fp32
    quantised models card vs CPU; then the quantised chains of `model_name`
    (`QUANT_CHAINS`), with their drift against the bf16 chain. A quantised
    card-vs-CPU chain may part by more than rounding: a one-ulp difference
    before a quantiser can move an int8 code by one step (ROADMAP.md,
    tolerances), so its limit is 1e-2 of max. Returns {chain: launches}."""
    gemms = _int8_gemms()
    small = {"w8a8": _small_chain_check("DiT-S/2", {"quant": "w8a8"}, rtol=1e-2),
             "w8a8_cache2": _small_chain_check("DiT-S/2", {"quant": "w8a8"}, cached=True,
                                               rtol=1e-2)}
    rows, launches = _option_chains(QUANT_CHAINS, steps, exact, profile_root, model_name)
    emit({"phase": "quant", "int8_gemm": gemms, "small_check": small, "model": "DiT-XL/2",
          "depth": CUT_DEPTH, "chains": rows})
    return launches


def _moe_small_train_check(steps=2):
    """A small fp32 MoE model (DiT-MoE-S/2-8E2A, depth 2, remat) trained 2
    steps on the card and on the CPU from the same weights with the same
    draws: the losses (with the aux terms) within 1e-5 relative, the last
    gradients within 1e-4 of their largest, and every MoE layer's kept
    (choice, token) mask the same in every forward, recomputes included."""
    g = torch.Generator().manual_seed(17)
    x, y = torch.randn(4, 4, 8, 8, generator=g), torch.tensor([1, 7, 3, 999])
    draws = [{"t": torch.randint(0, 1000, (4,), generator=g),
              "noise": torch.randn(4, 4, 8, 8, generator=g),
              "force_drop_ids": torch.tensor([0, 1, 0, 0])} for _ in range(steps)]
    res = {}
    for device in ("cuda", "cpu"):
        model = DiT_models["DiT-MoE-S/2-8E2A"](input_size=8, depth=2, remat=True, device=device,
                                               seed=0)
        cli.perturb_(model)
        masks = []

        def keep(m, inp, out):
            with torch.no_grad():
                masks.append(m.route(inp[0]).keep.cpu())
        hooks = [b.mlp.register_forward_hook(keep) for b in model.blocks]
        state = create_train_state(model, lr=LR)
        step = make_train_step(model, create_diffusion("", device=device).schedule, lr=LR)
        batch = {"x": x.to(device), "y": y.to(device)}
        metrics = [step(state, batch, draws=[{k: v.to(device) for k, v in d.items()}])
                   for d in draws]
        for h in hooks:
            h.remove()
        res[device] = {"loss": [m["loss"].item() for m in metrics],
                       "moe": {k: v.item() for k, v in metrics[-1].items() if "moe" in k},
                       "grad": torch.cat([p.grad.flatten() for p in model.parameters()]).cpu(),
                       "router_grad": max(b.mlp.router.weight.grad.abs().max().item()
                                          for b in model.blocks), "masks": masks}
    card, cpu = res["cuda"], res["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card["loss"], cpu["loss"]))
    grad_err = (card["grad"] - cpu["grad"]).abs().max().item()
    grad_tol = 1e-4 * cpu["grad"].abs().max().item()
    same_masks = (len(card["masks"]) == len(cpu["masks"]) > 0
                  and all(torch.equal(a, b) for a, b in zip(card["masks"], cpu["masks"])))
    if not (loss_err <= 1e-5 and grad_err <= grad_tol and same_masks
            and card["router_grad"] > 0):
        raise AssertionError(f"small MoE training card vs CPU: loss rel err {loss_err}, grad "
                             f"err {grad_err} (tol {grad_tol}), masks equal {same_masks}, "
                             f"router grad {card['router_grad']}")
    return {"loss_rel_err": loss_err, "loss_tol": 1e-5, "grad_max_abs_err": grad_err,
            "grad_tol": grad_tol, "masks_compared": len(card["masks"]),
            "kept_share": torch.cat(card["masks"]).float().mean().item(),
            "moe_metrics": card["moe"], "losses": card["loss"]}


def _moe_sample(model_name, steps, profile_root):
    """`model_name`'s chain at cell 1's shape through the sampler CLI's
    functions, launches exact, profiled, with the share of (token, choice)
    slots its capacity dropped; then the CLI's own `sample_latents`, equal."""
    args = cli.parse_args(["--model", model_name, "--ckpt", "random", "--bf16", "--cfg-scale",
                           "4.0", "--num-sampling-steps", str(steps)])
    cli.check_args(args)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = cli.build_model(args, torch.device("cuda"), args.seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    diffusion = cli.build_diffusion(args, torch.device("cuda"))
    dropped = []
    hooks = [b.mlp.register_forward_hook(lambda m, i, out: dropped.append(out[1][2]))
             for b in model.blocks]
    try:
        row, launches, latents = _sampler_chain(args, model, diffusion, steps)
        dropped_frac = torch.stack(dropped).mean().item()
    finally:
        for h in hooks:
            h.remove()
    row["profile"] = _profile_chain(args, model, f"{profile_root}_moe.txt")
    again = cli.sample_latents(args, model, diffusion)  # the CLI's own function, seeded
    if not torch.equal(again, latents):
        raise AssertionError("sample_latents differs from the same chain run by its parts")
    row.update(model=MOE_MODEL, depth=model.depth,
               params=sum(p.numel() for p in model.parameters()),
               model_build_s=build_s, dropped_frac=dropped_frac,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del model, diffusion, latents, again
    torch.cuda.empty_cache()
    return row, launches


def phase_moe(steps, profile_root):
    """The DiT-MoE family: small models card vs CPU (a chain, two train
    steps); kernel 3 against `_update_math` over the MoE tree at full width,
    depth MOE_FU_DEPTH, both nu dtypes; DiT-MoE-XL/2-8E2A at full width cut
    to CUT_DEPTH sampling cell 1's chain (`_moe_sample`); then the trainer
    CLI's functions with --fused-optimizer (depth MOE_TRAIN_DEPTH) and with
    the default AdamW route (depth MOE_ADAMW_DEPTH), each 3 steps after 2
    under sync debug mode "error". Returns {path: launches}."""
    small_chain = _small_chain_check("DiT-MoE-S/2-8E2A", {})
    small_train = _moe_small_train_check()
    fu_rows = {_dtype_name(nu): phase_fused_update(nu_dtype=nu, model=MOE_MODEL,
                                                   depth=MOE_FU_DEPTH, library=False,
                                                   phase="moe_fused_update")
               for nu in (torch.float32, torch.bfloat16)}
    launches = {}
    with cut_depth(MOE_MODEL, CUT_DEPTH) as cut:
        row, launches["moe_sample"] = _moe_sample(cut, steps, profile_root)
    base = ["--synthetic-data", "--global-batch-size", "32", "--global-seed", "0"]
    with cut_depth(MOE_MODEL, MOE_TRAIN_DEPTH) as cut:
        fused, launches["moe_train_fused"] = _train_run(
            ["--fused-optimizer"], warmup=2, steps=MOE_TRAIN_STEPS, no_sync=True,
            base=["--model", cut] + base)
    with cut_depth(MOE_MODEL, MOE_ADAMW_DEPTH) as cut:
        adamw, launches["moe_train_adamw"] = _train_run(
            [], warmup=2, steps=MOE_TRAIN_STEPS, no_sync=True, base=["--model", cut] + base)
    emit({"phase": "moe", "small_check_chain": small_chain, "small_check_train": small_train,
          "fused_update": fu_rows, "sample": row, "train_fused_optimizer": fused,
          "train_adamw": adamw})
    return launches


def _with_bounds(row):
    """A kernel_check row with its kernels' bounds (the formulas of phases
    kernel, kernel_bwd and ring_kernel*): forward 4 B S^2 D operations, the
    backward 10; bytes each input read and each output written once."""
    B, S, H, hd = row["B"], row["S"], row["H"], row["hd"]
    dtype = getattr(torch, row["dtype"])
    D, elt = H * hd, torch.tensor([], dtype=dtype).element_size()
    if row["regime"] == "ring-hop":  # q, k, v in; o_u, l fp32 out; back: do, dl fp32 in
        fwd_bytes = 3 * B * S * D * elt + 4 * (B * S * D + B * S * H)
        bwd_bytes = 6 * B * S * D * elt + 4 * (B * S * D + B * S * H)
    else:  # packed qkv in, out; back: qkv, out, dO in, dqkv out
        fwd_bytes, bwd_bytes = 4 * B * S * D * elt, 8 * B * S * D * elt
    for key, nbytes, flops in (("bound", fwd_bytes, 4 * B * S * S * D),
                               ("bwd_bound", bwd_bytes, 10 * B * S * S * D)):
        if key == "bwd_bound" and row["bwd_kernel_ms"] is None:
            continue
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
        row[f"{key}_ms"] = max(t_bytes, t_ops)
        row[f"{key}_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return {"phase": "kernel_check", **row}


def phase_kernel_check():
    """`fast_dit_torch.kernel_check` on the card: kernels 1 and 2 at S = 256
    to 4096 and kernels 4 and 5 at 1024 to 4096 against float64, fp32 within
    2e-5, bf16 within 5e-2; one line a case. Returns its launches (the
    check's calls and its timed calls)."""
    _build.reset_launch_counts()
    rows, failures = kernel_check.run(torch.device("cuda"),
                                      emit=lambda line: emit(_with_bounds(json.loads(line))))
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    if failures:
        bad = [(r["S"], r["dtype"], r["fwd_impl"]) for r in rows
               if not (r["fwd_ok"] and r["grad_ok"])]
        raise AssertionError(f"kernel_check: {failures} cases past their limits: {bad}")
    return launches


def phase_parity():
    """`fast_dit_torch.parity_check` on both committed bundles recorded from
    the reference sampler (DDPM and DDIM, 10 steps, a DiT of depth 2 and 4
    heads of 8): within PARITY_ATOL of the recorded latents, kernel 1 (fp32)
    launched exactly depth x steps times in each. Returns {path: launches}."""
    fixtures = os.path.join(REPO_DIR, "tests", "fixtures")
    rows, launches = {}, {}
    for sampler in PARITY_BUNDLES:
        with open(os.path.join(fixtures, f"ref_bundle_{sampler}_T10.json")) as f:
            meta = json.load(f)
        args = parity_check.build_parser().parse_args([
            "--bundle", os.path.join(fixtures, f"ref_bundle_{sampler}_T10.npz"),
            "--ckpt", os.path.join(fixtures, "ref_bundle_model.pt"),
            "--model-config", json.dumps(meta["model_config"]), "--sampler", sampler,
            "--atol", str(PARITY_ATOL), "--diffusion-steps", str(meta["T"]),
            "--noise-schedule", meta["schedule"], "--clip-denoised", "--device", "cuda"])
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        res = parity_check.replay(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        n = dict(_build.launch_counts)
        want = {**{k: 0 for k in n}, "attention_fwd": meta["model_config"]["depth"] * meta["T"]}
        if n != want:
            raise AssertionError(f"parity {sampler}: launches {n}, expected {want}")
        if not res["ok"]:
            raise AssertionError(f"parity {sampler}: max|d| {res['max_abs']} > {res['bound']}")
        rows[sampler] = {"max_abs": res["max_abs"], "mean_abs": res["mean_abs"],
                         "atol": PARITY_ATOL, "steps": meta["T"], "seconds": seconds,
                         "launches": n}
        launches[f"parity_{sampler}"] = n
    emit({"phase": "parity", "dtype": "float32", "head_dim": 8, "bundles": rows})
    return launches


def write_validate_weights(model, path):
    """`model`'s state dict, reference layout, as a `.pt` file at `path`."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)
    return path


def phase_validate(dit_pt, vae_bin):
    """`fast_dit_torch.validate_pretrained` at DiT-XL/2 256², full width and
    depth, on the sampling path's seeded weights (`dit_pt`) and the random
    full-width VAE: A within 1e-3 of the functional oracle, B, C (8 demo
    labels, CFG 4.0, fp32) and D (`sample_ddp`, bf16, VALIDATE_FID images in
    batches of 8, the split-half FID), C and D at VALIDATE_STEPS steps;
    kernel 1 launched exactly depth x (1 + steps + batches x steps). The FID
    of random weights checks the mechanism, not quality."""
    out_dir = os.path.join(OUT_DIR, "validate")
    batch = 8  # D's batch, the kit's own
    args = validate_pretrained.build_parser().parse_args([
        "--dit", dit_pt, "--vae", vae_bin, "--model", "DiT-XL/2",
        "--num-sampling-steps", str(VALIDATE_STEPS), "--num-fid-samples", str(VALIDATE_FID),
        "--out-dir", out_dir, "--device", "cuda"])
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    summary = validate_pretrained.run(args, torch.device("cuda"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    depth = DiT_models["DiT-XL/2"].keywords["depth"]
    calls = depth * (1 + VALIDATE_STEPS + math.ceil(VALIDATE_FID / batch) * VALIDATE_STEPS)
    want = {**{k: 0 for k in launches}, "attention_fwd": calls}
    if summary["exit_code"] != 0:
        raise AssertionError(f"validate: VALIDATION FAILED: {summary}")
    if launches != want:
        raise AssertionError(f"validate: launches {launches}, expected {want}")
    npzs = [os.path.join(r, f) for r, _, fs in os.walk(os.path.join(out_dir, "fid_samples"))
            for f in fs if f.endswith(".npz")]
    images = np.load(npzs[0])["arr_0"]
    if images.shape != (VALIDATE_FID, 256, 256, 3):
        raise AssertionError(f"validate: the npz holds {images.shape}")
    emit({"phase": "validate", "model": "DiT-XL/2", "image_size": 256, "depth": depth,
          "A_max_abs": summary["parity_max_abs"], "A_atol": args.parity_atol,
          "C_dtype": "float32", "C_steps": VALIDATE_STEPS,
          "C_s_per_step": summary["timing"]["C_s_per_step"],
          "D_dtype": "bfloat16", "D_images": VALIDATE_FID,
          "D_images_per_s": summary["timing"]["D_images_per_s"],
          "fid_split_half_random_weights": summary["fid"], "timing": summary["timing"],
          "seconds": seconds, "launches": launches, "npz_std": float(images.std()),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    shutil.rmtree(out_dir, ignore_errors=True)
    os.remove(dit_pt)
    return launches


def phase_sample_ddp(vae_bin):
    """The FID harness's own `main` at full width: DiT-XL/2 256² cut to
    CUT_DEPTH, the random VAE, 16 images in 2 batches of 8, 10 DDPM steps,
    CFG 1.5, `--tf32` at its default (on); the npz must equal the PNGs read
    back, and the attention forward must launch exactly depth x steps x
    batches times."""
    with cut_depth(DDP_ARGS[1], CUT_DEPTH) as cut:
        args = sample_ddp.build_parser().parse_args(
            ["--model", cut, *DDP_ARGS[2:], "--vae-ckpt", vae_bin, "--sample-dir",
             os.path.join(OUT_DIR, "samples")])
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        res = sample_ddp.main(args)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        depth = DiT_models[args.model].keywords["depth"]
    launches = dict(_build.launch_counts)
    batches = args.num_fid_samples // args.per_proc_batch_size
    want = {**{k: 0 for k in launches},
            "attention_fwd": depth * args.num_sampling_steps * batches}
    if launches != want:
        raise AssertionError(f"sample_ddp launches {launches}, expected {want}")
    arr = np.load(res["npz"])["arr_0"]
    if arr.shape != (args.num_fid_samples, 256, 256, 3) or arr.dtype != np.uint8:
        raise AssertionError(f"sample_ddp npz arr_0 is {arr.shape} {arr.dtype}")
    pngs = []
    for i in range(args.num_fid_samples):
        with open(f"{res['sample_dir']}/{i:06d}.png", "rb") as f:
            pngs.append(decode_png(f.read()))
    if not np.array_equal(arr, np.stack(pngs)):
        raise AssertionError("sample_ddp npz differs from its PNGs")
    emit({"phase": "sample_ddp", "model": args.model, "depth": depth,
          "image_size": args.image_size,
          "dtype": "float32", "tf32": args.tf32, "cfg_scale": args.cfg_scale,
          "steps": args.num_sampling_steps, "per_proc_batch": args.per_proc_batch_size,
          "images": res["images"], "loop_s": res["seconds"], "total_s": total_s,
          "images_per_s": res["images"] / res["seconds"], "launches": launches,
          "npz_shape": list(arr.shape), "pixel_mean": float(arr.mean()),
          "pixel_std": float(arr.std()),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    torch.cuda.empty_cache()
    return launches


def phase_extract(vae):
    """Feature extraction's per-batch work (`encode_images`, `write_features`)
    on 16 seeded 256² images in [-1, 1], fp32 with TF32 off: the features
    must be (1, 4, 32, 32), finite, and read back by the trainer's
    `FeatureDataset`."""
    feat_dir, label_dir = feature_dirs(os.path.join(OUT_DIR, "features"), 256)
    os.makedirs(feat_dir)
    os.makedirs(label_dir)
    gx = torch.Generator().manual_seed(13)
    x = torch.rand(EXTRACT_IMAGES, 3, 256, 256, generator=gx) * 2 - 1
    labels = torch.randint(0, 1000, (EXTRACT_IMAGES,), generator=gx).tolist()
    g = torch.Generator(device="cuda").manual_seed(12)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, EXTRACT_IMAGES, EXTRACT_BATCH):
        idx = list(range(s, s + EXTRACT_BATCH))
        write_features(feat_dir, label_dir, idx, encode_images(vae, x[s:s + EXTRACT_BATCH], g),
                       labels[s:s + EXTRACT_BATCH])
    seconds = time.perf_counter() - t0
    ds = FeatureDataset(feat_dir, label_dir)
    feats = [ds[i] for i in range(len(ds))]
    if len(ds) != EXTRACT_IMAGES or not all(f.shape == (1, 4, 32, 32) and np.isfinite(f).all()
                                            for f, _ in feats):
        raise AssertionError(f"extracted features: {len(ds)} files, shapes "
                             f"{sorted({f.shape for f, _ in feats})}")
    batches = list(feature_batches(ds, EXTRACT_BATCH, seed=0, num_epochs=1))
    if [b["x"].shape for b in batches] != [(EXTRACT_BATCH, 4, 32, 32)] * 2:
        raise AssertionError(f"feature_batches gave {[b['x'].shape for b in batches]}")
    emit({"phase": "extract", "images": EXTRACT_IMAGES, "batch": EXTRACT_BATCH,
          "image_size": 256, "dtype": "float32", "tf32": False, "seconds": seconds,
          "images_per_s": EXTRACT_IMAGES / seconds,
          "feature_std": float(np.std([f for f, _ in feats]))})


def main():
    ap = argparse.ArgumentParser(description="Drive the PyTorch port on one card.")
    ap.add_argument("--steps", type=int, default=50, help="DDPM steps of the sampling path")
    ap.add_argument("--profile", metavar="TABLE", default=None,
                    help="profile four sampling steps, the fp32 decode of 8 latents, each "
                         "fast-sampler chain, two training steps, two sequence-parallel "
                         "sampling steps and one sequence-parallel gradient step; write the "
                         "kernel tables to TABLE and TABLE's name + _vae, + _<chain>, "
                         "+ _train, + _seq and + _seq_grad")
    a = ap.parse_args()

    smi = timed("device", phase_device)
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    vae_bin = timed("vae_file", write_random_vae, os.path.join(OUT_DIR, "vae_random.bin"))
    timed("build", phase_build)
    fwd = timed("kernel", phase_kernel)
    bwd = timed("kernel_bwd", phase_kernel_bwd)
    fused = timed("fused_update", phase_fused_update)
    fused_nu16 = timed("fused_update_nu_bf16", phase_fused_update, nu_dtype=torch.bfloat16,
                       library_ms=fused["library_ms"])
    timed("model", phase_model)
    vae_table = None
    if a.profile:
        root, ext = os.path.splitext(a.profile)
        vae_table = f"{root}_vae{ext}"
    vae = timed("vae", phase_vae, vae_bin, vae_table)
    sample_launches, model = timed("sample", phase_sample, a.steps, a.profile, vae_bin)
    dit_pt = timed("validate_weights", write_validate_weights, model,
                   os.path.join(OUT_DIR, "validate_dit.pt"))
    models = [model]
    del model  # phase_samplers takes it out of `models`
    sampler_launches = timed("samplers", phase_samplers, a.profile, vae_bin, models)
    # the new chains' profiler tables: beside --profile's, else under OUT_DIR
    option_root = os.path.splitext(a.profile)[0] if a.profile else os.path.join(OUT_DIR,
                                                                                "profile")
    with cut_depth("DiT-XL/2", CUT_DEPTH) as cut:
        exact = timed("option_reference", _exact_chain, a.steps, cut)
        tome_launches = timed("tome", phase_tome, a.steps, exact, option_root, cut)
        quant_launches = timed("quant", phase_quant, a.steps, exact, option_root, cut)
    del exact
    ddp_launches = timed("sample_ddp", phase_sample_ddp, vae_bin)
    timed("extract", phase_extract, vae)
    del vae
    torch.cuda.empty_cache()
    train_launches = timed("train", phase_train, a.profile)
    moe_launches = timed("moe", phase_moe, a.steps, option_root)
    timed("resume", phase_resume)
    parallel_launches = timed("train_parallel", phase_train_parallel)
    ring_fwd = timed("ring_kernel", phase_ring_kernel)
    ring_bwd = timed("ring_kernel_bwd", phase_ring_kernel_bwd)
    seq_table = None
    if a.profile:
        root, ext = os.path.splitext(a.profile)
        seq_table = f"{root}_seq{ext}"
    seq_sample_launches, seq_grad_launches = timed("seq_parallel", phase_seq_parallel,
                                                   SEQ_SAMPLE_STEPS, seq_table)
    pipe_model, pipe_launches, pipe_grad_launches, pipe_rank_launches, rank_rows = timed(
        "pipeline", phase_pipeline)
    pf_launches = timed("pipefusion", phase_pipefusion, pipe_model, rank_rows)
    del pipe_model
    torch.cuda.empty_cache()
    nvs_launches = timed("nvs", phase_nvs)
    check_launches = timed("kernel_check", phase_kernel_check)
    parity_launches = timed("parity", phase_parity)
    validate_launches = timed("validate", phase_validate, dit_pt, vae_bin)
    paths = {"sample": sample_launches,
             **{f"samplers_{c}": n for c, n in sampler_launches.items()},
             **tome_launches, **quant_launches, "sample_ddp": ddp_launches, **train_launches,
             **moe_launches, **parallel_launches, "seq_sample": seq_sample_launches,
             "seq_grad": seq_grad_launches, "pipeline": pipe_launches,
             "pipeline_grad": pipe_grad_launches, "pipeline_ranks": pipe_rank_launches,
             "pipefusion": pf_launches, **nvs_launches, "kernel_check": check_launches,
             **parity_launches, "validate": validate_launches}
    by_path = {k: {path: n.get(k, 0) for path, n in paths.items()} for k in _build.launch_counts}
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

    emit({"timing": TIMING, "total_s": time.perf_counter() - _T0})
    emit({"kernels": [
        entry("attention_fwd", "fast_dit_torch/csrc/flash_attention_fwd.cu",
              "fast_dit_tpu/ops/flash_attention.py:119", fwd),
        entry("attention_bwd", "fast_dit_torch/csrc/flash_attention_bwd.cu",
              "fast_dit_tpu/ops/flash_attention.py:185", bwd),
        entry("fused_adamw_ema", "fast_dit_torch/csrc/fused_update.cu",
              "fast_dit_tpu/ops/fused_update.py:138", fused,
              err=max(fused["max_abs_err"].values())),
        # the same kernel's bf16-nu instantiation (JAX runs bf16 nu through
        # _update_math on XLA, the math of the same TPU kernel)
        entry("fused_adamw_ema_nu_bf16", "fast_dit_torch/csrc/fused_update.cu",
              "fast_dit_tpu/ops/fused_update.py:138", fused_nu16,
              err=max(fused_nu16["max_abs_err"].values())),
        entry("ring_hop_fwd", "fast_dit_torch/csrc/ring_hop_fwd.cu",
              "fast_dit_tpu/ops/ring_attention.py:77", ring_fwd),
        entry("ring_hop_bwd", "fast_dit_torch/csrc/ring_hop_bwd.cu",
              "fast_dit_tpu/ops/ring_attention.py:111", ring_bwd),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
