"""fast_dit_torch: the PyTorch + CUDA port of fast_dit_tpu for NVIDIA Hopper.

Slice 1 covers class-conditional DiT sampling: the models, the diffusion
sampling core, the checkpoint converter, the sampler CLI
(`python -m fast_dit_torch.sample`) and the hand-written CUDA packed-qkv
attention forward (`csrc/flash_attention_fwd.cu`). Slice 2 covers training:
the loss functions, the train step with its three optimizer routes, the
feature data, the trainer CLI (`python -m fast_dit_torch.train`) and two
more hand-written CUDA kernels, the attention backward
(`csrc/flash_attention_bwd.cu`) and the fused AdamW + EMA update
(`csrc/fused_update.cu`). Slice 3 covers sequence parallelism
(`parallel/sequence.py`): ring attention over sharded tokens
(`ops/ring_attention.py`) with the hand-written CUDA ring hop forward and
backward (`csrc/ring_hop_fwd.cu`, `csrc/ring_hop_bwd.cu`). Slice 6 covers
the pixel-space ends: the SD-VAE (`models/vae.py`, diffusers' names, stock
convolutions, GroupNorm and attention: the JAX VAE has no Pallas kernel)
with its local weight import (`ckpt/vae_import.py`, `.bin` or
`.safetensors` without the `safetensors` package), the decode in
`python -m fast_dit_torch.sample`, the FID harness `python -m
fast_dit_torch.sample_ddp` (rank-strided PNGs and the `arr_0` npz, read
back by the Pillow-free `utils.image.decode_png`), the image-folder
pipeline (`data/imagenet.py`) and `python -m fast_dit_torch.extract_features`.
Slice 7 completes the diffusion library but the FORA-cached loops:
DPM-Solver++ and UniPC, Karras spacing, the guidance interval, the reverse
DDIM loop, the bits-per-dim bound, flow matching (`diffusion/flow.py`) and
the loss-aware timestep sampler (`diffusion/timestep_samplers.py`), wired
into both sampler CLIs and the trainer. Slice 10 adds JAX's last model
options: the DiT-MoE family with its routing aux losses (`models/moe.py`),
token merging (`ops/tome.py`), W8A8 int8 sampling (`ops/quant.py`), and the
binding to the C++ feature loader (`data/native_loader.py`). Slice 11 runs
the trainer on a mesh of ranks (`torchrun ... -m fast_dit_torch.train`):
data parallelism, FSDP, tensor and expert parallelism with JAX's sharding
rules (`parallel/mesh.py`, `parallel/collectives.py`, `utils/platform.py`),
one-file checkpoints gathered from and cut back to the ranks, and the
sampler CLIs' `--ckpt` resolution (`ckpt/download.py`).
"""

__version__ = "0.1.0"
