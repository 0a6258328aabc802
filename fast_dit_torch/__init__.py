"""fast_dit_torch: the PyTorch + CUDA port of fast_dit_tpu for NVIDIA Hopper.

Slice 1 covers class-conditional DiT sampling: the models, the diffusion
sampling core, the checkpoint converter, the sampler CLI
(`python -m fast_dit_torch.sample`) and the hand-written CUDA packed-qkv
attention forward (`csrc/flash_attention_fwd.cu`).
"""

__version__ = "0.1.0"
