"""The plain reference of the benchmark: fp32 PyTorch, TF32 off, written from
the published descriptions (DiT, arXiv:2212.09748; DDPM with learned variances, arXiv:2102.09672; AdamW, arXiv:1711.05101).

It imports nothing of the program and nothing of JAX. It takes the weights
and inputs that the benchmark makes from the seed, never anything the
program made, and reads the program's outputs only to judge them.

`Precision` selects where the computation is rounded: `EXACT` is the
reference itself; `LOWER` is the control, every matrix product's inputs
rounded to fp8 (e4m3, one scale per tensor), the optimizer state and the
sampler's step in bf16, the step below what the configurations state.
"""

from .precision import EXACT, LOWER, Precision

__all__ = ["EXACT", "LOWER", "Precision"]
