"""The port's CUDA kernels against their plain twins, on the card.

These need an NVIDIA card with `nvcc` (sm_90a); elsewhere they skip. Run
them on the card, where JAX is not installed, without the JAX test
configuration in conftest.py:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

import pytest
import torch

from fast_dit_torch.ops import _build
from fast_dit_torch.ops.flash_attention import _attention_qkv_plain, flash_attention_qkv_flat

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}  # bf16 twin computes in fp32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,S,H,hd", [
    (16, 256, 16, 72),  # DiT-XL/2 at 256², CFG batch of 8 labels
    (2, 200, 6, 64),    # a ragged S
    (1, 7, 2, 128),     # S below one tile, the largest head dim
    (3, 65, 4, 8),      # one key past a tile, the smallest head dim
])
def test_attention_kernel_matches_twin(cuda, B, S, H, hd, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(B, S, 3 * H * hd, generator=g, device=cuda).to(dtype)
    before = _build.launch_counts["attention_fwd"]
    out = flash_attention_qkv_flat(qkv, H)
    torch.cuda.synchronize()
    assert _build.launch_counts["attention_fwd"] == before + 1
    assert out.dtype == dtype and out.shape == (B, S, H * hd)
    ref = _attention_qkv_plain(qkv, H, hd ** -0.5)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


def test_attention_kernel_refuses_a_backward(cuda):
    qkv = torch.randn(1, 16, 3 * 64, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        flash_attention_qkv_flat(qkv, 1).sum().backward()
