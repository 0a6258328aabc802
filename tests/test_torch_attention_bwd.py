"""The attention backward's plain version (fast_dit_torch/ops/flash_attention.py)
against the JAX package's fused Pallas backward.

`_attention_qkv_bwd_plain` is held to `jax.vjp` of
`flash_attention_qkv_flat(..., fwd_impl="pallas")`, whose backward is
`_bwd_kernel` run interpreted, as the JAX tests run it off the TPU, and to
torch autograd of the forward's plain version. The CUDA kernel itself is
held against the plain version on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_dit_tpu.ops.flash_attention import flash_attention_qkv_flat as jax_flat
from fast_dit_torch.ops import _build
from fast_dit_torch.ops.flash_attention import (_attention_qkv_bwd_plain, _attention_qkv_plain,
                                                _launch_bwd, flash_attention_qkv_flat)

ATOL = 1e-5  # fp32 on both sides; the sums run in other orders


def _inputs(B, S, H, hd, seed=0):
    rs = np.random.RandomState(seed)
    qkv = rs.randn(B, S, 3 * H * hd).astype(np.float32)
    dout = rs.randn(B, S, H * hd).astype(np.float32)
    return qkv, dout


@pytest.mark.parametrize("B,S,H,hd,scale", [
    (2, 16, 16, 72, None),   # XL-shaped heads (hd 72)
    (2, 64, 6, 64, None),    # S/2-shaped
    (1, 512, 2, 64, None),   # crosses the TPU kernel's 256-row q chunk loop
    (2, 64, 6, 64, 0.3),     # a custom scale
])
def test_plain_backward_matches_pallas_backward(B, S, H, hd, scale):
    qkv, dout = _inputs(B, S, H, hd)
    _, vjp = jax.vjp(lambda x: jax_flat(x, H, scale=scale, fwd_impl="pallas"), qkv)
    (want,) = vjp(dout)
    s = float(hd ** -0.5 if scale is None else scale)
    got = _attention_qkv_bwd_plain(torch.from_numpy(qkv), torch.from_numpy(dout), H, s)
    assert got.shape == (B, S, 3 * H * hd) and got.dtype == torch.float32
    assert np.abs(got.numpy() - np.asarray(want)).max() <= ATOL


@pytest.mark.parametrize("B,S,H,hd", [
    (2, 64, 16, 72),  # XL-shaped heads (hd 72)
    (1, 256, 6, 64),  # S/2-shaped, one full TPU q chunk
])
def test_bf16_plain_backward_matches_the_bf16_pallas_backward(B, S, H, hd):
    """The port's bf16 contract against `jax.vjp` through the TPU kernels'
    bf16 path (clamped, unnormalised softmax, 1/rowsum folded into dO and
    q): the same bf16 qkv and dO, 2e-2 of the largest gradient. N(0, 1)
    inputs keep every logit far below the clamp at 50 (about 5 at most),
    where the two are gradients of the same function."""
    qkv, dout = _inputs(B, S, H, hd, seed=4)
    x, g = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (qkv, dout))
    (want,) = jax.jit(lambda a, b: jax.vjp(
        lambda y: jax_flat(y, H, fwd_impl="pallas"), a)[1](b))(x, g)
    want = np.asarray(want.astype(jnp.float32))
    got = _attention_qkv_bwd_plain(torch.from_numpy(qkv).to(torch.bfloat16),
                                   torch.from_numpy(dout).to(torch.bfloat16), H, hd ** -0.5)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, 3 * H * hd)
    assert np.abs(got.float().numpy() - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_plain_backward_matches_autograd_of_the_plain_forward(dtype):
    qkv, dout = _inputs(2, 40, 4, 16, seed=1)
    x = torch.from_numpy(qkv).to(dtype).requires_grad_()
    g = torch.from_numpy(dout).to(dtype)
    _attention_qkv_plain(x, 4, 0.25).backward(g)
    got = _attention_qkv_bwd_plain(x.detach(), g, 4, 0.25)
    assert got.dtype == dtype
    # autograd's bf16 path rounds the output and its gradient to bf16 on the
    # way through the forward's final cast; the closed form rounds once
    tol = ATOL if dtype == torch.float32 else 2 ** -7 * x.grad.float().abs().max().item()
    assert (got.float() - x.grad.float()).abs().max().item() <= tol


def test_cpu_gradients_flow_through_the_plain_forward(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("no build on the CPU"))
    qkv, dout = _inputs(2, 24, 2, 32, seed=2)
    x = torch.from_numpy(qkv).requires_grad_()
    before = dict(_build.launch_counts)
    flash_attention_qkv_flat(x, 2).backward(torch.from_numpy(dout))
    want = _attention_qkv_bwd_plain(torch.from_numpy(qkv), torch.from_numpy(dout), 2, 32 ** -0.5)
    assert (x.grad - want).abs().max().item() <= ATOL
    assert _build.launch_counts == before


def test_upstream_gradient_is_cast_to_the_qkv_dtype():
    qkv, dout = _inputs(1, 8, 2, 8, seed=3)
    x = torch.from_numpy(qkv).to(torch.bfloat16)
    g32 = torch.from_numpy(dout)
    assert torch.equal(_attention_qkv_bwd_plain(x, g32, 2, 0.5),
                       _attention_qkv_bwd_plain(x, g32.to(torch.bfloat16), 2, 0.5))


def test_backward_launcher_raises_rather_than_falling_back_off_cuda(monkeypatch):
    # the kernel's launcher refuses anything not on the card before building
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("no build expected"))
    qkv = torch.zeros(1, 8, 3 * 16)
    out, dout = torch.zeros(1, 8, 16), torch.zeros(1, 8, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _launch_bwd(qkv, out, dout, torch.zeros(1, 2, 8), 2, 8, 0.5)


def test_every_kernel_has_a_source_and_a_counter():
    assert set(_build.SOURCES) == {"flash_attention_fwd", "flash_attention_bwd", "fused_update",
                                   "ring_hop_fwd", "ring_hop_bwd", "attention_transposed"}
    # the fused update counts its fp32-nu and bf16-nu instantiations apart
    assert set(_build.launch_counts) == {"attention_fwd", "attention_bwd", "fused_adamw_ema",
                                         "fused_adamw_ema_nu_bf16", "ring_hop_fwd",
                                         "ring_hop_bwd", "attention_transposed"}
    for name, src in _build.SOURCES.items():
        assert (_build.CSRC / src).is_file()
        assert _build._target(name).name.startswith(f"lib{name}-")
    _build.launch_counts["attention_bwd"] += 3
    _build.reset_launch_counts()
    assert set(_build.launch_counts.values()) == {0}
