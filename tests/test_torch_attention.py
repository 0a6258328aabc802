"""The port's attention (fast_dit_torch/ops) against the JAX package.

On the CPU the port's wrapper computes its plain twin, so these tests pin
the twin to the JAX Pallas forward `_fwd_kernel` (run interpreted, as the
JAX tests run it off-TPU) and to `_xla_attention_qkv`. The CUDA kernel
itself is held against the twin on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_dit_tpu.ops.flash_attention import _xla_attention_qkv
from fast_dit_tpu.ops.flash_attention import flash_attention_qkv_flat as jax_flat
from fast_dit_torch.ops import _build
from fast_dit_torch.ops.attention import attention_qkv, resolve_backend
from fast_dit_torch.ops.flash_attention import (_attention_qkv_plain, check_qkv,
                                                flash_attention_qkv_flat)
from test_torch_world import drop_tmp_path  # noqa: F401 (an autouse fixture)

ATOL = 1e-5  # fp32 on both sides; the sums run in other orders


def _qkv(B, S, H, hd, seed=0):
    return np.random.RandomState(seed).randn(B, S, 3 * H * hd).astype(np.float32)


@pytest.mark.parametrize("B,S,H,hd,scale", [
    (2, 16, 16, 72, None),   # XL-shaped heads (hd 72)
    (2, 64, 6, 64, None),    # S/2-shaped
    (1, 512, 2, 64, None),   # crosses the TPU kernel's 256-row q chunk
    (2, 64, 6, 64, 0.3),     # a custom scale
])
def test_twin_matches_pallas_forward(B, S, H, hd, scale):
    qkv = _qkv(B, S, H, hd)
    pallas = jax.jit(lambda x: jax_flat(x, H, scale=scale, fwd_impl="pallas"))
    want = np.asarray(pallas(qkv))
    got = flash_attention_qkv_flat(torch.from_numpy(qkv), H, scale=scale).numpy()
    assert got.shape == (B, S, H * hd)
    assert np.abs(got - want).max() <= ATOL

    s = float(hd ** -0.5 if scale is None else scale)
    xla = np.asarray(jax.jit(lambda x: _xla_attention_qkv(x, s, H))(qkv))
    assert np.abs(got - xla).max() <= ATOL


@pytest.mark.parametrize("B,S,H,hd", [
    (2, 64, 16, 72),  # XL-shaped heads (hd 72)
    (1, 256, 6, 64),  # S/2-shaped, one full TPU q chunk
])
def test_bf16_twin_matches_the_bf16_pallas_forward(B, S, H, hd):
    """The port's bf16 contract against the TPU kernel's bf16 path (clamped,
    unnormalised softmax): the same bf16 inputs, 2e-2 of the largest output.
    N(0, 1) inputs keep every logit far below the clamp at 50 (about 5 at
    most), where the two softmaxes are the same function."""
    qkv = _qkv(B, S, H, hd, seed=4)
    pallas = jax.jit(lambda x: jax_flat(x, H, fwd_impl="pallas"))
    want = np.asarray(pallas(jnp.asarray(qkv, dtype=jnp.bfloat16)).astype(jnp.float32))
    got = flash_attention_qkv_flat(torch.from_numpy(qkv).to(torch.bfloat16), H)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H * hd)
    assert np.abs(got.float().numpy() - want).max() <= 2e-2 * np.abs(want).max()


def test_auto_on_cpu_takes_the_twin(monkeypatch):
    def no_build(name):
        raise AssertionError("a CPU tensor must never reach the kernel")

    monkeypatch.setattr(_build, "load", no_build)
    qkv = torch.from_numpy(_qkv(2, 16, 16, 72))
    before = dict(_build.launch_counts)
    out = attention_qkv(qkv, 16, backend="auto")
    assert torch.equal(out, _attention_qkv_plain(qkv, 16, 72 ** -0.5))
    assert torch.equal(attention_qkv(qkv, 16, backend="einsum"), out)
    assert _build.launch_counts == before


@pytest.mark.parametrize("make,heads,match", [
    (lambda: torch.zeros(2, 16, 3 * 4 * 60), 4, "multiple of 8"),          # hd 60
    (lambda: torch.zeros(2, 16, 3 * 2 * 136), 2, "up to 128"),             # hd 136
    (lambda: torch.zeros(2, 16, 3 * 4 * 64, dtype=torch.float16), 4, "float32 or bfloat16"),
    (lambda: torch.zeros(2, 16, 3 * 4 * 64, dtype=torch.float64), 4, "float32 or bfloat16"),
    (lambda: torch.zeros(2, 3 * 4 * 64, 16).transpose(1, 2), 4, "contiguous"),
    (lambda: torch.zeros(16, 3 * 4 * 64), 4, r"\(B, S, 3D\)"),
    (lambda: torch.zeros(2, 16, 100), 4, r"3 \* num_heads"),
])
def test_wrapper_raises_on_what_the_kernel_refuses(make, heads, match):
    with pytest.raises(ValueError, match=match):
        flash_attention_qkv_flat(make(), heads)


def test_wrapper_raises_rather_than_falling_back_off_cpu(monkeypatch):
    # a tensor that is not on the CPU goes to the kernel path, never the twin:
    # here (a meta tensor) that path refuses it before building anything
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("no build expected"))
    qkv = torch.empty(2, 16, 3 * 4 * 64, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_qkv_flat(qkv, 4)


def test_build_names_libraries_by_source_and_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    target = _build._target("flash_attention_fwd")
    assert target.parent == tmp_path and target.name.startswith("libflash_attention_fwd-")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-DX"])
    assert _build._target("flash_attention_fwd") != target  # flags are in the hash
    monkeypatch.setattr(_build.os.path, "isfile", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert not list(tmp_path.iterdir())


def test_build_names_libraries_by_their_headers_too(tmp_path, monkeypatch):
    # an edited csrc/*.cuh must not load a library built from the old one
    for name in _build.SOURCES.values():
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._target("flash_attention_fwd")
    (tmp_path / "tiles.cuh").write_text("// a header\n")
    added = _build._target("flash_attention_fwd")
    (tmp_path / "tiles.cuh").write_text("// an edited header\n")
    assert len({before, added, _build._target("flash_attention_fwd")}) == 3


def test_check_qkv_returns_head_dim_and_backend_names():
    assert check_qkv(torch.zeros(1, 7, 3 * 16 * 72), 16) == 72
    assert check_qkv(torch.zeros(1, 1, 3 * 8, dtype=torch.bfloat16), 1) == 8
    assert resolve_backend("einsum") == "einsum"
    with pytest.raises(ValueError, match="unknown attention backend"):
        resolve_backend("pallas")
