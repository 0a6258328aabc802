"""The port's clamped attention forward (fast_dit_torch/ops/attn_layout.py)
against the TPU kernel of `benchmarks/attn_layout_bench.py`.

`_transposed_forward_plain` is held to JAX's `transposed_forward`, loaded by
path (the benchmark folder is not a package), whose Pallas kernel runs in
interpret mode off the TPU (:90). Inputs come from numpy seeds and cross as
numpy arrays. The CUDA kernel itself is held to the plain version on the
card (tests/test_torch_cuda.py and chip_smoke.py's `attn_layout` phase).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from fast_dit_torch import ops
from fast_dit_torch.ops import _build
from fast_dit_torch.ops.attn_layout import _transposed_forward_plain, transposed_forward
from fast_dit_torch.ops.flash_attention import _attention_qkv_plain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# fp32: sums in other orders. bf16: of max |out|; both sides round p_u to bf16
# at the same point and sum in fp32, so they agree far more closely (0 at
# every case here, measured): the limit is the kernels' bf16 limit
TOL = {"fp32": 1e-5, "bf16": 2e-2}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_transposed_forward():
    spec = importlib.util.spec_from_file_location(
        "attn_layout_bench", os.path.join(REPO, "benchmarks", "attn_layout_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.transposed_forward


def _qkv(B, S, H, hd, seed, large=False):
    """A packed (B, S, 3D) fp32 qkv. `large`: q and k are integers in [-8, 8],
    so q k^T is exact in fp32 in any order and s = u * scale rounds alike on
    both sides, while about 2 % of the logits pass 50 (up to ~90 at hd 8)."""
    rs = np.random.RandomState(seed)
    D = H * hd
    if large:
        qk = rs.randint(-8, 9, (B, S, 2 * D)).astype(np.float32)
        return np.concatenate([qk, rs.randn(B, S, D).astype(np.float32)], axis=-1)
    return (rs.randn(B, S, 3 * D) * 0.5).astype(np.float32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("B,S,H,hd", [(2, 40, 3, 8), (1, 24, 2, 72)])
def test_plain_matches_pallas(B, S, H, hd, dtype):
    jdt, tdt = DTYPES[dtype]
    x = _qkv(B, S, H, hd, seed=S)
    scale = hd ** -0.5
    want = np.asarray(_jax_transposed_forward()(jnp.asarray(x).astype(jdt), scale, H)
                      .astype(jnp.float32))
    got = _transposed_forward_plain(torch.from_numpy(x).to(tdt), scale, H)
    assert got.dtype == tdt and got.shape == (B, S, H * hd)
    err = np.abs(got.float().numpy() - want).max()
    limit = TOL[dtype] * (np.abs(want).max() if dtype == "bf16" else 1.0)
    assert err <= limit, (err, limit)


def test_plain_follows_the_clamp_past_50():
    B, S, H, hd = 2, 40, 3, 8
    x = _qkv(B, S, H, hd, seed=1, large=True)
    scale = hd ** -0.5
    q, k = (x[..., i * H * hd:(i + 1) * H * hd].reshape(B, S, H, hd) for i in range(2))
    assert (np.einsum("bqhd,bkhd->bhqk", q, k) * scale).max() > 50
    want = np.asarray(_jax_transposed_forward()(jnp.asarray(x), scale, H))
    t = torch.from_numpy(x)
    got = _transposed_forward_plain(t, scale, H).numpy()
    assert np.abs(got - want).max() <= TOL["fp32"]
    # kernel 1's exact softmax parts from the clamped contract there
    exact = _attention_qkv_plain(t, H, scale).numpy()
    assert np.abs(got - exact).max() > 0.1


def test_plain_is_softmax_attention_below_the_clamp():
    x = torch.from_numpy(_qkv(2, 33, 2, 16, seed=3))
    np.testing.assert_allclose(_transposed_forward_plain(x, 0.25, 2).numpy(),
                               _attention_qkv_plain(x, 2, 0.25).numpy(), atol=1e-6)


def test_wrapper_runs_the_plain_version_on_a_cpu_tensor_and_counts_no_launch():
    x = torch.from_numpy(_qkv(2, 17, 2, 8, seed=4)).to(torch.bfloat16)
    before = dict(_build.launch_counts)
    out = transposed_forward(x, 0.3, 2)
    assert _build.launch_counts == before
    assert torch.equal(out, _transposed_forward_plain(x, 0.3, 2))
    assert ops.transposed_forward is transposed_forward


@pytest.mark.parametrize("qkv,heads,match", [
    (torch.zeros(1, 4, 3 * 16, dtype=torch.float16), 2, "float32 or bfloat16"),
    (torch.zeros(1, 4, 3 * 20), 3, "3 \\* num_heads"),       # D % H != 0
    (torch.zeros(1, 4, 3 * 8), 2, "multiple of 8"),          # hd 4
    (torch.zeros(1, 4, 3 * 136), 1, "up to 128"),            # hd 136
    (torch.zeros(1, 4, 3 * 32)[:, ::2], 2, "contiguous"),    # a strided view
    (torch.zeros(4, 3 * 16), 2, "packed qkv"),               # not (B, S, 3D)
])
def test_wrapper_refuses_what_the_kernel_does_not_take(qkv, heads, match, monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("no build expected"))
    with pytest.raises(ValueError, match=match):
        transposed_forward(qkv, 0.5, heads)


def test_launcher_raises_rather_than_falling_back_off_cuda(monkeypatch):
    # a tensor on neither the CPU nor the card reaches the launcher, which
    # refuses it before building
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("no build expected"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        transposed_forward(torch.zeros(1, 4, 3 * 16, device="meta"), 0.5, 2)


def test_kernel_check_rows_take_the_library_times():
    # chip_smoke's kernel_check lines: the bounds and, given the library's
    # times, the kernels' ratios to them
    row = {"S": 256, "dtype": "bfloat16", "B": 2, "H": 16, "hd": 72, "regime": "fwd+bwd",
           "kernel_ms": 0.03, "bwd_kernel_ms": 0.12}
    seen = []

    def library(r):
        seen.append((r["B"], r["S"], r["H"], r["hd"], r["dtype"], r["regime"]))
        return "sdpa", 0.02, 0.1

    out = chip_smoke._with_bounds(dict(row), library)
    assert seen == [(2, 256, 16, 72, "bfloat16", "fwd+bwd")]
    assert out["phase"] == "kernel_check" and out["library"] == "sdpa"
    assert out["library_ms"] == 0.02 and out["bwd_library_ms"] == 0.1
    assert out["x_library"] == pytest.approx(1.5) and out["bwd_x_library"] == pytest.approx(1.2)
    assert out["bound_by"] == "bytes" and out["bwd_bound_ms"] > out["bound_ms"]
    inference = chip_smoke._with_bounds({**row, "regime": "inference", "bwd_kernel_ms": None},
                                        lambda r: ("sdpa", 0.02, None))
    assert inference["bwd_library_ms"] is None and "bwd_x_library" not in inference
    assert "bwd_bound_ms" not in inference
    assert "library_ms" not in chip_smoke._with_bounds(dict(row))


def test_the_kernel_is_built_and_counted_with_the_others():
    assert _build.SOURCES["attention_transposed"] == "attention_transposed_fwd.cu"
    assert (_build.CSRC / "attention_transposed_fwd.cu").is_file()
    assert _build.launch_counts["attention_transposed"] == 0
    # the bench shape's bound: 4 B S D bf16 bytes over the card's rate
    assert chip_smoke.attention_bound_ms(16, 256, 16, 72, torch.bfloat16) == pytest.approx(
        (4 * 16 * 256 * 1152 * 2 / 3.35e12 * 1e3, "bytes"))
