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
from fast_dit_torch.ops.attn_layout import (TMA_BOX_ROWS, _plan_array, _tma_plan,
                                            _transposed_forward_plain, transposed_forward)
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


# ---------------------------------------------------------------------------
# the bf16 body's plan: TMA's rules, and every head rebuilt from the boxes and
# 16-byte pieces the kernel moves, with TMA's out-of-bounds rule in numpy
# ---------------------------------------------------------------------------

def _box_index(m, coords):
    """(element index into the flat tensor, in-bounds mask) of the box of map
    `m` at `coords` (innermost first), shaped as the box lies in shared memory
    (outermost dim first). Byte offsets come from the map's strides alone."""
    rank = len(m["dims"])
    strides = (2, *m["strides"])  # bf16
    off = np.zeros((), np.int64)
    ok = np.ones((), bool)
    for i in range(rank):
        shape = [1] * rank
        shape[rank - 1 - i] = m["box"][i]
        pos = (coords[i] + np.arange(m["box"][i])).reshape(shape)
        off = off + pos * strides[i]
        ok = ok & (pos >= 0) & (pos < m["dims"][i])
    assert (off[ok] % 2 == 0).all()
    return off // 2, ok


def _tma_load(flat, m, coords):
    idx, ok = _box_index(m, coords)
    return np.where(ok, flat[np.where(ok, idx, 0)], 0).reshape(m["box"][-1::-1]).squeeze()


@pytest.mark.parametrize("S", [1, 7, 65, 180, 256])
@pytest.mark.parametrize("hd", list(range(8, 129, 8)))
def test_tma_plan_keeps_the_rules_and_rebuilds_every_head(hd, S):
    B, H = 2, 2
    plan = _tma_plan(B, S, H, hd)
    hdp, chunks, maps = plan["hdp"], plan["chunks"], plan["maps"]
    n_tma = plan["tma_chunks"]
    assert {w for _, w in chunks[:n_tma]} == {chunks[0][1]}
    assert hdp % 16 == 0 and hd <= hdp < hd + 16
    assert [c for c, _ in chunks] == [sum(w for _, w in chunks[:i]) for i in range(len(chunks))]
    assert sum(w for _, w in chunks) == hdp and all(w in (16, 32, 64) for _, w in chunks)
    for m in maps.values():
        rank = len(m["dims"])
        assert rank <= 5 and len(m["box"]) == rank and len(m["strides"]) == rank - 1
        assert all(s % 16 == 0 and s < 2 ** 40 for s in m["strides"])
        assert all(1 <= b <= 256 for b in m["box"]) and all(d < 2 ** 32 for d in m["dims"])
        assert m["box"][0] == chunks[0][1] and m["box"][0] * 2 % 16 == 0
        assert m["swizzle"] in (32, 64, 128) and m["box"][0] * 2 <= m["swizzle"]
    # the packed form the C entry point reads: rank, dims, strides, box, swizzle
    arr = list(_plan_array(B, S, H, hd))
    m = maps["out"]
    assert arr[16:] == [4, *m["dims"], 0, *m["strides"], 0, *m["box"], 0, m["swizzle"]]

    # loads: K and V in 64-key tiles, Q in tiles of block_rows, 64-row boxes;
    # the first chunks by TMA boxes, the others in 16-byte pieces (8 columns)
    D = H * hd
    x = np.arange(1, B * S * 3 * D + 1, dtype=np.int64)
    heads = x.reshape(B, S, 3, H, hd)
    nk = -(-S // TMA_BOX_ROWS) * TMA_BOX_ROWS
    nq = -(-S // plan["block_rows"]) * plan["block_rows"]
    for b in range(B):
        for h in range(H):
            for part, rows in ((0, nq), (1, nk), (2, nk)):
                tile = np.full((rows, hdp), -1, np.int64)
                for r0 in range(0, rows, TMA_BOX_ROWS):
                    for col, w in chunks[:n_tma]:
                        tile[r0:r0 + TMA_BOX_ROWS, col:col + w] = _tma_load(
                            x, maps["qkv"], (col, h, part, r0, b))
                for col, w in chunks[n_tma:]:
                    for r in range(rows):
                        for c in range(col, col + w, 8):
                            ok = r < S and c < hd
                            tile[r, c:c + 8] = heads[b, r, part, h, c:c + 8] if ok else 0
                want = np.zeros((rows, hdp), np.int64)
                want[:S, :hd] = heads[b, :, part, h]
                np.testing.assert_array_equal(tile, want)

    # stores: each warpgroup's 64 rows of a query tile; the first chunks
    # through the output map, the others in pieces; only rows < S and columns
    # < hd land, and every output element does
    out = np.full(B * S * D, -1, np.int64)
    o = np.arange(B * H * nq * hdp, dtype=np.int64).reshape(B, H, nq, hdp)
    for b in range(B):
        for h in range(H):
            for r0 in range(0, nq, TMA_BOX_ROWS):
                for col, w in chunks[:n_tma]:
                    idx, ok = _box_index(maps["out"], (col, h, r0, b))
                    vals = o[b, h, r0:r0 + TMA_BOX_ROWS, col:col + w].reshape(idx.shape)
                    out[idx[ok]] = vals[ok]
            for col, w in chunks[n_tma:]:
                for r in range(min(nq, S)):
                    for c in range(col, min(col + w, hd), 8):
                        at = ((b * S + r) * H + h) * hd + c
                        out[at:at + 8] = o[b, h, r, c:c + 8]
    np.testing.assert_array_equal(out.reshape(B, S, H, hd),
                                  o[:, :, :S, :hd].transpose(0, 2, 1, 3))


def test_the_build_comparison_needs_a_card():
    # kernel6_compare times builds of kernel 6 on the card; without one it
    # stops before building anything
    from fast_dit_torch import kernel6_compare
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        kernel6_compare.main(["--other", "pr16=missing.cu"])
