"""The port's ring attention (fast_dit_torch/ops/ring_attention.py) against
the JAX package's.

The hop's plain versions are held to `_hop_forward` and `_hop_backward`,
whose Pallas kernels run interpreted, as `tests/test_sequence.py` runs them
off the TPU; the ring over `LocalRing(n)` is held to the JAX
`ring_attention` under `shard_map` on the conftest's virtual CPU devices
(`create_seq_mesh(n)`). Inputs come from numpy seeds and cross as numpy
arrays. The CUDA kernels themselves are held to the plain versions on the
card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from fast_dit_tpu.ops.ring_attention import _hop_backward, _hop_forward
from fast_dit_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from fast_dit_tpu.parallel.sequence import create_seq_mesh
from fast_dit_torch.models.dit import DiT
from fast_dit_torch.ops import _build
from fast_dit_torch.ops.attention import attention_qkv
from fast_dit_torch.ops.ring_attention import (_hop_backward_plain, _hop_forward_plain,
                                               _launch_hop_bwd, _launch_hop_fwd, _RingHopFn,
                                               ring_attention, ring_attention_qkv)
from fast_dit_torch.parallel import LocalRing

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# the hop, relative to the largest output: fp32, sums in other orders; bf16,
# the TPU kernel rounds p_u (and, backward, do and du) to bf16 before its
# products where the plain version keeps them fp32
HOP_RTOL = {"fp32": 1e-5, "bf16": 2e-2}
# the ring, as tests/test_sequence.py holds the JAX ring to dense attention:
# (output, q/k/v gradients)
RING_TOL = {"fp32": (2e-5, 1e-4), "bf16": (2e-2, 5e-2)}
HOP_SHAPE = (2, 32, 48, 2, 64)  # B, Sq, Sk, H, hd, as test_ring_hop_kernel_vjp_matches_xla_reference


def _hop_inputs(case, seed=0):
    """q (B, Sq, D), k, v (B, Sk, D), do, dl. "clamp": q and k are integers
    in [-8, 8], so about 2 % of the logits pass 50 (the clamp and its
    gradient mask are exercised) while q k^T and s = u / 8 stay exact in
    fp32 in any order: near 50, exp turns a rounding of s into |s| times
    that relative error in p_u, which the check would otherwise measure."""
    B, Sq, Sk, H, hd = HOP_SHAPE
    rs = np.random.RandomState(seed)
    if case == "clamp":
        q = rs.randint(-8, 9, (B, Sq, H * hd)).astype(np.float32)
        k = rs.randint(-8, 9, (B, Sk, H * hd)).astype(np.float32)
    else:
        q = rs.randn(B, Sq, H * hd).astype(np.float32) * 0.5
        k = rs.randn(B, Sk, H * hd).astype(np.float32) * 0.5
    v = rs.randn(B, Sk, H * hd).astype(np.float32) * 0.5
    do = rs.randn(B, Sq, H * hd).astype(np.float32)
    dl = rs.randn(B, Sq, H).astype(np.float32)
    return q, k, v, do, dl


def _cast(arrays, dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    jx = [jnp.asarray(a).astype(jdt) for a in arrays]
    tx = [torch.from_numpy(a).to(tdt) for a in arrays]
    return jx, tx


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("case", ["normal", "clamp"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_hop_forward_plain_matches_pallas(dtype, case):
    B, Sq, Sk, H, hd = HOP_SHAPE
    (jq, jk, jv), (tq, tk, tv) = _cast(_hop_inputs(case)[:3], dtype)
    scale = hd ** -0.5
    want_o, want_l = _hop_forward(jq, jk, jv, scale, H)
    got_o, got_l = _hop_forward_plain(tq, tk, tv, scale, H)
    assert got_o.dtype == got_l.dtype == torch.float32
    assert got_o.shape == (B, Sq, H * hd) and got_l.shape == (B, Sq, H)
    if case == "clamp":  # some logits pass the clamp
        assert float(jnp.max(want_l)) > np.exp(50.0)
    assert _rel_err(got_o.numpy(), want_o) <= HOP_RTOL[dtype]
    assert _rel_err(got_l.numpy(), want_l) <= HOP_RTOL[dtype]


@pytest.mark.parametrize("case", ["normal", "clamp"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_hop_backward_plain_matches_pallas(dtype, case):
    B, Sq, Sk, H, hd = HOP_SHAPE
    q, k, v, do, dl = _hop_inputs(case, seed=1)
    (jq, jk, jv), (tq, tk, tv) = _cast((q, k, v), dtype)
    scale = hd ** -0.5
    want = _hop_backward(jq, jk, jv, jnp.asarray(do), jnp.asarray(dl), scale, H)
    got = _hop_backward_plain(tq, tk, tv, torch.from_numpy(do), torch.from_numpy(dl), scale, H)
    for name, g, w, S in zip(("dq", "dk", "dv"), got, want, (Sq, Sk, Sk)):
        assert g.dtype == DTYPES[dtype][1] and g.shape == (B, S, H * hd), name
        assert _rel_err(g.float().numpy(), w) <= HOP_RTOL[dtype], name


def _hops_rounded_as_the_bf16_kernels(q, k, v, do, dl, scale, num_heads):
    """One hop forward and backward in torch, rounded where the bf16 CUDA
    bodies (csrc/ring_hop_{fwd,bwd}.cu) round: p_u, do and du to bf16 before
    their products, l summed from the rounded p_u, every sum fp32. q, k, v
    bf16 (B, S, D), do and dl fp32; (o_u, l) fp32 and (dq, dk, dv) bf16."""
    B, Sq, D = q.shape
    hd = D // num_heads
    rnd = lambda t: t.to(torch.bfloat16).float()
    qh, kh, vh = (t.float().reshape(B, t.shape[1], num_heads, hd) for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    p_u = torch.exp(torch.clamp(s, max=50.0))
    pc, doc = rnd(p_u), rnd(do).reshape(B, Sq, num_heads, hd)
    o = torch.einsum("bhqk,bkhd->bqhd", pc, vh).reshape(B, Sq, D)
    dp = torch.einsum("bqhd,bkhd->bhqk", doc, vh) + dl.transpose(1, 2)[..., None]
    du = rnd(torch.where(s < 50.0, p_u * dp, 0.0) * scale)
    grads = (torch.einsum("bhqk,bkhd->bqhd", du, kh), torch.einsum("bhqk,bqhd->bkhd", du, qh),
             torch.einsum("bhqk,bqhd->bkhd", pc, doc))
    return (o, pc.sum(-1).transpose(1, 2),
            *(g.reshape(B, -1, D).to(torch.bfloat16) for g in grads))


@pytest.mark.parametrize("case,shape", [("normal", (2, 64, 40, 16, 72)),
                                        ("clamp", (2, 64, 40, 6, 64))])
def test_bf16_kernel_rounding_stays_within_the_card_limit(case, shape):
    """The bf16 hop bodies round p_u, do and du to bf16 where the plain
    versions keep fp32; the card holds them to 2e-2 of the largest output
    of the plain versions. That rounding alone, at chip_smoke.py's shapes
    scaled down and at the integer clamp-crossing inputs, stays inside it."""
    B, Sq, Sk, H, hd = shape
    rs = np.random.RandomState(10)
    if case == "clamp":
        q, k = (rs.randint(-8, 9, (B, S, H * hd)).astype(np.float32) for S in (Sq, Sk))
    else:
        q, k = (rs.randn(B, S, H * hd).astype(np.float32) for S in (Sq, Sk))
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in (q, k, rs.randn(B, Sk, H * hd).astype(np.float32)))
    do = torch.from_numpy(rs.randn(B, Sq, H * hd).astype(np.float32))
    dl = torch.from_numpy(rs.randn(B, Sq, H).astype(np.float32))
    scale = hd ** -0.5
    plain = _hop_forward_plain(q, k, v, scale, H) + _hop_backward_plain(q, k, v, do, dl, scale, H)
    if case == "clamp":
        assert plain[1].max().item() > np.exp(50.0)
    rounded = _hops_rounded_as_the_bf16_kernels(q, k, v, do, dl, scale, H)
    for name, got, want in zip(("o_u", "l", "dq", "dk", "dv"), rounded, plain):
        assert got.shape == want.shape, name
        assert _rel_err(got.float().numpy(), want.float().numpy()) <= HOP_RTOL["bf16"], name


@pytest.mark.parametrize("case", ["normal", "clamp"])
def test_bf16_kernel_rounding_is_the_pallas_hops_rounding(case):
    """The bf16 bodies' rounding points are the TPU kernels' (`pc`, `doc`,
    `duc`): modelled in torch, they agree with the bf16 Pallas hops at least
    as closely as the fp32 plain versions do."""
    B, Sq, Sk, H, hd = HOP_SHAPE
    q, k, v, do, dl = _hop_inputs(case, seed=11)
    (jq, jk, jv), (tq, tk, tv) = _cast((q, k, v), "bf16")
    scale = hd ** -0.5
    want = (_hop_forward(jq, jk, jv, scale, H)
            + tuple(_hop_backward(jq, jk, jv, jnp.asarray(do), jnp.asarray(dl), scale, H)))
    tdo, tdl = torch.from_numpy(do), torch.from_numpy(dl)
    plain = (_hop_forward_plain(tq, tk, tv, scale, H)
             + _hop_backward_plain(tq, tk, tv, tdo, tdl, scale, H))
    rounded = _hops_rounded_as_the_bf16_kernels(tq, tk, tv, tdo, tdl, scale, H)
    for name, r, p, w in zip(("o_u", "l", "dq", "dk", "dv"), rounded, plain, want):
        r_err = _rel_err(r.float().numpy(), w)
        assert r_err <= _rel_err(p.float().numpy(), w), name
        assert r_err <= HOP_RTOL["bf16"], name


def _jax_ring(q, k, v, n, scale=None):
    mesh = create_seq_mesh(n)
    fn = lambda a, b, c: jax_ring_attention(a, b, c, axis="seq", scale=scale)
    return shard_map(fn, mesh=mesh, in_specs=(P(None, "seq"),) * 3,
                     out_specs=P(None, "seq"), check_vma=False)(q, k, v)


def _torch_ring(q, k, v, n, scale=None):
    ring = LocalRing(n)
    return ring.unshard(ring_attention(ring.shard(q), ring.shard(k), ring.shard(v), ring,
                                       scale=scale))


def _ring_inputs(seed, S=48, H=2, hd=64):
    rs = np.random.RandomState(seed)
    qkv = [rs.randn(2, S, H, hd).astype(np.float32) * 0.5 for _ in range(3)]
    return qkv, rs.randn(2, S, H, hd).astype(np.float32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_ring_attention_matches_jax(n, dtype):
    """Output and q/k/v gradients of sum((out - tgt)^2) over LocalRing(n) vs
    the JAX ring over an n-device mesh; n = 3 makes every shard differ from
    its neighbours in both directions, so a wrong roll direction shows."""
    arrays, tgt = _ring_inputs(seed=n)
    (jq, jk, jv), (tq, tk, tv) = _cast(arrays, dtype)
    tol_out, tol_grad = RING_TOL[dtype]

    def jloss(q, k, v):
        return jnp.sum((_jax_ring(q, k, v, n).astype(jnp.float32) - tgt) ** 2)

    want = _jax_ring(jq, jk, jv, n)
    g_want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    ts = [t.requires_grad_() for t in (tq, tk, tv)]
    got = _torch_ring(*ts, n)
    assert got.dtype == DTYPES[dtype][1]
    ((got.float() - torch.from_numpy(tgt)) ** 2).sum().backward()
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol_out, atol=tol_out)
    for t, w in zip(ts, g_want):
        assert t.grad.dtype == DTYPES[dtype][1]
        np.testing.assert_allclose(t.grad.float().numpy(), np.asarray(w, np.float32),
                                   rtol=tol_grad, atol=tol_grad)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_ring_attention_custom_scale(dtype):
    arrays, _ = _ring_inputs(seed=7)
    (jq, jk, jv), (tq, tk, tv) = _cast(arrays, dtype)
    want = _jax_ring(jq, jk, jv, 4, scale=0.31)
    got = _torch_ring(tq, tk, tv, 4, scale=0.31)
    tol = RING_TOL[dtype][0]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_streaming_path_is_exact_past_the_clamp():
    """fp32 takes the streaming online softmax: exact where logits pass 50,
    where the clamped hops would not be (JAX `_ring_xla`)."""
    rs = np.random.RandomState(8)
    q, k = (rs.randn(2, 24, 2, 8).astype(np.float32) * 8 for _ in range(2))
    v = rs.randn(2, 24, 2, 8).astype(np.float32)
    want = _jax_ring(*(jnp.asarray(a) for a in (q, k, v)), 3)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", tq, tk) * 8 ** -0.5
    assert s.max() > 50
    dense = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), tv)
    got = _torch_ring(tq, tk, tv, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=2e-5, atol=2e-5)


def test_local_ring_layout_and_rotation():
    """shard -> (n*B, N/n, ...) shard-major; after s rotations shard i holds
    shard (i - s) mod n, the JAX perm [(i, (i + 1) % n)]."""
    n, B = 3, 2
    ring = LocalRing(n)
    x = torch.arange(B * 6 * 4, dtype=torch.float32).reshape(B, 6, 4)
    xs = ring.shard(x)
    assert xs.shape == (n * B, 2, 4)
    assert torch.equal(xs[1 * B + 1], x[1, 2:4])
    assert torch.equal(ring.unshard(xs), x)
    assert torch.equal(ring.expand(torch.tensor([[5.0], [6.0]])).flatten(),
                       torch.tensor([5.0, 6.0] * n))
    rolled = xs
    for s in range(1, n + 1):
        rolled = ring.rotate(rolled)
        for i in range(n):
            assert torch.equal(rolled[i * B:(i + 1) * B], xs[((i - s) % n) * B:][:B])
    with pytest.raises(ValueError, match="do not split"):
        LocalRing(4).shard(x)


def test_packed_qkv_is_read_in_place_in_the_jax_column_order():
    """q at column 0, k at D, v at 2D: the (3, H, hd) order of the JAX
    attention's projection."""
    rs = np.random.RandomState(9)
    B, S, H, hd = 2, 16, 2, 8
    qkv = torch.from_numpy(rs.randn(B, S, 3 * H * hd).astype(np.float32)).to(torch.bfloat16)
    ring = LocalRing(2)
    got = ring_attention_qkv(ring.shard(qkv), H, ring)
    q, k, v = (qkv[..., i * H * hd:(i + 1) * H * hd].reshape(B, S, H, hd) for i in range(3))
    want = ring_attention(*(ring.shard(t.contiguous()) for t in (q, k, v)), ring)
    assert torch.equal(got, want.reshape(got.shape))
    assert torch.equal(attention_qkv(ring.shard(qkv), H, backend="ring", ring=ring), got)


def test_ring_backend_without_a_ring_raises():
    """The counterpart of test_ring_backend_string_outside_shardmap_fails."""
    with pytest.raises(RuntimeError, match="sequence-parallel"):
        attention_qkv(torch.zeros(1, 4, 3 * 16), 2, backend="ring")


@pytest.mark.parametrize("backend", ["auto", "einsum"])
def test_ring_with_a_dense_backend_raises(backend):
    with pytest.raises(ValueError, match="needs the 'ring' backend"):
        attention_qkv(torch.zeros(2, 4, 3 * 16), 2, backend=backend, ring=LocalRing(2))


def test_ring_is_not_a_model_backend():
    """A model takes the ring from its forward, not from its constructor."""
    with pytest.raises(ValueError, match="unknown attention backend"):
        DiT(input_size=8, patch_size=2, in_channels=4, hidden_size=32, depth=1, num_heads=2,
            num_classes=10, attn_backend="ring", device="cpu")


def test_hop_cotangents_are_fp32_and_gradients_keep_the_input_dtype():
    q, k, v, do, dl = _hop_inputs("normal", seed=2)
    ts = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in (q, k, v)]
    o, l = _RingHopFn.apply(*ts, 0.125, 2)
    assert o.dtype == l.dtype == torch.float32
    (o * torch.from_numpy(do)).sum().add((l * torch.from_numpy(dl)).sum()).backward()
    want = _hop_backward_plain(*(t.detach() for t in ts), torch.from_numpy(do),
                               torch.from_numpy(dl), 0.125, 2)
    for t, w in zip(ts, want):
        assert t.grad.dtype == torch.bfloat16
        assert torch.equal(t.grad, w)


def test_cpu_ring_builds_and_launches_nothing(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("no build on the CPU"))
    arrays, _ = _ring_inputs(seed=3, S=16)
    ts = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in arrays]
    before = dict(_build.launch_counts)
    _torch_ring(*ts, 4).float().sum().backward()
    assert _build.launch_counts == before


def test_hop_launchers_raise_rather_than_falling_back_off_cuda(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("no build expected"))
    q, kv = torch.zeros(1, 8, 16), torch.zeros(1, 4, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _launch_hop_fwd(q, kv, kv, 0.5, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _launch_hop_bwd(q, kv, kv, torch.zeros(1, 8, 16), torch.zeros(1, 8, 2), 0.5, 2)
    with pytest.raises(ValueError, match="hd a multiple of 8"):
        _launch_hop_fwd(torch.zeros(1, 8, 24), torch.zeros(1, 4, 24), torch.zeros(1, 4, 24),
                        0.5, 2)
