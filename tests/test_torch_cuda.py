"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA card with `nvcc` (sm_90a); elsewhere they skip. Run
them on the card, where JAX is not installed, without the JAX test
configuration in conftest.py:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from fast_dit_torch.ops import _build
from fast_dit_torch.ops import fused_update as fu
from fast_dit_torch.ops.attn_layout import _launch as _launch_transposed
from fast_dit_torch.ops.attn_layout import _transposed_forward_plain, transposed_forward
from fast_dit_torch.ops.flash_attention import (_attention_qkv_bwd_plain, _attention_qkv_plain,
                                                _launch_fwd, flash_attention_qkv_flat)
from fast_dit_torch.ops.ring_attention import (_BWD_ARGS, _FWD_ARGS, _hop_backward_plain,
                                               _hop_forward_plain, _launch_hop_bwd,
                                               _launch_hop_fwd, ring_attention)
from fast_dit_torch.parallel import LocalRing
from test_torch_world import drop_tmp_path  # noqa: F401 (an autouse fixture)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}  # bf16 plain version computes in fp32
# the backward, relative to max |dqkv|: fp32 sums in other orders; bf16, p and
# ds rounded to bf16 before their products, the output rounded once and delta
# formed from the bf16-rounded forward output
BWD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SHAPES = [
    (16, 256, 16, 72),  # DiT-XL/2 at 256², CFG batch of 8 labels
    (32, 256, 16, 72),  # DiT-XL/2 at 256², training batch 32
    (2, 1024, 16, 72),  # DiT-XL/2 at 512²: 1024 tokens
    (2, 200, 6, 64),    # a ragged S
    (1, 7, 2, 128),     # S below one tile, the largest head dim
    (3, 65, 4, 8),      # one key past a tile, the smallest head dim
    # head dims that pad to the bf16 kernels' k step of 16, at ragged S
    (2, 65, 3, 16), (2, 130, 3, 24), (2, 65, 3, 40), (2, 130, 3, 56),
    (2, 65, 3, 80), (2, 130, 3, 96), (2, 65, 3, 112),
]
# (shape, large): large logits at the main shape and a ragged one
CASES = [(*shape, False) for shape in SHAPES] + [(16, 256, 16, 72, True), (2, 200, 6, 64, True)]


def _qkv(cuda, B, S, H, hd, dtype, large, seed):
    """A packed qkv. `large`: q and k scaled by 4, so the logits reach about
    100 (past the TPU's bf16 clamp at 50) and the row max decides the rows;
    v scaled by 1/4, so the output stays below 2 and the absolute limits
    stay the measure (at |o| near 4 one bf16 ulp is 3e-2). Not by 8: the
    logits then reach ~360, and an exact fp32 softmax carries |logit| x
    2^-24 of rounding in each p, so two fp32 orders part by ~1.1e-5 of
    max |dqkv| in the backward, past its 1e-5 limit."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn(B, S, 3 * H * hd, generator=g, device=cuda)
    if large:
        qkv[..., :2 * H * hd] *= 4
        qkv[..., 2 * H * hd:] *= 0.25
        q, k = (qkv[..., i * H * hd:(i + 1) * H * hd].view(B, S, H, hd) for i in range(2))
        assert torch.einsum("bqhd,bkhd->bhqk", q, k).max().item() * hd ** -0.5 > 50
    return qkv.to(dtype)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,S,H,hd,large", CASES)
def test_attention_kernel_matches_twin(cuda, B, S, H, hd, large, dtype):
    qkv = _qkv(cuda, B, S, H, hd, dtype, large, seed=0)
    before = _build.launch_counts["attention_fwd"]
    out = flash_attention_qkv_flat(qkv, H)
    torch.cuda.synchronize()
    assert _build.launch_counts["attention_fwd"] == before + 1
    assert out.dtype == dtype and out.shape == (B, S, H * hd)
    assert torch.isfinite(out).all()
    ref = _attention_qkv_plain(qkv, H, hd ** -0.5)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,S,H,hd,large", CASES)
def test_attention_backward_kernel_matches_plain(cuda, B, S, H, hd, large, dtype):
    qkv = _qkv(cuda, B, S, H, hd, dtype, large, seed=1).requires_grad_()
    g = torch.Generator(device=cuda).manual_seed(2)
    dout = torch.randn(B, S, H * hd, generator=g, device=cuda).to(dtype)
    before = dict(_build.launch_counts)
    flash_attention_qkv_flat(qkv, H).backward(dout)
    torch.cuda.synchronize()
    assert _build.launch_counts["attention_fwd"] == before["attention_fwd"] + 1
    assert _build.launch_counts["attention_bwd"] == before["attention_bwd"] + 1
    ref = _attention_qkv_bwd_plain(qkv.detach(), dout, H, hd ** -0.5).float()
    assert qkv.grad.dtype == dtype and torch.isfinite(qkv.grad).all()
    err = (qkv.grad.float() - ref).abs().max().item()
    assert err <= BWD_RTOL[dtype] * ref.abs().max().item()


@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16], ids=["p32", "p16"])
@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16], ids=["mu32", "mu16"])
def test_fused_update_kernel_matches_update_math(cuda, p_dtype, mu_dtype):
    g = torch.Generator(device=cuda).manual_seed(2)
    sizes = [1, 33, 4096, 1000003]  # leaves of any size, one launch each
    params = [(0.1 * torch.randn(n, generator=g, device=cuda)).to(p_dtype) for n in sizes]
    plain = [p.clone() for p in params]
    state = fu.fused_adamw_ema_init(params, mu_dtype=mu_dtype)
    pstate = fu.fused_adamw_ema_init(plain, mu_dtype=mu_dtype)
    ema, pema = [w.clone() for w in state.master], [w.clone() for w in pstate.master]
    hyper = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, wd=0.01, ema_decay=0.99)
    before = _build.launch_counts["fused_adamw_ema"]
    for _ in range(3):
        grads = [(0.01 * torch.randn(n, generator=g, device=cuda)).to(p_dtype) for n in sizes]
        fu.fused_adamw_ema_apply(state, grads, params, ema, lr=1e-3, weight_decay=0.01,
                                 ema_decay=0.99)
        fu._apply_plain(pstate, grads, plain, pema, hyper)
    torch.cuda.synchronize()
    assert _build.launch_counts["fused_adamw_ema"] == before + 3 * len(sizes)
    # both round op for op in fp32, each op correctly rounded: equal in every element
    for got, want in ((params, plain), (state.mu, pstate.mu), (state.nu, pstate.nu),
                      (state.master, pstate.master), (ema, pema)):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            assert torch.equal(a, b)


@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16], ids=["p32", "p16"])
@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16], ids=["mu32", "mu16"])
def test_fused_update_kernel_with_bf16_nu_matches_update_math(cuda, p_dtype, mu_dtype):
    """The kernel's bf16-nu instantiation, at sizes that are no multiple of
    any vector width: vhat from the unrounded v32, only the stored nu
    rounded, equal to `_update_math` in every element."""
    g = torch.Generator(device=cuda).manual_seed(5)
    sizes = [1, 7, 33, 4097, 1000003]
    params = [(0.1 * torch.randn(n, generator=g, device=cuda)).to(p_dtype) for n in sizes]
    plain = [p.clone() for p in params]
    state = fu.fused_adamw_ema_init(params, mu_dtype=mu_dtype, nu_dtype=torch.bfloat16)
    pstate = fu.fused_adamw_ema_init(plain, mu_dtype=mu_dtype, nu_dtype=torch.bfloat16)
    ema, pema = [w.clone() for w in state.master], [w.clone() for w in pstate.master]
    hyper = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, wd=0.01, ema_decay=0.99)
    before = dict(_build.launch_counts)
    for _ in range(3):
        grads = [(0.01 * torch.randn(n, generator=g, device=cuda)).to(p_dtype) for n in sizes]
        fu.fused_adamw_ema_apply(state, grads, params, ema, lr=1e-3, weight_decay=0.01,
                                 ema_decay=0.99)
        fu._apply_plain(pstate, grads, plain, pema, hyper)
    torch.cuda.synchronize()
    assert _build.launch_counts["fused_adamw_ema_nu_bf16"] == (
        before["fused_adamw_ema_nu_bf16"] + 3 * len(sizes))
    assert _build.launch_counts["fused_adamw_ema"] == before["fused_adamw_ema"]
    for got, want in ((params, plain), (state.mu, pstate.mu), (state.nu, pstate.nu),
                      (state.master, pstate.master), (ema, pema)):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            assert torch.equal(a, b)


def test_factored_state_on_the_card_matches_the_cpu(cuda):
    """A small DiT's factored state, two steps: on the card the dense leaves
    go through the kernel and equal `_apply_plain` on the card in every
    element; the factored leaves run the same stock ops as on the CPU, whose
    means are summed in another order: within 1e-5 of their largest value."""
    from fast_dit_torch.ckpt import jax_leaves
    from fast_dit_torch.models import DiT
    model = DiT(input_size=8, hidden_size=192, depth=2, num_heads=3, num_classes=10,
                device="cpu")
    leaves = jax_leaves(model)
    g = torch.Generator().manual_seed(6)
    init = [(0.1 * torch.randn(p.shape, generator=g)).to(torch.bfloat16)
            for p in model.parameters()]
    grads = [[(0.01 * torch.randn(p.shape, generator=g)).to(torch.bfloat16) for p in init]
             for _ in range(2)]
    hyper = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, wd=0.0, ema_decay=0.9999)
    outs = {}
    for run, device in (("kernel", "cuda"), ("plain", "cuda"), ("cpu", "cpu")):
        params = [p.to(device) for p in init]
        state = fu.fused_adamw_ema_init(params, factored=True, leaves=leaves)
        ema = [w.clone() for w in state.master]
        before = dict(_build.launch_counts)
        for gs in grads:
            gs = [x.to(device) for x in gs]
            if run == "plain":
                fu._apply_plain(state, gs, params, ema, hyper)
            else:
                fu.fused_adamw_ema_apply(state, gs, params, ema, lr=1e-3)
        if run == "kernel":
            dense = sum(not isinstance(v, fu.FactoredNu) for v in state.nu)
            assert 0 < dense < len(state.nu)
            assert _build.launch_counts["fused_adamw_ema"] == before["fused_adamw_ema"] + 2 * dense
        outs[run] = (state, ema)
    torch.cuda.synchronize()
    (card, card_ema), (plain, plain_ema), (cpu, cpu_ema) = (outs[k] for k in ("kernel", "plain",
                                                                             "cpu"))
    for i, v in enumerate(cpu.nu):
        if isinstance(v, fu.FactoredNu):
            for a, b in ((card.master[i], cpu.master[i]), (card_ema[i], cpu_ema[i]),
                         (card.nu[i].row, v.row), (card.nu[i].col, v.col)):
                assert (a.cpu() - b).abs().max() <= 1e-5 * b.abs().max()
        else:
            for a, b in ((card.master[i], plain.master[i]), (card_ema[i], plain_ema[i]),
                         (card.nu[i], plain.nu[i]), (card.mu[i], plain.mu[i])):
                assert torch.equal(a, b)


@pytest.mark.parametrize("policy", [None, "nothing", "attn", "attn_mlp"])
def test_remat_policy_launch_counts_and_gradients_on_the_card(cuda, policy):
    """Per training step (forward + backward) of a bf16 DiT: no remat
    launches the forward kernel once per block, every policy twice (its
    attention region runs again in the backward); the backward kernel once
    per block; the gradients of each policy equal no remat's."""
    from fast_dit_torch.models import DiT
    grads = {}
    for p in (None, policy):
        model = DiT(input_size=8, hidden_size=384, depth=3, num_heads=6, dtype=torch.bfloat16,
                    remat=p is not None, remat_policy=p or "nothing", device=cuda, seed=1)
        x = torch.randn(4, 4, 8, 8, generator=torch.Generator().manual_seed(2)).to(cuda)
        _build.reset_launch_counts()
        model(x, torch.tensor([1, 50, 500, 900], device=cuda), torch.tensor([1, 2, 3, 4],
              device=cuda), train=True, force_drop_ids=torch.zeros(4, dtype=torch.long,
              device=cuda)).square().sum().backward()
        torch.cuda.synchronize()
        want = 3 if p is None else 6
        assert _build.launch_counts["attention_fwd"] == want
        assert _build.launch_counts["attention_bwd"] == 3
        grads[p] = torch.cat([q.grad.flatten() for q in model.parameters()])
    assert torch.equal(grads[None], grads[policy])


def test_a_cached_dit_call_launches_no_kernel(cuda):
    from fast_dit_torch.models import DiT
    model = DiT(input_size=8, hidden_size=384, depth=2, num_heads=6, dtype=torch.bfloat16,
                device=cuda).eval()
    x = torch.randn(4, 4, 8, 8, device=cuda)
    t, y = torch.full((4,), 10, device=cuda), torch.tensor([1, 2, 1000, 1000], device=cuda)
    _build.reset_launch_counts()
    with torch.inference_mode():
        _, cache = model.forward_with_cfg(x, t, y, 4.0, want_cache=True)
        assert _build.launch_counts["attention_fwd"] == 2
        out = model.forward_with_cfg(x, t - 1, y, 4.0, cache=cache)
    torch.cuda.synchronize()
    assert _build.launch_counts["attention_fwd"] == 2 and torch.isfinite(out).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_separate_qkv_attention_runs_the_kernels(cuda, dtype):
    """`dot_product_attention` over separate q, k, v of equal lengths (the
    NVS model's cross-attention at the fork's shape): q, k, v packed into
    one (B, S, 3D) tensor, kernel 1 forward and kernel 2 backward, against
    the plain version on the same inputs."""
    from fast_dit_torch.ops.attention import _attention_plain, dot_product_attention
    g = torch.Generator(device=cuda).manual_seed(4)
    leaves = [torch.randn(4, 256, 16 * 72, generator=g, device=cuda).to(dtype).requires_grad_()
              for _ in range(3)]
    dout = torch.randn(4, 256, 16 * 72, generator=g, device=cuda).to(dtype)
    before = dict(_build.launch_counts)
    out = dot_product_attention(*leaves, 16)
    grads = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert _build.launch_counts["attention_fwd"] == before["attention_fwd"] + 1
    assert _build.launch_counts["attention_bwd"] == before["attention_bwd"] + 1
    plain = [t.detach().float().requires_grad_() for t in leaves]
    want = _attention_plain(*plain, 16, 72 ** -0.5)
    want_grads = torch.autograd.grad(want, plain, dout.float())
    assert (out.float() - want).abs().max() <= TOL[dtype]
    for got, ref in zip(grads, want_grads):
        assert (got.float() - ref).abs().max() <= BWD_RTOL[dtype] * ref.abs().max()


def test_separate_qkv_attention_refuses_unequal_lengths_on_the_card(cuda):
    from fast_dit_torch.ops.attention import dot_product_attention
    q, kv = torch.randn(2, 256, 64, device=cuda), torch.randn(2, 16, 64, device=cuda)
    before = dict(_build.launch_counts)
    with pytest.raises(ValueError, match="Sq=256 and Sk=16.*'einsum'"):
        dot_product_attention(q, kv, kv, 4)
    out = dot_product_attention(q, kv, kv, 4, backend="einsum")  # the plain version, asked for
    assert out.shape == q.shape and torch.isfinite(out).all()
    assert dict(_build.launch_counts) == before


def test_ditnvs_on_the_card_matches_the_cpu(cuda):
    """A small fp32 DiTNVS, card against CPU (1e-4 x max): kernel 1 once a
    block and once a cross layer per forward."""
    from fast_dit_torch import sample as cli
    from fast_dit_torch.nvs import DiTNVS
    g = torch.Generator().manual_seed(6)
    x, f = torch.randn(4, 4, 16, 16, generator=g), torch.randn(4, 48, 8, 8, generator=g)
    t, y = torch.tensor([3, 300, 600, 999]), torch.tensor([1, 2, 10, 10])
    outs = {}
    for device in (cuda, torch.device("cpu")):
        model = DiTNVS(input_size=16, hidden_size=128, depth=3, num_heads=2, num_classes=10,
                       dino_dim=48, dino_patch_grid=8, cross_layers=(0, 2), device=device)
        cli.perturb_(model)
        _build.reset_launch_counts()
        with torch.no_grad():
            outs[device.type] = model.forward_with_cfg(x.to(device), t.to(device), f.to(device),
                                                       y.to(device), 4.0).cpu()
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert _build.launch_counts["attention_fwd"] == 3 + 2
    assert (outs["cuda"] - outs["cpu"]).abs().max() <= 1e-4 * outs["cpu"].abs().max()


# the ring hop: (B, Sq, Sk, H, hd); fp32 and bf16 relative to max |output|:
# fp32, sums in other orders; bf16, the kernels round p_u, do and du to bf16
# before their products where the plain version keeps them fp32
HOP_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
HOP_SHAPES = [
    (16, 256, 256, 16, 72),  # DiT-XL/2 512², 4 shards of 256 tokens, batch 4
    (2, 200, 136, 6, 64),    # ragged, Sq != Sk
    (1, 7, 70, 2, 128),      # Sq below one tile, the largest head dim
    (3, 65, 9, 4, 8),        # one query past a tile, the smallest head dim
    # odd n8 tile counts (5, 15) and hd padded by 8 to the bf16 k step
    (2, 130, 70, 3, 40),
    (2, 65, 136, 3, 120),
]


def _hop_inputs(cuda, B, Sq, Sk, H, hd, dtype, clamp=False, seed=3):
    """q, k, v, do, dl; with `clamp`, q and k are integers in [-8, 8], so
    some logits pass 50 while q k^T stays exact in fp32 in any order."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    if clamp:
        q = torch.randint(-8, 9, (B, Sq, H * hd), generator=g, device=cuda).float()
        k = torch.randint(-8, 9, (B, Sk, H * hd), generator=g, device=cuda).float()
    else:
        q = torch.randn(B, Sq, H * hd, generator=g, device=cuda)
        k = torch.randn(B, Sk, H * hd, generator=g, device=cuda)
    v = torch.randn(B, Sk, H * hd, generator=g, device=cuda)
    do = torch.randn(B, Sq, H * hd, generator=g, device=cuda)
    dl = torch.randn(B, Sq, H, generator=g, device=cuda)
    return q.to(dtype), k.to(dtype), v.to(dtype), do, dl


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.parametrize("clamp", [False, True], ids=["normal", "clamp"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,Sq,Sk,H,hd", HOP_SHAPES)
def test_ring_hop_kernels_match_plain(cuda, B, Sq, Sk, H, hd, dtype, clamp):
    q, k, v, do, dl = _hop_inputs(cuda, B, Sq, Sk, H, hd, dtype, clamp)
    scale = hd ** -0.5
    before = dict(_build.launch_counts)
    o, l = _launch_hop_fwd(q, k, v, scale, H)
    dq, dk, dv = _launch_hop_bwd(q, k, v, do, dl, scale, H)
    torch.cuda.synchronize()
    assert _build.launch_counts["ring_hop_fwd"] == before["ring_hop_fwd"] + 1
    assert _build.launch_counts["ring_hop_bwd"] == before["ring_hop_bwd"] + 1
    want_o, want_l = _hop_forward_plain(q, k, v, scale, H)
    if clamp:
        assert want_l.max().item() > 5e21  # exp(50): some logits pass the clamp
    assert o.dtype == l.dtype == torch.float32 and l.shape == (B, Sq, H)
    assert _rel(o, want_o) <= HOP_RTOL[dtype] and _rel(l, want_l) <= HOP_RTOL[dtype]
    for got, want in zip((dq, dk, dv), _hop_backward_plain(q, k, v, do, dl, scale, H)):
        assert got.dtype == dtype and got.shape == want.shape
        assert torch.isfinite(got).all() and _rel(got, want) <= HOP_RTOL[dtype]


def test_bf16_ring_hop_kernels_match_plain_at_a_4096_token_shard(cuda):
    """DiT-XL/2 at 1024² over a 4-card ring: 16 key tiles per block."""
    B, Sq, Sk, H, hd = 8, 1024, 1024, 16, 72
    q, k, v, do, dl = _hop_inputs(cuda, B, Sq, Sk, H, hd, torch.bfloat16, seed=6)
    scale = hd ** -0.5
    got = _launch_hop_fwd(q, k, v, scale, H) + _launch_hop_bwd(q, k, v, do, dl, scale, H)
    torch.cuda.synchronize()
    want = _hop_forward_plain(q, k, v, scale, H) + _hop_backward_plain(q, k, v, do, dl, scale, H)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all() and _rel(a, b) <= HOP_RTOL[torch.bfloat16]


def _fp32_core_hops(q, k, v, do, dl, scale, H):
    """(forward, backward) launches of the hop kernels' fp32-core bodies on
    bf16 inputs: dtype code 2, which no wrapper passes."""
    B, Sq, D = q.shape
    strides = [s for t in (q, k, v) for s in (t.stride(0), t.stride(1))]
    shape = (B, Sq, k.shape[1], H, D // H, scale, 2, torch.cuda.current_stream().cuda_stream)
    o, l = torch.empty(B, Sq, D, device=q.device), torch.empty(B, Sq, H, device=q.device)
    grads = [torch.empty_like(t) for t in (q, k, v)]
    fwd = _build.function("ring_hop_fwd", "fdt_ring_hop_fwd", _FWD_ARGS)
    bwd = _build.function("ring_hop_bwd", "fdt_ring_hop_bwd", _BWD_ARGS)
    ptrs = [t.data_ptr() for t in (q, k, v)]
    return (lambda: fwd(*ptrs, o.data_ptr(), l.data_ptr(), *strides, *shape),
            lambda: bwd(*ptrs, do.data_ptr(), dl.data_ptr(), *(t.data_ptr() for t in grads),
                        *strides, *shape))


def _device_ms(fn, iters=20):
    """Mean device time per call; the timed calls queue behind a spin of the
    device (about 20 ms, far longer than the host takes to issue them), so
    the wrapper's host time does not show."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1 << 25)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def test_bf16_hop_kernels_beat_their_fp32_core_bodies(cuda):
    """The tensor-core bodies run the bf16 hops (a loose bound, 2x, against
    the 4.5-5.3x measured on an H100, so that the path taken is checked and
    not the noise)."""
    B, Sq, Sk, H, hd = 16, 256, 256, 16, 72
    q, k, v, do, dl = _hop_inputs(cuda, B, Sq, Sk, H, hd, torch.bfloat16, seed=7)
    scale = hd ** -0.5
    old_fwd, old_bwd = _fp32_core_hops(q, k, v, do, dl, scale, H)
    assert old_fwd() == 0 and old_bwd() == 0
    fwd_ms = _device_ms(lambda: _launch_hop_fwd(q, k, v, scale, H))
    bwd_ms = _device_ms(lambda: _launch_hop_bwd(q, k, v, do, dl, scale, H))
    assert 2 * fwd_ms <= _device_ms(old_fwd)
    assert 2 * bwd_ms <= _device_ms(old_bwd)


def test_ring_hop_kernels_read_packed_columns_in_place(cuda):
    """q, k and v as column views of one packed (B, S, 3D) tensor (row stride
    3D) give what contiguous copies give."""
    B, S, H, hd = 4, 96, 4, 72
    D = H * hd
    g = torch.Generator(device=cuda).manual_seed(4)
    qkv = torch.randn(B, S, 3 * D, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = (qkv[..., i * D:(i + 1) * D] for i in range(3))
    do = torch.randn(B, S, D, generator=g, device=cuda)
    dl = torch.randn(B, S, H, generator=g, device=cuda)
    views = _launch_hop_fwd(q, k, v, 0.1, H) + _launch_hop_bwd(q, k, v, do, dl, 0.1, H)
    copies = [t.contiguous() for t in (q, k, v)]
    dense = _launch_hop_fwd(*copies, 0.1, H) + _launch_hop_bwd(*copies, do, dl, 0.1, H)
    for a, b in zip(views, dense):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [2, 4])
def test_bf16_ring_launches_the_hop_kernels(cuda, n):
    """The bf16 ring on the card: n hop launches forward and n backward, and
    the result matches the CPU ring (the plain hops)."""
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(2, 128, 4, 64, generator=g).to(torch.bfloat16) for _ in range(3))
    ring = LocalRing(n)
    outs, grads = [], []
    for device in ("cuda", "cpu"):
        ts = [t.to(device).requires_grad_() for t in (q, k, v)]
        before = dict(_build.launch_counts)
        out = ring.unshard(ring_attention(*(ring.shard(t) for t in ts), ring))
        out.float().square().sum().backward()
        if device == "cuda":
            torch.cuda.synchronize()
            assert _build.launch_counts["ring_hop_fwd"] == before["ring_hop_fwd"] + n
            assert _build.launch_counts["ring_hop_bwd"] == before["ring_hop_bwd"] + n
        outs.append(out.float().cpu())
        grads.append([t.grad.float().cpu() for t in ts])
    assert _rel(outs[0], outs[1]) <= 2e-2
    for a, b in zip(*grads):
        assert _rel(a, b) <= 5e-2


def test_a_refused_hop_launch_raises(cuda):
    # hd 12 is not a multiple of 8: the wrapper's check is bypassed here, so
    # the C entry point refuses it and the error must surface
    q = torch.zeros(1, 4, 2 * 12, device=cuda)
    fn = _build.function("ring_hop_fwd", "fdt_ring_hop_fwd", _FWD_ARGS)
    with pytest.raises(RuntimeError, match="ring_hop_fwd launch: CUDA error"):
        code = fn(q.data_ptr(), q.data_ptr(), q.data_ptr(), q.data_ptr(), q.data_ptr(),
                  96, 24, 96, 24, 96, 24, 1, 4, 4, 2, 12, 0.5, 0,
                  torch.cuda.current_stream().cuda_stream)
        _build.check_status("ring_hop_fwd", code, "ring_hop_fwd launch")


def test_a_refused_launch_raises(cuda):
    # hd 12 is not a multiple of 8: the wrapper's own check is bypassed here,
    # so the C entry point refuses it and the error must surface
    qkv = torch.zeros(1, 4, 3 * 2 * 12, device=cuda)
    with pytest.raises(RuntimeError, match="attention_fwd launch: CUDA error"):
        _launch_fwd(qkv, 2, 12, 0.5)


def test_a_failed_build_raises(cuda, tmp_path, monkeypatch):
    (tmp_path / "broken.cu").write_text("this is not CUDA C++\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setitem(_build.SOURCES, "broken", "broken.cu")
    with pytest.raises(RuntimeError, match="nvcc failed for broken.cu"):
        _build.load("broken")
    assert "broken" not in _build._libs


# ---------------------------------------------------------------------------
# the SD-VAE and the decoded samplers (no kernel of their own: convolutions,
# GroupNorm and the mid-block attention are stock torch ops; the samplers'
# DiT launches the attention forward)
# ---------------------------------------------------------------------------

VAE_RTOL = 5e-4  # card vs CPU, fp32, TF32 off, relative to max |out|


def _vae_bin(tmp_path, channels):
    import chip_smoke

    return chip_smoke.write_random_vae(str(tmp_path / "vae.bin"), channels)


def _tf32_flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("channels,size", [((32, 64), 32), ((128, 256, 512, 512), 64)],
                         ids=["small", "full"])
def test_vae_card_matches_cpu(cuda, tmp_path, channels, size):
    from fast_dit_torch.ckpt import load_vae
    from fast_dit_torch.utils.device import tf32

    path = _vae_bin(tmp_path, channels)
    g = torch.Generator().manual_seed(0)
    f = 2 ** (len(channels) - 1)
    x = torch.rand(2, 3, size, size, generator=g) * 2 - 1
    z = torch.randn(2, 4, size // f, size // f, generator=g)
    card, cpu = load_vae(path, channels, device=cuda), load_vae(path, channels, device="cpu")
    before = _tf32_flags()
    with torch.inference_mode(), tf32(False):
        assert _tf32_flags() == (False, False)
        for method, inp in (("encode_moments", x), ("decode", z)):
            got = getattr(card, method)(inp.to(cuda)).cpu()
            want = getattr(cpu, method)(inp)
            assert got.shape == want.shape and torch.isfinite(got).all()
            assert (got - want).abs().max() <= VAE_RTOL * want.abs().max()
    assert _tf32_flags() == before


def test_decoded_sampler_on_the_card(cuda, tmp_path, monkeypatch):
    """`python -m fast_dit_torch.sample` with a VAE on a small model: one
    forward launch per block per step, the card's decode of the latents
    agrees with the CPU's, and the CLI writes the grid."""
    from fast_dit_torch import sample as cli
    from fast_dit_torch.utils.image import decode_png

    path = _vae_bin(tmp_path, (32, 64))
    flags = ["--ckpt", "random", "--model", "DiT-S/2", "--num-sampling-steps", "4",
             "--vae-ckpt", path]
    args = cli.parse_args(flags)
    model, diffusion = cli.build(args)
    _build.reset_launch_counts()
    latents = cli.sample_latents(args, model, diffusion)
    torch.cuda.synchronize()
    assert _build.launch_counts["attention_fwd"] == model.depth * 4
    got = cli.decode(cli.build_vae(args, cuda), latents).cpu()
    cpu = torch.device("cpu")
    want = cli.decode(cli.build_vae(cli.parse_args(flags + ["--device", "cpu"]), cpu),
                      latents.cpu())
    assert got.shape == (8, 3, 64, 64) and torch.isfinite(got).all()
    assert (got - want).abs().max() <= VAE_RTOL * want.abs().max()
    monkeypatch.chdir(tmp_path)
    cli.main(args)
    grid = decode_png((tmp_path / "sample.png").read_bytes())
    assert grid.shape == (2 * 66 + 2, 4 * 66 + 2, 3)


def test_sample_ddp_on_the_card(cuda, tmp_path):
    """The FID harness on a small model: launches exact, the npz equals the
    PNGs, and the TF32 flags are restored after `--tf32`."""
    from fast_dit_torch import sample_ddp
    from fast_dit_torch.utils.image import decode_png

    path = _vae_bin(tmp_path, (32, 64))
    args = sample_ddp.build_parser().parse_args([
        "--ckpt", "random", "--model", "DiT-S/2", "--num-sampling-steps", "3",
        "--vae-ckpt", path, "--vae-channels", "32,64", "--per-proc-batch-size", "4",
        "--num-fid-samples", "6", "--sample-dir", str(tmp_path / "samples")])
    before = _tf32_flags()
    _build.reset_launch_counts()
    res = sample_ddp.main(args)
    assert _build.launch_counts["attention_fwd"] == 12 * 3 * 2  # depth x steps x batches
    assert _tf32_flags() == before
    arr = np.load(res["npz"])["arr_0"]
    assert arr.shape == (6, 64, 64, 3) and arr.dtype == np.uint8 and arr.std() > 0
    for i in range(6):
        with open(f"{res['sample_dir']}/{i:06d}.png", "rb") as f:
            assert np.array_equal(decode_png(f.read()), arr[i])


# token merging at 256² runs kernel 1 at S = 256 - r: 180 at ratio 0.3, 128 at 0.5
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("S", [180, 128])
def test_attention_kernel_at_the_tome_lengths(cuda, S, dtype):
    qkv = _qkv(cuda, 16, S, 16, 72, dtype, False, seed=11)
    out = flash_attention_qkv_flat(qkv, 16)
    ref = _attention_qkv_plain(qkv, 16, 72 ** -0.5)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


# ---------------------------------------------------------------------------
# kernel 6: the clamped attention forward of the TPU's head-dim layout
# experiment (benchmarks/attn_layout_bench.py)
# ---------------------------------------------------------------------------

# chip_smoke.py's attn_layout cases (the TPU bench's shape, a ragged S, hd 128,
# large logits), then small shapes at the edges of a tile and of the head dims;
# for the bf16 body's ring of stages and boxes: an S that wraps the ring many
# times, an S of exactly one key tile (one box of 16 columns), and hd 120
# (boxes of 64 + 64, the second cut at 56 columns) at a ragged S
LAYOUT_CASES = [(16, 256, 16, 72, False), (16, 180, 16, 72, False), (16, 256, 16, 128, False),
                (16, 256, 16, 72, True), (1, 7, 2, 128, False), (3, 65, 4, 8, False),
                (2, 130, 3, 40, False), (2, 200, 6, 64, True), (2, 1000, 2, 72, False),
                (1, 64, 1, 16, False), (1, 129, 3, 120, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,S,H,hd,large", LAYOUT_CASES)
def test_transposed_kernel_matches_plain(cuda, B, S, H, hd, large, dtype):
    qkv = _qkv(cuda, B, S, H, hd, dtype, large, seed=12)
    scale = hd ** -0.5
    before = dict(_build.launch_counts)
    out = transposed_forward(qkv, scale, H)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {
        **before, "attention_transposed": before["attention_transposed"] + 1}
    assert out.dtype == dtype and out.shape == (B, S, H * hd) and torch.isfinite(out).all()
    ref = _transposed_forward_plain(qkv, scale, H)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    if large:  # the kernel follows the clamp, where kernel 1 is exact softmax
        exact = flash_attention_qkv_flat(qkv, H)
        assert (out.float() - exact.float()).abs().max().item() > TOL[dtype]


def test_transposed_kernel_reads_the_packed_qkv_in_place(cuda):
    """The wrapper allocates the output and nothing else: q, k and v are read
    as column views of the packed tensor (row stride 3D), never copied out."""
    B, S, H, hd = 4, 96, 4, 72
    qkv = _qkv(cuda, B, S, H, hd, torch.bfloat16, False, seed=13)
    transposed_forward(qkv, 0.1, H)  # built and loaded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    before = torch.cuda.memory_allocated(cuda)
    out = transposed_forward(qkv, 0.1, H)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(cuda) - before == out.numel() * out.element_size()
    assert torch.equal(out, transposed_forward(qkv.clone(), 0.1, H))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_a_misaligned_qkv_is_refused(cuda, dtype):
    # TMA takes 16-byte aligned tensors only: a view one element into its
    # storage must raise, not launch
    B, S, H, hd = 1, 8, 2, 16
    qkv = torch.zeros(1 + B * S * 3 * H * hd, dtype=dtype, device=cuda)[1:].view(B, S, -1)
    assert qkv.is_contiguous() and qkv.data_ptr() % 16
    before = dict(_build.launch_counts)
    with pytest.raises(ValueError, match="16-byte aligned"):
        transposed_forward(qkv, 0.25, H)
    assert dict(_build.launch_counts) == before


def test_a_refused_transposed_launch_raises(cuda):
    # hd 12 is not a multiple of 8: the wrapper's check is bypassed here, so
    # the C entry point refuses it and the error must surface
    qkv = torch.zeros(1, 4, 3 * 2 * 12, device=cuda)
    with pytest.raises(RuntimeError, match="attention_transposed launch: CUDA error"):
        _launch_transposed(qkv, 0.5, 2, 12)


def _small_chain(device, options, cached):
    """A small fp32 DiT with `options`, DDPM 6 steps at CFG 4.0 (cached:
    the layer cache at interval 2), from seeded weights and noise."""
    from fast_dit_torch import sample as cli
    from fast_dit_torch.diffusion import create_diffusion
    from fast_dit_torch.models import DiT_models

    name = "DiT-MoE-S/2-8E2A" if options.pop("moe", False) else "DiT-S/2"
    model = DiT_models[name](input_size=8, depth=2, device=device, seed=0, **options)
    cli.perturb_(model)
    g = torch.Generator().manual_seed(3)
    noise = torch.randn(2, 4, 8, 8, generator=g)
    noise = torch.cat([noise, noise]).to(device)
    step_noise = torch.randn(6, 4, 4, 8, 8, generator=g).to(device)
    y = torch.tensor([1, 7, 1000, 1000], device=device)
    d = create_diffusion("6", device=device)
    cfg = lambda x, t, **kw: model.forward_with_cfg(x, t, y, 4.0, **kw)
    kw = dict(noise=noise, step_noise=step_noise, clip_denoised=False)
    _build.reset_launch_counts()
    with torch.inference_mode():
        if cached:
            out = d.p_sample_loop_cached(lambda x, t: cfg(x, t, want_cache=True),
                                         lambda x, t, c: cfg(x, t, cache=c), noise.shape,
                                         interval=2, **kw)
        else:
            out = d.p_sample_loop(cfg, noise.shape, **kw)
    return out.cpu(), dict(_build.launch_counts)


@pytest.mark.parametrize("options,cached,rtol", [
    ({"tome_ratio": 0.5}, False, 1e-4), ({"tome_ratio": 0.3, "tome_mlp": True}, False, 1e-4),
    ({"tome_ratio": 0.5}, True, 1e-4), ({"moe": True}, False, 1e-4),
    # a one-ulp difference before a quantiser can move an int8 code by one
    # step (ROADMAP.md, tolerances)
    ({"quant": "w8a8"}, False, 1e-2), ({"quant": "w8a8"}, True, 1e-2)],
    ids=["tome-0.5", "tome-0.3-mlp", "tome-0.5-cache2", "moe", "w8a8", "w8a8-cache2"])
def test_option_chains_card_vs_cpu(cuda, options, cached, rtol):
    """Each new option's chain on the card (kernel 1) and on the CPU: the
    final latents within `rtol` of max; kernel 1 launched depth x refresh
    steps (6 steps; 3 refreshes at interval 2)."""
    got, launches = _small_chain(cuda, dict(options), cached)
    want, _ = _small_chain(torch.device("cpu"), dict(options), cached)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= rtol * want.abs().max().item()
    assert launches["attention_fwd"] == 2 * (3 if cached else 6)


def test_int8_gemm_on_the_card_is_exact(cuda):
    """`int8_mm` (cuBLAS through `torch._int_mm`) at DiT-XL/2's four
    projection shapes, and at 5 rows (padded to 17): the int32 products of
    an integer matmul on the CPU."""
    from fast_dit_torch.ops.quant import int8_mm

    g = torch.Generator().manual_seed(4)
    for M, K, N in ((4096, 1152, 3456), (4096, 1152, 1152), (4096, 1152, 4608),
                    (4096, 4608, 1152), (5, 64, 24)):
        a = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
        b = torch.randint(-127, 128, (N, K), generator=g, dtype=torch.int8)
        got = int8_mm(a.to(cuda), b.to(cuda).t())
        assert got.dtype == torch.int32 and torch.equal(got.cpu(), a.long().mm(b.long().t()).int())
    with pytest.raises(ValueError, match="multiples of 8"):
        int8_mm(torch.zeros(32, 12, dtype=torch.int8, device=cuda),
                torch.zeros(12, 8, dtype=torch.int8, device=cuda))


def test_moe_train_steps_card_vs_cpu(cuda):
    """Two steps of a small fp32 MoE DiT (remat) on the card and the CPU:
    losses within 1e-5 relative, gradients within 1e-4 of their largest,
    the same kept (choice, token) masks in every forward; kernel 1 twice and
    kernel 2 once a block a step."""
    from fast_dit_torch import sample as cli
    from fast_dit_torch.diffusion import create_diffusion
    from fast_dit_torch.models import DiT_models
    from fast_dit_torch.train import create_train_state, make_train_step

    g = torch.Generator().manual_seed(5)
    x, y = torch.randn(4, 4, 8, 8, generator=g), torch.tensor([1, 7, 3, 999])
    draws = [{"t": torch.randint(0, 1000, (4,), generator=g),
              "noise": torch.randn(4, 4, 8, 8, generator=g)} for _ in range(2)]
    res = {}
    for device in (cuda, torch.device("cpu")):
        model = DiT_models["DiT-MoE-S/2-8E2A"](input_size=8, depth=2, remat=True,
                                               class_dropout_prob=0.0, device=device, seed=0)
        cli.perturb_(model)
        masks = []

        def keep(m, inp, out):
            with torch.no_grad():
                masks.append(m.route(inp[0]).keep.cpu())
        for b in model.blocks:
            b.mlp.register_forward_hook(keep)
        state = create_train_state(model, lr=1e-4)
        step = make_train_step(model, create_diffusion("", device=device).schedule, lr=1e-4)
        batch = {"x": x.to(device), "y": y.to(device)}
        _build.reset_launch_counts()
        losses = [step(state, batch, draws=[{k: v.to(device) for k, v in d.items()}])["loss"]
                  .item() for d in draws]
        res[device.type] = (losses, torch.cat([p.grad.flatten() for p in model.parameters()])
                            .cpu(), masks, dict(_build.launch_counts))
    (cl, cg, cm, launches), (pl, pg, pm, _) = res["cuda"], res["cpu"]
    assert all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(cl, pl))
    assert (cg - pg).abs().max() <= 1e-4 * pg.abs().max()
    assert len(cm) == len(pm) == 8 and all(torch.equal(a, b) for a, b in zip(cm, pm))
    assert launches["attention_fwd"] == 2 * 2 * 2 and launches["attention_bwd"] == 2 * 2


def _pipeline_model(device, dtype=torch.float32):
    from fast_dit_torch import sample as cli
    from fast_dit_torch.models import DiT_models
    model = DiT_models["DiT-S/2"](input_size=16, depth=4, dtype=dtype, device=device, seed=0)
    cli.perturb_(model)
    return model


@pytest.mark.parametrize("n_stages,microbatches", [(2, 2), (4, 4)])
def test_pipeline_on_the_card_matches_the_cpu(cuda, n_stages, microbatches):
    """LocalStages on the card (kernels 1 and 2) against the CPU (their
    plain versions), fp32 DiT-S/2 at depth 4: the output within 1e-4 of its
    largest, every gradient within 1e-4 of the largest of its leaf; kernel 1
    launched depth x M times by the forward and kernel 2 depth x M times by
    the backward, one per block and microbatch (no bubble computes)."""
    from fast_dit_torch.parallel import LocalStages, dit_pipeline_forward
    g = torch.Generator().manual_seed(6)
    x, t = torch.randn(8, 4, 16, 16, generator=g), torch.tensor([1, 50, 500, 999] * 2)
    y = torch.tensor([1, 7, 1000, 3] * 2)
    res = {}
    for device in (cuda, torch.device("cpu")):
        model = _pipeline_model(device)
        _build.reset_launch_counts()
        out = dit_pipeline_forward(model, x.to(device), t.to(device), y.to(device),
                                   LocalStages(n_stages), microbatches)
        fwd = dict(_build.launch_counts)
        out.square().sum().backward()
        res[device.type] = (out.detach().cpu(), {n: p.grad.cpu() for n, p in
                                                 model.named_parameters()},
                            fwd, dict(_build.launch_counts))
    (out, grads, fwd, both), (want, want_grads, _, _) = res["cuda"], res["cpu"]
    assert (out - want).abs().max() <= 1e-4 * want.abs().max()
    for name, gr in grads.items():
        assert (gr - want_grads[name]).abs().max() <= 1e-4 * want_grads[name].abs().max(), name
    assert fwd["attention_fwd"] == 4 * microbatches and fwd["attention_bwd"] == 0
    assert both["attention_fwd"] == 4 * microbatches
    assert both["attention_bwd"] == 4 * microbatches


def test_pipefusion_chain_on_the_card_matches_the_cpu(cuda):
    """A chunked PipeFusion chain with CFG (DDIM 4, 4 chunks, warmup 1,
    LocalStages(2)) on the card, under sync debug mode "error" (no host sync
    in a step), against the CPU within 1e-4 of max; the chunk attention is
    stock SDPA, so kernel 1 is never launched."""
    from fast_dit_torch.diffusion import create_diffusion
    from fast_dit_torch.parallel import LocalStages, pipefusion_sample_loop
    z = torch.randn(2, 4, 16, 16, generator=torch.Generator().manual_seed(7))
    outs = []
    for device in (cuda, torch.device("cpu")):
        model = _pipeline_model(device).eval()
        sched = create_diffusion("ddim4", device=device).schedule
        y, zd = torch.tensor([1, 7], device=device), z.to(device)
        _build.reset_launch_counts()
        on_card = device.type == "cuda"
        if on_card:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = pipefusion_sample_loop(model, z.shape, sched, y, LocalStages(2), 4, warmup=1,
                                         noise=zd, cfg_scale=4.0)
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode(0)
        outs.append(out.cpu())
        assert _build.launch_counts["attention_fwd"] == 0
    assert torch.isfinite(outs[0]).all()
    assert (outs[0] - outs[1]).abs().max() <= 1e-4 * outs[1].abs().max()
