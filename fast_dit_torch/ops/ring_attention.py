"""Ring attention: exact self-attention over a sequence-sharded token axis.

Counterpart of `fast_dit_tpu/ops/ring_attention.py`. Every shard holds a
contiguous block of one sample's tokens; the ring runs n steps, each one
attending the local queries to the resident key/value block and then passing
that block to the next shard (`ring.rotate`), so after n steps every query
has seen every key. The ring object (`parallel/sequence.py`) owns the
rotation: `LocalRing` rolls n shards held on one device, `ProcessGroupRing`
sends to the next rank of a `torch.distributed` group.

Two paths, chosen by dtype as the JAX `ring_attention` chooses (:371-377):

- **bf16: the hop kernels.** Logits are clamped, p_u = exp(min(s, 50)), so
  one hop's partials are unnormalised and add across hops with no running
  max: each hop returns o_u = p_u v and the row sums l, both fp32, the ring
  adds them in hop order, and the output is o / max(l, 1e-30). The hop is
  `_RingHopFn`, the counterpart of `_ring_hop`'s custom VJP (:234-252): its
  forward is the CUDA kernel `csrc/ring_hop_fwd.cu` (TPU `_hop_fwd_kernel`,
  :77), its backward `csrc/ring_hop_bwd.cu` (TPU `_hop_bwd_kernel`, :111),
  and its residuals are the q, k and v shards only. On a CPU tensor the two
  plain versions, `_hop_forward_plain` and `_hop_backward_plain`, take their
  place; on a CUDA tensor the kernels launch or the wrapper raises.
- **fp32 (and any other dtype): the streaming online softmax** of
  `_ring_xla` (:329-355), exact for any logit size, in plain torch and
  differentiated by autograd, as the JAX package leaves it to XLA.

What is not carried over: the TPU's `H*hd % 128 == 0` lane rule and its
`Sq <= 4096` VMEM bound (`_HOP_MAX_SEQ`, :69) describe the TPU; the kernels
take hd any multiple of 8 up to 128 and any Sq and Sk. The v5e crossover to
the XLA hop forward below 2048-token shards (`_HOP_PALLAS_FWD_MIN_SEQ`,
:289-306) is not carried over either: every bf16 hop forward on the card
goes through the kernel. The kernels' bf16 bodies run on the tensor cores
and round p_u, do and du to bf16 before their products, as the TPU kernels
do (`pc`, `doc`, `duc`, :99-102, :143-148), with l summed from the rounded
p_u; the plain versions (and the kernels' fp32 bodies) keep them fp32, a
documented deviation of the plain versions (`ROADMAP.md` §3).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import _DTYPE_CODES, _I, _P, MAX_HEAD_DIM, _split_heads

__all__ = ["ring_attention", "ring_attention_qkv"]

_CLAMP = 50.0
# finite stand-in for -inf in the streaming path (JAX `_NEG`, :64)
_NEG = -1e30
_L = ctypes.c_longlong
# q, k, v, o, l; q's (batch, row) strides, k's, v's; B, Sq, Sk, H, hd, scale, dtype, stream
_FWD_ARGS = [_P, _P, _P, _P, _P, _L, _L, _L, _L, _L, _L,
             _I, _I, _I, _I, _I, ctypes.c_float, _I, _P]
# q, k, v, do, dl, dq, dk, dv; strides as above; B, Sq, Sk, H, hd, scale, dtype, stream
_BWD_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _L, _L, _L, _L,
             _I, _I, _I, _I, _I, ctypes.c_float, _I, _P]


def _hop_forward_plain(q, kb, vb, scale: float, num_heads: int):
    """One hop's unnormalised partials in plain torch, fp32 throughout:
    o_u = exp(min(q k^T * scale, 50)) v, fp32 (B, Sq, D), and its row sums
    l, fp32 (B, Sq, H). The formulas of `_hop_fwd_kernel` (:95-102) with p_u
    kept in fp32. q is (B, Sq, D), kb and vb (B, Sk, D), D = H * hd."""
    B, Sq, D = q.shape
    qh, kh, vh = (_split_heads(t, num_heads, 1)[0] for t in (q, kb, vb))
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    p_u = torch.exp(torch.clamp(s, max=_CLAMP))
    o = torch.einsum("bhqk,bkhd->bqhd", p_u, vh).reshape(B, Sq, D)
    return o, p_u.sum(dim=-1).transpose(1, 2).contiguous()


def _hop_backward_plain(q, kb, vb, do, dl, scale: float, num_heads: int):
    """dq (B, Sq, D), dk and dv (B, Sk, D) of one hop, in the inputs' dtype,
    from the cotangents do (B, Sq, D) and dl (B, Sq, H) of (o_u, l); fp32
    throughout. With u = q k^T, s = u * scale, p_u = exp(min(s, 50)) (the
    formulas of `_hop_bwd_kernel`, :118-151):
        dv = p_u^T do,  dp = do v^T + dl,  du = p_u [s < 50] dp scale,
        dq = du k,  dk = du^T q."""
    B, Sq, D = q.shape
    Sk = kb.shape[1]
    qh, kh, vh, doh = (_split_heads(t, num_heads, 1)[0] for t in (q, kb, vb, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    p_u = torch.exp(torch.clamp(s, max=_CLAMP))
    dv = torch.einsum("bhqk,bqhd->bkhd", p_u, doh)
    dp = torch.einsum("bqhd,bkhd->bhqk", doh, vh) + dl.float().transpose(1, 2)[..., None]
    du = torch.where(s < _CLAMP, p_u * dp, 0.0) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", du, kh)
    dk = torch.einsum("bhqk,bqhd->bkhd", du, qh)
    return (dq.reshape(B, Sq, D).to(q.dtype), dk.reshape(B, Sk, D).to(kb.dtype),
            dv.reshape(B, Sk, D).to(vb.dtype))


def _check_flat(t: torch.Tensor, what: str, elem: int) -> tuple:
    """(batch stride, row stride) of a (B, S, D) CUDA tensor the kernels can
    read: unit column stride, 16-byte aligned start and strides."""
    if t.device.type != "cuda":
        raise ValueError(f"ring hop kernel runs on CUDA tensors, got {what} on {t.device}")
    if t.stride(2) != 1:
        raise ValueError(f"ring hop kernel takes {what} with unit column stride")
    sb, sr = t.stride(0), t.stride(1)
    if t.data_ptr() % 16 or (sb * elem) % 16 or (sr * elem) % 16:
        raise ValueError(f"ring hop kernel takes 16-byte aligned {what} rows")
    return sb, sr


def _check_hop(q, kb, vb, num_heads: int) -> int:
    """Raise unless the hop kernels take (q, kb, vb); return hd."""
    if q.dtype not in _DTYPE_CODES or kb.dtype != q.dtype or vb.dtype != q.dtype:
        raise ValueError(f"ring hop kernel takes float32 or bfloat16 q, k, v of one dtype, "
                         f"got {q.dtype}, {kb.dtype}, {vb.dtype}")
    if q.dim() != 3 or kb.dim() != 3 or kb.shape != vb.shape:
        raise ValueError(f"expected q (B, Sq, D) and k, v (B, Sk, D), got "
                         f"{tuple(q.shape)}, {tuple(kb.shape)}, {tuple(vb.shape)}")
    B, Sq, D = q.shape
    if kb.shape[0] != B or kb.shape[2] != D or num_heads < 1 or D % num_heads:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(kb.shape)} do not share B and "
                         f"D = num_heads({num_heads}) * hd")
    hd = D // num_heads
    if hd % 8 or hd > MAX_HEAD_DIM:
        raise ValueError(f"ring hop kernel takes hd a multiple of 8 up to {MAX_HEAD_DIM}, "
                         f"got {hd}")
    Sk = kb.shape[1]
    if min(B, Sq, Sk) < 1 or B > 65535 or num_heads > 65535:
        raise ValueError(f"ring hop kernel takes 1 <= B, H <= 65535 and Sq, Sk >= 1, "
                         f"got B={B}, Sq={Sq}, Sk={Sk}, H={num_heads}")
    return hd


def _launch_hop_fwd(q, kb, vb, scale: float, num_heads: int):
    """Kernel 4: (o_u fp32 (B, Sq, D), l fp32 (B, Sq, H)); bf16 on the
    tensor cores, fp32 on the fp32 cores."""
    hd = _check_hop(q, kb, vb, num_heads)
    elem = q.element_size()
    strides = [s for t, w in ((q, "q"), (kb, "k"), (vb, "v")) for s in _check_flat(t, w, elem)]
    B, Sq, D = q.shape
    fn = _build.function("ring_hop_fwd", "fdt_ring_hop_fwd", _FWD_ARGS)
    o = torch.empty((B, Sq, D), dtype=torch.float32, device=q.device)
    l = torch.empty((B, Sq, num_heads), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(q.data_ptr(), kb.data_ptr(), vb.data_ptr(), o.data_ptr(), l.data_ptr(),
                  *strides, B, Sq, kb.shape[1], num_heads, hd, scale,
                  _DTYPE_CODES[q.dtype], stream)
    _build.check_status("ring_hop_fwd", code, "ring_hop_fwd launch")
    _build.launch_counts["ring_hop_fwd"] += 1
    return o, l


def _launch_hop_bwd(q, kb, vb, do, dl, scale: float, num_heads: int):
    """Kernel 5: (dq, dk, dv) in the input dtype from fp32 do and dl; bf16
    on the tensor cores (do rounded to bf16 inside the kernel), fp32 on the
    fp32 cores."""
    hd = _check_hop(q, kb, vb, num_heads)
    B, Sq, D = q.shape
    Sk = kb.shape[1]
    if not (do.dtype == dl.dtype == torch.float32 and do.shape == (B, Sq, D)
            and dl.shape == (B, Sq, num_heads) and do.is_contiguous() and dl.is_contiguous()):
        raise ValueError("ring hop backward takes contiguous fp32 do (B, Sq, D) and "
                         "dl (B, Sq, H)")
    elem = q.element_size()
    strides = [s for t, w in ((q, "q"), (kb, "k"), (vb, "v")) for s in _check_flat(t, w, elem)]
    _check_flat(do, "do", 4)
    if dl.device != q.device:
        raise ValueError(f"ring hop backward takes dl on {q.device}, got {dl.device}")
    fn =_build.function("ring_hop_bwd", "fdt_ring_hop_bwd", _BWD_ARGS)
    dq = torch.empty((B, Sq, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, Sk, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(q.data_ptr(), kb.data_ptr(), vb.data_ptr(), do.data_ptr(), dl.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *strides,
                  B, Sq, Sk, num_heads, hd, scale, _DTYPE_CODES[q.dtype], stream)
    _build.check_status("ring_hop_bwd", code, "ring_hop_bwd launch")
    _build.launch_counts["ring_hop_bwd"] += 1
    return dq, dk, dv


class _RingHopFn(torch.autograd.Function):
    """One ring hop, (q, kb, vb) -> (o_u, l): kernel 4 forward, kernel 5
    backward on a CUDA tensor, the plain versions on a CPU tensor. The
    residuals are the q, k and v shards only; the hop softmax is rebuilt in
    the backward."""

    @staticmethod
    def forward(ctx, q, kb, vb, scale, num_heads):
        ctx.save_for_backward(q, kb, vb)
        ctx.args = (scale, num_heads)
        if q.device.type == "cpu":
            return _hop_forward_plain(q, kb, vb, scale, num_heads)
        return _launch_hop_fwd(q, kb, vb, scale, num_heads)

    @staticmethod
    def backward(ctx, do, dl):
        q, kb, vb = ctx.saved_tensors
        # the cotangents are fp32 whatever the input dtype, as `_ring_hop_bwd`
        # casts them (:245-249)
        do, dl = do.float().contiguous(), dl.float().contiguous()
        hop = _hop_backward_plain if q.device.type == "cpu" else _launch_hop_bwd
        return (*hop(q, kb, vb, do, dl, *ctx.args), None, None)


def _ring_hops(q, k, v, ring, scale: float):
    """bf16 ring over the hop kernels (`_ring_pallas`, :296-321). o and l
    start at zero in fp32 and add each hop's partials in hop order; k/v pass
    to the next shard after every hop, so at step s shard i holds the block
    of shard (i - s) mod n."""
    B, Sq, H, hd = q.shape
    D = H * hd
    qf, kb, vb = (t.reshape(B, t.shape[1], D) for t in (q, k, v))
    o = torch.zeros((B, Sq, D), dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Sq, H), dtype=torch.float32, device=q.device)
    for step in range(ring.size):
        ob, lb = _RingHopFn.apply(qf, kb, vb, scale, H)
        o = o + ob
        l = l + lb
        if step + 1 < ring.size:  # the last rotation would only bring k/v home
            kb, vb = ring.rotate(kb), ring.rotate(vb)
    out = o.reshape(B, Sq, H, hd) / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def _ring_stream(q, k, v, ring, scale: float):
    """fp32 streaming online softmax with a running (o, m, l) (`_ring_xla`,
    :329-355): exact for any logit size."""
    B, Sq, H, hd = q.shape
    qf = (q.float() * scale).transpose(1, 2)  # (B, H, Sq, hd)
    o = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Sq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    kb, vb = k, v
    for step in range(ring.size):
        kf = kb.float().transpose(1, 2)
        vf = vb.float().transpose(1, 2)
        logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vf)
        m = m_new
        if step + 1 < ring.size:
            kb, vb = ring.rotate(kb), ring.rotate(vb)
    return (o / l[..., None]).transpose(1, 2).to(q.dtype)


def ring_attention(q, k, v, ring, *, scale=None) -> torch.Tensor:
    """Exact attention over a token axis sharded around `ring`.

    q, k, v: (B, S_local, H, hd), the local shards of (B, n * S_local, H, hd)
    tensors whose shards sit in ring order (shard i holds tokens
    [i * S_local, (i + 1) * S_local)); under `LocalRing` the n shards of one
    device are stacked on the batch axis. Returns the local (B, S_local, H,
    hd) shard of the exact attention output, in q's dtype. bf16 takes the
    hop kernels (their plain versions on a CPU tensor), every other dtype the
    streaming path. `scale` defaults to hd ** -0.5.
    """
    hd = q.shape[-1]
    scale = float(hd ** -0.5 if scale is None else scale)
    if q.dtype == torch.bfloat16:
        return _ring_hops(q, k, v, ring, scale)
    return _ring_stream(q, k, v, ring, scale)


def ring_attention_qkv(qkv: torch.Tensor, num_heads: int, ring, *, scale=None) -> torch.Tensor:
    """Packed (B, S_local, 3*H*hd) qkv -> (B, S_local, H*hd) over `ring`.
    q, k and v are column views of the packed tensor (q at column 0, k at D,
    v at 2D, the (3, H, hd) order of the JAX projection): the kernels read
    them in place through their row stride."""
    B, S, threeD = qkv.shape
    hd = threeD // (3 * num_heads)
    q, k, v = qkv.view(B, S, 3, num_heads, hd).unbind(2)
    return ring_attention(q, k, v, ring, scale=scale).reshape(B, S, threeD // 3)
