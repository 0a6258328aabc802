"""DiT building blocks as `nn.Module`s (counterpart of
`fast_dit_tpu/models/layers.py`).

Module and parameter names are the reference torch names
(`fast_dit_tpu/ckpt/torch_import.py:97-121`), so a reference `.pt` state
dict loads with `load_state_dict(strict=True)`.

Every module carries a `dtype`, as flax's modules do: parameters stay fp32
and are cast to the compute dtype where they are used; LayerNorm statistics
stay fp32. `torch.autocast` is not used, since its casting rules differ.

The qkv projection is a plain `Linear(D, 3D)` whose output rows are in
(3, H, hd) order: it is already the packed (B, N, 3D) layout the attention
kernel reads, so there is no permute and no split copy.

Sequence parallelism (`DiT.forward(..., ring=)`, `parallel/sequence.py`)
runs the same blocks on token shards: `Attention`, `DiTBlock.forward` and `full_step` take the `ring` the
tokens are sharded around, and with one, attention takes the "ring" backend
(q, k and v read in place from the packed qkv, q at column 0, k at D, v at
2D). Every other op of a block is per token and runs on the shard as it is.

The block's options, as in JAX (`layers.py:155-208, 394-463`):
- `quant="w8a8"`: qkv, proj, fc1 and fc2 are `QuantLinear`s (int8 products,
  `ops/quant.py`); adaLN, the embedders and the final layer stay in the
  activation dtype, and the attention core is unchanged (kernel 1).
- `tome_r > 0`: token merging (`ops/tome.py`); one match from the block
  input, the attention branch (and the MLP branch with `tome_mlp`) on N - r
  tokens, its output unmerged to N.
- `moe_experts > 0`: the MLP is a routed `MoeMlp` (`models/moe.py`), whose
  aux values the block returns beside its output (`forward_aux`).

The parallel trainer (`parallel/mesh.py shard_params`) reads every
parameter through `collectives.full`, which gathers an FSDP shard where it
is used, and gives `Attention` and `Mlp` a `tp_group` under tensor
parallelism: each rank then holds H/m heads of qkv and the matching input
columns of proj, fc1's output rows and fc2's input columns, and Megatron's
pair of functions carries the collectives, `copy_to_group` at the input of
qkv and fc1 (its backward sums the input's gradient over the group) and
`reduce_from_group` after proj and fc2, whose bias is added once, after the
sum. Everything else is replicated.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import RING, attention_qkv, resolve_backend
from ..ops.quant import QUANT_MODES, int8_matmul, quantize_cols
from ..ops.tome import bipartite_soft_matching_2d
from ..parallel.collectives import copy_to_group, full, reduce_from_group
from .moe import MoeMlp

__all__ = [
    "modulate",
    "Linear",
    "QuantLinear",
    "PatchEmbed",
    "TimestepEmbedder",
    "LabelEmbedder",
    "Attention",
    "Mlp",
    "DiTBlock",
    "FinalLayer",
]


def modulate(x, shift, scale):
    """x * (1 + scale) + shift with (B, D) conditioners over (B, N, D) tokens."""
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def _layer_norm(x, dtype):
    """LayerNorm with no affine, eps 1e-6, fp32 statistics."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=1e-6).to(dtype)


class Linear(nn.Linear):
    """`nn.Linear` whose fp32 parameters are cast to `dtype` at use."""

    def __init__(self, in_features, out_features, bias=True, dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x, bias=True):
        dt = self.dtype
        b = None if self.bias is None or not bias else full(self.bias).to(dt)
        return F.linear(x.to(dt), full(self.weight).to(dt), b)


def _row_parallel(linear: Linear, x, group):
    """A row-parallel `linear`: the ranks' partial products summed over the
    group, then the bias, once."""
    y = reduce_from_group(linear(x, bias=False), group)
    return y + full(linear.bias).to(y.dtype)


class QuantLinear(Linear):
    """Int8 W8A8 `Linear` for inference (counterpart of `QuantDenseGeneral`):
    the same fp32 `weight` (out, in) and `bias`, so every state dict of the
    float model loads unchanged. The input rows are quantised at every call
    over the whole contraction axis, the weight per output channel; the
    weight's int8 copy is kept until the weight changes (JAX quantises it in
    the graph, and XLA hoists it out of the sampling loop)."""

    def __init__(self, in_features, out_features, bias=True, dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias, dtype=dtype)
        self._wq = None
        self._wq_key = None

    def quantized_weight(self):
        """quantize_cols of the (in, out) weight: int8 (in, out), a view of
        an (out, in) tensor, and the fp32 (1, out) scales."""
        w = self.weight
        key = (w.data_ptr(), w.device, w._version)
        if self._wq_key != key:
            with torch.no_grad():
                self._wq = quantize_cols(w.detach().t())
            self._wq_key = key
        return self._wq

    def forward(self, x):
        return int8_matmul(x, self.weight.t(), self.bias, out_dtype=self.dtype,
                           wq=self.quantized_weight())


class _ConvWeight(nn.Module):
    """Holds the reference conv's (D, C, p, p) weight and (D,) bias."""

    def __init__(self, hidden_size, in_channels, patch_size):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(hidden_size, in_channels, patch_size, patch_size))
        self.bias = nn.Parameter(torch.zeros(hidden_size))


class PatchEmbed(nn.Module):
    """Patchify NCHW input to (B, N, D) tokens: a reshape and one linear over
    patches flattened in (C, ph, pw) order, which is the reference's
    stride == kernel conv exactly (and no cuDNN TF32 convolution)."""

    def __init__(self, patch_size, in_channels, hidden_size, dtype=torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.proj = _ConvWeight(hidden_size, in_channels, patch_size)

    def forward(self, x):
        B, C, H, W = x.shape
        p = self.patch_size
        assert H % p == 0 and W % p == 0, f"input {H}x{W} not divisible by patch {p}"
        gh, gw = H // p, W // p
        x = x.reshape(B, C, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5)
        x = x.reshape(B, gh * gw, C * p * p)
        w = full(self.proj.weight)
        w = w.reshape(w.shape[0], -1)
        return F.linear(x.to(self.dtype), w.to(self.dtype), full(self.proj.bias).to(self.dtype))


class TimestepEmbedder(nn.Module):
    """Sinusoidal frequency embedding + MLP."""

    def __init__(self, hidden_size, frequency_embedding_size=256, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.frequency_embedding_size = frequency_embedding_size
        self.mlp = nn.Sequential(
            Linear(frequency_embedding_size, hidden_size, dtype=dtype),
            nn.SiLU(),
            Linear(hidden_size, hidden_size, dtype=dtype),
        )

    @staticmethod
    def timestep_embedding(t, dim, max_period=10000):
        """[cos | sin] embedding (cos first); frequencies
        exp(-log(P) * i / half), fp32."""
        half = dim // 2
        freqs = torch.exp(-math.log(max_period)
                          * torch.arange(half, dtype=torch.float32, device=t.device) / half)
        args = t.float()[:, None] * freqs[None]
        embedding = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        if dim % 2:
            embedding = torch.cat([embedding, torch.zeros_like(embedding[:, :1])], dim=-1)
        return embedding

    def forward(self, t):
        return self.mlp(self.timestep_embedding(t, self.frequency_embedding_size))


class LabelEmbedder(nn.Module):
    """Class-label embedding with CFG null-class dropout; the null class id
    is `num_classes` (`fast_dit_tpu/models/layers.py:123-152`).

    In training, each label is dropped with probability `dropout_prob`, the
    draw coming from the explicit `generator` (flax's "label_drop" rng has
    no torch counterpart); `force_drop_ids` (1 = drop) wins over the draw,
    in and out of training."""

    def __init__(self, num_classes, hidden_size, dropout_prob):
        super().__init__()
        self.num_classes = num_classes
        self.dropout_prob = dropout_prob
        self.embedding_table = nn.Embedding(num_classes + int(dropout_prob > 0), hidden_size)

    def token_drop(self, labels, generator=None, force_drop_ids=None):
        if force_drop_ids is None:
            u = torch.rand(labels.shape[0], generator=generator, device=labels.device)
            drop = u < self.dropout_prob
        else:
            drop = force_drop_ids == 1
        return torch.where(drop, self.num_classes, labels)

    def forward(self, labels, train=False, force_drop_ids=None, generator=None):
        if (train and self.dropout_prob > 0) or force_drop_ids is not None:
            labels = self.token_drop(labels, generator, force_drop_ids)
        return F.embedding(labels, full(self.embedding_table.weight))


class Attention(nn.Module):
    """Multi-head self-attention over the packed qkv projection."""

    def __init__(self, dim, num_heads, qkv_bias=True, dtype=torch.float32,
                 attn_backend="auto", quant=None):
        super().__init__()
        assert dim % num_heads == 0
        self.dtype = dtype
        self.num_heads = num_heads  # this rank's heads under tensor parallelism
        self.attn_backend = resolve_backend(attn_backend)
        self.tp_group = None
        linear = QuantLinear if quant else Linear
        self.qkv = linear(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.proj = linear(dim, dim, dtype=dtype)

    def forward(self, x, ring=None):
        """With `ring`, x is a token shard and attention runs around the ring
        (the "ring" backend) in place of the model's dense backend."""
        qkv = self.qkv(copy_to_group(x, self.tp_group))  # columns in (3, H, hd) order
        backend = RING if ring is not None else self.attn_backend
        out = attention_qkv(qkv, self.num_heads, backend=backend, ring=ring)
        if self.tp_group is None:
            return self.proj(out)
        return _row_parallel(self.proj, out, self.tp_group)


class Mlp(nn.Module):
    """Linear -> GELU(tanh) -> Linear."""

    def __init__(self, in_features, hidden_features, dtype=torch.float32, quant=None):
        super().__init__()
        self.dtype = dtype
        self.tp_group = None
        linear = QuantLinear if quant else Linear
        self.fc1 = linear(in_features, hidden_features, dtype=dtype)
        self.fc2 = linear(hidden_features, in_features, dtype=dtype)

    def forward(self, x):
        h = F.gelu(self.fc1(copy_to_group(x, self.tp_group)), approximate="tanh")
        return self.fc2(h) if self.tp_group is None else _row_parallel(self.fc2, h,
                                                                        self.tp_group)


class DiTBlock(nn.Module):
    """adaLN-Zero transformer block.

    `forward` is the standard block; `forward_aux` also returns the MoE
    router's aux values (None for a dense MLP); `full_step` also returns the
    attention and MLP branch outputs, and `cached_step` reuses them with
    fresh adaLN gates (the layer cache of the cached samplers).
    `remat_forward` runs the block under one of JAX's remat policies
    (`fast_dit_tpu/models/dit.py:133-146`), with the same operations in the
    same order as `full_step`, so its gradients equal the plain block's bit
    for bit; it returns (x, aux) too.
    """

    def __init__(self, hidden_size, num_heads, mlp_ratio=4.0, dtype=torch.float32,
                 attn_backend="auto", quant=None, tome_r=0, tome_mlp=False, moe_experts=0,
                 moe_top_k=2, moe_capacity=1.25):
        super().__init__()
        if quant is not None and quant not in QUANT_MODES:
            raise ValueError(f"quant={quant!r} not in {QUANT_MODES}")
        if quant and moe_experts > 0:
            raise ValueError("int8 quant + MoE is untested")  # JAX's refusal (layers.py:412)
        self.dtype = dtype
        self.tome_r = tome_r
        self.tome_mlp = tome_mlp
        self.moe = moe_experts > 0
        self.attn = Attention(hidden_size, num_heads, dtype=dtype, attn_backend=attn_backend,
                              quant=quant)
        hidden = int(hidden_size * mlp_ratio)
        self.mlp = (MoeMlp(hidden_size, moe_experts, hidden, top_k=moe_top_k,
                           capacity_factor=moe_capacity, dtype=dtype) if self.moe
                    else Mlp(hidden_size, hidden, dtype=dtype, quant=quant))
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), Linear(hidden_size, 6 * hidden_size, dtype=dtype))

    def _modulation(self, c):
        return self.adaLN_modulation(c).chunk(6, dim=-1)

    def _attn_branch(self, x, shift_msa, scale_msa, ring=None, tome=None):
        h = modulate(_layer_norm(x, self.dtype), shift_msa, scale_msa)
        if tome is None:
            return self.attn(h, ring)
        merge, unmerge = tome
        return unmerge(self.attn(merge(h), ring))

    def _mlp_branch(self, x, gate_msa, attn_out, shift_mlp, scale_mlp, tome=None):
        """(x + gate_msa attn_out, mlp_out, aux); aux is None for a dense MLP."""
        x = x + gate_msa[:, None, :] * attn_out
        h = modulate(_layer_norm(x, self.dtype), shift_mlp, scale_mlp)
        tome = tome if self.tome_mlp else None
        out = self.mlp(h if tome is None else tome[0](h))
        out, aux = out if self.moe else (out, None)
        return x, (out if tome is None else tome[1](out)), aux

    def _after_attn(self, x, gate_msa, attn_out, shift_mlp, scale_mlp, gate_mlp):
        x, mlp_out, aux = self._mlp_branch(x, gate_msa, attn_out, shift_mlp, scale_mlp)
        return x + gate_mlp[:, None, :] * mlp_out, aux

    def forward(self, x, c, ring=None):
        return self._step(x, c, ring)[0]

    def forward_aux(self, x, c, ring=None):
        x, _, aux = self._step(x, c, ring)
        return x, aux

    def full_step(self, x, c, ring=None):
        return self._step(x, c, ring)[:2]

    def _step(self, x, c, ring=None):
        """(x, (attn_out, mlp_out), aux)."""
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = self._modulation(c)
        # one match from the block input serves both branches
        tome = bipartite_soft_matching_2d(x, self.tome_r) if self.tome_r > 0 else None
        attn_out = self._attn_branch(x, shift_msa, scale_msa, ring, tome)
        x, mlp_out, aux = self._mlp_branch(x, gate_msa, attn_out, shift_mlp, scale_mlp, tome)
        x = x + gate_mlp[:, None, :] * mlp_out
        return x, (attn_out, mlp_out), aux

    def remat_forward(self, x, c, ring=None, policy="nothing"):
        """The block under `torch.utils.checkpoint` (non-reentrant) -> (x, aux),
        keeping for the backward what JAX's policy keeps:

        - "nothing": the block is one region; only its input is kept.
        - "attn": the attention branch and the rest are two regions; the
          branch output `attn_out` is kept because the second region takes
          it as input.
        - "attn_mlp": the attention branch and the MLP branch are regions,
          the last residual add is outside, so `attn_out` and `mlp_out` are
          kept (the gate's product saves `mlp_out`).

        Where there are regions, the adaLN modulation (B, 6D) runs outside
        them and is kept too; JAX recomputes it. In every policy the
        backward runs the attention branch again, since its kernel's
        backward needs the forward's output and row statistics: two
        forward-kernel launches and one backward launch per block and step.
        A MoE router's aux values are outputs of the region that computes
        them, so the recompute neither counts them again nor cuts their
        gradient.
        """
        kw = dict(use_reentrant=False, preserve_rng_state=False)  # blocks draw nothing
        if policy == "nothing":
            return checkpoint(self.forward_aux, x, c, ring, **kw)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = self._modulation(c)
        attn_out = checkpoint(self._attn_branch, x, shift_msa, scale_msa, ring, **kw)
        if policy == "attn":
            return checkpoint(self._after_attn, x, gate_msa, attn_out, shift_mlp, scale_mlp,
                              gate_mlp, **kw)
        if policy != "attn_mlp":
            raise ValueError(f"unknown remat policy {policy!r}")
        x, mlp_out, aux = checkpoint(self._mlp_branch, x, gate_msa, attn_out, shift_mlp,
                                     scale_mlp, **kw)
        return x + gate_mlp[:, None, :] * mlp_out, aux

    def cached_step(self, x, c, attn_out, mlp_out):
        _, _, gate_msa, _, _, gate_mlp = self._modulation(c)
        x = x + gate_msa[:, None, :] * attn_out
        return x + gate_mlp[:, None, :] * mlp_out


class FinalLayer(nn.Module):
    """adaLN (shift, scale) + linear head."""

    def __init__(self, hidden_size, patch_size, out_channels, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.linear = Linear(hidden_size, patch_size * patch_size * out_channels, dtype=dtype)
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), Linear(hidden_size, 2 * hidden_size, dtype=dtype))

    def forward(self, x, c):
        shift, scale = self.adaLN_modulation(c).chunk(2, dim=-1)
        return self.linear(modulate(_layer_norm(x, self.dtype), shift, scale))
