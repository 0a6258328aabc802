"""Token merging (ToMe) for DiT inference (counterpart of
`fast_dit_tpu/ops/tome.py:53-139`).

Per block, the `r` source tokens most similar to a destination token merge
into it before the attention branch (and the MLP branch with `tome_mlp`)
and come back after, so the branch runs on N - r tokens while the residual
stream keeps all N. Destinations are a fixed strided grid, one per sy x sx
cell; every other token is a source. Each source scores its most
cosine-similar destination; the r best-scoring sources merge, the rest keep
a row of their own.

The contract is JAX's, not its TPU formulation:

- the descending rank of the scores, ties broken by the lower source index,
  is a stable descending sort here, where JAX counts a comparison matrix;
- merge is `index_add_` of fp32 rows divided by the group sizes, and
  unmerge a row gather, where JAX multiplies by a one-hot matrix. The rows
  of the merged array are [destinations | kept sources], in JAX's order, so
  the token -> row map equals JAX's exactly, ties and duplicates included.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["tome_merge_count", "bipartite_soft_matching_2d"]


def tome_merge_count(num_patches: int, ratio: float, sx: int = 2, sy: int = 2) -> int:
    """The merge count of `ratio` (a fraction of all tokens), clipped to the
    number of source tokens: at the 2 x 2 stride at most 75 % merge."""
    gh = gw = int(round(num_patches ** 0.5))
    if gh * gw != num_patches:
        raise ValueError(f"non-square token grid: {num_patches}")
    n_dst = ((gh + sy - 1) // sy) * ((gw + sx - 1) // sx)
    r = int(num_patches * ratio)
    return max(0, min(r, num_patches - n_dst))


def _dst_src_split(gh: int, gw: int, sx: int, sy: int):
    """Destination and source token indices on the gh x gw grid."""
    ii, jj = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    dst_mask = ((ii % sy == 0) & (jj % sx == 0)).reshape(-1)
    return np.flatnonzero(dst_mask), np.flatnonzero(~dst_mask)


@functools.lru_cache(maxsize=None)
def _split_on(device: torch.device, gh: int, gw: int, sx: int, sy: int):
    """`_dst_src_split` as index tensors made on `device` once: a stable
    sort of the destination mask puts the sources first and the
    destinations after, each in index order. Built there, not copied from
    the host, since a copy would wait for the card; and outside inference
    mode, so that any later call may save them."""
    with torch.inference_mode(False):
        ii = torch.arange(gh, device=device)[:, None]
        jj = torch.arange(gw, device=device)[None, :]
        is_dst = ((ii % sy == 0) & (jj % sx == 0)).reshape(-1)
        n_src = gh * gw - ((gh + sy - 1) // sy) * ((gw + sx - 1) // sx)
        order = torch.argsort(is_dst.to(torch.uint8), stable=True)
        return order[n_src:], order[:n_src]


def bipartite_soft_matching_2d(metric: torch.Tensor, r: int, *, sx: int = 2, sy: int = 2):
    """(merge, unmerge) for the r best source -> destination merges.

    metric: (B, N, D), the tokens of a square grid that decide the match.
    `merge(x)`: (B, N, D) -> (B, N - r, D), each merged group's mean,
    accumulated in fp32 and cast to x's dtype; `unmerge(y)`: (B, N - r, D)
    -> (B, N, D), each token reads its representative's row. `r` comes from
    `tome_merge_count`."""
    B, N, _ = metric.shape
    gh = gw = int(round(N ** 0.5))
    if gh * gw != N:
        raise ValueError(f"non-square token grid: {N}")
    device = metric.device
    dst_idx, src_idx = _split_on(device, gh, gw, sx, sy)
    n_dst, n_src = len(dst_idx), len(src_idx)
    if not 0 < r <= n_src:
        raise ValueError(f"merge count {r} must lie in [1, {n_src}]")

    m = metric.float()
    m = m / (torch.linalg.vector_norm(m, dim=-1, keepdim=True) + 1e-6)
    scores = torch.einsum("bsd,btd->bst", m[:, src_idx], m[:, dst_idx])
    node_max, node_idx = scores.max(dim=-1)  # best destination per source (first on ties)

    if r == n_src:  # every source merges
        src_slot = node_idx
    else:
        # rank 0 = most similar; equal scores rank by index, as in JAX
        order = torch.sort(node_max, dim=-1, descending=True, stable=True).indices
        rank = torch.empty_like(order)
        rank.scatter_(1, order, torch.arange(n_src, device=device).expand(B, n_src))
        merged = rank < r
        kept_slot = n_dst + torch.cumsum((~merged).long(), dim=1) - 1
        src_slot = torch.where(merged, node_idx, kept_slot)

    # token -> row of the merged array [destination block | kept block]
    full_map = torch.empty((B, N), dtype=torch.long, device=device)
    full_map[:, dst_idx] = torch.arange(n_dst, device=device)
    full_map[:, src_idx] = src_slot
    n_merged = N - r
    counts = torch.zeros((B, n_merged), dtype=torch.float32, device=device)
    counts.scatter_add_(1, full_map, torch.ones((B, N), dtype=torch.float32, device=device))
    # flat rows of (B * (N - r)) for index_add_ and the gather
    flat = (full_map + n_merged * torch.arange(B, device=device)[:, None]).reshape(-1)

    def merge(x: torch.Tensor) -> torch.Tensor:
        D = x.shape[-1]
        s = torch.zeros((B * n_merged, D), dtype=torch.float32, device=x.device)
        s.index_add_(0, flat, x.reshape(B * N, D).float())
        return (s.reshape(B, n_merged, D) / counts[..., None]).to(x.dtype)

    def unmerge(y: torch.Tensor) -> torch.Tensor:
        D = y.shape[-1]
        return y.reshape(B * n_merged, D).index_select(0, flat).reshape(B, N, D)

    return merge, unmerge
