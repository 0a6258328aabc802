"""Depth-based and homography image warping between posed views
(counterpart of `fast_dit_tpu/nvs/warp.py`).

The forward warp scatters source pixels to the rounded target pixel with
the nearest surface winning, deterministically (`_scatter_nearest`, :64-91):
a scatter-min of the depth's int32 bit pattern (order-preserving for the
positive depths that `valid` admits), a second scatter-min of the source
index to break exact ties, then a write of the unique winner per pixel.
`scatter_reduce_(..., "amin")` is deterministic on the card too. The point
transforms are written as elementwise products and sums, each rounded
once, so a warp on the card equals the CPU's bit for bit; `torch.round`
rounds half to even, as `jnp.round` does.

Poses are world->camera [R | t]; depth is positive along +z.
"""

from __future__ import annotations

import torch

__all__ = [
    "depth_to_points",
    "transform_points",
    "project_points",
    "warp_image_by_depth",
    "warp_depth_map",
    "homography_from_pose",
    "warp_image_homography",
    "valid_pixel_ratio",
]

_BIG = torch.iinfo(torch.int32).max


def _grid(h, w, dtype=torch.float32, device=None):
    v, u = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                          torch.arange(w, dtype=dtype, device=device), indexing="ij")
    return u, v


def depth_to_points(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """(h, w) depth + intrinsics -> (h, w, 3) camera-space points."""
    u, v = _grid(*depth.shape, depth.dtype, depth.device)
    x = (u - K[0, 2]) / K[0, 0] * depth
    y = (v - K[1, 2]) / K[1, 1] * depth
    return torch.stack([x, y, depth], dim=-1)


def transform_points(pts: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3) points through x' = R x + t."""
    x, y, z = pts[..., 0:1], pts[..., 1:2], pts[..., 2:3]
    return x * R[:, 0] + y * R[:, 1] + z * R[:, 2] + t


def project_points(pts: torch.Tensor, K: torch.Tensor):
    """(..., 3) camera points -> ((..., 2) pixels, (...) depth)."""
    z = pts[..., 2]
    z_safe = torch.where(z.abs() > 1e-8, z, torch.full_like(z, 1e-8))
    u = K[0, 0] * pts[..., 0] / z_safe + K[0, 2]
    v = K[1, 1] * pts[..., 1] / z_safe + K[1, 2]
    return torch.stack([u, v], dim=-1), z


def _scatter_nearest(values, uv, depth, valid, out_hw):
    """Scatter (N, C) values to round(uv) with nearest-depth priority ->
    ((h, w, C) canvas, (h, w) bool hit mask)."""
    h, w = out_hw
    u = torch.round(uv[..., 0]).to(torch.int64)
    v = torch.round(uv[..., 1]).to(torch.int64)
    inb = (u >= 0) & (u < w) & (v >= 0) & (v < h) & valid
    bucket = h * w  # out-of-bounds slot, dropped at the end
    flat = torch.where(inb, v * w + u, torch.full_like(u, bucket))
    zbits = depth.to(torch.float32).contiguous().view(torch.int32)
    big = torch.full_like(zbits, _BIG)
    zbits = torch.where(inb, zbits, big)
    best_z = torch.full((bucket + 1,), _BIG, dtype=torch.int32, device=uv.device)
    best_z.scatter_reduce_(0, flat, zbits, "amin")
    tied = inb & (zbits == best_z[flat])
    idx = torch.arange(flat.shape[0], dtype=torch.int32, device=uv.device)
    best_i = torch.full((bucket + 1,), _BIG, dtype=torch.int32, device=uv.device)
    best_i.scatter_reduce_(0, flat, torch.where(tied, idx, big), "amin")
    winner = tied & (idx == best_i[flat])
    canvas = torch.zeros((bucket + 1, values.shape[-1]), dtype=values.dtype, device=uv.device)
    # losers all land in the dropped slot, so every kept pixel has one writer
    canvas[torch.where(winner, flat, torch.full_like(flat, bucket))] = values
    hit = torch.zeros((bucket + 1,), dtype=torch.bool, device=uv.device)
    hit[flat] = True
    return canvas[:-1].reshape(h, w, -1), hit[:-1].reshape(h, w)


def _reproject(src_depth, K_src, K_tgt, R_rel, t_rel):
    pts = transform_points(depth_to_points(src_depth, K_src).reshape(-1, 3), R_rel, t_rel)
    uv, z = project_points(pts, K_tgt)
    return uv, z, (z > 1e-6) & (src_depth.reshape(-1) > 0)


def warp_image_by_depth(src_img, src_depth, K_src, K_tgt, R_rel, t_rel):
    """Reproject (h, w, C) source pixels into the target view ->
    (warped (h, w, C), covered target pixels (h, w) bool)."""
    uv, z, valid = _reproject(src_depth, K_src, K_tgt, R_rel, t_rel)
    return _scatter_nearest(src_img.reshape(-1, src_img.shape[-1]), uv, z, valid,
                            src_depth.shape)


def warp_depth_map(src_depth, K_src, K_tgt, R_rel, t_rel):
    """The target-view depth of the reprojected surface, and its mask."""
    uv, z, valid = _reproject(src_depth, K_src, K_tgt, R_rel, t_rel)
    warped, mask = _scatter_nearest(z[:, None], uv, z, valid, src_depth.shape)
    return warped[..., 0], mask


def homography_from_pose(K_src, K_tgt, R_rel, t_rel, *, plane_normal=None,
                         plane_distance: float = 1.0):
    """Planar homography H = K_tgt (R + t n^T / d) K_src^-1, H[2, 2] = 1."""
    n = (torch.tensor([0.0, 0.0, 1.0], dtype=R_rel.dtype, device=R_rel.device)
         if plane_normal is None else plane_normal)
    H = K_tgt @ (R_rel + torch.outer(t_rel, n) / plane_distance) @ torch.linalg.inv(K_src)
    return H / H[2, 2]


def warp_image_homography(src_img, H):
    """Backward-warp (h, w, C) through H with nearest sampling ->
    (warped (h, w, C), in-bounds (h, w) bool)."""
    h, w, _ = src_img.shape
    u, v = _grid(h, w, H.dtype, H.device)
    tgt = torch.stack([u, v, torch.ones_like(u)], dim=-1).reshape(-1, 3)
    src = torch.einsum("ij,nj->ni", torch.linalg.inv(H), tgt)
    src = src[:, :2] / src[:, 2:3].abs().clamp(min=1e-8) * torch.sign(src[:, 2:3])
    su = torch.round(src[:, 0]).to(torch.int64)
    sv = torch.round(src[:, 1]).to(torch.int64)
    inb = (su >= 0) & (su < w) & (sv >= 0) & (sv < h)
    out = src_img[sv.clamp(0, h - 1), su.clamp(0, w - 1)]
    out = torch.where(inb[:, None], out, torch.zeros_like(out))
    return out.reshape(h, w, -1), inb.reshape(h, w)


def valid_pixel_ratio(mask: torch.Tensor) -> torch.Tensor:
    """Fraction of covered target pixels."""
    return mask.to(torch.float32).mean()
