"""Multi-view geometry for novel-view synthesis, in torch (counterpart of
`fast_dit_tpu/nvs/geometry.py`): quaternions, skew matrices, relative
pose, essential and fundamental matrices (with the rank-2 projection),
epipolar lines and distances, Plücker ray embeddings, raymaps, intrinsics
rescaling and 2D Fourier coordinate features. Batched where meaningful;
each function computes on its inputs' device.

Conventions: quaternions are (w, x, y, z); poses are world->camera
[R | t] with x_cam = R @ x_world + t; pixels are (u, v) with u = column.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "quaternion_to_rotation_matrix",
    "skew",
    "relative_pose",
    "essential_matrix",
    "fundamental_matrix",
    "epipolar_lines",
    "point_line_distance",
    "epipolar_distance_map",
    "plucker_coordinates",
    "raymap",
    "fourier_features",
    "scale_intrinsics",
]


def quaternion_to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion (w, x, y, z) -> (..., 3, 3) rotation matrix."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(*q.shape[:-1], 3, 3)


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix [v]_x."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    rows = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return rows.reshape(*v.shape[:-1], 3, 3)


def relative_pose(R1, t1, R2, t2):
    """World->cam poses of views 1, 2 -> (R_rel, t_rel) mapping cam1->cam2:
    x2 = R_rel x1 + t_rel."""
    R_rel = R2 @ R1.transpose(-1, -2)
    t_rel = t2 - torch.einsum("...ij,...j->...i", R_rel, t1)
    return R_rel, t_rel


def essential_matrix(R_rel, t_rel):
    """E = [t]_x R for the cam1->cam2 relative pose."""
    return skew(t_rel) @ R_rel


def fundamental_matrix(K1, K2, R_rel, t_rel, *, rank2_project: bool = True):
    """F = K2^-T [t]_x R K1^-1, optionally projected to rank 2 by an SVD
    (U diag(s1, s2, 0) V^T does not depend on the singular vectors' signs),
    normalised so that F[2, 2] = 1 where it is not ~0."""
    E = essential_matrix(R_rel, t_rel)
    F = torch.linalg.inv(K2).transpose(-1, -2) @ E @ torch.linalg.inv(K1)
    if rank2_project:
        u, s, vh = torch.linalg.svd(F)
        s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
        F = (u * s[..., None, :]) @ vh
    f22 = F[..., 2:3, 2:3]
    return F / torch.where(f22.abs() > 1e-12, f22, torch.ones_like(f22))


def _homogeneous(pts_uv):
    return torch.cat([pts_uv, torch.ones_like(pts_uv[..., :1])], dim=-1)


def epipolar_lines(F, pts_uv):
    """(..., 3, 3) F and (..., N, 2) pixels in image 1 -> (..., N, 3) lines
    ax + by + c = 0 in image 2."""
    return torch.einsum("...ij,...nj->...ni", F, _homogeneous(pts_uv))


def point_line_distance(lines, pts_uv):
    """(..., N, 3) lines and (..., M, 2) points -> (..., N, M) distances."""
    num = torch.einsum("...ni,...mi->...nm", lines, _homogeneous(pts_uv)).abs()
    den = torch.linalg.vector_norm(lines[..., :2], dim=-1, keepdim=True)
    return num / den.clamp(min=1e-12)


def _pixel_grid(h, w, dtype=torch.float32, device=None):
    """(h*w, 2) pixel centres (u + 0.5, v + 0.5), row-major."""
    v, u = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                          torch.arange(w, dtype=dtype, device=device), indexing="ij")
    return torch.stack([u + 0.5, v + 0.5], dim=-1).reshape(-1, 2)


def epipolar_distance_map(F, h: int, w: int, *, softmax_temp: float = None,
                          threshold: float = None):
    """Distance from every target pixel to the epipolar line of every source
    pixel: (h*w source, h*w target). With `threshold`, the soft within-band
    weight map sigmoid((threshold - d) / temp)."""
    pts = _pixel_grid(h, w, F.dtype, F.device)
    d = point_line_distance(epipolar_lines(F, pts), pts)
    if threshold is None:
        return d
    temp = softmax_temp if softmax_temp is not None else 1.0
    return torch.sigmoid((threshold - d) / temp)


def plucker_coordinates(K, R, t, h: int, w: int):
    """Per-pixel Plücker ray embedding (d, o x d): (h, w, 6). (R, t) is
    world->camera; rays leave the camera centre o = -R^T t in world
    coordinates."""
    homog = _homogeneous(_pixel_grid(h, w, K.dtype, K.device))
    dirs_cam = torch.einsum("ij,nj->ni", torch.linalg.inv(K), homog)
    dirs_world = torch.einsum("ji,nj->ni", R, dirs_cam)  # R^T d
    dirs_world = dirs_world / torch.linalg.vector_norm(dirs_world, dim=-1, keepdim=True)
    origin = -torch.einsum("ji,j->i", R, t)
    moment = torch.linalg.cross(origin.expand_as(dirs_world), dirs_world, dim=-1)
    return torch.cat([dirs_world, moment], dim=-1).reshape(h, w, 6)


def raymap(K, R, t, h: int, w: int):
    """6-channel raymap (origins | directions): (h, w, 6)."""
    dirs = plucker_coordinates(K, R, t, h, w)[..., :3]
    origin = -torch.einsum("ji,j->i", R, t)
    return torch.cat([origin.expand_as(dirs), dirs], dim=-1)


def scale_intrinsics(K: torch.Tensor, sx: float, sy: float = None) -> torch.Tensor:
    """Rescale intrinsics for a resized image: fx, cx by sx; fy, cy by sy.
    For normalised intrinsics pass the target width and height."""
    sy = sx if sy is None else sy
    s = torch.tensor([[sx, 1.0, sx], [1.0, sy, sy], [1.0, 1.0, 1.0]], dtype=K.dtype,
                     device=K.device)
    return K * s


def fourier_features(coords: torch.Tensor, num_bands: int = 6,
                     max_freq: float = 10.0) -> torch.Tensor:
    """Multi-scale sin/cos features of (..., D) coordinates ->
    (..., D * 2 * num_bands)."""
    freqs = 2.0 ** torch.linspace(0.0, math.log2(max_freq), num_bands, dtype=coords.dtype,
                                  device=coords.device)
    ang = coords[..., None] * freqs
    feats = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return feats.reshape(*coords.shape[:-1], -1)
