"""Novel-view synthesis (counterpart of `fast_dit_tpu/nvs/`): geometry,
warping, epipolar attention, RePaint inpainting, the DINO-conditioned
`DiTNVS`, DINO feature loading, metrics and pose I/O."""

from . import dino, epipolar, geometry, inpaint, metrics, pose_io, warp
from .conditioning import CrossAttention, DiTCrossBlock, DiTNVS
from .epipolar import epipolar_attention, epipolar_weight_map, patchify_attention_mask
from .inpaint import inpaint_sample_loop, mask_from_black_pixels

__all__ = [
    "dino",
    "epipolar",
    "geometry",
    "inpaint",
    "metrics",
    "pose_io",
    "warp",
    "CrossAttention",
    "DiTCrossBlock",
    "DiTNVS",
    "epipolar_attention",
    "epipolar_weight_map",
    "patchify_attention_mask",
    "inpaint_sample_loop",
    "mask_from_black_pixels",
]
