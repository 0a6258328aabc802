"""Pose-format converters (counterpart of `fast_dit_tpu/nvs/pose_io.py`,
which imports no JAX; the port keeps its own copy): ORB-SLAM text ->
Blender-convention JSON, and pose JSON -> RealEstate10K-format rows. Every
function takes explicit inputs and outputs.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np

__all__ = [
    "orb_to_blender",
    "convert_poses_to_json",
    "extract_realestate_rows",
    "write_realestate_txt",
]

# orb starts with +z forward, +y down
_PRE_CONVERSION = np.array([
    [1, 0, 0, 0],
    [0, -1, 0, 0],
    [0, 0, -1, 0],
    [0, 0, 0, 1],
], dtype=np.float64)

# converts +y-down world to +z-up world
_CONVERSION = np.array([
    [1, 0, 0, 0],
    [0, 0, 1, 0],
    [0, -1, 0, 0],
    [0, 0, 0, 1],
], dtype=np.float64)


def orb_to_blender(orb_t: np.ndarray) -> np.ndarray:
    """ORB-SLAM world->camera 4x4 -> Blender-convention camera-to-world."""
    camera_local = np.linalg.inv(np.asarray(orb_t, np.float64))
    orb_world = camera_local @ _PRE_CONVERSION
    return _CONVERSION @ orb_world


def convert_poses_to_json(input_file: str, output_file: str,
                          *, invert_extrinsics: bool = True) -> dict:
    """Pose txt (rows: id fx fy cx cy + 12 pose values) -> Blender JSON with
    focal/center, per-frame poses, and a sequential generation order.
    `invert_extrinsics` inverts each row's pose first, for ScanNet's."""
    with open(input_file) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]

    poses: List[List[List[float]]] = []
    focal_x = focal_y = center_x = center_y = None
    for line in lines:
        values = [float(x) for x in line.split()]
        focal_x, focal_y, center_x, center_y = values[1:5]
        orb_t = np.array([values[5:9], values[9:13], values[13:17],
                          [0, 0, 0, 1.0]])
        if invert_extrinsics:
            orb_t = np.linalg.inv(orb_t)
        poses.append(orb_to_blender(orb_t).tolist())

    num_frames = len(poses)
    output_data = {
        "focal_x": focal_x,
        "focal_y": focal_y,
        "center_x": center_x,
        "center_y": center_y,
        "poses": poses,
        "dependencies": [None] + list(range(num_frames - 1)),
        "generation_order": list(range(1, num_frames)),
    }
    with open(output_file, "w") as f:
        json.dump(output_data, f, indent=2)
    return output_data


def extract_realestate_rows(entries: Sequence[Dict], frame_ids: Sequence[str]) -> List[str]:
    """Per-frame {timestamp, intrinsics (3x3), pose (>=3x4)} dicts ->
    RealEstate10K rows: `ts fx fy cx cy r00 r01 r02 t0 ... r22 t2`."""
    rows = []
    by_ts = {str(e["timestamp"]): e for e in entries}
    for frame_id in frame_ids:
        entry = by_ts.get(str(frame_id))
        if entry is None:
            continue
        K = entry["intrinsics"]
        pose = entry["pose"]
        row = [str(frame_id), K[0][0], K[1][1], K[0][2], K[1][2]]
        row += [item for sublist in pose[0:3] for item in sublist]
        rows.append(" ".join(map(str, row)))
    return rows


def write_realestate_txt(json_path: str, frames_dir: str, output_file: str,
                         ext: str = ".png") -> int:
    """JSON of per-frame entries + a frame folder -> RealEstate10K txt,
    ordered by sorted frame filenames."""
    with open(json_path) as f:
        data = json.load(f)
    frame_ids = sorted(
        os.path.splitext(fn)[0] for fn in os.listdir(frames_dir)
        if fn.endswith(ext))
    rows = extract_realestate_rows(data, frame_ids)
    os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
    with open(output_file, "w") as f:
        f.write("\n".join(rows) + ("\n" if rows else ""))
    return len(rows)
