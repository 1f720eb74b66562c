"""Stage artifacts: npz voxel grids and camera JSONs in the reference's
``results/`` layout.

A copy of ``pbr3d.io.artifacts``: importing it from ``pbr3d.io`` would
import ``pbr3d.io.masks`` and with it ``cv2``, which the port does not need
on its main path.

* voxel grids: ``np.savez_compressed(path, voxel_grid=uint8 (W,H,D,3))``
  (reference: notebook 1 cell 9, notebook 3 cell 9).
* cameras: ``{view: {cam_pos, target, f, cx, cy[, H, W]}}`` JSON
  (reference: notebook 2 cell 11; loader utils/eval_helpers_intra.py:56-75).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Mapping

import numpy as np

from pbr3d_torch.config import labels_to_rgb, rgb_to_labels
from pbr3d_torch.utils import profiling


def save_voxel_grid(path: str | Path, labels: np.ndarray) -> None:
    """Save a uint8 label grid (W,H,D) as a reference-format RGB npz."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, voxel_grid=labels_to_rgb(np.asarray(labels)))


def load_voxel_grid_rgb(path: str | Path) -> np.ndarray:
    """uint8 (W,H,D,3) RGB voxel grid (reference: eval_helpers_intra.py:19-23)."""
    return np.load(path)["voxel_grid"]


@profiling.spanned("io.load_voxel_grid")
def load_voxel_grid_labels(path: str | Path) -> np.ndarray:
    """uint8 (W,H,D) label grid (non-palette colors -> OTHER_ID, none expected)."""
    return rgb_to_labels(load_voxel_grid_rgb(path))


def _to_json_safe(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, dict):
        return {k: _to_json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_json_safe(v) for v in obj]
    return obj


def save_camera_params(path: str | Path, params_by_view: Mapping[str, Mapping]) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(_to_json_safe(dict(params_by_view)), f, indent=2)


def load_camera_json(path: str | Path, view: str) -> Dict[str, np.ndarray | float]:
    """One view's camera from a reference-format JSON."""
    with open(path) as f:
        data = json.load(f)
    if view not in data:
        raise KeyError(f"View '{view}' not found in {Path(path).name}")
    cam = data[view]
    return {
        "cam_pos": np.array(cam["cam_pos"], dtype=np.float32),
        "target": np.array(cam["target"], dtype=np.float32),
        "f": float(cam["f"]),
        "cx": float(cam["cx"]),
        "cy": float(cam["cy"]),
    }


def voxel_grid_iou(a: np.ndarray, b: np.ndarray) -> float:
    """Occupancy IoU between two grids (label (W,H,D) or RGB (W,H,D,3)).

    The golden-regression metric: per-stage voxel-IoU vs ``results/``.
    """
    occ_a = np.any(a > 0, axis=-1) if a.ndim == 4 else a > 0
    occ_b = np.any(b > 0, axis=-1) if b.ndim == 4 else b > 0
    if occ_a.shape != occ_b.shape:
        raise ValueError(f"shape mismatch: {occ_a.shape} vs {occ_b.shape}")
    union = np.logical_or(occ_a, occ_b).sum()
    if union == 0:
        return float("nan")
    return float(np.logical_and(occ_a, occ_b).sum() / union)


def colored_voxel_grid_iou(a: np.ndarray, b: np.ndarray) -> float:
    """Exact-label IoU over occupied voxels of either grid."""
    la = rgb_to_labels(a) if a.ndim == 4 else a
    lb = rgb_to_labels(b) if b.ndim == 4 else b
    occ = (la > 0) | (lb > 0)
    union = occ.sum()
    if union == 0:
        return float("nan")
    return float(((la == lb) & occ).sum() / union)
