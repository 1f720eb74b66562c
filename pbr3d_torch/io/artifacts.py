"""Stage artifacts: npz voxel grids in the reference's ``results/`` layout.

A copy of the grid functions of ``pbr3d.io.artifacts``: importing them from
``pbr3d.io`` would import ``pbr3d.io.masks`` and with it ``cv2``, which the
port does not need on its main path.

* voxel grids: ``np.savez_compressed(path, voxel_grid=uint8 (W,H,D,3))``
  (reference: notebook 1 cell 9, notebook 3 cell 9).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pbr3d_torch.config import labels_to_rgb, rgb_to_labels


def save_voxel_grid(path: str | Path, labels: np.ndarray) -> None:
    """Save a uint8 label grid (W,H,D) as a reference-format RGB npz."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, voxel_grid=labels_to_rgb(np.asarray(labels)))


def load_voxel_grid_labels(path: str | Path) -> np.ndarray:
    """uint8 (W,H,D) label grid (non-palette colors -> OTHER_ID, none expected)."""
    return rgb_to_labels(np.load(path)["voxel_grid"])


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
