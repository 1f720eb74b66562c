"""The three quality gates of the study bench (``bench.py:72-136,185-187``
of the JAX package's repo), on in-memory arguments.

* stage 1: occupancy IoU of a stage-1 grid against the golden grid of the
  same monument, the larger of the two stride-downsampled to the other's
  resolution;
* stage 3: the notebook-4 "whole" cell — the visibility-aware silhouette IoU
  of the deformed grid under the final front camera;
* stage 3: the mean IoU of the parts present in the mask.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np

from pbr3d_torch import config
from pbr3d_torch.deform.verify import _iou_bool_np, _part_zbufs_grid
from pbr3d_torch.io.artifacts import voxel_grid_iou
from pbr3d_torch.io.masks import compute_binary_gt

#: Cross-resolution occupancy-IoU floor: it measures the goldens' drift and
#: the resampling, stage 1 itself being bit-exact against the reference.
STAGE1_IOU_MIN = 0.92
STAGE3_WHOLE_IOU_MIN = 0.80
STAGE3_MEAN_PART_IOU_MIN = 0.50


def stage1_iou_vs_golden(grid: np.ndarray, gold: np.ndarray) -> Optional[float]:
    """Occupancy IoU of ``grid`` against the golden label grid ``gold``.  The
    goldens were made at 512 (Akbar: 128), so whichever grid is larger is
    strided down, and both are cropped to their common shape (a resize may
    have truncated where the other rounded).  None when the shapes still
    differ by more than 2 along an axis."""
    if max(gold.shape) >= max(grid.shape):
        factor = max(1, round(max(gold.shape) / max(grid.shape)))
        gold = gold[::factor, ::factor, ::factor]
    else:
        factor = max(1, round(max(grid.shape) / max(gold.shape)))
        grid = grid[::factor, ::factor, ::factor]
    if any(abs(a - b) > 2 for a, b in zip(gold.shape, grid.shape)):
        return None
    lo = tuple(min(a, b) for a, b in zip(gold.shape, grid.shape))
    crop = tuple(slice(0, n) for n in lo)
    return voxel_grid_iou(np.asarray(grid)[crop], gold[crop])


def stage3_whole_iou(
    grid_stage3: np.ndarray,
    cam_front: Dict,
    mask_labels: np.ndarray,
    grid_stage1: np.ndarray,
    *,
    device,
) -> float:
    """The notebook-4 "whole" cell of a deformed grid under ``cam_front``
    against ``mask_labels`` (the front mask resized to the stage-1 grid as
    notebook 4 resizes it).  A pixel is visible iff some part's z-buffer is
    finite there: each pixel's nearest point passes the visibility test
    against itself (eval_helpers_intra.py:168-190)."""
    H, W = mask_labels.shape[:2]
    present = {int(v) for v in np.flatnonzero(np.bincount(grid_stage3.reshape(-1))) if 0 < v < 10}
    names = [p for p, i in config.PART_IDS.items() if i in present]
    zbs = _part_zbufs_grid(grid_stage3, cam_front, H, W, names, device=device)
    visible = np.isfinite(np.minimum.reduce(list(zbs.values())))[:H, :W]
    return _iou_bool_np(compute_binary_gt(mask_labels, grid_stage1), visible)


def mean_part_iou(deform_params: Mapping[str, Mapping]) -> float:
    """Mean stage-3 IoU over the parts PRESENT in the mask (notebook 4
    prints "--" for parts with an empty ground truth)."""
    scored = [d["iou"] for d in deform_params.values() if d.get("gt_px", 1) > 0]
    return float(sum(scored) / max(len(scored), 1))
