"""The plain reference of the camera search's objective on notebook 2's route,
in float64 PyTorch and numpy, beside ``study_reference.py``.

It imports nothing of the program: from a stage-1 grid, a view's label plane
and a camera it recomputes the mean part IoU that the search maximises
(``utils/camera_estimation.py:489, 597-603`` with the shell of the search):

* the alignment parts are the front and back minarets (notebook 2 cells 5
  and 9); the mask keeps their labels and zeroes every other;
* the points are the 6-connected surface shell of those parts' voxels: a
  selected voxel with at least one face neighbour unselected or off the
  grid, as (x, y, z) = (d2, d1, d0) in raster order (the order decides which
  point a pixel keeps, the last one);
* the splat and the per-part IoU are ``study_reference.splat_mean_iou``.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness import study_reference as sref

#: The alignment parts' labels (front and back minarets).
ALIGN_IDS = (sref.PART_IDS["front_minarets"], sref.PART_IDS["back_minarets"])


def shell(grid: np.ndarray, ids=ALIGN_IDS, *, device):
    """((N, 3) float64 points, (N,) uint8 labels) of the surface shell of the
    voxels labelled ``ids``."""
    g = torch.as_tensor(np.ascontiguousarray(grid), device=device)
    sel = torch.isin(g, torch.as_tensor(list(ids), dtype=g.dtype, device=device))
    pad = torch.nn.functional.pad(sel.to(torch.uint8), (1, 1, 1, 1, 1, 1)).bool()
    D0, D1, D2 = sel.shape
    interior = sel.clone()
    for a0, a1, a2 in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0), (1, 1, 2)):
        interior &= pad[a0:a0 + D0, a1:a1 + D1, a2:a2 + D2]
    d0, d1, d2 = torch.nonzero(sel & ~interior, as_tuple=True)
    return torch.stack([d2, d1, d0], 1).to(torch.float64), g[d0, d1, d2]


def selected(mask: np.ndarray, ids=ALIGN_IDS) -> np.ndarray:
    """The view's plane with every label but ``ids`` zeroed."""
    m = np.asarray(mask)
    return np.where(np.isin(m, ids), m, 0).astype(np.uint8)


def camera_iou(cam, points, mask: np.ndarray, ids=ALIGN_IDS, *, dtype=torch.float64) -> float:
    """The search's objective at one camera (a dict or a 9-vector): the mean
    part IoU of the shell ``points`` (from :func:`shell`) splatted at the
    mask's own plane against the selected mask."""
    pts, labels = points
    vec = sref.cam_vector(cam) if isinstance(cam, dict) else np.asarray(cam, np.float32).astype(np.float64)
    cams = torch.as_tensor(vec, device=pts.device).view(1, 1, 9)
    gt = torch.as_tensor(selected(mask, ids), device=pts.device)[None]
    return float(sref.splat_mean_iou(cams, pts[None], labels[None], None, gt, list(ids), dtype=dtype)[0, 0])
