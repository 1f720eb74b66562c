"""Stage 1 — global and per-part-group carving (the modular route).

Port of ``pbr3d.carving.stage1.global_carve`` / ``part_carve``
(reference: utils/voxel_carving_utils.py:139-160,269-298).  Grids are uint8
*label* grids (W, H, D): 0 = empty, 1..10 = part ids.  The production path,
:func:`pbr3d_torch.carving.fused.carve_monument_fused`, runs the same carves;
these functions are the oracle route the tests hold against the reference's
own output.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np
import torch

from pbr3d_torch import config
from pbr3d_torch.ops.carve import rotate_carve_sweep


def global_carve(
    binary_mask: np.ndarray,
    exterior_labels: np.ndarray,
    angle_interval: int = 90,
    bucket: int | None = None,
    *,
    device,
) -> torch.Tensor:
    """Silhouette-carve + semantic label extrusion.

    ``binary_mask``: (H, W) {0,1}; ``exterior_labels``: (H, W) uint8 labels.
    Returns a uint8 label grid (W, H, W) on ``device``: the carved occupancy
    painted with the exterior label of each voxel's (x, y) column
    (reference ``apply_colored_mask_to_voxel_grid``, :128-136).
    """
    h, w = binary_mask.shape
    occ = torch.ones((w, h, w), dtype=torch.uint8, device=device)
    carved = rotate_carve_sweep(
        occ, torch.as_tensor(binary_mask, device=device).T, angle_interval,
        bucket, device=device,
    )
    col = torch.as_tensor(exterior_labels, device=device).T.to(torch.uint8)
    return carved * col[:, :, None]


def part_carve(
    labels_grid,
    exterior_labels: np.ndarray,
    group_jobs: Iterable[Tuple[Sequence[str], int]],
    bucket: int | None = None,
    *,
    device,
) -> torch.Tensor:
    """Re-carve each part group under its own symmetry sweep.

    Groups whose 2D mask is empty are skipped; later groups overwrite earlier
    ones where nonzero (reference: voxel_carving_utils.py:139-160).
    """
    labels_grid = torch.as_tensor(labels_grid, device=device)
    exterior_labels = np.asarray(exterior_labels)
    final = torch.zeros_like(labels_grid)
    for names, angle in group_jobs:
        mask2d = np.isin(exterior_labels, config.part_ids(names))  # (H, W)
        if not mask2d.any():
            continue
        m_wh = torch.from_numpy(np.ascontiguousarray(mask2d.T)).to(device)
        sub = labels_grid * m_wh.to(torch.uint8)[:, :, None]
        carved = rotate_carve_sweep(sub, m_wh, int(angle), bucket, device=device)
        part = sub * carved
        final = torch.where(part > 0, part, final)
    return final
