"""Voxel-grid -> point-set utilities (label domain), as in
``pbr3d.carving.voxel``.

Coordinate convention preserved from the reference: a label grid is indexed
(d0, d1, d2); point lists are columns (x, y, z) = (d2, d1, d0) in the raster
order of ``np.where`` (reference: utils/voxel_utils.py:17-18,41-43), which
``torch.nonzero`` shares.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _xyz_f32(d0: torch.Tensor, d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """(N, 3) float32 (x, y, z) from nonzero index triples."""
    return torch.stack([d2, d1, d0], dim=1).to(torch.float32)


def all_points(grid_labels, *, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """All occupied voxels as (x, y, z) float32 points + uint8 labels, on
    ``device`` (reference: eval_helpers_intra.py:138-139)."""
    g = torch.as_tensor(grid_labels, device=device)
    d0, d1, d2 = torch.nonzero(g > 0, as_tuple=True)
    return _xyz_f32(d0, d1, d2), g[d0, d1, d2]
