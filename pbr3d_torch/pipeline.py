"""End-to-end pipeline entry points, as in ``pbr3d.pipeline``.

Stage boundaries and file formats match the reference exactly (npz voxel
grids under ``1.Orthographic_Voxel_Carving``), so either implementation can
produce a stage and the other can consume it.  Stage 1 only, so far.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from pbr3d_torch import config
from pbr3d_torch.carving.fused import carve_monument_fused
from pbr3d_torch.io.artifacts import save_voxel_grid
from pbr3d_torch.io.masks import prepare_masks


def run_stage1(
    monument: str,
    data_root: str | Path = config.data_root(),
    max_dim: Optional[int] = None,
    preset: config.CarvePreset = config.DEFAULT_CARVE_PRESET,
    out_dir: Optional[str | Path] = None,
    *,
    device,
) -> np.ndarray:
    """Orthographic semantic voxel carving (notebook 1) on ``device``."""
    if max_dim is None:
        max_dim = config.GOLDEN_MAX_DIM.get(monument, config.MAX_DIM)
    masks = prepare_masks(data_root, monument, "front", max_dim)
    grid = carve_monument_fused(masks, preset, device=device)
    if out_dir is not None:
        save_voxel_grid(
            Path(out_dir) / "1.Orthographic_Voxel_Carving" / f"{monument}_voxel_grid.npz",
            grid,
        )
    return grid
