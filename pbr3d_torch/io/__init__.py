"""Artifact & dataset IO (host side), as in ``pbr3d.io``.

Keeps the reference's on-disk formats byte-compatible:
npz voxel grids (key ``voxel_grid``, uint8 (W,H,D,3)), camera JSONs, PNG masks.
"""

from pbr3d_torch.io.masks import MaskSet, load_mask_rgb, load_mask_labels, prepare_masks
from pbr3d_torch.io.artifacts import (
    save_voxel_grid,
    load_voxel_grid_rgb,
    load_voxel_grid_labels,
    save_camera_params,
    load_camera_json,
    voxel_grid_iou,
)

__all__ = [
    "MaskSet",
    "load_mask_rgb",
    "load_mask_labels",
    "prepare_masks",
    "save_voxel_grid",
    "load_voxel_grid_rgb",
    "load_voxel_grid_labels",
    "save_camera_params",
    "load_camera_json",
    "voxel_grid_iou",
]
