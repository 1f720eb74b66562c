"""Stage 2, perspective camera estimation: minaret keypoints, the bounded LM
keypoint fit and the mask-IoU camera search."""

from pbr3d_torch.camera.geometry import look_at_rotation, project_points, project_point
from pbr3d_torch.camera.keypoints import (
    extract_minaret_voxels_by_label,
    extract_minaret_masks_by_label,
    extract_top_bottom_voxel_points,
    extract_top_bottom_image_points,
    extract_minaret_kps_for_view,
)
from pbr3d_torch.camera.estimate import (
    auto_compute_initial_params_matching_bbox,
    optimize_camera_with_keypoints,
)
from pbr3d_torch.camera.align import refine_camera_mask_iou, evaluate_camera_iou

__all__ = [
    "look_at_rotation",
    "project_points",
    "project_point",
    "extract_minaret_voxels_by_label",
    "extract_minaret_masks_by_label",
    "extract_top_bottom_voxel_points",
    "extract_top_bottom_image_points",
    "extract_minaret_kps_for_view",
    "auto_compute_initial_params_matching_bbox",
    "optimize_camera_with_keypoints",
    "refine_camera_mask_iou",
    "evaluate_camera_iou",
]
