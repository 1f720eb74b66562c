"""Camera initialisation and keypoint fitting, as in ``pbr3d.camera.estimate``.

* :func:`auto_compute_initial_params_matching_bbox` replicates the
  reference's bbox-alignment heuristic (camera on -Z at 2x the voxel bbox
  diagonal, focal length from a 30° vertical FOV rescaled by the
  image/projection bbox-width ratio; reference:
  utils/camera_estimation.py:56-108).
* :func:`optimize_camera_with_keypoints` is the JAX package's bounded
  Levenberg-Marquardt fit over the 9 camera DoF (it replaced the reference's
  scipy L-BFGS-B): residual Jacobians by forward-mode derivatives, box bounds
  by projection, damping adapted per step, in float32.  On the card the whole
  fit is one launch of the hand-written kernel
  :func:`pbr3d_torch.ops.cuda_kernels.lm_fit_kernel` (dual numbers in
  registers, no autograd); on CPU tensors it is the plain version
  :func:`~pbr3d_torch.ops.cuda_kernels.lm_fit_plain`, PyTorch's forward-mode
  AD, which holds a process-wide lock (one dual level a process).  The
  normal equations are elementwise sums, not matmuls, so no TF32 can enter
  them (the JAX package asks for ``Precision.HIGHEST`` there).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from pbr3d_torch import config
from pbr3d_torch.carving.voxel import points_by_parts
from pbr3d_torch.ops.cuda_kernels import lm_fit_kernel, lm_fit_plain


def init_from_bbox(
    bbox_min: np.ndarray,
    bbox_max: np.ndarray,
    mask_labels: np.ndarray,
    parts_for_alignment: Sequence[str],
    fov_deg: float = 30.0,
) -> Dict:
    """The bbox-matched init from the selected voxels' float32 bbox (host
    math only).  Raises ValueError when the mask holds no selected pixel."""
    H_img, W_img = mask_labels.shape[:2]
    center = (bbox_min + bbox_max) / 2
    size = float(np.linalg.norm(bbox_max - bbox_min))

    ids = config.part_ids(parts_for_alignment)
    ys, xs = np.where(np.isin(mask_labels, ids))
    img_min = np.array([xs.min(), ys.min()], np.float64)
    img_max = np.array([xs.max(), ys.max()], np.float64)
    img_width = float(np.linalg.norm(img_max - img_min))

    cam_pos = center + np.array([0.0, 0.0, -size * 2.0])
    f = H_img / (2.0 * np.tan(np.deg2rad(fov_deg) / 2.0))
    approx_proj_width = (size * f) / (size * 2.0)
    f_adjusted = f * (img_width / approx_proj_width)

    return {
        "cam_pos": cam_pos.astype(np.float64),
        "target": center.astype(np.float64),
        "f": float(f_adjusted),
        "cx": W_img / 2.0,
        "cy": H_img / 2.0,
    }


def parts_bbox(grid_labels, parts: Sequence[str], *, device) -> Tuple[np.ndarray, np.ndarray]:
    """float32 (x, y, z) bbox of the selected parts' voxels, reduced on
    ``device``.  Raises ValueError when none is selected."""
    pts, _ = points_by_parts(grid_labels, parts, device=device)
    if pts.shape[0] == 0:
        raise ValueError(f"no voxels of {list(parts)} in the grid")
    lo, hi = pts.aminmax(dim=0)
    return lo.cpu().numpy(), hi.cpu().numpy()


def auto_compute_initial_params_matching_bbox(
    grid_labels,
    mask_labels: np.ndarray,
    parts_for_alignment: Sequence[str],
    fov_deg: float = 30.0,
    *,
    device,
) -> Dict:
    lo, hi = parts_bbox(grid_labels, parts_for_alignment, device=device)
    return init_from_bbox(lo, hi, mask_labels, parts_for_alignment, fov_deg)


def default_bounds(H: int, W: int) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's hand-tuned L-BFGS-B box bounds
    (utils/camera_estimation.py:144-152)."""
    lo = np.array([-W, -H, -2000, -W, -H, -2000, 10, 0, 0], np.float32)
    hi = np.array([2 * W, 2 * H, 100, 2 * W, 2 * H, 100, 2000, W, H], np.float32)
    return lo, hi


def _lm_fit(
    x0: torch.Tensor,
    vox_kps: torch.Tensor,  # (K, 3)
    img_kps: torch.Tensor,  # (K, 2)
    kp_mask: torch.Tensor,  # (K,) 1/0 — masked residuals are zeroed
    lo: torch.Tensor,
    hi: torch.Tensor,
    loss_type: str = "L2",
    max_iters: int = 200,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bounded Levenberg-Marquardt on the keypoint residuals of one view;
    returns (x (9,), loss) as device tensors.  A CUDA tensor goes to the
    hand-written kernel, a CPU tensor to its plain version (forward-mode AD
    under ``cuda_kernels._FORWARD_AD_LOCK``); both stop where the JAX
    package's ``while |delta| > 1e-10`` loop stops."""
    if x0.device.type == "cuda":
        fit = lm_fit_kernel
    elif x0.device.type == "cpu":
        fit = lm_fit_plain
    else:
        raise ValueError(f"_lm_fit: unsupported device {x0.device}")
    x, loss, _ = fit(*(t[None] for t in (x0, vox_kps, img_kps, kp_mask, lo, hi)),
                     loss_type=loss_type, max_iters=max_iters)
    return x[0], loss[0]


def keypoint_fit_inputs(
    voxel_keypoints: Dict[str, np.ndarray],
    image_keypoints: Dict[str, Tuple[float, float]],
    image_hw: Tuple[int, int],
    init_params: Dict,
) -> Tuple[np.ndarray, ...]:
    """float32 (x0 (9,) clipped to the bounds, voxel keypoints (K, 3), image
    keypoints (K, 2), mask (K,) of ones, lo (9,), hi (9,)) of one view's fit,
    in the image keypoints' order."""
    H, W = image_hw
    keys = list(image_keypoints.keys())
    vox = np.stack([voxel_keypoints[k] for k in keys]).astype(np.float32)
    img = np.stack([image_keypoints[k] for k in keys]).astype(np.float32)
    x0 = np.concatenate(
        [
            np.asarray(init_params["cam_pos"], np.float64),
            np.asarray(init_params["target"], np.float64),
            [init_params["f"], init_params["cx"], init_params["cy"]],
        ]
    )
    lo, hi = default_bounds(H, W)
    return np.clip(x0.astype(np.float32), lo, hi), vox, img, np.ones(len(keys), np.float32), lo, hi


def optimize_camera_with_keypoints(
    voxel_keypoints: Dict[str, np.ndarray],
    image_keypoints: Dict[str, Tuple[float, float]],
    image_hw: Tuple[int, int],
    init_params: Dict,
    loss_type: str = "L2",
    *,
    device,
) -> Dict:
    """Fit the 9-DoF camera to the keypoint correspondences on ``device``.

    Same objective and bounds as the reference; returns the fitted params
    dict with its final ``loss``."""
    args = [torch.tensor(a, device=device)
            for a in keypoint_fit_inputs(voxel_keypoints, image_keypoints, image_hw, init_params)]
    x, fun = _lm_fit(*args, loss_type=loss_type)
    x = x.cpu().numpy().astype(np.float64)
    return {
        "cam_pos": x[0:3],
        "target": x[3:6],
        "f": float(x[6]),
        "cx": float(x[7]),
        "cy": float(x[8]),
        "loss": float(fun),
    }
