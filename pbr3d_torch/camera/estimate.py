"""Camera initialisation and keypoint fitting, as in ``pbr3d.camera.estimate``.

* :func:`auto_compute_initial_params_matching_bbox` replicates the
  reference's bbox-alignment heuristic (camera on -Z at 2x the voxel bbox
  diagonal, focal length from a 30° vertical FOV rescaled by the
  image/projection bbox-width ratio; reference:
  utils/camera_estimation.py:56-108).
* :func:`optimize_camera_with_keypoints` is the JAX package's bounded
  Levenberg-Marquardt fit over the 9 camera DoF (it replaced the reference's
  scipy L-BFGS-B): residual Jacobians by forward-mode AD, box bounds by
  projection, damping adapted per step.  It runs in float32 on the device.
  The normal equations are elementwise sums, not matmuls, so no TF32 can
  enter them (the JAX package asks for ``Precision.HIGHEST`` there).
"""

from __future__ import annotations

import threading
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from pbr3d_torch import config
from pbr3d_torch.carving.voxel import points_by_parts
from pbr3d_torch.ops.cameramath import project_points


#: Forward-mode AD keeps one dual level for the whole process, and a second
#: thread that enters it raises "Nested forward mode AD is not supported":
#: the fits of concurrent threads (``run_all``'s preparation pool) take turns.
_FORWARD_AD_LOCK = threading.Lock()


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
    """Bounded Levenberg-Marquardt on the keypoint residuals; returns
    (x (9,), loss) as device tensors.

    The JAX package loops ``while it < max_iters and |delta| > 1e-10``.
    Here all ``max_iters`` steps run, and a step taken once ``|delta|`` has
    fallen to 1e-10 (or is NaN) changes nothing, so the state freezes where
    the JAX loop would have stopped, with no host sync per step.

    The Jacobian is forward-mode AD, as ``jax.jacfwd``: one dual evaluation
    of the residuals at 9 copies of x whose tangents are the unit vectors
    (the projection takes a camera batch), so a step costs two batched
    residual evaluations and no per-direction loop."""
    import torch.autograd.forward_ad as fwAD

    def residuals(x, vox, img, mask):  # (B, 9) -> (B, R)
        u, v, _ = project_points(vox, x[:, 0:3], x[:, 3:6], x[:, 6], x[:, 7], x[:, 8])
        r = (torch.stack([u, v], dim=-1) - img) * mask[:, None]
        if loss_type == "L1":
            # Smooth |r| so the Jacobian exists everywhere.
            r = torch.sqrt(r * r + 1e-12) * mask[:, None]
        return r.reshape(x.shape[0], -1)

    def loss(x):  # (B, 9) -> (B,)
        r = residuals(x, vox_kps, img_kps, kp_mask)
        return (r * r).sum(dim=1) if loss_type == "L2" else r.abs().sum(dim=1)

    eye = torch.eye(9, dtype=torch.float32, device=x0.device)
    x = x0
    lam = torch.tensor(1e-3, dtype=torch.float32, device=x0.device)
    dn = torch.tensor(1.0, dtype=torch.float32, device=x0.device)
    with _FORWARD_AD_LOCK, fwAD.dual_level():
        # The keypoints enter as duals with zero tangents: forward AD of an
        # op that mixes dual and plain operands takes a slow decomposition.
        consts = [fwAD.make_dual(t, torch.zeros_like(t)) for t in (vox_kps, img_kps, kp_mask)]
        for _ in range(max_iters):
            active = dn > 1e-10
            r = residuals(fwAD.make_dual(x.expand(9, 9).clone(), eye), *consts)
            if loss_type == "L1":
                # LM on the squared residuals: for L1 they are sqrt(|r|), so
                # LM minimises Σ|r| via IRLS.
                r = torch.sqrt(r.abs() + 1e-12)
            out = fwAD.unpack_dual(r)
            r, J = out.primal[0], out.tangent.T  # (R,), (R, 9)
            JtJ = (J[:, :, None] * J[:, None, :]).sum(dim=0)
            g = (J * r[:, None]).sum(dim=0)
            delta = torch.linalg.solve_ex(JtJ + lam * eye, -g)[0]
            x_new = torch.clamp(x + delta, lo, hi)
            l_new, l_old = loss(torch.stack([x_new, x]))
            better = l_new < l_old
            lam_new = torch.clamp(torch.where(better, lam * 0.5, lam * 4.0), 1e-8, 1e12)
            x = torch.where(active & better, x_new, x)
            lam = torch.where(active, lam_new, lam)
            dn = torch.where(active, torch.sqrt((delta * delta).sum()), dn)
    return x, loss(x[None])[0]


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
    H, W = image_hw
    keys = list(image_keypoints.keys())
    vox = torch.tensor(np.stack([voxel_keypoints[k] for k in keys]).astype(np.float32), device=device)
    img = torch.tensor(np.stack([image_keypoints[k] for k in keys]).astype(np.float32), device=device)
    kp_mask = torch.ones(len(keys), dtype=torch.float32, device=device)
    x0 = np.concatenate(
        [
            np.asarray(init_params["cam_pos"], np.float64),
            np.asarray(init_params["target"], np.float64),
            [init_params["f"], init_params["cx"], init_params["cy"]],
        ]
    )
    lo, hi = default_bounds(H, W)
    x0 = np.clip(x0.astype(np.float32), lo, hi)
    as_dev = lambda a: torch.tensor(a, device=device)  # noqa: E731
    x, fun = _lm_fit(as_dev(x0), vox, img, kp_mask, as_dev(lo), as_dev(hi), loss_type=loss_type)
    x = x.cpu().numpy().astype(np.float64)
    return {
        "cam_pos": x[0:3],
        "target": x[3:6],
        "f": float(x[6]),
        "cx": float(x[7]),
        "cy": float(x[8]),
        "loss": float(fun),
    }
