"""Camera parameterisation helpers, as in ``pbr3d.camera.geometry``.

The camera is 9 DoF (cam_pos, target, f, cx, cy) with a fixed up vector;
the projection math lives in ``pbr3d_torch.ops.cameramath``.  The rig
transforms below (yaw, dolly-zoom, principal-point reparameterisation) are
float64 host math on camera dicts, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pbr3d_torch.ops.cameramath import (  # noqa: F401  (re-exported)
    camera_rays,
    look_at_rotation,
    look_at_rotation_np,
    project_points,
)


def yaw_camera_about_center(cam: Dict, grid_shape, deg: float) -> Dict:
    """Rotate the camera rig (position and target) about the voxel grid
    centre's vertical (y) axis — one start per branch of the monuments'
    4-fold symmetry, which leaves an oblique view's azimuth ambiguous."""
    center = np.asarray(grid_shape[:3], np.float64)[[2, 1, 0]] / 2.0  # (x,y,z)
    a = np.deg2rad(deg)
    R = np.array(
        [[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
         [-np.sin(a), 0.0, np.cos(a)]]
    )
    out = dict(cam)
    out["cam_pos"] = center + R @ (np.asarray(cam["cam_pos"], np.float64) - center)
    out["target"] = center + R @ (np.asarray(cam["target"], np.float64) - center)
    return out


def dolly_zoom(cam: Dict, s: float) -> Dict:
    """Push the camera back s× along the optical axis while zooming f by s
    (image size preserved at the target depth)."""
    c = np.asarray(cam["cam_pos"], np.float64)
    t = np.asarray(cam["target"], np.float64)
    out = dict(cam)
    out["cam_pos"] = t + (c - t) * s
    out["f"] = float(cam["f"]) * s
    return out


def reparam_principal_point(
    cam: Dict, cx_new: float = 0.0, cy_new: float = 0.0
) -> Dict:
    """Move the principal point to (cx_new, cy_new) and retarget along

        ẑ' ∝ ẑ + ((cx'−cx)/f)·x̂ + ((cy−cy')/f)·ŷ

    which preserves the projection to first order — a walk along the
    (target, cx, cy) ridge that single-DoF probes cannot make."""
    c = np.asarray(cam["cam_pos"], np.float64)
    t = np.asarray(cam["target"], np.float64)
    f = float(cam["f"])
    cx, cy = float(cam["cx"]), float(cam["cy"])
    R = look_at_rotation_np(c, t)
    xhat, yhat, zhat = R[0], R[1], R[2]
    a = (cx_new - cx) / f
    b = (cy - cy_new) / f
    z2 = zhat + a * xhat + b * yhat
    z2 = z2 / np.linalg.norm(z2)
    dist = float(np.linalg.norm(t - c))
    out = dict(cam)
    out["target"] = c + dist * z2
    out["cx"] = float(cx_new)
    out["cy"] = float(cy_new)
    return out


def project_point(pt, cam: Dict, *, device) -> torch.Tensor:
    """(u, v) float32 of one point on ``device`` (reference ``project``,
    utils/camera_geometry.py:17-27)."""
    p = torch.as_tensor(np.asarray(pt, np.float32), device=device)[None]
    u, v, _ = project_points(p, cam["cam_pos"], cam["target"], cam["f"], cam["cx"], cam["cy"])
    return torch.stack([u[0], v[0]])


def params_to_vector(cam: Dict) -> np.ndarray:
    """Camera dict -> 9-vector (float32, host array)."""
    return np.concatenate(
        [
            np.asarray(cam["cam_pos"], np.float32).ravel(),
            np.asarray(cam["target"], np.float32).ravel(),
            np.asarray([cam["f"], cam["cx"], cam["cy"]], np.float32),
        ]
    )


def vector_to_params(x, H: int | None = None, W: int | None = None) -> Dict:
    """9-vector (host array or tensor) -> camera dict, with H/W if given."""
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    out = {
        "cam_pos": x[0:3],
        "target": x[3:6],
        "f": x[6],
        "cx": x[7],
        "cy": x[8],
    }
    if H is not None:
        out["H"] = H
        out["W"] = W
    return out
