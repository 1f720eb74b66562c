"""Low-level pinhole-camera math, as in ``pbr3d.ops.cameramath``.

The camera is 9 DoF: cam_pos (3), target (3), f, cx, cy; the up vector is
(0, 1, 0), with (0, 0, 1) when the view direction is (anti)parallel to it;
``u = (X/Z)·f + cx``, ``v = -(Y/Z)·f + cy`` with Z clamped to >= 1e-8
(reference: utils/camera_geometry.py:3-27).

Rounding.  Every function here is float32 elementwise work — no matmul, so
no TF32 on any device.  The JAX package's CPU backend fuses each ``a*b + c``
into one FMA, which rounds once; torch has no fma op, and its CPU float32
``sqrt`` is not correctly rounded.  So :func:`_fma` and :func:`_sqrt` take the
float64 route: the product of two float32 values is exact in float64, and
the one sum rounds twice (float64, then float32), which equals a single
rounding except at exact midpoints.  With that, rotations and ``(u, v, Z)``
are bit-equal to the JAX package on the CPU, and a splat's pixel rounding
agrees on the card too.  Cameras may carry leading batch dimensions:
``cam_pos``/``target`` ``(..., 3)`` and ``f``/``cx``/``cy`` ``(...)`` broadcast
against ``(N,)`` point columns into ``(..., N)`` outputs.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


#: ``jnp.isclose(a, 1.0)``'s bound ``atol + rtol * |1.0|``, in float32.
_ISCLOSE_TOL = float(np.float32(1e-8) + np.float32(1e-5))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a*b + c`` rounded once (see the module docstring)."""
    return (a.double() * b.double() + c.double()).float()


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root."""
    return torch.sqrt(x.double()).float()


def _norm(v: torch.Tensor) -> torch.Tensor:
    """|v| over the last axis (3), summed in index order with fused adds."""
    return _sqrt(_fma(v[..., 2], v[..., 2], _fma(v[..., 1], v[..., 1], v[..., 0] * v[..., 0])))


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [_fma(a[..., i], b[..., j], -(a[..., j] * b[..., i])) for i, j in ((1, 2), (2, 0), (0, 1))],
        dim=-1,
    )


def look_at_rotation_np(eye, target) -> np.ndarray:
    """Numpy float64 mirror of :func:`look_at_rotation` for host callers
    (same degenerate-up fallback)."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    up_default = np.array([0.0, 1.0, 0.0])
    up_fallback = np.array([0.0, 0.0, 1.0])
    z = target - eye
    z = z / np.linalg.norm(z)
    up = up_fallback if np.isclose(abs(float(np.dot(z, up_default))), 1.0) else up_default
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=0)


def look_at_rotation(eye: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """World->camera rotation ``(..., 3, 3)`` (rows are the camera x/y/z axes
    in world coordinates) from float32 ``(..., 3)`` eye and target."""
    z = target - eye
    z = z / _norm(z)[..., None]
    degenerate = (z[..., 1].detach().abs() - 1.0).abs() <= _ISCLOSE_TOL
    # cross(up, z) for up = (0, 1, 0), or (0, 0, 1) when degenerate: each
    # component is one product by 1 plus products by 0, hence exact.
    zero = z[..., 0] - z[..., 0]
    x = torch.where(
        degenerate[..., None],
        torch.stack([-z[..., 1], z[..., 0], zero], dim=-1),
        torch.stack([z[..., 2], zero, -z[..., 0]], dim=-1),
    )
    x = x / _norm(x)[..., None]
    y = _cross(z, x)
    return torch.stack([x, y, z], dim=-2)


def _as_f32(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(a, np.float32), device=device)


def _cam_tensors(cam_pos, target, f, cx, cy, device):
    return tuple(_as_f32(a, device) for a in (cam_pos, target, f, cx, cy))


def camera_rays(pts: torch.Tensor, cam_pos, target) -> torch.Tensor:
    """(N, 3) world points -> (..., N, 3) camera-frame coordinates."""
    pts = pts.to(torch.float32)
    cam_pos, target, *_ = _cam_tensors(cam_pos, target, 0, 0, 0, pts.device)
    R = look_at_rotation(cam_pos, target)
    d = [pts[:, i] - cam_pos[..., i, None] for i in range(3)]
    return torch.stack(
        [_fma(R[..., r, 2, None], d[2], _fma(R[..., r, 0, None], d[0], R[..., r, 1, None] * d[1]))
         for r in range(3)],
        dim=-1,
    )


def project_points_soa(
    xs: torch.Tensor,
    ys: torch.Tensor,
    zs: torch.Tensor,
    cam_pos,
    target,
    f,
    cx,
    cy,
    z_clamp: float = 1e-8,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Structure-of-arrays projection: three (N,) float32 coordinate vectors
    in, (u, v, Z_cam) out, each ``(..., N)`` for a camera batch ``(...)``.
    Nine fused multiply-adds per point, then the Z clamp."""
    cam_pos, target, f, cx, cy = _cam_tensors(cam_pos, target, f, cx, cy, xs.device)
    R = look_at_rotation(cam_pos, target)
    d = (xs - cam_pos[..., 0, None], ys - cam_pos[..., 1, None], zs - cam_pos[..., 2, None])

    def row(r):
        Rr = R[..., r, :, None]
        return _fma(Rr[..., 2, :], d[2], _fma(Rr[..., 0, :], d[0], Rr[..., 1, :] * d[1]))

    X, Y, Z = row(0), row(1), row(2)
    Zc = torch.clamp_min(Z, z_clamp)
    u = _fma(X / Zc, f[..., None], cx[..., None])
    v = _fma(-(Y / Zc), f[..., None], cy[..., None])
    return u, v, Z


def project_points(
    pts: torch.Tensor,
    cam_pos,
    target,
    f,
    cx,
    cy,
    z_clamp: float = 1e-8,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project (N, 3) points (or point sets ``(..., N, 3)`` whose leading
    dimensions broadcast against the cameras'); returns (u, v, Z_cam), Z
    clamped to ``z_clamp`` exactly like the reference's vectorized splat path
    (utils/projection_utils.py:9-14)."""
    pts = pts.to(torch.float32)
    return project_points_soa(pts[..., 0], pts[..., 1], pts[..., 2], cam_pos, target, f, cx, cy, z_clamp)
