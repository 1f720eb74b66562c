"""Point-splat projection, z-buffering and mask IoU, as in
``pbr3d.ops.projection``.

Reference semantics replicated:

* splat projector (utils/projection_utils.py:5-23): round u/v half to even,
  keep in-bounds points, last point wins on collisions.  The winner is the
  per-pixel max of the int64 key ``order*256 + label``, one
  ``scatter_reduce(amax)`` into ``H*W + 1`` buckets (the last is the dump for
  points off the plane) — deterministic on any device, and good for any N.
* z-buffer (utils/eval_helpers_intra.py:134-160): per-pixel min camera Z of
  all points with Z > 1e-6, a ``scatter_reduce(amin)``.
* visibility-aware part projection (utils/eval_helpers_intra.py:168-190):
  pixel on iff some point has |Z - zbuf| < eps.
* per-part colour-exact IoU (utils/camera_estimation.py:770-788).

The port pads nothing, so planes are allocated at their true (H, W) and the
JAX package's ``true_hw`` bound is not needed.  ``point_valid`` may be None
(every point valid).  :func:`splat_labels` and :func:`zbuffer_soa` take a
camera batch (see ``pbr3d_torch.ops.cameramath``) and return ``(..., H, W)``
planes; the mask-IoU camera search evaluates its candidates that way.  The
JAX package's one-hot matmul surrogate ``splat_partwise_iou_mm`` is not
ported: the port runs the exact splat everywhere.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pbr3d_torch.ops.cameramath import project_points, project_points_soa


def _pixel_index(
    u: torch.Tensor, v: torch.Tensor, valid, H: int, W: int, true_hw=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Round to integer pixels (half to even, as ``jnp.round``); returns
    (int64 flat index with dump bucket H*W, in-bounds mask).  Bounds are
    tested on the rounded floats, so no cast can overflow; ``true_hw`` gives
    them as tensors where planes of several sizes share one (H, W) allocation."""
    ur, vr = torch.round(u), torch.round(v)
    Ht, Wt = (H, W) if true_hw is None else true_hw
    ok = (ur >= 0) & (ur < Wt) & (vr >= 0) & (vr < Ht)
    if valid is not None:
        ok = ok & valid
    pix = torch.where(ok, vr.to(torch.int64) * W + ur.to(torch.int64), H * W)
    return pix, ok


def _segment(vals: torch.Tensor, seg: torch.Tensor, n: int, reduce: str, init) -> torch.Tensor:
    """Per-segment ``reduce`` ("amax"/"amin"/"sum") of ``vals`` over the last
    axis into ``(..., n)`` buckets that start at ``init``."""
    out = torch.full((*vals.shape[:-1], n), init, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(-1, seg, vals, reduce, include_self=True)


def splat_labels(
    pts: torch.Tensor,
    labels: torch.Tensor,
    point_valid,
    cam_pos, target, f, cx, cy,
    H: int, W: int,
    true_hw=None,
) -> torch.Tensor:
    """Project labelled points to a ``(..., H, W)`` uint8 label image,
    last write wins.  ``pts (N, 3)`` float32, ``labels (N,)`` uint8.

    Several point sets at once, each under its own cameras: ``pts
    (V, 1, N, 3)``, ``labels`` and ``point_valid (V, 1, N)`` (sets shorter
    than N padded with invalid points) against cameras ``(V, P)``, with
    ``true_hw = (Ht, Wt)``, each ``(V, 1, 1)``, the image bounds of each set
    inside the shared ``(H, W)`` plane."""
    N = pts.shape[-2]
    u, v, _ = project_points(pts, cam_pos, target, f, cx, cy)
    pix, ok = _pixel_index(u, v, point_valid, H, W, true_hw)
    key = torch.arange(N, dtype=torch.int64, device=pts.device) * 256 + labels.to(torch.int64)
    win = _segment(torch.where(ok, key, -1), pix, H * W + 1, "amax", -1)[..., : H * W]
    img = torch.where(win >= 0, win % 256, 0).to(torch.uint8)
    return img.reshape(*img.shape[:-1], H, W)


def zbuffer_soa(
    xs: torch.Tensor,
    ys: torch.Tensor,
    zs: torch.Tensor,
    point_valid,
    cam_pos, target, f, cx, cy,
    H: int, W: int,
    z_valid_min: float = 1e-6,
) -> torch.Tensor:
    """``(..., H, W)`` float32 min-Z buffer from (N,) coordinate vectors (inf
    where nothing projects)."""
    u, v, Z = project_points_soa(xs, ys, zs, cam_pos, target, f, cx, cy)
    valid = Z > z_valid_min if point_valid is None else point_valid & (Z > z_valid_min)
    pix, ok = _pixel_index(u, v, valid, H, W)
    inf = torch.full_like(Z, float("inf"))
    zb = _segment(torch.where(ok, Z, inf), pix, H * W + 1, "amin", float("inf"))[..., : H * W]
    return zb.reshape(*zb.shape[:-1], H, W)


def zbuffer(
    pts: torch.Tensor,
    point_valid,
    cam_pos, target, f, cx, cy,
    H: int, W: int,
    z_valid_min: float = 1e-6,
) -> torch.Tensor:
    """``(..., H, W)`` float32 min-Z buffer of (N, 3) points (inf where
    nothing projects)."""
    pts = pts.to(torch.float32)
    return zbuffer_soa(pts[:, 0], pts[:, 1], pts[:, 2], point_valid,
                       cam_pos, target, f, cx, cy, H, W, z_valid_min)


def project_visible(
    pts: torch.Tensor,
    point_valid,
    zbuf: torch.Tensor,
    cam_pos, target, f, cx, cy,
    eps: float = 1e-3,
    z_valid_min: float = 1e-6,
) -> torch.Tensor:
    """(H, W) bool mask of pixels where some point is within ``eps`` of the
    z-buffer ``zbuf (H, W)`` (one camera)."""
    H, W = zbuf.shape
    u, v, Z = project_points(pts, cam_pos, target, f, cx, cy)
    valid = Z > z_valid_min if point_valid is None else point_valid & (Z > z_valid_min)
    pix, ok = _pixel_index(u, v, valid, H, W)
    zb_at = zbuf.reshape(-1)[pix.clamp(0, H * W - 1)]
    hit = ok & ((Z - zb_at).abs() < eps)
    count = _segment(hit.to(torch.int32), pix, H * W + 1, "sum", 0)[: H * W]
    return (count > 0).reshape(H, W)


def partwise_zbuffers(
    pts: torch.Tensor,
    labels: torch.Tensor,
    point_valid,
    cam_pos, target, f, cx, cy,
    part_ids,
    H: int, W: int,
    z_valid_min: float = 1e-6,
) -> torch.Tensor:
    """(K, H, W) min-Z buffer per part in one segment reduction (one camera).

    Each point belongs to at most one part, so offsetting the pixel index by
    ``slot * (H*W + 1)`` gives disjoint segment ranges; slot K collects the
    points of no listed part."""
    part_ids = torch.as_tensor(part_ids, device=pts.device)
    K = part_ids.shape[0]
    u, v, Z = project_points(pts, cam_pos, target, f, cx, cy)
    valid = Z > z_valid_min if point_valid is None else point_valid & (Z > z_valid_min)
    pix, ok = _pixel_index(u, v, valid, H, W)
    match = labels.to(torch.int64)[None, :] == part_ids.to(torch.int64)[:, None]
    slot = torch.where(match.any(dim=0), match.to(torch.uint8).argmax(dim=0), K)
    seg = torch.where(ok, slot * (H * W + 1) + pix, (K + 1) * (H * W + 1) - 1)
    inf = torch.full_like(Z, float("inf"))
    zb = _segment(torch.where(ok, Z, inf), seg, (K + 1) * (H * W + 1), "amin", float("inf"))
    return zb.reshape(K + 1, H * W + 1)[:K, : H * W].reshape(K, H, W)


def partwise_zbuffers_grid(
    grid: torch.Tensor,
    cam_vec: torch.Tensor,
    part_ids,
    H: int, W: int,
) -> torch.Tensor:
    """(K, H, W) per-part min-Z buffers straight from a dense ``(D, Hg, Wg)``
    uint8 label grid on the device, for the 9-vector camera ``cam_vec``.
    Only occupied voxels are projected (the empty ones are invalid points in
    the JAX package and never reach a bucket), at (x, y, z) = (d2, d1, d0)."""
    d0, d1, d2 = torch.nonzero(grid, as_tuple=True)
    pts = torch.stack([d2, d1, d0], dim=1).to(torch.float32)
    return partwise_zbuffers(
        pts, grid[d0, d1, d2], None,
        cam_vec[0:3], cam_vec[3:6], cam_vec[6], cam_vec[7], cam_vec[8],
        part_ids, H, W,
    )


def partwise_iou(
    proj_labels: torch.Tensor,
    gt_labels: torch.Tensor,
    part_ids,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Colour-exact per-part IoU ``(..., K)`` and its mean ``(...)`` between
    ``(..., H, W)`` label planes and one ``(H, W)`` ground truth, or ground
    truths whose leading dimensions broadcast against the planes' (reference:
    camera_estimation.py:770-788).  A part with an empty union scores 0.0.
    The mean is the JAX package's: the left-to-right sum times the float32
    reciprocal of K (XLA turns ``jnp.mean``'s division into that product)."""
    part_ids = torch.as_tensor(part_ids, device=proj_labels.device).to(torch.int64)[:, None]
    K = part_ids.shape[0]
    hw = gt_labels.shape[-2] * gt_labels.shape[-1]
    p = proj_labels.reshape(*proj_labels.shape[:-2], 1, hw) == part_ids
    g = gt_labels.reshape(*gt_labels.shape[:-2], 1, hw) == part_ids
    inter = (p & g).sum(dim=-1).to(torch.float32)
    union = (p | g).sum(dim=-1).to(torch.float32)
    iou = torch.where(union > 0, inter / union.clamp_min(1.0), torch.zeros_like(union))
    total = iou[..., 0]
    for k in range(1, K):
        total = total + iou[..., k]
    return iou, total * float(np.float32(1) / np.float32(K))


def binary_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of two boolean masks; NaN when the union is empty
    (reference: eval_helpers_intra.py:268-271)."""
    inter = (a & b).sum().to(torch.float32)
    union = (a | b).sum().to(torch.float32)
    return torch.where(union > 0, inter / union.clamp_min(1.0), torch.full_like(union, float("nan")))
