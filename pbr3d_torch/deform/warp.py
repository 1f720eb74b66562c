"""The 4-DoF per-part symmetry-preserving warp, as in ``pbr3d.deform.warp``.

Reference semantics (utils/deformation_estimation.py:70-98, 262-313): for a
part's point set (x, y, z), about its centroid:

    x' = x·scale_xz + shift_xz·(W_vox/W_img)·sign(x)
    y' = y·scale_y  − shift_y ·(H_vox/H_img)
    z' = z·scale_xz + shift_xz·(D_vox/W_img)·sign(z)

applied to 7 jittered copies (±0.25 per axis), then rounded half to even —
a hole-free forward warp that keeps left/right and front/back symmetry.  The
voxel shape reads (D, H, W) = grid.shape[:3], as the reference indexes it.

Batching.  ``deforms`` is ``(..., 4)``: a ``(P, 4)`` candidate batch warps
``(N,)`` coordinates into ``(P, N)`` (approx) or ``(P, 7N)`` (exact, the
jitter copies jitter-major) outputs.

Rounding.  XLA's CPU backend fuses the first product of each axis with the
sum that follows, ``fma(c, scale, shift·p·sign(c)) + center`` (and
``fma(c_y, scale_y, −shift_y·p_y)``); the warp takes the same contraction
through :func:`pbr3d_torch.ops.cameramath._fma`, so warped coordinates are
bit-equal to the JAX package's on the CPU.  ``p`` is a float32 division of
float32 extents.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from pbr3d_torch import config
from pbr3d_torch.ops.cameramath import _fma

_JITTER = np.array(
    [
        [0, 0, 0],
        [0.25, 0, 0], [-0.25, 0, 0],
        [0, 0.25, 0], [0, -0.25, 0],
        [0, 0, 0.25], [0, 0, -0.25],
    ],
    np.float32,
)


def _pixel_ratios(image_hw, voxel_shape, device) -> Tuple[torch.Tensor, ...]:
    """(px, py, pz) = (W/W_img, H/H_img, D/W_img), float32 divisions."""
    (h_img, w_img), (D, H, W) = image_hw, voxel_shape
    f32 = np.float32
    return tuple(torch.tensor(v, device=device) for v in (
        f32(W) / f32(w_img), f32(H) / f32(h_img), f32(D) / f32(w_img)))


def _warp(cx, cy, cz, sy, dy, sxz, dxz, center, px, py, pz):
    """The centred warp plus the centroid, in XLA's fusion pattern."""
    xw = _fma(cx, sxz, dxz * px * torch.sign(cx)) + center[0]
    yw = _fma(cy, sy, -(dy * py)) + center[1]
    zw = _fma(cz, sxz, dxz * pz * torch.sign(cz)) + center[2]
    return xw, yw, zw


def deform_coords_soa(
    coords: torch.Tensor,  # (N, 3) int16/float32 (x, y, z)
    valid,  # (N,) bool or None (all valid)
    image_hw,  # (H_img, W_img)
    voxel_shape,  # (D, H, W)
    deforms: torch.Tensor,  # (..., 4): scale_y, shift_y, scale_xz, shift_xz
    center: torch.Tensor,  # (3,) float32 — the FULL part centroid
    approx: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(xs, ys, zs, valid), each ``(..., N)`` float32 (approx: the warped
    floats, no jitter) or ``(..., 7N)`` (exact: 7 jittered copies rounded
    half to even, as float32 integers).  Points leaving the grid are marked
    invalid (deformation_estimation.py:105-111)."""
    dev = coords.device
    c = coords.to(torch.float32)
    center = torch.as_tensor(center, dtype=torch.float32, device=dev)
    deforms = torch.as_tensor(deforms, dtype=torch.float32, device=dev)
    px, py, pz = _pixel_ratios(image_hw, voxel_shape, dev)
    D, H, W = (float(v) for v in voxel_shape)
    d = [deforms[..., i, None] for i in range(4)]
    xw, yw, zw = _warp(c[:, 0] - center[0], c[:, 1] - center[1], c[:, 2] - center[2],
                       *d, center, px, py, pz)
    lead = xw.shape[:-1]
    if approx:
        inb = ((xw >= -0.5) & (xw < W - 0.5) & (yw >= -0.5) & (yw < H - 0.5)
               & (zw >= -0.5) & (zw < D - 0.5))
        return xw, yw, zw, inb if valid is None else inb & valid
    jit = torch.from_numpy(_JITTER).to(dev)

    def jitter(w, axis):
        return torch.round(w[..., None, :] + jit[:, axis, None]).reshape(*lead, -1)

    xs, ys, zs = jitter(xw, 0), jitter(yw, 1), jitter(zw, 2)
    inb = ((xs >= 0) & (xs <= W - 1) & (ys >= 0) & (ys <= H - 1)
           & (zs >= 0) & (zs <= D - 1))
    if valid is not None:
        inb = inb & valid.repeat(7)
    return xs, ys, zs, inb


def deform_coords(
    coords: torch.Tensor,
    valid,
    image_hw,
    voxel_shape,
    deforms: torch.Tensor,
    center: torch.Tensor,
    approx: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """AoS form of :func:`deform_coords_soa`: ``(..., M, 3)`` coordinates
    (float32 for approx, int64 for exact) and ``(..., M)`` validity."""
    xs, ys, zs, v = deform_coords_soa(coords, valid, image_hw, voxel_shape,
                                      deforms, center, approx)
    out = torch.stack([xs, ys, zs], dim=-1)
    return (out if approx else out.to(torch.int64)), v


def scatter_part(
    grid: torch.Tensor,  # (D, H, W) uint8 label grid (accumulator)
    coords: torch.Tensor,  # (M, 3) int (x, y, z)
    valid: torch.Tensor,  # (M,)
    label: int,
) -> torch.Tensor:
    """``grid[z, y, x] = label`` for the valid points, in place
    (deformation_estimation.py:120-124).  Every write of one part carries
    the same label, so duplicate cells are harmless."""
    D, H, W = grid.shape
    c = coords[valid].to(torch.int64)
    flat = (c[:, 2] * H + c[:, 1]) * W + c[:, 0]
    grid.view(-1).index_fill_(0, flat, label)
    return grid


def build_deformed_grid(
    voxel_shape: Tuple[int, int, int],
    part_points: Dict[str, torch.Tensor],
    deforms: Dict[str, np.ndarray],
    centers: Dict[str, np.ndarray],
    image_hw: Tuple[int, int],
    part_order: Sequence[str],
) -> torch.Tensor:
    """Sequential rebuild (reference ``save_deformed_grid``,
    deformation_estimation.py:288-313): one warp + scatter per part in
    ``part_order``, later parts overwriting earlier ones.  Parts without a
    deform are skipped."""
    dev = next(iter(part_points.values())).device
    out = torch.zeros(tuple(voxel_shape), dtype=torch.uint8, device=dev)
    for part in part_order:
        if part not in deforms or part not in part_points:
            continue
        c, v = deform_coords(
            part_points[part], None, image_hw, voxel_shape,
            torch.as_tensor(np.asarray(deforms[part], np.float32), device=dev),
            torch.as_tensor(np.asarray(centers[part], np.float32), device=dev),
        )
        scatter_part(out, c, v, config.PART_IDS[part])
    return out


#: Points warped per pass of the fused rebuild; bounds the (7, n) work
#: tensors (the 11.4 M-point Bibi@512 rebuild is 80 M keys).
_REBUILD_CHUNK = 1 << 22


def build_deformed_grid_fused(
    part_points: Dict[str, torch.Tensor],
    deforms: Dict[str, np.ndarray],
    centers: Dict[str, np.ndarray],
    image_hw: Tuple[int, int],
    voxel_shape: Tuple[int, int, int],
    part_order: Sequence[str],
) -> torch.Tensor:
    """Every part's warp and the whole grid scatter as one reduction;
    returns the device uint8 label grid.

    Sequential per-part scatters resolve voxel collisions by part order,
    later parts winning.  The same result in one pass: warp every point
    with its part's deform, then keep per voxel the maximum of the int64
    key ``point_index*7 + jitter`` — monotone in the concatenated part
    order, so the winner is the sequential one.  The points are warped in
    chunks; the key stays global."""
    parts = [p for p in part_order if p in deforms]
    D, H, W = (int(v) for v in voxel_shape)
    dev = next(iter(part_points.values())).device
    winner = torch.full((D * H * W + 1,), -1, dtype=torch.int64, device=dev)
    labels = []
    base = 0
    jit = torch.arange(7, dtype=torch.int64, device=dev)[:, None]
    for part in parts:
        pts = part_points[part]
        d = torch.as_tensor(np.asarray(deforms[part], np.float32), device=dev)
        ctr = torch.as_tensor(np.asarray(centers[part], np.float32), device=dev)
        for s in range(0, pts.shape[0], _REBUILD_CHUNK):
            chunk = pts[s:s + _REBUILD_CHUNK]
            xs, ys, zs, ok = deform_coords_soa(chunk, None, image_hw, voxel_shape, d, ctr)
            vox = ((zs.to(torch.int64) * H + ys.to(torch.int64)) * W + xs.to(torch.int64))
            vox = torch.where(ok, vox, D * H * W)
            order = (torch.arange(chunk.shape[0], dtype=torch.int64, device=dev)
                     + (base + s))[None, :] * 7 + jit
            key = torch.where(ok, order.reshape(-1), -1)
            winner.scatter_reduce_(0, vox, key, "amax", include_self=True)
        labels.append(torch.full((pts.shape[0],), config.PART_IDS[part],
                                 dtype=torch.uint8, device=dev))
        base += pts.shape[0]
    winner = winner[: D * H * W]
    if not labels:
        return torch.zeros((D, H, W), dtype=torch.uint8, device=dev)
    lab = torch.cat(labels)[(winner // 7).clamp_min(0)]
    return torch.where(winner >= 0, lab, 0).to(torch.uint8).reshape(D, H, W)
