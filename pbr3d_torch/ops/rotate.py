"""Host float64 planners of the Y-axis rotate-and-carve sweep, and the two
rotations that execute them on a device (:func:`rotate_y`,
:func:`rotate_y_binary_u8`).

The planners are copied verbatim from ``pbr3d.ops.rotate`` (whose module
imports jax).  These
plans are the state the port carries across from the JAX package: the corner
gather indices and the per-pixel 16-bit decision LUTs are computed on the
host in float64, with scipy's evaluation order, so that the device sweep
needs only integer gathers and bit operations and stays bit-exact against
``scipy.ndimage.affine_transform(order=1)`` on uint8 grids.  Rebuilding them
in float32 on the card would move exact-0.5 ties and break that.

Reference semantics (utils/voxel_carving_utils.py:104-126,65-69):

* center-pinned inverse mapping: output voxel ``o`` samples the input at
  ``Rinv @ (o - c) + c`` with ``c = shape / 2``;
* trilinear (order=1) interpolation, zero fill outside the grid;
* the uint8 output is the *rounded* interpolant, half away from zero — for
  {0,1} grids that is a ``>= 0.5`` threshold.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def rotation_matrix_inv(angle_deg: float) -> np.ndarray:
    """Inverse of the Y-axis rotation (reference: voxel_carving_utils.py:65-69)."""
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    R = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    return np.linalg.inv(R)


@functools.lru_cache(maxsize=256)
def _coord_plan(W: int, D: int, angle_deg: float):
    """Shared float64 source-coordinate computation for one (shape, angle).

    Returns ``(x0, z0, fx, fz, inside)`` flat arrays over the (W*D) output
    (x, z) lattice.

    Matches scipy's float64 evaluation order bit-for-bit: the y row/col of
    Rinv is exactly [0, 1, 0] so y drops out, and scipy's C kernel
    accumulates ``offset + Σ_j m[i,j]·o[j]`` offset-FIRST (verified against
    scipy 1.17).  ``inside`` implements scipy's mode="constant" (NOT
    "grid-constant"): a sample outside [0, size-1] on any axis is cval (0)
    outright, classified on the unsnapped coordinates.  Coordinates within
    1e-9 of an integer are then snapped for the corner/weight computation,
    collapsing multiples of 90° to exact permutations.
    """
    c = np.array([W, 0.0, D], np.float64) / 2.0  # y center cancels in x/z rows
    Rinv = rotation_matrix_inv(angle_deg)
    offset = c - Rinv @ c
    ox, oz = np.meshgrid(
        np.arange(W, dtype=np.float64), np.arange(D, dtype=np.float64), indexing="ij"
    )
    src_x = (offset[0] + Rinv[0, 0] * ox + Rinv[0, 2] * oz).ravel()
    src_z = (offset[2] + Rinv[2, 0] * ox + Rinv[2, 2] * oz).ravel()

    inside = (src_x >= 0) & (src_x <= W - 1) & (src_z >= 0) & (src_z <= D - 1)

    def _snap(v):
        r = np.round(v)
        return np.where(np.abs(v - r) < 1e-9, r, v)

    src_x = _snap(src_x)
    src_z = _snap(src_z)
    x0 = np.floor(src_x)
    z0 = np.floor(src_z)
    return x0, z0, src_x - x0, src_z - z0, inside


@functools.lru_cache(maxsize=256)
def _gather_plan(
    W: int, D: int, angle_deg: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Corner gather indices & weights for a (W, ·, D) grid rotated by angle.

    Returns ``idx (k, W*D) int32`` flat indices into the (W*D)-flattened (x,z)
    plane and ``w (k, W*D) float32`` weights (zero where the sample falls
    outside the grid -> constant-0 fill).  k is 1 for exact-permutation
    angles, else 4.
    """
    x0, z0, fx, fz, inside = _coord_plan(W, D, float(angle_deg))

    if np.all(fx[inside] < 1e-12) and np.all(fz[inside] < 1e-12):
        # Exact permutation (0/90/180/270 with matching dims).
        xi = x0.astype(np.int64)
        zi = z0.astype(np.int64)
        idx = np.where(inside, np.clip(xi, 0, W - 1) * D + np.clip(zi, 0, D - 1), 0)
        return idx.astype(np.int32)[None], inside.astype(np.float32)[None]

    idxs, ws = [], []
    for ddx, wx in ((0.0, 1.0 - fx), (1.0, fx)):
        for ddz, wz in ((0.0, 1.0 - fz), (1.0, fz)):
            xi = np.clip((x0 + ddx).astype(np.int64), 0, W - 1)
            zi = np.clip((z0 + ddz).astype(np.int64), 0, D - 1)
            idxs.append((xi * D + zi).astype(np.int32))
            ws.append(np.where(inside, wx * wz, 0.0).astype(np.float32))
    return np.stack(idxs), np.stack(ws)


def rotate_y(grid, angle_deg: float, *, device) -> torch.Tensor:
    """Rotate a (W, H, D) grid about +Y by ``angle_deg`` (trilinear), in
    float32 on ``device``.

    Returns the raw interpolant (no rounding); zeros outside the grid.  The
    corner terms add up in the JAX package's order, ``out + w[k] * g_k``,
    product and sum each rounded: XLA's CPU backend does not fuse this sum
    into FMAs (bit-equal in ``tests/test_torch_stage1_api.py``), and eager
    torch runs the multiply and the add as two kernels on any device.
    """
    grid = torch.as_tensor(grid, device=device).to(torch.float32)
    W, H, D = grid.shape
    if float(angle_deg) % 360.0 == 0.0:
        return grid
    idx, w = _gather_plan(W, D, float(angle_deg))
    # (W,H,D) -> (H, W*D): y becomes the batch axis, gathers hit axis 1.
    g2 = grid.permute(1, 0, 2).reshape(H, W * D)
    idx = torch.from_numpy(idx).to(device=device, dtype=torch.int64)
    w = torch.from_numpy(w).to(device)
    out = torch.zeros_like(g2)
    for k in range(idx.shape[0]):
        out = out + w[k] * torch.index_select(g2, 1, idx[k])
    return out.view(H, W, D).permute(1, 0, 2)


@functools.lru_cache(maxsize=256)
def _binary_plan(W: int, D: int, angle_deg: float):
    """Decision-LUT plan for bit-exact binary rotation.

    For a {0,1} grid, the rounded interpolant at an output pixel depends only
    on *which* of its 4 corners are occupied — 16 cases.  We evaluate all 16
    subset sums in float64 on the host (same accumulation order as scipy's
    spline kernel) and pack the ``>= 0.5`` decisions into a per-pixel 16-bit
    mask.  The device kernel then needs only integer gathers and bit ops —
    bit-exact against scipy regardless of on-device float precision.

    Returns ``(idx (4, W*D) int32, dec (W*D) int32)`` or None for
    exact-permutation angles (handled by the generic plan).
    """
    idx, w = _gather_plan(W, D, float(angle_deg))
    if idx.shape[0] == 1:
        return None
    # Float64 corner weights from the SAME (snapped) coordinates the gather
    # indices were built from — the f32 cast in _gather_plan loses the bits
    # that decide exact-0.5 ties.
    _, _, fx, fz, inside = _coord_plan(W, D, float(angle_deg))
    corner_w = [
        (1.0 - fx) * (1.0 - fz),
        (1.0 - fx) * fz,
        fx * (1.0 - fz),
        fx * fz,
    ]
    dec = np.zeros(W * D, np.int32)
    for code in range(16):
        s = np.zeros(W * D, np.float64)
        for k in range(4):
            if (code >> k) & 1:
                s = s + corner_w[k]
        dec |= ((s >= 0.5) & inside).astype(np.int32) << code
    return idx, dec


@functools.lru_cache(maxsize=512)
def lut_plan(W: int, D: int, angle_deg: float) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform LUT form of the binary rotation for ANY angle.

    Returns ``(idx (4, W*D) int32, dec (W*D) int32)`` usable by the scan-based
    carve sweep: gather the 4 corner occupancies, form a 4-bit code, and read
    the per-pixel decision bit.  Exact-permutation angles are encoded with all
    four corners equal to the source cell and decision mask 0xAAAA (out =
    corner-0 bit) gated by the inside mask — so every angle shares one device
    program shape.
    """
    plan = _binary_plan(W, D, float(angle_deg))
    if plan is not None:
        return plan
    idx1, w1 = _gather_plan(W, D, float(angle_deg))  # permutation form
    idx = np.broadcast_to(idx1[0], (4, idx1.shape[1])).copy()
    dec = np.where(w1[0] > 0, np.int32(0xAAAA), np.int32(0)).astype(np.int32)
    return idx, dec


@functools.lru_cache(maxsize=512)
def lut_plan_embedded(
    W: int, D: int, Wp: int, Dp: int, angle_deg: float
) -> Tuple[np.ndarray, np.ndarray]:
    """LUT plan for a (W, ·, D) grid EMBEDDED at the origin of a padded
    (Wp, ·, Dp) grid.

    The corner indices and float64 decisions are computed in the ORIGINAL
    frame (identical bits to :func:`lut_plan`), then re-addressed into the
    padded flat layout; padded output pixels get decision 0 (always empty).
    A sweep on the padded grid therefore produces BIT-IDENTICAL content in
    the original region while sharing one compiled executable across every
    crop that fits the bucket — the key trick for a backend where every
    distinct program shape is a fresh (slow) remote compile.
    """
    idx, dec = lut_plan(W, D, float(angle_deg))
    k = idx.shape[0]
    # original flat (xi*D + zi) -> padded flat (xi*Dp + zi)
    xi = idx // D
    zi = idx % D
    idx_p = xi * Dp + zi
    out_idx = np.zeros((k, Wp * Dp), np.int32)
    out_dec = np.zeros((Wp * Dp,), np.int32)
    # positions of original output pixels inside the padded flat layout
    ox, oz = np.meshgrid(np.arange(W), np.arange(D), indexing="ij")
    pos = (ox * Dp + oz).ravel()
    out_idx[:, pos] = idx_p
    out_dec[pos] = dec
    return out_idx, out_dec


def rotate_y_binary_u8(grid, angle_deg: float, *, device) -> torch.Tensor:
    """Rotate a {0,1} grid, bit-exactly reproducing scipy's uint8 path.

    Equivalent to ``affine_transform(uint8_grid, ...)`` for binary grids:
    trilinear-interpolate in float64, round half away from zero.  Implemented
    with the per-pixel decision LUT of :func:`_binary_plan` — integer gathers
    and bit operations only; exact-permutation angles (90°, 180°) go through
    :func:`rotate_y` and a ``>= 0.5`` threshold.  The result has the input's
    dtype (float32 {0., 1.} in the JAX package's carve chain).
    """
    grid = torch.as_tensor(grid, device=device)
    if float(angle_deg) % 360.0 == 0.0:
        return grid
    W, H, D = grid.shape
    plan = _binary_plan(W, D, float(angle_deg))
    if plan is None:  # exact permutation — single masked gather
        return (rotate_y(grid, angle_deg, device=device) >= 0.5).to(grid.dtype)
    idx, dec = plan
    idx = torch.from_numpy(idx).to(device=device, dtype=torch.int64)
    dec = torch.from_numpy(dec).to(device)
    g2 = (grid.permute(1, 0, 2).reshape(H, W * D) > 0).to(torch.uint8)
    code = torch.zeros_like(g2)
    for k in range(4):
        code |= torch.index_select(g2, 1, idx[k]) << k
    bit = code.to(torch.int32)
    torch.bitwise_right_shift(dec[None, :], bit, out=bit)
    bit &= 1
    return bit.to(grid.dtype).view(H, W, D).permute(1, 0, 2)
