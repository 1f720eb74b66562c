"""Silhouette carving: the cumulative rotate-and-carve sweep.

Reference semantics (utils/voxel_carving_utils.py:104-126): for
``angle in range(0, 91, angle_interval)`` rotate the *current* grid by that
step's angle (rotations accumulate) and zero the voxels whose (x, y) column
lies outside the mask.

Port of ``pbr3d.ops.carve``: the per-angle plans come from the float64 host
planners in :mod:`pbr3d_torch.ops.rotate`; the device work is, per angle,
four column gathers of a uint8 (H, W*D) occupancy plane, a 4-bit code, one
bit of the pixel's 16-bit decision LUT, and the column mask.  ``lax.scan``
over the angles becomes a Python loop.  Bit-exact against the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pbr3d_torch.ops.rotate import lut_plan, lut_plan_embedded


def carve_with_mask(occ: torch.Tensor, mask_wh: torch.Tensor) -> torch.Tensor:
    """Zero voxels whose (x, y) column lies outside the (W, H) mask."""
    return occ * (mask_wh > 0).to(occ.dtype)[:, :, None]


def sweep_angles(angle_interval: int) -> tuple:
    """The carve sweep schedule: range(0, 91, angle_interval)."""
    return tuple(range(0, 91, int(angle_interval)))


@functools.lru_cache(maxsize=256)
def _stacked_plans(W: int, D: int, angle_interval: int):
    """Stacked (A, 4, N) int32 indices + (A, N) int32 decision LUTs for the
    non-zero sweep angles (the 0° step is a pure mask multiply)."""
    angles = [a for a in sweep_angles(angle_interval) if a % 360 != 0]
    if not angles:
        return (
            np.zeros((0, 4, W * D), np.int32),
            np.zeros((0, W * D), np.int32),
        )
    idxs, decs = zip(*(lut_plan(W, D, float(a)) for a in angles))
    return np.stack(idxs), np.stack(decs)


@functools.lru_cache(maxsize=512)
def _stacked_plans_padded(W: int, D: int, Wp: int, Dp: int, angle_interval: int):
    angles = [a for a in sweep_angles(angle_interval) if a % 360 != 0]
    if not angles:
        return (
            np.zeros((0, 4, Wp * Dp), np.int32),
            np.zeros((0, Wp * Dp), np.int32),
        )
    idxs, decs = zip(*(lut_plan_embedded(W, D, Wp, Dp, float(a)) for a in angles))
    return np.stack(idxs), np.stack(decs)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def plans_to_device(plans, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Host (idx, dec) plans -> (int64 indices, int32 LUTs) on ``device``."""
    idx, dec = plans
    return (
        torch.from_numpy(idx).to(device=device, dtype=torch.int64),
        torch.from_numpy(dec).to(device=device),
    )


def sweep_scan(
    g2: torch.Tensor, m2: torch.Tensor, idx: torch.Tensor, dec: torch.Tensor
) -> torch.Tensor:
    """g2 (H, N) occupancy {0,1}; m2 (H, N) column mask {0,1};
    idx (A, 4, N) int64; dec (A, N) int32 16-bit decision LUTs.

    Returns the carved (H, N) uint8 plane.  The corner reads are
    ``index_select`` along axis 1 of the uint8 plane: a ``gather`` would need
    its index expanded to (H, N) int64, about 1 GB per corner at 512.  The
    LUT shift runs in int32 (torch's uint16 shifts are thin); the decision
    bits are the same.
    """
    m8 = m2.to(torch.uint8)
    g = g2.to(torch.uint8) * m8  # the 0° identity step
    for pidx, pdec in zip(idx, dec):
        code = torch.zeros_like(g)
        for k in range(4):
            code |= torch.index_select(g, 1, pidx[k]) << k
        bit = code.to(torch.int32)
        torch.bitwise_right_shift(pdec[None, :], bit, out=bit)
        bit &= 1
        g = bit.to(torch.uint8)
        g *= m8
    return g


def rotate_carve_sweep(
    occ, mask_wh, angle_interval: int, bucket: int | None = None, *, device,
) -> torch.Tensor:
    """Cumulative rotate-and-carve sweep (reference ``process_voxel_grid``),
    bit-exact vs the scipy uint8 path.

    ``occ``: (W, H, D) {0,1} (any dtype, array or tensor); ``mask_wh``:
    (W, H) — any nonzero kept.  Returns a uint8 (W, H, D) tensor on
    ``device``.  NOTE: the output grid ends up rotated by the *sum* of the
    step angles (e.g. 90° total for interval 90), exactly as in the
    reference.

    ``bucket``: pad every dimension up to a multiple of ``bucket`` and sweep
    at the padded shape with origin-embedded plans
    (:func:`pbr3d_torch.ops.rotate.lut_plan_embedded`); the result in the
    original region is bit-identical.
    """
    occ = (torch.as_tensor(occ, device=device) > 0).to(torch.uint8)
    m_wh = (torch.as_tensor(mask_wh, device=device) > 0).to(torch.uint8)
    W, H, D = occ.shape
    if bucket:
        Wp, Hp, Dp = (_round_up(x, bucket) for x in (W, H, D))
    else:
        Wp, Hp, Dp = W, H, D

    if (Wp, Hp, Dp) == (W, H, D):
        plans = _stacked_plans(W, D, int(angle_interval))
    else:
        plans = _stacked_plans_padded(W, D, Wp, Dp, int(angle_interval))
        occ = torch.nn.functional.pad(occ, (0, Dp - D, 0, Hp - H, 0, Wp - W))
        m_wh = torch.nn.functional.pad(m_wh, (0, Hp - H, 0, Wp - W))
    out = sweep_volume(occ, m_wh, plans_to_device(plans, device))
    return out[:W, :H, :D].contiguous()


def sweep_volume(occ: torch.Tensor, m_wh: torch.Tensor, plans) -> torch.Tensor:
    """Sweep a (W, H, D) uint8 occupancy against a (W, H) column mask with
    device ``plans`` (idx, dec); returns the carved (W, H, D) uint8 grid."""
    W, H, D = occ.shape
    g2 = occ.permute(1, 0, 2).reshape(H, W * D)
    m2 = (m_wh > 0).to(torch.uint8).T[:, :, None].expand(H, W, D).reshape(H, W * D)
    out = sweep_scan(g2, m2, *plans)
    return out.view(H, W, D).permute(1, 0, 2)
