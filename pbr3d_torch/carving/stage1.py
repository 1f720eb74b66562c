"""Stage 1 — orthographic semantic voxel carving, the modular (unfused)
route.

Port of ``pbr3d.carving.stage1`` (reference: utils/voxel_carving_utils.py).
Grids are uint8 *label* grids (W, H, D): 0 = empty, 1..10 = part ids.

Pipeline (reference: notebook 1 cells 5-7; voxel_carving_utils.py:269-400):

1. :func:`global_carve`: silhouette-carve a full (w, h, w) grid with the
   binary front mask under the cumulative rotate-and-carve sweep, then paint
   part labels by extruding the exterior semantic mask along depth;
2. :func:`part_carve`: re-carve each part group against its own 2D mask;
3. :func:`component_guided_carve`: per 3D connected component of a part,
   re-carve inside its bbox against the bbox-cropped 2D mask at a finer
   angle — one component at a time, each carve seeing the occupancy of every
   part in its bbox after the erasures of the components before it;
4. :func:`extrude_interior_parts`: extrude doors/windows inward from the
   first occupied surface along ±Z and ±X;
5. :func:`recolor_backward_components` after :func:`reorient` (a frame
   change that persists into the saved artifact, reference :383-393).

The production route, :func:`pbr3d_torch.carving.fused.carve_monument_fused`,
runs the same carves batched and takes only presets whose group angles equal
the global angle; :func:`carve_monument` takes any.  The two give the same
grid but where step 3 differs (see :func:`component_guided_carve`), as the
JAX package's two routes do.
Device work runs on ``device``; connected components are labelled on the
host (scipy raster order, as the JAX package numbers them).
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np
import torch

from pbr3d_torch import config
from pbr3d_torch.carving.fused import _bbox3, _extrude, recolor_back_host, reorient
from pbr3d_torch.config import PART_IDS
from pbr3d_torch.ops.carve import rotate_carve_sweep
from pbr3d_torch.ops.components import _host_component_stats, _host_scipy_label


def _as_wh(mask, W: int, H: int):
    """Ensure a 2D mask is (W, H) (reference: voxel_carving_utils.py:19-28).

    Accepts (H, W) or (W, H); square masks are assumed (H, W), matching the
    reference's precedence.
    """
    if mask.shape == (H, W):
        return mask.T
    if mask.shape == (W, H):
        return mask
    raise ValueError(f"Mask shape {mask.shape} incompatible with (W,H)=({W},{H})")


def global_carve(
    binary_mask: np.ndarray,
    exterior_labels: np.ndarray,
    angle_interval: int = 90,
    bucket: int | None = None,
    *,
    device,
) -> torch.Tensor:
    """Silhouette-carve + semantic label extrusion.

    ``binary_mask``: (H, W) {0,1}; ``exterior_labels``: (H, W) uint8 labels.
    Returns a uint8 label grid (W, H, W) on ``device``: the carved occupancy
    painted with the exterior label of each voxel's (x, y) column
    (reference ``apply_colored_mask_to_voxel_grid``, :128-136).
    """
    h, w = binary_mask.shape
    occ = torch.ones((w, h, w), dtype=torch.uint8, device=device)
    carved = rotate_carve_sweep(
        occ, torch.as_tensor(binary_mask, device=device).T, angle_interval,
        bucket, device=device,
    )
    col = torch.as_tensor(exterior_labels, device=device).T.to(torch.uint8)
    return carved * col[:, :, None]


def part_carve(
    labels_grid,
    exterior_labels: np.ndarray,
    group_jobs: Iterable[Tuple[Sequence[str], int]],
    bucket: int | None = None,
    *,
    device,
) -> torch.Tensor:
    """Re-carve each part group under its own symmetry sweep.

    Groups whose 2D mask is empty are skipped; later groups overwrite earlier
    ones where nonzero (reference: voxel_carving_utils.py:139-160).
    """
    labels_grid = torch.as_tensor(labels_grid, device=device)
    exterior_labels = np.asarray(exterior_labels)
    final = torch.zeros_like(labels_grid)
    for names, angle in group_jobs:
        mask2d = np.isin(exterior_labels, config.part_ids(names))  # (H, W)
        if not mask2d.any():
            continue
        m_wh = torch.from_numpy(np.ascontiguousarray(mask2d.T)).to(device)
        sub = labels_grid * m_wh.to(torch.uint8)[:, :, None]
        carved = rotate_carve_sweep(sub, m_wh, int(angle), bucket, device=device)
        part = sub * carved
        final = torch.where(part > 0, part, final)
    return final


def component_guided_carve(
    labels_grid,
    exterior_labels: np.ndarray,
    part_name: str,
    angle: int = 60,
    *,
    device,
) -> torch.Tensor:
    """Finer-angle re-carve of each 3D connected component of one part.

    For every 6-connected component of ``labels == part``, in scipy's raster
    order: crop the grid to the component bbox, sweep-carve the *occupancy of
    all parts in the bbox* against the bbox-cropped 2D part mask, and erase
    the component's voxels wherever the carve removed them (reference
    ``left_right_guided_carve``, voxel_carving_utils.py:163-210).  Bboxes may
    overlap, so the components go one after another.  Returns a new grid.

    This is the JAX package's unfused route.  Its fused route (and the
    reference) sweeps the component's own occupancy instead; where other
    voxels in the bbox hold up a rotated sample the two keep different
    voxels (golden Itimad of the study: 48 minaret voxels).
    """
    labels_grid = torch.as_tensor(labels_grid, device=device).clone()
    target = PART_IDS[part_name]
    mask2d = np.asarray(exterior_labels) == target  # (H, W)
    if not mask2d.any():
        return labels_grid
    occ = labels_grid.cpu().numpy() == target
    bb = _bbox3(occ)
    if bb is None:
        return labels_grid
    # labelling the part's bbox gives the grid's components in the same
    # raster order
    (X0, X1), (Y0, Y1), (Z0, Z1) = bb
    comp, n = _host_scipy_label(occ[X0:X1, Y0:Y1, Z0:Z1], "face")
    stats = _host_component_stats(comp, n, centroid_axes=())
    for i in range(1, n + 1):
        (a0, b0, c0), (a1, b1, c1) = stats["bbox_min"][i], stats["bbox_max"][i] + 1
        x0, y0, z0, x1, y1, z1 = (int(v) for v in (a0 + X0, b0 + Y0, c0 + Z0, a1 + X0, b1 + Y0, c1 + Z0))
        m_wh = np.ascontiguousarray(_as_wh(mask2d[y0:y1, x0:x1], x1 - x0, y1 - y0))
        window = labels_grid[x0:x1, y0:y1, z0:z1]
        carved = rotate_carve_sweep(window, m_wh, int(angle), device=device)
        comp_sub = torch.from_numpy(comp[a0:a1, b0:b1, c0:c1] == i).to(device)
        window.masked_fill_(comp_sub & (carved == 0), 0)
    return labels_grid


def extrude_from_surface(
    labels_grid,
    mask2d: np.ndarray,
    axis: int,
    direction: str = "+",
    depth: int = 5,
    fill_id: int | None = None,
    *,
    device,
) -> torch.Tensor:
    """Extrude ``depth`` voxels inward from the first occupied surface.

    Replicates the reference exactly (voxel_carving_utils.py:213-248),
    including its quirk for ``axis=0`` where the (H, W) mask's column index
    is read as depth z (harmless because stage-1 grids have W == D), and the
    start of an empty column (0 from the front, size-1 from the back).
    ``fill_id=None`` erases instead of painting.  Returns a new grid.
    """
    grid = torch.as_tensor(labels_grid, device=device).clone()
    mask_hw = torch.as_tensor(np.asarray(mask2d, bool), device=device)
    _extrude(grid, mask_hw, axis, direction == "+", int(depth), 0 if fill_id is None else int(fill_id))
    return grid


def extrude_interior_parts(
    labels_grid,
    semantic_labels: np.ndarray,
    extrusion_depths: Iterable[Tuple[str, int]],
    *,
    device,
) -> torch.Tensor:
    """Extrude each interior part in all four directions (±Z then ±X)
    (reference: voxel_carving_utils.py:356-373).  Returns a new grid."""
    grid = torch.as_tensor(labels_grid, device=device).clone()
    semantic = torch.as_tensor(np.asarray(semantic_labels), device=device)
    for part, depth in extrusion_depths:
        pid = PART_IDS[part]
        mask_hw = semantic == pid  # (H, W) — FULL mask, not exterior
        for axis, positive in ((2, True), (2, False), (0, True), (0, False)):
            _extrude(grid, mask_hw, axis, positive, int(depth), pid)
    return grid


def recolor_backward_components(
    labels_grid,
    part_name: str = "front_minarets",
    new_part_name: str = "back_minarets",
    k: int = 2,
    sort_axis: int = 0,
    *,
    device,
) -> torch.Tensor:
    """Keep the ``k`` components of ``part_name`` with the smallest mean
    coordinate along ``sort_axis`` (a stable ranking: equal means go to the
    lower component id); recolor the rest to ``new_part_name`` (reference:
    voxel_carving_utils.py:252-266).  Labelling and ranking run on the host;
    returns a new grid on ``device``."""
    host = torch.as_tensor(labels_grid).cpu().numpy().copy()
    out = recolor_back_host(host, k, sort_axis, part_name, new_part_name)
    return torch.from_numpy(out).to(device)


def partwise_carve(
    labels_grid,
    exterior_labels: np.ndarray,
    semantic_labels: np.ndarray,
    preset: config.CarvePreset = config.DEFAULT_CARVE_PRESET,
    *,
    device,
) -> torch.Tensor:
    """Part-wise refinement after global carving
    (reference: voxel_carving_utils.py:302-400)."""
    grid = part_carve(labels_grid, exterior_labels, preset.group_jobs, device=device)
    for part, angle in preset.part_symmetry:
        grid = component_guided_carve(grid, exterior_labels, part, angle, device=device)
    grid = extrude_interior_parts(grid, semantic_labels, preset.extrusion_depths, device=device)
    if preset.recolor_back_minarets:
        grid = recolor_backward_components(reorient(grid), device=device)
    return grid


def carve_monument(
    mask_set,
    preset: config.CarvePreset = config.DEFAULT_CARVE_PRESET,
    *,
    device,
) -> np.ndarray:
    """Full stage 1 for one monument: global + part-wise carving, for any
    :class:`~pbr3d_torch.config.CarvePreset`.

    ``mask_set``: a :class:`pbr3d_torch.io.masks.MaskSet`.  Returns the final
    uint8 label grid as host numpy, in the reoriented frame (the reference's
    saved stage-1 artifacts), as ``carve_monument_fused`` does.
    """
    grid = global_carve(
        mask_set.binary, mask_set.exterior_labels, preset.global_angle_interval, device=device
    )
    grid = partwise_carve(
        grid, mask_set.exterior_labels, mask_set.semantic_labels, preset, device=device
    )
    return grid.cpu().numpy()
