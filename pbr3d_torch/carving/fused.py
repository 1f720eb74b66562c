"""Stage 1, production path: ``carve_monument_fused`` for one scene.

Port of the single-scene path of ``pbr3d.carving.fused``.  The JAX version
pads every grid, window and mask to buckets so that monuments and component
crops share compiled TPU programs; PyTorch runs eagerly, so the port works
at the true extents.  The plans are origin-embedded and the padding is
always empty, so this changes no voxel: the result is bit-identical to the
JAX package (and therefore to the reference implementation).

Phases (reference: utils/voxel_carving_utils.py:269-400):

1. global carve + per-part-group re-carve (device sweeps);
2. component-guided carve: host scipy labelling of one grid download, then
   one device sweep per component bbox window;
3. interior extrusion of doors/windows in the four directions (device);
4. the persistent transpose+flip reorientation (device) and the
   back-minaret recolor (host).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pbr3d_torch import config
from pbr3d_torch.config import PART_IDS
from pbr3d_torch.ops.carve import _stacked_plans, plans_to_device, sweep_volume
from pbr3d_torch.ops.components import _host_component_stats, _host_scipy_label
from pbr3d_torch.utils.profiling import prof


def _global_and_part_carve(
    binary_wh: torch.Tensor,  # (W, H) uint8 {0,1}
    ext_wh: torch.Tensor,  # (W, H) uint8 labels
    plans,  # device (idx, dec) of the global sweep
    group_ids: Tuple[Tuple[int, ...], ...],
) -> torch.Tensor:
    """Global carve + per-group part carve.

    All groups use the same (90°) sweep plans as the global carve — true for
    the reference's notebook preset (checked by the caller).
    """
    W, H = binary_wh.shape
    occ0 = torch.ones((W, H, W), dtype=torch.uint8, device=binary_wh.device)
    grid = sweep_volume(occ0, binary_wh, plans) * ext_wh[:, :, None]

    final = torch.zeros_like(grid)
    for ids in group_ids:
        m_wh = torch.isin(ext_wh, torch.tensor(ids, dtype=torch.uint8, device=ext_wh.device))
        sub = grid * m_wh.to(torch.uint8)[:, :, None]
        part = sub * sweep_volume((sub > 0).to(torch.uint8), m_wh, plans)
        final = torch.where(part > 0, part, final)
    return final


def _guided_windows_for_part(
    grid: torch.Tensor,  # (W, H, D) uint8 labels on device; updated in place
    comp_host: np.ndarray,  # (W, H, D) int32 host component labels
    n: int,
    stats,
    mask2d: np.ndarray,  # (H, W) bool
    angle: int,
) -> torch.Tensor:
    """Carve each component inside its bbox window against the bbox-cropped
    2D part mask, sweeping only that component's own occupancy
    (reference ``left_right_guided_carve``, voxel_carving_utils.py:163-210).

    The component labels are safely stale (a part's carve only erases its own
    voxels); the window content is the live grid, so earlier parts' carving
    applies.  JAX's ``dynamic_slice``/``dynamic_update_slice`` become a
    slice view of ``grid`` written in place.
    """
    device = grid.device
    for i in range(1, n + 1):
        if stats["count"][i] == 0:
            continue
        x0, y0, z0 = (int(v) for v in stats["bbox_min"][i])
        x1, y1, z1 = (int(v) + 1 for v in stats["bbox_max"][i])
        w, d = x1 - x0, z1 - z0
        comp = torch.from_numpy(comp_host[x0:x1, y0:y1, z0:z1] == i).to(device)
        m_wh = torch.from_numpy(np.ascontiguousarray(mask2d[y0:y1, x0:x1].T)).to(device)
        plans = plans_to_device(_stacked_plans(w, d, int(angle)), device)
        carved = sweep_volume(comp.to(torch.uint8), m_wh, plans)
        grid[x0:x1, y0:y1, z0:z1].masked_fill_(comp & (carved == 0), 0)
    return grid


def guided_carve_all(
    grid: torch.Tensor,
    exterior_labels: np.ndarray,
    part_symmetry,
) -> torch.Tensor:
    """Component-guided carving for every part in ``part_symmetry``.

    The grid is downloaded ONCE; component labelling and stats run on the
    host (exact scipy).  Only per-window component crops are uploaded.
    Updates ``grid`` in place and returns it.
    """
    parts = [
        (p, a) for p, a in part_symmetry
        if (exterior_labels == PART_IDS[p]).any()
    ]
    if not parts:
        return grid
    grid_host = grid.cpu().numpy()
    for part, angle in parts:
        target = PART_IDS[part]
        comp_true, n = _host_scipy_label(grid_host == target, "face")
        if n == 0:
            continue
        stats = _host_component_stats(comp_true, n, centroid_axes=())
        grid = _guided_windows_for_part(
            grid, comp_true, n, stats, exterior_labels == target, int(angle)
        )
    return grid


def _extrude_all(
    grid: torch.Tensor,  # (W, H, D) uint8 labels; updated in place
    sem_wh: torch.Tensor,  # (W, H) full-semantic labels (transposed)
    jobs: Tuple[Tuple[int, int], ...],  # (part_id, depth)
) -> torch.Tensor:
    """All interior extrusions (reference extrude_4dirs x parts,
    voxel_carving_utils.py:213-248,356-373): paint ``depth`` voxels inward
    from the first occupied voxel of each masked column along +Z, -Z, +X, -X.

    Empty columns start at index 0 (+) or size-1 (-), as in the reference:
    ``argmax`` over a uint8 axis returns the first maximal index in torch as
    in JAX.  The JAX version ORs ``depth`` one-voxel slabs; here each
    direction is one band ``start <= c < start + depth`` (or its mirror),
    the same voxels since every coordinate lies inside the grid.
    """
    W, H, D = grid.shape
    iz = torch.arange(D, device=grid.device).view(1, 1, D)
    ix = torch.arange(W, device=grid.device).view(W, 1, 1)
    for pid, depth in jobs:
        mask_wh = sem_wh == pid
        for axis, positive in ((2, True), (2, False), (0, True), (0, False)):
            occ = (grid > 0).to(torch.uint8)
            size = D if axis == 2 else W
            if positive:
                start = occ.argmax(dim=axis)
            else:
                last = (size - 1) - occ.flip(axis).argmax(dim=axis)
                start = torch.where(occ.any(dim=axis).bool(), last, size - 1)
            if axis == 2:
                coord, start, valid = iz, start[:, :, None], mask_wh[:, :, None]
            else:
                # the (H, W) mask read as (H, D) — reference quirk (W == D)
                coord, start, valid = ix, start[None], mask_wh.T[None]
            if positive:
                band = (coord >= start) & (coord < start + depth)
            else:
                band = (coord <= start) & (coord > start - depth)
            grid.masked_fill_(band & valid, pid)
    return grid


def recolor_back_host(
    g: np.ndarray,  # (d, h, w) uint8, ALREADY reoriented, host; edited in place
    k: int = 2,
    sort_axis: int = 0,
) -> np.ndarray:
    """Back-minaret recolor of an already-reoriented grid (reference
    voxel_carving_utils.py:252-266): all but the ``k`` front-most
    front_minaret components become back_minarets.  Labeling runs on the
    part's occupied bbox only (identical components)."""
    with prof("rbh.copy", sync=False):
        if not g.flags.writeable:
            g = g.copy()
    pid = PART_IDS["front_minarets"]
    new_pid = PART_IDS["back_minarets"]
    with prof("rbh.eqbbox", sync=False):
        occ = g == pid
        bb = _bbox3(occ)
    if bb is None:
        return g
    (X0, X1), (Y0, Y1), (Z0, Z1) = bb
    with prof("rbh.label", sync=False):
        comp, n = _host_scipy_label(occ[X0:X1, Y0:Y1, Z0:Z1], "face")
    if n <= k:
        return g
    with prof("rbh.stats", sync=False):
        stats = _host_component_stats(comp, n, centroid_axes=(sort_axis,))
    # crop-frame centroids: the constant bbox offset does not change the
    # front-most ranking along sort_axis
    means = stats["centroid"][1 : n + 1, sort_axis]
    keep = set((np.argsort(means, kind="stable")[:k] + 1).tolist())
    recolor_ids = np.array([i for i in range(1, n + 1) if i not in keep], np.int32)
    sub = g[X0:X1, Y0:Y1, Z0:Z1]
    sub[np.isin(comp, recolor_ids)] = new_pid
    return g


def _bbox3(occ: np.ndarray):
    """((x0,x1),(y0,y1),(z0,z1)) half-open bbox of True voxels, or None."""
    out = []
    for ax in range(3):
        proj = occ.any(axis=tuple(i for i in range(3) if i != ax))
        nz = np.flatnonzero(proj)
        if nz.size == 0:
            return None
        out.append((int(nz[0]), int(nz[-1]) + 1))
    return out


def _reorient(g: torch.Tensor) -> torch.Tensor:
    """The transpose(2,1,0)+flip(1) frame change the reference applies before
    recoloring and never undoes (voxel_carving_utils.py:383-386)."""
    return torch.flip(g.permute(2, 1, 0), (1,))


def carve_monument_fused(
    mask_set,
    preset: config.CarvePreset = config.DEFAULT_CARVE_PRESET,
    *,
    device,
) -> np.ndarray:
    """Full stage 1 for one monument on ``device``.  Returns the uint8 label
    grid as host numpy, true extent, reoriented frame — identical to
    ``pbr3d.carving.fused.carve_monument_fused``."""
    binary = mask_set.binary  # (h, w)
    ext = mask_set.exterior_labels
    sem = mask_set.semantic_labels
    h, w = binary.shape

    group_ids = tuple(
        tuple(int(i) for i in config.part_ids(names))
        for names, angle in preset.group_jobs
    )
    angles = {angle for _, angle in preset.group_jobs}
    if angles != {preset.global_angle_interval}:
        raise NotImplementedError(
            "fused stage 1 assumes group angles == global angle; "
            "use pbr3d_torch.carving.stage1 for exotic presets"
        )

    def wh(m):
        return torch.from_numpy(np.ascontiguousarray(m.T)).to(device)

    with prof("stage1.sweep"):
        plans = plans_to_device(_stacked_plans(w, w, preset.global_angle_interval), device)
        grid = _global_and_part_carve(wh(binary), wh(ext), plans, group_ids)
    with prof("stage1.guided"):
        grid = guided_carve_all(grid, ext, preset.part_symmetry)

    jobs = tuple((PART_IDS[p], int(depth)) for p, depth in preset.extrusion_depths)
    if jobs:
        with prof("stage1.extrude"):
            grid = _extrude_all(grid, wh(sem), jobs)

    if not preset.recolor_back_minarets:
        return grid.cpu().numpy()
    with prof("stage1.download_reorient"):
        host = _reorient(grid).cpu().numpy()
    with prof("stage1.recolor", sync=False):
        return recolor_back_host(host)
