"""Exact notebook-4 acceptance verification for stage-3 deforms, as in
``pbr3d.deform.verify``.

The search models visibility with per-part z-buffers of the init grid's
point sets warped on the fly; notebook 4 (reference
``utils/eval_helpers_intra.py:560-748``) evaluates the REBUILT deformed grid
(7-jitter rounding, later parts overwriting earlier ones) against the
rounded-resize mask.  This module recomputes the nb4 cells from the rebuilt
grid and reverts offenders until no init→deformed cell regresses.  For a
fixed pixel the nb4 visibility test ``∃ point: |Z−zbuf| < eps`` is decided
by the part's min-Z point, so the per-part z-buffers of the rebuilt grid
carry the full information.

The z-buffers come from the dense grids on the device
(:func:`pbr3d_torch.ops.projection.partwise_zbuffers_grid`); the cells and
the revert decisions are host numpy on the downloaded planes, as in the
JAX package.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pbr3d_torch import config
from pbr3d_torch.camera.geometry import params_to_vector
from pbr3d_torch.deform.search import (
    IDENTITY_DEFORM,
    _deform_vec,
    _pad_plane_hw,
    _pad_planes,
    _visible_iou_from_zb,
)
from pbr3d_torch.ops.projection import partwise_zbuffers_grid
from pbr3d_torch.utils import profiling

#: The nb4 table's searched-part rows (eval_helpers_intra.py:564).
NB4_PARTS = ("dome", "chhatris", "main_door", "windows", "plinth")


def _part_zbufs_grid(grid, cam: Dict, H: int, W: int, parts, *, device) -> Dict[str, np.ndarray]:
    """part -> (Hp, Wp) host min-Z image of a dense label grid (host array
    or device tensor), all parts in one reduction on ``device``."""
    g = torch.as_tensor(grid, device=device)
    cam_vec = torch.tensor(params_to_vector(cam), device=device)
    ids = [config.PART_IDS[p] for p in parts]
    zbs = _pad_planes(partwise_zbuffers_grid(g, cam_vec, ids, H, W),
                      *_pad_plane_hw(H, W)).cpu().numpy()
    profiling.count("stage3.round_trips")
    return {p: zbs[i] for i, p in enumerate(parts)}


def _cells_from_zbufs(
    zbufs: Dict[str, np.ndarray], gt_planes: Dict[str, np.ndarray]
) -> Dict[str, float]:
    """part -> visible IoU given every part's min-Z image of one grid."""
    parts = list(zbufs)
    out = {}
    for p in parts:
        others = [zbufs[q] for q in parts if q != p]
        rest = (np.minimum.reduce(others) if others
                else np.full_like(zbufs[p], np.inf))
        out[p] = _visible_iou_from_zb(zbufs[p], rest, gt_planes[p])
    return out


def _rows_from_state(
    zb_i: Dict[str, np.ndarray],
    zb_d: Dict[str, np.ndarray],
    gt_planes: Dict[str, np.ndarray],
    parts,
    mask_p: np.ndarray,
) -> Dict[str, Tuple[float, float]]:
    """All nb4 rows (init, deformed) from the two grids' z-buffer stacks."""
    cells_i = _cells_from_zbufs(zb_i, gt_planes)
    cells_d = _cells_from_zbufs(zb_d, gt_planes)
    out = {}
    for p in parts:
        if p not in NB4_PARTS:
            continue
        if gt_planes[p].sum() == 0:
            continue  # nb4 prints "--"
        out[p] = (cells_i[p], cells_d[p])

    # "minarets" row: INIT-grid minaret points z-tested against each grid
    # (eval_helpers_intra.py:631-648); minarets are pinned, so their min-Z
    # decides visibility in both columns.
    min_parts = [p for p in ("front_minarets", "back_minarets") if p in parts]
    tot_i = np.minimum.reduce(list(zb_i.values()))
    tot_d = np.minimum.reduce(list(zb_d.values()))
    if min_parts:
        zb_min = np.minimum.reduce([zb_i[p] for p in min_parts])
        gt_min = np.logical_or.reduce([gt_planes[p] for p in min_parts])
        out["minarets"] = (_visible_iou_from_zb(zb_min, tot_i, gt_min),
                           _visible_iou_from_zb(zb_min, tot_d, gt_min))

    # "whole" row: occupied-pixel silhouette of each grid vs the union GT of
    # labels present in the INIT grid (eval_helpers_intra.py:274-285)
    gt_whole = np.isin(mask_p, [config.PART_IDS[p] for p in parts])
    out["whole"] = (
        _iou_bool_np(np.isfinite(tot_i), gt_whole),
        _iou_bool_np(np.isfinite(tot_d), gt_whole),
    )
    return out


def _present_parts(grid, device) -> list:
    """The grid's part names, in ``config.PART_NAMES`` order (device
    ``torch.unique``)."""
    ids = set(torch.unique(torch.as_tensor(grid, device=device)).cpu().tolist())
    profiling.count("stage3.round_trips")
    return [p for p in config.PART_NAMES if p != "background" and config.PART_IDS[p] in ids]


def _nb4_state(
    grid_init,
    grid_def,
    mask_nb4: np.ndarray,
    cam: Dict,
    zb_i: Optional[Dict[str, np.ndarray]] = None,
    parts: Optional[list] = None,
    *,
    device,
):
    """(cells, zb_i, zb_d, gt_planes, parts, mask_p) for a rebuilt grid.
    ``zb_i`` (the init z-buffers) is reused when it covers ``parts`` at the
    plane shape; ``parts`` defaults to the init grid's present parts."""
    H, W = np.asarray(mask_nb4).shape[:2]
    Hp, Wp = _pad_plane_hw(H, W)
    if parts is None:
        parts = _present_parts(grid_init, device)
    mask_p = np.zeros((Hp, Wp), np.uint8)
    mask_p[:H, :W] = np.asarray(mask_nb4)
    gt_planes = {p: mask_p == config.PART_IDS[p] for p in parts}

    if zb_i is not None and (
        any(p not in zb_i for p in parts)
        or any(np.asarray(zb_i[p]).shape != (Hp, Wp) for p in parts)
    ):
        zb_i = None  # incompatible precompute: take the dense pass
    if zb_i is None:
        with profiling.span("stage3.verify.zb_init"):
            zb_i = _part_zbufs_grid(grid_init, cam, H, W, parts, device=device)
    # parts overwritten in the rebuilt grid have an empty (inf) z-buffer
    with profiling.span("stage3.verify.zb_def"):
        zb_d = _part_zbufs_grid(grid_def, cam, H, W, parts, device=device)
    with profiling.span("stage3.verify.rows"):
        cells = _rows_from_state(zb_i, zb_d, gt_planes, parts, mask_p)
    return cells, zb_i, zb_d, gt_planes, parts, mask_p


def nb4_exact_cells(
    grid_init,
    grid_def,
    mask_nb4: np.ndarray,
    cam: Dict,
    *,
    device,
) -> Dict[str, Tuple[float, float]]:
    """The nb4 per-part init→deformed IoU cells, exactly as notebook 4
    computes them.  ``mask_nb4`` must be the ROUNDED-resize label mask."""
    return _nb4_state(grid_init, grid_def, mask_nb4, cam, device=device)[0]


def _iou_bool_np(a: np.ndarray, b: np.ndarray) -> float:
    union = np.logical_or(a, b).sum()
    return float(np.logical_and(a, b).sum() / union) if union else 0.0


def enforce_no_regression(
    grid_init,
    deforms: Dict[str, Dict],
    mask_nb4: np.ndarray,
    cam: Dict,
    build_fn,
    max_rounds: int = 3,
    zb_i: Optional[Dict[str, np.ndarray]] = None,
    parts: Optional[list] = None,
    first_state: Optional[tuple] = None,
    *,
    device,
):
    """Rebuild→verify→revert loop: returns (possibly-updated deforms, grid).

    ``build_fn({part: (4,) vec}) -> grid`` rebuilds the deformed grid.  Any
    nb4 cell that regresses init→deformed beyond its tolerance gets its
    part reverted to identity; if the part is already identity, the deformed
    part whose revert recovers it most (by z-buffer swap) is reverted.
    ``first_state`` — (cells, zb_i, zb_d, gt_planes, parts, mask_p,
    grid_def) of ``deforms``' rebuilt grid, when the caller has it."""
    def vecs():
        return {p: _deform_vec(d["deform"]) for p, d in deforms.items()}

    if first_state is not None:
        cells, zb_i, zb_d, gt_planes, parts, mask_p, grid_def = first_state
    else:
        with profiling.span("stage3.verify.build"):
            grid_def = build_fn(vecs())
        with profiling.span("stage3.verify.nb4_state"):
            cells, zb_i, zb_d, gt_planes, parts, mask_p = _nb4_state(
                grid_init, grid_def, mask_nb4, cam, zb_i=zb_i, parts=parts,
                device=device,
            )

    def _tol(p: str) -> float:
        # part cells may not regress at all; the aggregate rows get small
        # allowances (identity parts on the wrong pixels inflate "whole";
        # "minarets" z-tests INIT points against the deformed grid)
        return {"whole": 0.01, "minarets": 0.005}.get(p, 1e-6)

    identity = {"scale_y": 1.0, "shift_y": 0.0, "scale_xz": 1.0, "shift_xz": 0.0}
    for _ in range(max_rounds):
        regressed = [p for p, (i, d) in cells.items() if d + _tol(p) < i]
        if not regressed:
            break
        changed = False
        for p in regressed:
            dv = vecs().get(p)
            if dv is not None and not np.array_equal(dv, IDENTITY_DEFORM):
                print(f"[stage3-verify] nb4 regression {p} "
                      f"{cells[p][0]:.3f}->{cells[p][1]:.3f}: revert to identity",
                      file=sys.stderr)
                deforms[p]["deform"] = dict(identity)
                profiling.count("stage3.reverts")
                changed = True
            else:
                # p is identity: rank the deformed parts by how much
                # swapping each one's deformed z-buffer for its init one
                # recovers p (image math; the next round verifies exactly)
                cands = [
                    q for q, dq in vecs().items()
                    if q != p and not np.array_equal(dq, IDENTITY_DEFORM)
                ]
                best_q, best_iou = None, cells[p][1]
                for q in cands:
                    zb_try = dict(zb_d)
                    zb_try[q] = zb_i[q]
                    rows = _rows_from_state(zb_i, zb_try, gt_planes, parts, mask_p)
                    iou_try = rows.get(p, (0.0, 0.0))[1]
                    if iou_try > best_iou:
                        best_q, best_iou = q, iou_try
                if best_q is not None:
                    print(f"[stage3-verify] nb4 regression {p} "
                          f"{cells[p][0]:.3f}->{cells[p][1]:.3f}: reverting "
                          f"offender {best_q}", file=sys.stderr)
                    deforms[best_q]["deform"] = dict(identity)
                    profiling.count("stage3.reverts")
                    changed = True
        if not changed:
            break
        grid_def = build_fn(vecs())
        cells, _, zb_d, gt_planes, parts, mask_p = _nb4_state(
            grid_init, grid_def, mask_nb4, cam, zb_i=zb_i, parts=parts, device=device,
        )

    # refresh the stored per-part IoUs with the exact nb4 deformed values
    for p, (_, d) in cells.items():
        if p in deforms:
            deforms[p]["iou"] = float(d)
    return deforms, grid_def
