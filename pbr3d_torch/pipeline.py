"""End-to-end pipeline entry points, as in ``pbr3d.pipeline``.

Stage boundaries and file formats match the reference exactly (npz voxel
grids under ``1.Orthographic_Voxel_Carving``, camera JSONs
``{init,kp,final} x {view}`` under ``2.Perspective_Camera_Estimation``), so
either implementation can produce a stage and the other can consume it.
Stages 1 and 2, so far.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from pbr3d_torch import config
from pbr3d_torch.camera.align import Draws, refine_camera_mask_iou
from pbr3d_torch.camera.estimate import (
    auto_compute_initial_params_matching_bbox,
    init_from_bbox,
    optimize_camera_with_keypoints,
    parts_bbox,
)
from pbr3d_torch.camera.geometry import dolly_zoom, reparam_principal_point, yaw_camera_about_center
from pbr3d_torch.camera.keypoints import extract_minaret_kps_for_view, extract_minaret_voxels_by_label
from pbr3d_torch.carving.fused import carve_monument_fused
from pbr3d_torch.io.artifacts import save_camera_params, save_voxel_grid
from pbr3d_torch.io.masks import load_mask_labels, prepare_masks
from pbr3d_torch.utils.profiling import prof

ALIGN_PARTS = ("front_minarets", "back_minarets")  # notebook 2 cells 5/9

#: Views whose mask-IoU search lands below this get second searches from a
#: family of reparameterised starts (see :func:`_retry_starts`); front views
#: use a higher floor, and their retry costs only 3 extra starts.
RETRY_IOU_FLOOR = {"front": 0.60, "drone": 0.45}


def run_stage1(
    monument: str,
    data_root: str | Path = config.data_root(),
    max_dim: Optional[int] = None,
    preset: config.CarvePreset = config.DEFAULT_CARVE_PRESET,
    out_dir: Optional[str | Path] = None,
    *,
    device,
) -> np.ndarray:
    """Orthographic semantic voxel carving (notebook 1) on ``device``."""
    if max_dim is None:
        max_dim = config.GOLDEN_MAX_DIM.get(monument, config.MAX_DIM)
    masks = prepare_masks(data_root, monument, "front", max_dim)
    grid = carve_monument_fused(masks, preset, device=device)
    if out_dir is not None:
        save_voxel_grid(
            Path(out_dir) / "1.Orthographic_Voxel_Carving" / f"{monument}_voxel_grid.npz",
            grid,
        )
    return grid


def _retry_starts(kp_params: Dict, grid_shape, view: str = "drone",
                  mask_hw=None, grid_labels=None, mask_labels=None, *, device):
    """(tag, init_params, step_scale) second-start family for one view.

    Front views get principal-point ridge starts only: cx=cy=0, the
    pitch-down ridge cy=H and the centred cx=W/2, cy=H/2.  Oblique (drone)
    views get the full family: the 4-fold symmetry leaves their azimuth
    ambiguous (90°/270° yaws, composed with a 2x dolly-zoom), the golden
    regime can sit at 2x the distance (dolly2), and the kp fit can park the
    camera below the horizon (``elev+``: a fresh bbox-matched init along the
    kp direction with its elevation forced positive)."""
    starts = [("pp0", reparam_principal_point(kp_params), 1.0)]
    if view == "front":
        if mask_hw is not None:
            H, W = int(mask_hw[0]), int(mask_hw[1])
            starts.append(("ppH", reparam_principal_point(kp_params, W / 2, H), 1.0))
            starts.append(("ppc", reparam_principal_point(kp_params, W / 2, H / 2), 1.0))
        return starts
    starts.append(("dolly2", dolly_zoom(kp_params, 2.0), 2.0))
    for deg in (90, 270):
        y = yaw_camera_about_center(kp_params, grid_shape, deg)
        starts.append((f"yaw{deg}+dolly2", dolly_zoom(y, 2.0), 2.0))
    if grid_labels is not None and mask_labels is not None:
        # The device reduction stays outside the catch-all below, so a
        # device fault cannot pass silently; its ValueError means "no
        # minaret voxels", and then the classic family runs alone.
        try:
            bbox = parts_bbox(grid_labels, ALIGN_PARTS, device=device)
        except ValueError:
            return starts
        try:
            base = init_from_bbox(*bbox, mask_labels, list(ALIGN_PARTS))
            center = (bbox[0] + bbox[1]) / 2.0
            size = float(np.linalg.norm(bbox[1] - bbox[0]))
            d = np.asarray(kp_params["cam_pos"], np.float64) - center
            d[1] = abs(d[1])
            n = float(np.linalg.norm(d))
            if n > 1e-6 and size > 0:
                elev = dict(base)
                elev["cam_pos"] = (center + 2.0 * size * (d / n)).astype(np.float64)
                elev["target"] = np.asarray(center, np.float64)
                starts.append(("elev+", elev, 2.0))
        except Exception:
            pass  # degenerate masks (host math only): the classic family still runs
    return starts


def run_stage2(
    monument: str,
    grid_labels: np.ndarray,
    data_root: str | Path = config.data_root(),
    out_dir: Optional[str | Path] = None,
    *,
    generations: int = 40,
    population: int = 64,
    seed: int = 0,
    draws: Draws = None,
    device,
) -> Dict[str, Dict[str, Dict]]:
    """Perspective camera estimation (notebook 2): init -> kp -> final per
    view, from the dataset's front (at the grid's max dim) and drone masks.
    ``draws`` is described in ``pbr3d_torch.camera.align``."""
    max_dim = int(np.max(grid_labels.shape))
    views = {
        "front": load_mask_labels(data_root, monument, "front", max_dim),
        "drone": load_mask_labels(data_root, monument, "drone"),
    }
    return run_stage2_views(
        monument, grid_labels, views, out_dir, generations=generations,
        population=population, seed=seed, draws=draws, device=device,
    )[0]


def run_stage2_views(
    monument: str,
    grid_labels: np.ndarray,
    views: Mapping[str, np.ndarray],
    out_dir: Optional[str | Path] = None,
    *,
    generations: int = 40,
    population: int = 64,
    seed: int = 0,
    draws: Draws = None,
    device,
) -> Tuple[Dict[str, Dict[str, Dict]], Dict[str, float]]:
    """The body of :func:`run_stage2` on in-memory ``{view: label plane}``.

    Returns ``(cameras, ious)``: the ``{init, kp, final}`` cameras per view
    and each final camera's search IoU.  Views that fail minaret extraction
    are skipped, mirroring the notebook's try/except (notebook 2 cell 5)."""
    grid_dev = torch.as_tensor(grid_labels, device=device)
    # The 3D minaret components depend only on the grid: shared by views.
    try:
        with prof("stage2 minaret labelling (host)"):
            vox_parts = extract_minaret_voxels_by_label(grid_labels)
    except ValueError:
        vox_parts = None

    init_params: Dict[str, Dict] = {}
    kp_params: Dict[str, Dict] = {}
    final_params: Dict[str, Dict] = {}
    ious: Dict[str, float] = {}
    search = dict(generations=generations, population=population, draws=draws, device=device)
    for view, mask in views.items():
        try:
            vox_kps, img_kps = extract_minaret_kps_for_view(grid_labels, mask, voxel_parts=vox_parts)
            init = auto_compute_initial_params_matching_bbox(
                grid_dev, mask, list(ALIGN_PARTS), device=device)
        except ValueError as e:
            print(f"[stage2] {monument}/{view} skipped: {e}", file=sys.stderr)
            continue
        init_params[view] = init
        with prof(f"stage2 {view} keypoint LM"):
            kp_params[view] = optimize_camera_with_keypoints(
                vox_kps, img_kps, mask.shape[:2], init, device=device)
        with prof(f"stage2 {view} search from kp"):
            final_params[view], iou = refine_camera_mask_iou(
                grid_dev, mask, list(ALIGN_PARTS), kp_params[view], seed=seed, **search)
        if iou < RETRY_IOU_FLOOR[view]:
            for tag, init2, scale in _retry_starts(
                kp_params[view], np.asarray(grid_labels).shape, view,
                mask_hw=mask.shape[:2], grid_labels=grid_dev, mask_labels=mask, device=device,
            ):
                with prof(f"stage2 {view} search from {tag}"):
                    p2, iou2 = refine_camera_mask_iou(
                        grid_dev, mask, list(ALIGN_PARTS), init2,
                        seed=seed + 1, step_scale=scale, **search)
                if iou2 > iou:
                    final_params[view], iou = p2, iou2
        # quarter-step fine polish
        with prof(f"stage2 {view} polish"):
            p3, iou3 = refine_camera_mask_iou(
                grid_dev, mask, list(ALIGN_PARTS), final_params[view],
                seed=seed + 3, step_scale=0.25, **search)
        if iou3 > iou:
            final_params[view], iou = p3, iou3
        ious[view] = iou

    cameras = {"init": init_params, "kp": kp_params, "final": final_params}
    if out_dir is not None:
        base = Path(out_dir) / "2.Perspective_Camera_Estimation"
        for tag, params in cameras.items():
            save_camera_params(
                base / f"{monument}_camera_params_{tag}.json",
                {v: {k: p[k] for k in p if k != "loss"} for v, p in params.items()},
            )
    return cameras, ious
