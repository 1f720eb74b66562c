"""Intra-method consistency evaluation (the notebook-4 tables), as in
``pbr3d.eval.intra``:

* ``run_minaret_kp_evaluation``: keypoint reprojection error tables,
  Θinit -> Θkp (reference eval_helpers_intra.py:287-424);
* ``run_minaret_iou_evaluation``: visibility-aware per-minaret IoU,
  Θinit -> Θkp -> Θfinal (reference :427-558);
* ``run_part_minaret_binary_iou``: per-part / minaret / whole-silhouette
  IoU, init grid -> deformed grid under Θfinal (reference :560-748).

Each ``run_*`` function is a thin shell that reads grids, cameras and PNG
masks from paths, over a body on in-memory inputs:
``{monument: Scene(grid, deformed grid, label plane, {"init", "kp",
"final": camera dict})}`` -> the table's ``cells`` (row -> monument ->
string).  The bodies run the z-buffers and the visibility projection on
``device`` at exact shapes (no padding); the minaret components and the
keypoints are host work, as in stage 2.  Tables keep the reference's formats
(pandas + tabulate, monument short codes, "a→b" cells); ``pandas`` and
``tabulate`` are imported inside ``_finish_table`` only, OpenCV inside the
mask loader only.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch

from pbr3d_torch import config
from pbr3d_torch.camera.geometry import project_point
from pbr3d_torch.camera.keypoints import (
    extract_minaret_masks_by_label,
    extract_minaret_voxels_by_label,
    extract_top_bottom_image_points,
    extract_top_bottom_voxel_points,
)
from pbr3d_torch.carving.voxel import all_points, points_by_parts
from pbr3d_torch.io.artifacts import load_camera_json, load_voxel_grid_labels
from pbr3d_torch.io.masks import compute_binary_gt, load_mask_labels_for_grid
from pbr3d_torch.ops.projection import binary_iou, project_visible, zbuffer

MINARETS = ["LM1", "RM1", "LM2", "RM2"]

MONUMENT_SHORT = {
    "Taj": "TM", "Bibi": "BkM", "Itimad": "IuD", "Akbar": "AT", "Charminar": "CM",
}

#: Monuments whose back minarets only expose their tops in the front view
#: (reference: eval_helpers_intra.py:303-309).
BACK_TOP_ONLY = {
    "Itimad": True, "Akbar": True, "Charminar": True, "Taj": False, "Bibi": False,
}

PARTS = ["dome", "chhatris", "main_door", "windows", "plinth"]

#: The three tables' headers.
KP_HEADER = "\n=== Minaret Keypoint Reprojection Error (px) ===\nΘinit → Θkp\n"
IOU_HEADER = "\n=== Minaret IoU (INIT voxel grid, visible only) ===\nΘinit → Θkp → Θfinal\n"
PART_HEADER = "\n=== Part / Minaret / Binary IoU (init → deformed) ===\nCamera: Θfinal, visibility-aware\n"


class Scene(NamedTuple):
    """One monument's notebook-4 inputs: the stage-1 label grid, the stage-3
    deformed grid (None for the first two tables), the view's label plane
    resized to the grid as notebook 4 resizes it, and the cameras by tag
    ("init", "kp", "final")."""

    grid: np.ndarray
    deformed: Optional[np.ndarray]
    mask: np.ndarray
    cams: Mapping[str, Dict]


def project_keypoints(voxel_kps: Dict[str, np.ndarray], cam: Dict, *, device) -> Dict[str, np.ndarray]:
    return {k: project_point(np.asarray(pt, np.float32), cam, device=device).cpu().numpy()
            for k, pt in voxel_kps.items()}


def _cam_args(cam: Dict):
    return cam["cam_pos"], cam["target"], cam["f"], cam["cx"], cam["cy"]


def _zbuf(grid_labels, cam: Dict, H: int, W: int, device) -> torch.Tensor:
    pts, _ = all_points(grid_labels, device=device)
    return zbuffer(pts, None, *_cam_args(cam), H, W)


def _visible(pts, cam: Dict, zbuf_img: torch.Tensor, device) -> torch.Tensor:
    if not isinstance(pts, torch.Tensor):
        pts = np.asarray(pts, np.float32)
    pts = torch.as_tensor(pts, device=device).to(torch.float32)
    return project_visible(pts, None, zbuf_img, *_cam_args(cam))


def _iou_bool(a, b, device) -> float:
    return float(binary_iou(torch.as_tensor(a, device=device).bool(), torch.as_tensor(b, device=device).bool()))


def _finish_table(cells: Dict, monuments: Sequence[str], header: str):
    """The cells as a printed ``pandas.DataFrame`` in the reference's format."""
    import pandas as pd
    from tabulate import tabulate

    df = pd.DataFrame.from_dict(cells, orient="index")
    df = df[[m for m in monuments]]
    df.columns = [MONUMENT_SHORT[m] for m in df.columns]
    print(header)
    print(tabulate(df, headers="keys", tablefmt="grid", showindex=True))
    return df


def _load_scene(monument, view, root_voxels, root_masks, cam_dir, tags, deformed_voxels=None) -> Scene:
    grid = load_voxel_grid_labels(os.path.join(root_voxels, f"{monument}_voxel_grid.npz"))
    deformed = None if deformed_voxels is None else load_voxel_grid_labels(
        os.path.join(deformed_voxels, f"{monument}_deformed_voxel_grid.npz"))
    mask = load_mask_labels_for_grid(root_masks, monument, view, grid.shape)
    cams = {tag: load_camera_json(os.path.join(cam_dir, f"{monument}_camera_params_{tag}.json"), view)
            for tag in tags}
    return Scene(grid, deformed, mask, cams)


def minaret_kp_cells(scenes: Mapping[str, Scene], *, device) -> Dict[str, Dict[str, str]]:
    """Θinit -> Θkp keypoint reprojection error (px) per minaret: the first
    table's cells."""
    cells = {m: {} for m in MINARETS + ["Average"]}
    for monument, scene in scenes.items():
        cams = {"init": scene.cams["init"], "rep": scene.cams["kp"]}
        voxel_kps = extract_top_bottom_voxel_points(extract_minaret_voxels_by_label(scene.grid))
        image_kps = extract_top_bottom_image_points(extract_minaret_masks_by_label(scene.mask))

        err = {tag: {} for tag in cams}
        for tag, cam in cams.items():
            proj = project_keypoints(voxel_kps, cam, device=device)
            for m in MINARETS:
                errs = [np.linalg.norm(np.asarray(image_kps[f"{m}_top"]) - proj[f"{m}_top"])]
                if not (m in ("LM2", "RM2") and BACK_TOP_ONLY[monument]):
                    errs.append(
                        np.linalg.norm(np.asarray(image_kps[f"{m}_bottom"]) - proj[f"{m}_bottom"])
                    )
                err[tag][m] = float(np.mean(errs))

        for m in MINARETS:
            cells[m][monument] = f"{err['init'][m]:.2f}→{err['rep'][m]:.2f}"
        cells["Average"][monument] = (
            f"{np.mean(list(err['init'].values())):.2f}"
            f"→{np.mean(list(err['rep'].values())):.2f}"
        )
    return cells


def minaret_iou_cells(scenes: Mapping[str, Scene], *, device) -> Dict[str, Dict[str, str]]:
    """Visibility-aware per-minaret IoU under Θinit -> Θkp -> Θfinal: the
    second table's cells.  The minaret components go to the projector as raw
    (d0, d1, d2) index triples, as in the reference."""
    cells = {m: {} for m in MINARETS + ["Average"]}
    for monument, scene in scenes.items():
        H, W = scene.mask.shape[:2]
        cams = {"init": scene.cams["init"], "rep": scene.cams["kp"], "final": scene.cams["final"]}
        vox_parts = extract_minaret_voxels_by_label(scene.grid)
        msk_parts = extract_minaret_masks_by_label(scene.mask)
        grid = torch.as_tensor(scene.grid, device=device)

        iou = {m: {} for m in MINARETS}
        for tag, cam in cams.items():
            zb = _zbuf(grid, cam, H, W, device)
            pts_all = np.vstack([vox_parts[m] for m in MINARETS]).astype(np.float32)
            pr_all = _visible(pts_all, cam, zb, device)
            for m in MINARETS:
                gt = torch.as_tensor(msk_parts[m].astype(bool), device=device)
                pr = _visible(vox_parts[m].astype(np.float32), cam, zb, device)
                iou[m][tag] = _iou_bool(gt & pr_all, pr, device)

        for m in MINARETS:
            cells[m][monument] = "→".join(f"{iou[m][t]:.3f}" for t in ("init", "rep", "final"))
        cells["Average"][monument] = "→".join(
            f"{np.mean([iou[m][t] for m in MINARETS]):.3f}" for t in ("init", "rep", "final")
        )
    return cells


def part_minaret_binary_cells(scenes: Mapping[str, Scene], *, device) -> Dict[str, Dict[str, str]]:
    """Per-part + minaret + whole-silhouette IoU, init -> deformed, Θfinal:
    the third table's cells."""
    cells = {r: {} for r in PARTS + ["minarets", "whole"]}
    for monument, scene in scenes.items():
        mask = scene.mask
        H, W = mask.shape[:2]
        cam = scene.cams["final"]
        g_init = torch.as_tensor(scene.grid, device=device)
        g_def = torch.as_tensor(scene.deformed, device=device)
        zb_i = _zbuf(g_init, cam, H, W, device)
        zb_d = _zbuf(g_def, cam, H, W, device)

        for part in PARTS:
            gt = mask == config.PART_IDS[part]
            pts_i, _ = points_by_parts(g_init, [part], device=device)
            pts_d, _ = points_by_parts(g_def, [part], device=device)
            if gt.sum() == 0 or len(pts_i) == 0:
                cells[part][monument] = "--"
                continue
            pr_i = _visible(pts_i, cam, zb_i, device)
            pr_d = _visible(pts_d, cam, zb_d, device) if len(pts_d) else torch.zeros_like(pr_i)
            cells[part][monument] = f"{_iou_bool(gt, pr_i, device):.3f}→{_iou_bool(gt, pr_d, device):.3f}"

        pts_min, _ = points_by_parts(g_init, ["front_minarets", "back_minarets"], device=device)
        gt_min = np.isin(mask, config.part_ids(["front_minarets", "back_minarets"]))
        pr_i = _visible(pts_min, cam, zb_i, device)
        pr_d = _visible(pts_min, cam, zb_d, device)
        cells["minarets"][monument] = (
            f"{_iou_bool(gt_min, pr_i, device):.3f}→{_iou_bool(gt_min, pr_d, device):.3f}")

        gt_whole = compute_binary_gt(mask, scene.grid)
        pr_i = _visible(all_points(g_init, device=device)[0], cam, zb_i, device)
        pr_d = _visible(all_points(g_def, device=device)[0], cam, zb_d, device)
        cells["whole"][monument] = (
            f"{_iou_bool(gt_whole, pr_i, device):.3f}→{_iou_bool(gt_whole, pr_d, device):.3f}")
    return cells


def run_minaret_kp_evaluation(
    monuments: Sequence[str], view: str, root_voxels: str, root_masks: str, cam_dir: str, *, device,
):
    """Θinit -> Θkp keypoint reprojection error (px) per minaret."""
    scenes = {m: _load_scene(m, view, root_voxels, root_masks, cam_dir, ("init", "kp")) for m in monuments}
    return _finish_table(minaret_kp_cells(scenes, device=device), monuments, KP_HEADER)


def run_minaret_iou_evaluation(
    monuments: Sequence[str], view: str, root_voxels: str, root_masks: str, cam_dir: str, *, device,
):
    """Visibility-aware per-minaret IoU under Θinit -> Θkp -> Θfinal."""
    scenes = {m: _load_scene(m, view, root_voxels, root_masks, cam_dir, ("init", "kp", "final"))
              for m in monuments}
    return _finish_table(minaret_iou_cells(scenes, device=device), monuments, IOU_HEADER)


def run_part_minaret_binary_iou(
    monuments: Sequence[str], view: str, root_voxels: str, deformed_voxels: str, root_masks: str,
    cam_dir: str, *, device,
):
    """Per-part + minaret + whole-silhouette IoU, init -> deformed, Θfinal."""
    scenes = {m: _load_scene(m, view, root_voxels, root_masks, cam_dir, ("final",), deformed_voxels)
              for m in monuments}
    return _finish_table(part_minaret_binary_cells(scenes, device=device), monuments, PART_HEADER)
