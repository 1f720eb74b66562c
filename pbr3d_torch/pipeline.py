"""End-to-end pipeline entry points, as in ``pbr3d.pipeline``.

Stage boundaries and file formats match the reference exactly (npz voxel
grids under ``1.Orthographic_Voxel_Carving``, camera JSONs
``{init,kp,final} x {view}`` under ``2.Perspective_Camera_Estimation``, the
deformed grid and the deform-params JSON under
``3.Part-wise_3D_Refinement``), so either implementation can produce a stage
and the other can consume it.  Stages 1, 2 and 3 (``run_stage1``,
``run_stage2``, ``run_stage3``); ``run_pipeline``/``run_all`` are not ported
yet.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict, Mapping, Optional, Sequence, Tuple

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
from pbr3d_torch.deform import verify
from pbr3d_torch.deform.search import _deform_vec, prepare_shared_state, refine_parts
from pbr3d_torch.deform.warp import build_deformed_grid_fused
from pbr3d_torch.io.artifacts import save_camera_params, save_voxel_grid
from pbr3d_torch.io.masks import load_mask_labels, load_mask_labels_for_grid, prepare_masks
from pbr3d_torch.ops.point_table import build_point_table
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


def run_stage3(
    monument: str,
    grid_labels: np.ndarray,
    cam_final_front: Dict,
    data_root: str | Path = config.data_root(),
    out_dir: Optional[str | Path] = None,
    *,
    device,
    exact_verify: bool = True,
    **kw,
):
    """Part-wise 3D refinement (notebook 3) under the fixed front camera,
    reading the front mask from ``data_root`` like ``pbr3d.pipeline.
    run_stage3``: at the unpadded grid's max dim for the search, and
    resized to the padded grid (rounded dims) for the exact nb4 verify.
    ``kw`` goes to :func:`run_stage3_body`."""
    max_dim = int(np.max(grid_labels.shape))
    mask = load_mask_labels(data_root, monument, "front", max_dim)
    mask_nb4 = None
    if exact_verify:
        pad = kw.get("pad")
        pad = config.STAGE3_PAD.get(monument, 0) if pad is None else pad
        D, H, W = grid_labels.shape[:3]
        mask_nb4 = load_mask_labels_for_grid(data_root, monument, "front", (D, H + pad, W))
    return run_stage3_body(monument, grid_labels, mask, mask_nb4, cam_final_front, out_dir,
                           device=device, exact_verify=exact_verify, **kw)


def run_stage3_body(
    monument: str,
    grid_labels: np.ndarray,
    mask: np.ndarray,
    mask_nb4: Optional[np.ndarray],
    cam_final_front: Dict,
    out_dir: Optional[str | Path] = None,
    *,
    device,
    pad: Optional[int] = None,
    part_names: Optional[Sequence[str]] = None,
    overrides: Optional[Dict | str | Path] = None,
    exact_verify: bool = True,
    **search_kw,
) -> Tuple[Dict[str, Dict], np.ndarray]:
    """The body of :func:`run_stage3` on in-memory masks; returns (deform
    params per part, deformed uint8 label grid).

    ``grid_labels`` is the stage-1 grid; it is padded by ``pad`` rows on
    axis 1 (default ``config.STAGE3_PAD``).  ``mask`` is the front label
    plane at the unpadded grid's max dim; ``mask_nb4`` the notebook-4 mask
    of the padded grid (needed with ``exact_verify``).  ``overrides`` —
    {part: deform} or a path to a deform-params JSON (this package's or the
    JAX package's): those parts take the deform verbatim.

    The portfolio is the JAX package's (``pbr3d.pipeline.run_stage3``):
    at max dim <= 256 the fast profile; above it, with ``exact_verify``,
    the production profile plus the heavy one (union lattices 11∪16 and
    9∪13, three sweeps, a (2.5, 7) resweep window).  Each profile runs the
    greedy/ensemble schedule (``portfolio``, default (0, 1)) with a
    dual-scored pass 0: the second chain is skipped when the two objectives
    never diverged, else it adopts the first chain's pass-0 prefix.  The
    chains run one after the other (the JAX package overlaps them in a
    thread; stage 3 draws nothing at random, so the order changes no
    result).  The exact nb4 total picks the variant, ``enforce_no_regression``
    verifies it, and if the verify reverted anything the other variants are
    verified too and the best post-verify total wins."""
    if isinstance(overrides, (str, Path)):
        with open(overrides) as fh:
            overrides = json.load(fh)
        overrides = {p: (d["deform"] if "deform" in d else d) for p, d in overrides.items()}
    if exact_verify and mask_nb4 is None:
        raise ValueError("exact_verify needs the notebook-4 mask (mask_nb4)")
    if pad is None:
        pad = config.STAGE3_PAD.get(monument, 0)
    # the search profile follows the UNPADDED grid (notebook 3 loads the
    # front mask at the stage-1 resolution before padding)
    max_dim = int(np.max(grid_labels.shape))
    if pad:
        grid_labels = np.pad(grid_labels, ((0, 0), (0, pad), (0, 0)))
    search_kw = dict(search_kw)
    extra_profiles = []
    if max_dim <= 256:
        search_kw.setdefault("exact_topk", 6)
        search_kw.setdefault("fine_cap", 32768)
        search_kw.setdefault("resweep_window", (1.5, 5))
    else:
        heavy = dict(
            scale_range=[(0.5, 2.0, 11), (0.5, 2.0, 16)],
            shift_range=[(-100.0, 100.0, 9), (-100.0, 100.0, 13)],
            sweeps=3, resweep_window=(2.5, 7),
        )
        if exact_verify and not any(k in search_kw for k in heavy):
            extra_profiles = [("w", heavy)]

    with prof(f"stage3.{monument}.table"):
        table = build_point_table(grid_labels, device=device)
    schedule = search_kw.pop("portfolio", (0.0, 1.0))
    if not exact_verify:
        schedule = schedule[:1]
    profiles = [("", {})] + extra_profiles

    all_parts = [p for p in (part_names or
                             [q for q in config.PART_NAMES if q != "background"])
                 if table.count(config.PART_IDS[p]) > 0]
    with prof(f"stage3.{monument}.shared_prep"):
        part_sets, centers_t, zb_identity = prepare_shared_state(
            mask, cam_final_front, all_parts, table)
    part_points = {p: part_sets[p][0] for p in all_parts}

    def _run_variant(gw, prof_kw, tag, **chain_kw):
        with prof(f"stage3.{monument}.refine_parts[{tag}g{gw:g}]"):
            return refine_parts(
                grid_labels, mask, cam_final_front, part_names, device=device,
                overrides=overrides, table=table,
                zb_identity_in=zb_identity, part_sets_in=part_sets,
                centers_in=centers_t, first_gain_w=gw,
                **chain_kw, **{**search_kw, **prof_kw},
            )

    def _run_schedule(prof_kw, tag):
        """One profile's schedule portfolio; returns (variants, labels)."""
        if len(schedule) == 1:
            return [_run_variant(schedule[0], prof_kw, tag)], [f"{tag}g{schedule[0]:g}"]
        flag: Dict = {}
        snap: Dict = {}
        v0 = _run_variant(schedule[0], prof_kw, tag, dual_gain_w=schedule[1],
                          pass0_done=lambda d: flag.update(diverged=d),
                          pass0_snapshot_out=snap)
        if not flag.get("diverged"):
            print(f"[stage3] {monument}: portfolio [{tag}] deduped "
                  f"(pass-0 objectives never diverged)", file=sys.stderr)
            return [v0], [f"{tag}g{schedule[0]:g}"]
        prefix = snap if snap.get("idx") else None
        rest = [_run_variant(g2, prof_kw, tag, pass0_prefix=prefix) for g2 in schedule[1:]]
        return [v0] + rest, [f"{tag}g{g:g}" for g in schedule]

    variants, labels = [], []
    for tag, prof_kw in profiles:
        vs, ls = _run_schedule(prof_kw, tag)
        variants += vs
        labels += ls

    centers = {p: table.center(config.PART_IDS[p]) for p in variants[0]}
    part_order = [p for p in config.PART_NAMES if p in variants[0]]

    def build_fn(deform_vecs):
        return build_deformed_grid_fused(
            part_points, deform_vecs, centers, mask.shape[:2],
            grid_labels.shape[:3], part_order,
        )

    def _vecs(dd):
        return {p: _deform_vec(d["deform"]) for p, d in dd.items()}

    deforms = variants[0]
    if not exact_verify:
        deformed = build_fn(_vecs(deforms)).cpu().numpy()
    else:
        present = [p for p in config.PART_NAMES
                   if p != "background" and table.count(config.PART_IDS[p]) > 0]

        def _dsnap(dd):
            return {p: tuple(sorted(d["deform"].items())) for p, d in dd.items()}

        if len(variants) > 1 and all(_dsnap(v) == _dsnap(variants[0]) for v in variants[1:]):
            variants, labels = variants[:1], labels[:1]

        # the search's identity z-buffers are the init grid's only when the
        # two masks share a shape: planes pad to even dims here, so a
        # one-row difference would pass ``_nb4_state``'s plane-shape test
        zb_i_shared = zb_identity if mask.shape == mask_nb4.shape else None

        def _exact_state(grid_def):
            nonlocal zb_i_shared
            cells, zb_i_shared, zb_d, gt_planes, parts_v, mask_p = verify._nb4_state(
                grid_labels, grid_def, mask_nb4, cam_final_front,
                zb_i=zb_i_shared, parts=present, device=device,
            )
            return cells, zb_i_shared, zb_d, gt_planes, parts_v, mask_p, grid_def

        def _total(cells):
            return sum(v for _, v in cells.values())

        pick, pick_state = 0, None
        if len(variants) > 1:
            with prof(f"stage3.{monument}.portfolio_pick"):
                states = [_exact_state(build_fn(_vecs(dd))) for dd in variants]
                totals = [_total(st[0]) for st in states]
                pick = int(np.argmax(totals))
                pick_state = states[pick]
                print(f"[stage3] {monument}: portfolio "
                      f"{[f'{l}={t:.3f}' for l, t in zip(labels, totals)]}"
                      f" -> {labels[pick]}", file=sys.stderr)
        with prof(f"stage3.{monument}.exact_verify"):
            before = _dsnap(variants[pick])
            deforms, deformed = verify.enforce_no_regression(
                grid_labels, variants[pick], mask_nb4, cam_final_front,
                build_fn, zb_i=zb_i_shared, parts=present,
                first_state=pick_state, device=device,
            )
            if len(variants) > 1 and _dsnap(deforms) != before:
                # post-verify arbitration: a reverted winner can fall below
                # a clean loser, so verify the others and take the best
                best_total = _total(_exact_state(deformed)[0])
                for vi, dd in enumerate(variants):
                    if vi == pick:
                        continue
                    d2, g2 = verify.enforce_no_regression(
                        grid_labels, dd, mask_nb4, cam_final_front,
                        build_fn, zb_i=zb_i_shared, parts=present, device=device,
                    )
                    t2 = _total(_exact_state(g2)[0])
                    if t2 > best_total:
                        print(f"[stage3] {monument}: post-verify arbitration "
                              f"flipped to {labels[vi]} "
                              f"({t2:.3f} > {best_total:.3f})", file=sys.stderr)
                        deforms, deformed, best_total = d2, g2, t2
            deformed = deformed.cpu().numpy()
    if out_dir is not None:
        base = Path(out_dir) / "3.Part-wise_3D_Refinement"
        save_voxel_grid(base / f"{monument}_deformed_voxel_grid.npz", deformed)
        # the params round-trip through ``overrides`` for replay
        with open(base / f"{monument}_deform_params.json", "w") as fh:
            json.dump(deforms, fh, indent=2)
    return deforms, deformed
