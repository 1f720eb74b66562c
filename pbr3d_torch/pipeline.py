"""End-to-end pipeline entry points, as in ``pbr3d.pipeline``.

Stage boundaries and file formats match the reference exactly (npz voxel
grids under ``1.Orthographic_Voxel_Carving``, camera JSONs
``{init,kp,final} x {view}`` under ``2.Perspective_Camera_Estimation``, the
deformed grid and the deform-params JSON under
``3.Part-wise_3D_Refinement``), so either implementation can produce a stage
and the other can consume it.

``run_stage1``, ``run_stage2`` and ``run_stage3`` are the stages;
``run_pipeline`` chains them for one monument and ``run_all`` runs the study
of several, phase-major: the multi-scene carve, all views' camera searches
grouped (``_stage2_all_batched``), and the monuments' refinements on a small
thread pool, each started the moment its front camera is final.  Each entry
that reads the PNG dataset (``data_root``) has a body on in-memory masks
beside it (``run_stage1_body``, ``run_stage2_views``, ``run_stage3_body``,
``run_pipeline_body``, ``run_all_body``): the machines that run the port on
the card need hold neither the dataset nor OpenCV.

Threads.  ``run_all``'s workers (two for the stage-2 preparation, three for
stage 3) each issue their device work on a CUDA stream of their own
(``pbr3d_torch.utils.streams``).  What crosses between threads is host data
only: label grids, masks, camera dicts and the shell points as numpy arrays.
Every decision of stages 2 and 3 is taken on values downloaded from the
device, so a monument's result does not depend on what ran beside it.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
import traceback
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from pbr3d_torch import config
from pbr3d_torch.camera.align import Draws, refine_camera_mask_iou, refine_cameras_batched
from pbr3d_torch.camera.estimate import (
    auto_compute_initial_params_matching_bbox,
    init_from_bbox,
    optimize_camera_with_keypoints,
    parts_bbox,
)
from pbr3d_torch.camera.geometry import dolly_zoom, reparam_principal_point, yaw_camera_about_center
from pbr3d_torch.camera.keypoints import extract_minaret_kps_for_view, extract_minaret_voxels_by_label
from pbr3d_torch.carving.fused import carve_monument_fused, carve_monuments_batched
from pbr3d_torch.carving.voxel import surface_points_by_parts
from pbr3d_torch.deform import verify
from pbr3d_torch.deform.search import _deform_vec, prepare_shared_state, refine_parts
from pbr3d_torch.deform.warp import build_deformed_grid_fused
from pbr3d_torch.io.artifacts import save_camera_params, save_voxel_grid
from pbr3d_torch.io.masks import MaskSet, load_mask_labels, load_mask_labels_for_grid, prepare_masks
from pbr3d_torch.ops.point_table import build_point_table
from pbr3d_torch.utils import profiling
from pbr3d_torch.utils.streams import worker_stream

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
    """Orthographic semantic voxel carving (notebook 1) on ``device``, from
    the dataset's front masks at ``max_dim`` (default: the monument's golden
    resolution); see :func:`run_stage1_body`."""
    if max_dim is None:
        max_dim = config.GOLDEN_MAX_DIM.get(monument, config.MAX_DIM)
    return run_stage1_body(monument, prepare_masks(data_root, monument, "front", max_dim), out_dir, preset,
                           device=device)


def run_stage1_body(
    monument: str,
    mask_set: MaskSet,
    out_dir: Optional[str | Path] = None,
    preset: config.CarvePreset = config.DEFAULT_CARVE_PRESET,
    *,
    device,
) -> np.ndarray:
    """The body of :func:`run_stage1` on in-memory prepared front masks: the
    fused carve, and the grid saved under ``out_dir``.  Called on its own it
    is a trace (``stage1``, with the monument); inside a study, its span."""
    with profiling.trace("stage1", monument=monument):
        grid = carve_monument_fused(mask_set, preset, device=device)
        if out_dir is not None:
            _save_stage1(out_dir, monument, grid)
    return grid


def _save_stage1(out_dir: str | Path, monument: str, grid: np.ndarray) -> None:
    save_voxel_grid(Path(out_dir) / "1.Orthographic_Voxel_Carving" / f"{monument}_voxel_grid.npz", grid)


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
    are skipped, mirroring the notebook's try/except (notebook 2 cell 5).
    Called on its own it is a trace (``stage2``, with the monument); inside
    a study, its span."""
    with profiling.trace("stage2", monument=monument):
        grid_dev = torch.as_tensor(grid_labels, device=device)
        # The 3D minaret components depend only on the grid: shared by views.
        try:
            with profiling.span("stage2.labelling"):
                vox_parts = extract_minaret_voxels_by_label(grid_dev)
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
            with profiling.span("stage2.keypoint_lm", view=view):
                kp_params[view] = optimize_camera_with_keypoints(
                    vox_kps, img_kps, mask.shape[:2], init, device=device)
            with profiling.span("stage2.search", view=view, start="kp"):
                final_params[view], iou = refine_camera_mask_iou(
                    grid_dev, mask, list(ALIGN_PARTS), kp_params[view], seed=seed, **search)
            if iou < RETRY_IOU_FLOOR[view]:
                for tag, init2, scale in _retry_starts(
                    kp_params[view], np.asarray(grid_labels).shape, view,
                    mask_hw=mask.shape[:2], grid_labels=grid_dev, mask_labels=mask, device=device,
                ):
                    with profiling.span("stage2.search", view=view, start=tag):
                        p2, iou2 = refine_camera_mask_iou(
                            grid_dev, mask, list(ALIGN_PARTS), init2,
                            seed=seed + 1, step_scale=scale, **search)
                    if iou2 > iou:
                        final_params[view], iou = p2, iou2
            # quarter-step fine polish
            with profiling.span("stage2.polish", view=view):
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

    with profiling.span("stage3.table", monument=monument):
        table = build_point_table(grid_labels, device=device)
    schedule = search_kw.pop("portfolio", (0.0, 1.0))
    if not exact_verify:
        schedule = schedule[:1]
    profiles = [("", {})] + extra_profiles

    all_parts = [p for p in (part_names or
                             [q for q in config.PART_NAMES if q != "background"])
                 if table.count(config.PART_IDS[p]) > 0]
    with profiling.span("stage3.shared_prep", monument=monument):
        part_sets, centers_t, zb_identity = prepare_shared_state(
            mask, cam_final_front, all_parts, table)
    part_points = {p: part_sets[p][0] for p in all_parts}

    def _run_variant(gw, prof_kw, tag, **chain_kw):
        with profiling.span("stage3.refine_parts", monument=monument, variant=tag, gain_w=gw):
            profiling.count("stage3.chains")
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
            with profiling.span("stage3.portfolio_pick", monument=monument):
                states = [_exact_state(build_fn(_vecs(dd))) for dd in variants]
                totals = [_total(st[0]) for st in states]
                pick = int(np.argmax(totals))
                pick_state = states[pick]
                print(f"[stage3] {monument}: portfolio "
                      f"{[f'{l}={t:.3f}' for l, t in zip(labels, totals)]}"
                      f" -> {labels[pick]}", file=sys.stderr)
        with profiling.span("stage3.exact_verify", monument=monument):
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


@dataclasses.dataclass
class PipelineResult:
    monument: str
    grid_stage1: np.ndarray  # uint8 labels
    cameras: Dict[str, Dict[str, Dict]]  # tag -> view -> params
    deform_params: Dict[str, Dict]
    grid_stage3: np.ndarray
    timings: Dict[str, float]


@dataclasses.dataclass
class SceneMasks:
    """One monument's masks, as the three stages read them from the dataset."""

    front: MaskSet  # stage 1's prepared front masks
    views: Dict[str, np.ndarray]  # view -> label plane: stage 2's views; "front" is stage 3's mask
    nb4: Optional[np.ndarray] = None  # the notebook-4 front mask of the padded grid (exact verify)


def load_scene_masks(data_root: str | Path, monument: str, max_dim: Optional[int] = None,
                     pad: Optional[int] = None) -> SceneMasks:
    """The masks ``run_stage1/2/3`` would load for ``monument`` at ``max_dim``
    (default: its golden resolution), the notebook-4 mask for a grid padded by
    ``pad`` rows (default ``config.STAGE3_PAD``)."""
    if pad is None:
        pad = config.STAGE3_PAD.get(monument, 0)
    if max_dim is None:
        max_dim = config.GOLDEN_MAX_DIM.get(monument, config.MAX_DIM)
    front = prepare_masks(data_root, monument, "front", max_dim)
    h, w = front.hw
    grid_dim = max(h, w)  # stage 1's grid is (w, h, w)
    return SceneMasks(
        front=front,
        views={"front": load_mask_labels(data_root, monument, "front", grid_dim),
               "drone": load_mask_labels(data_root, monument, "drone")},
        nb4=load_mask_labels_for_grid(data_root, monument, "front", (w, h + pad, w)),
    )


def _device_fault(exc: BaseException) -> bool:
    """A CUDA error or an out-of-memory: never reported and skipped."""
    kinds = (torch.cuda.CudaError, torch.OutOfMemoryError,
             getattr(torch, "AcceleratorError", torch.cuda.CudaError))
    return isinstance(exc, kinds) or (isinstance(exc, RuntimeError) and "CUDA" in str(exc))


def run_pipeline(
    monument: str,
    data_root: str | Path = config.data_root(),
    max_dim: Optional[int] = None,
    out_dir: Optional[str | Path] = None,
    *,
    device,
    **kw,
) -> PipelineResult:
    """Full 3-stage reconstruction of one monument from the dataset on
    ``device``; ``kw`` goes to :func:`run_pipeline_body`."""
    scene = load_scene_masks(data_root, monument, max_dim, (kw.get("stage3_kw") or {}).get("pad"))
    return run_pipeline_body(monument, scene, out_dir, device=device, **kw)


def run_pipeline_body(
    monument: str,
    scene: SceneMasks,
    out_dir: Optional[str | Path] = None,
    *,
    stage2_kw: Optional[Dict] = None,
    stage3_kw: Optional[Dict] = None,
    grid_stage1: Optional[np.ndarray] = None,
    stage1_time: Optional[float] = None,
    device,
) -> PipelineResult:
    """The body of :func:`run_pipeline` on in-memory masks.

    ``grid_stage1`` injects a precomputed stage-1 grid (the multi-scene carve
    of :func:`run_all`); ``stage1_time`` is its share of the batch's wall
    time."""
    with profiling.trace("study", monument=monument):
        timings = {}
        t = time.perf_counter()
        if grid_stage1 is not None:
            with profiling.span("stage1"):
                grid1 = grid_stage1
                if out_dir is not None:
                    _save_stage1(out_dir, monument, grid1)
        else:
            grid1 = run_stage1_body(monument, scene.front, out_dir, device=device)
        timings["stage1"] = (stage1_time if grid_stage1 is not None and stage1_time is not None
                             else time.perf_counter() - t)
        print(f"[{monument}] stage1 {timings['stage1']:.1f}s grid={grid1.shape}",
              file=sys.stderr, flush=True)

        t = time.perf_counter()
        cameras, _ = run_stage2_views(monument, grid1, scene.views, out_dir, device=device, **(stage2_kw or {}))
        timings["stage2"] = time.perf_counter() - t
        print(f"[{monument}] stage2 {timings['stage2']:.1f}s views={list(cameras['final'])}",
              file=sys.stderr, flush=True)

        t = time.perf_counter()
        if not cameras["final"]:
            raise RuntimeError(
                f"{monument}: no view passed camera estimation (all views skipped); "
                "cannot run stage 3"
            )
        cam_front = cameras["final"].get("front") or next(iter(cameras["final"].values()))
        with profiling.span("stage3.body", monument=monument):
            deforms, grid3 = run_stage3_body(
                monument, grid1, scene.views["front"], scene.nb4, cam_front, out_dir, device=device,
                **(stage3_kw or {}))
        timings["stage3"] = time.perf_counter() - t
        print(f"[{monument}] stage3 {timings['stage3']:.1f}s parts={len(deforms)}",
              file=sys.stderr, flush=True)
    return PipelineResult(monument, grid1, cameras, deforms, grid3, timings)


def _prep_stage2_monument(m: str, grid: np.ndarray, views: Mapping[str, np.ndarray], *, device):
    """Per-monument stage-2 preparation on in-memory ``{view: label plane}``:
    the 3D minaret labelling shared by both views, the shell points once, and
    per view keypoints -> bbox init -> keypoint LM.  Returns ``(cams, jobs)``:
    the ``{init, kp, final}`` cameras (``final`` still empty) and the search
    jobs keyed ``(m, view)``.  Callers overlap monuments on a small pool, so
    this runs on a stream of its own and hands back host data only."""
    with profiling.span("stage2.prep", monument=m), worker_stream(device):
        grid_dev = torch.as_tensor(grid, device=device)
        with profiling.span("stage2.prep.vox_parts"):
            try:
                vox_parts = extract_minaret_voxels_by_label(grid_dev)
            except ValueError:
                vox_parts = None
        with profiling.span("stage2.prep.shell"):
            shell = tuple(t.cpu().numpy() for t in
                          surface_points_by_parts(grid_dev, list(ALIGN_PARTS), device=device))
        cams = {"init": {}, "kp": {}, "final": {}}
        mjobs = {}
        for view, mask in views.items():
            try:
                with profiling.span("stage2.prep.kps", view=view):
                    vox_kps, img_kps = extract_minaret_kps_for_view(grid, mask, voxel_parts=vox_parts)
                with profiling.span("stage2.prep.init", view=view):
                    init = auto_compute_initial_params_matching_bbox(
                        grid_dev, mask, list(ALIGN_PARTS), device=device)
            except ValueError as e:
                print(f"[stage2] {m}/{view} skipped: {e}", file=sys.stderr)
                continue
            cams["init"][view] = init
            with profiling.span("stage2.prep.lm", view=view):
                kp = optimize_camera_with_keypoints(vox_kps, img_kps, mask.shape[:2], init, device=device)
            cams["kp"][view] = kp
            mjobs[(m, view)] = dict(
                grid_labels=grid, mask_labels=mask, parts=list(ALIGN_PARTS),
                init_params=kp, points=shell,
            )
    return cams, mjobs


#: The chained deep polish of ``_stage2_all_batched``: (generations, step
#: scale, seed, coordinate-descent magnitudes, coordinate-descent rounds) of
#: each trial, all at population 256.
DEEP_POLISH_TRIALS = (
    (24, 0.5, 0, (1.0, 0.25, 4.0), 12),
    (24, 0.125, 0, (1.0, 0.25, 4.0), 12),
    (0, 0.0625, 0, (1.0, 0.25, 0.0625, 16.0), 48),
    (24, 0.25, 9, (1.0, 0.25, 4.0), 12),
    (24, 0.0625, 17, (1.0, 0.25, 4.0), 24),
)


def _stage2_all_batched(
    monuments: Sequence[str],
    grids: Mapping[str, np.ndarray],
    views: Mapping[str, Mapping[str, np.ndarray]],
    out_dir: Optional[str | Path],
    *,
    generations: int = 40,
    population: int = 64,
    seed: int = 0,
    on_front_final: Optional[Callable[[str, Dict], None]] = None,
    prep_futures: Optional[Mapping[str, Future]] = None,
    deep_polish: bool = False,
    draws: Draws = None,
    device,
) -> Dict[str, Dict[str, Dict[str, Dict]]]:
    """Stage 2 for every monument, the searches of all (monument, view)
    problems grouped through :func:`refine_cameras_batched`; ``views`` is
    ``{monument: {view: label plane}}``.

    The schedule is the JAX package's: the main search; the quarter-step
    ``fine_polish`` of the views that need no retry; for views under
    ``RETRY_IOU_FLOOR`` the ``_retry_starts`` family through a coarse-only
    triage, a native polish of the top two and a full re-search of the top
    start, fronts before drones; with ``deep_polish`` the five
    ``DEEP_POLISH_TRIALS`` from the running best, fronts before drones.

    ``on_front_final(monument, params)`` fires the moment a monument's FRONT
    camera can no longer change, so the caller can start stage 3 (which
    needs only that camera) beside the drone views' rounds.
    ``prep_futures`` holds already submitted :func:`_prep_stage2_monument`
    tasks; monuments not in it are prepared here."""
    jobs: Dict = {}
    cameras: Dict[str, Dict[str, Dict[str, Dict]]] = {}
    search = dict(draws=draws, device=device)

    with profiling.span("stage2.prep_wait"):
        with ThreadPoolExecutor(max_workers=3) as ex:
            futs = dict(prep_futures or {})
            for m in monuments:
                if m not in futs:
                    futs[m] = ex.submit(profiling.carried(_prep_stage2_monument), m, grids[m], views[m],
                                        device=device)
            for m in monuments:
                cameras[m], mjobs = futs[m].result()
                jobs.update(mjobs)
    if not jobs:
        return cameras

    with profiling.span("stage2.main_search"):
        finals = refine_cameras_batched(
            jobs, generations=generations, population=population, seed=seed, **search)
    retry = {k: jobs[k] for k, (_, iou) in finals.items() if iou < RETRY_IOU_FLOOR[k[1]]}

    def keep_better(results, note=False):
        for key, (params, iou) in results.items():
            k, tag = key if note else (key, None)
            if iou > finals[k][1]:
                if note:
                    print(f"[stage2] {k}: {tag} start improved {finals[k][1]:.4f} -> {iou:.4f}",
                          file=sys.stderr)
                finals[k] = (params, iou)

    def fine_polish(keys, seed_off):
        """Quarter-step refinement from the current finals: the main
        search's step schedule freezes on plateau ridges a few percent below
        the local optimum."""
        jf = {k: dict(jobs[k], init_params=finals[k][0], step_scale=0.25) for k in keys}
        if jf:
            keep_better(refine_cameras_batched(
                jf, generations=generations, population=population, seed=seed + seed_off, **search))

    def fire_fronts(keys):
        if on_front_final is not None:
            for m, view in keys:
                if view == "front":
                    on_front_final(m, finals[(m, view)][0])

    with profiling.span("stage2.fine_polish"):
        fine_polish([k for k in finals if k not in retry], 3)
    if not deep_polish:
        # (the deep polish re-searches every view, so with it the front
        # camera is final only after its front trials)
        fire_fronts([k for k in finals if k not in retry])

    def run_retries(keys, label):
        """Triage -> top-2 polish -> top-1 re-search for a retry subset.  The
        triage is coarse-only and ranks basins on a leaner budget (half the
        points, plane pixels and generations; the population stays full)."""
        jobs2 = {}
        for k in keys:
            j = retry[k]
            for tag, init, scale in _retry_starts(
                j["init_params"], np.asarray(j["grid_labels"]).shape, k[1],
                mask_hw=np.asarray(j["mask_labels"]).shape[:2],
                grid_labels=j["grid_labels"], mask_labels=j["mask_labels"], device=device,
            ):
                jobs2[(k, tag)] = dict(j, init_params=init, step_scale=scale)
        with profiling.span("stage2.retry_triage", label=label):
            coarse = refine_cameras_batched(
                jobs2, generations=max(6, generations // 2), population=population,
                seed=seed + 1, polish=False, point_cap=16384, plane_cap=80_000, **search)
        by_view: Dict = {}
        for (k, tag), (_, iou) in coarse.items():
            by_view.setdefault(k, []).append((iou, tag))
        # two complementary finishes, the best of either kept: a native
        # polish of the triage's top-2 PARAMS, and a full-budget re-search
        # of the top start from its ORIGINAL init
        jobs3 = {(k, tag): dict(jobs2[(k, tag)], init_params=coarse[(k, tag)][0])
                 for k, ranked in by_view.items() for _, tag in sorted(ranked, reverse=True)[:2]}
        jobs4 = {(k, max(ranked)[1]): dict(jobs2[(k, max(ranked)[1])]) for k, ranked in by_view.items()}
        with profiling.span("stage2.retry_polish", label=label):
            keep_better(refine_cameras_batched(
                jobs3, generations=0, population=population, seed=seed + 1, **search), note=True)
            keep_better(refine_cameras_batched(
                jobs4, generations=generations, population=population, seed=seed + 2, **search),
                note=True)
        with profiling.span("stage2.fine_polish_retry", label=label):
            fine_polish(keys, 4)

    if retry:
        print(f"[stage2] retrying {sorted(retry)} from reparameterized/dolly/yaw starts",
              file=sys.stderr)
        # FRONT retries first: stage 3 depends only on the front camera
        fronts = [k for k in retry if k[1] == "front"]
        drones = [k for k in retry if k[1] != "front"]
        if fronts:
            run_retries(fronts, "front")
            if not deep_polish:
                fire_fronts(fronts)
        if drones:
            run_retries(drones, "drone")

    if deep_polish:
        def run_trials(ks, label):
            with profiling.span("stage2.deep_polish", label=label):
                for gens, ss, sd, mags, cdr in DEEP_POLISH_TRIALS:
                    jf = {k: dict(jobs[k], init_params=finals[k][0], step_scale=ss) for k in ks}
                    keep_better(refine_cameras_batched(
                        jf, generations=gens, population=256, cd_rounds=cdr, seed=sd,
                        cd_mags=mags, **search))

        # fronts, then stage 3 may start, then the drones beside it; the
        # views are searched independently and seeded per trial, so the
        # split changes no result
        run_trials([k for k in finals if k[1] == "front"], "front")
        fire_fronts(list(finals))
        run_trials([k for k in finals if k[1] != "front"], "drone")

    for (m, view), (params, _) in finals.items():
        cameras[m]["final"][view] = params
    if out_dir is not None:
        base = Path(out_dir) / "2.Perspective_Camera_Estimation"
        for m in monuments:
            for tag, params in cameras[m].items():
                save_camera_params(
                    base / f"{m}_camera_params_{tag}.json",
                    {v: {k: p[k] for k in p if k != "loss"} for v, p in params.items()},
                )
    return cameras


def run_all(
    monuments: Sequence[str] = tuple(config.MONUMENTS),
    strict: bool = False,
    batch_stage1: bool = True,
    batch_stage2: bool = True,
    stage3_workers: int = 3,
    *,
    data_root: str | Path = config.data_root(),
    max_dim: Optional[int] = None,
    device,
    **kw,
) -> Dict[str, PipelineResult]:
    """The full pipeline for every monument from the dataset on ``device``,
    phase-major (see :func:`run_all_body`, which takes ``kw``).  With
    ``strict=False`` a monument whose masks do not load is reported and
    skipped."""
    scenes = {}
    for m in monuments:
        try:
            scenes[m] = load_scene_masks(data_root, m, max_dim, (kw.get("stage3_kw") or {}).get("pad"))
        except Exception:
            if strict:
                raise
            print(f"[run_all] {m} FAILED:", file=sys.stderr)
            traceback.print_exc()
    return run_all_body(scenes, strict, batch_stage1, batch_stage2, stage3_workers,
                        max_dim=max_dim, device=device, **kw)


def run_all_body(
    scenes: Mapping[str, SceneMasks],
    strict: bool = False,
    batch_stage1: bool = True,
    batch_stage2: bool = True,
    stage3_workers: int = 3,
    *,
    max_dim: Optional[int] = None,
    out_dir: Optional[str | Path] = None,
    stage2_kw: Optional[Dict] = None,
    stage3_kw: Optional[Dict] = None,
    device,
) -> Dict[str, PipelineResult]:
    """The body of :func:`run_all` on in-memory ``{monument: SceneMasks}``.

    * stage 1: the multi-scene carve (:func:`carve_monuments_batched`); each
      scene's stage-2 preparation is submitted the moment its grid is final;
    * stage 2: all (monument, view) camera searches grouped
      (:func:`_stage2_all_batched`); ``deep_polish`` defaults to on above 256
      (``max_dim`` None means golden resolution);
    * stage 3: each monument is refined on a pool of ``stage3_workers``
      threads, submitted the moment its front camera is final.

    With ``strict=False`` a failing monument is reported and skipped, and a
    batched phase that fails (or is switched off) gives way to the serial
    route through :func:`run_pipeline_body`; a device fault is raised
    whatever ``strict`` says."""
    with profiling.trace("study"):
        monuments = list(scenes)

        def tolerated(exc: Exception) -> bool:
            return not (strict or _device_fault(exc))

        prep_ex = ThreadPoolExecutor(max_workers=2)
        prep_futs: Dict[str, Future] = {}

        def on_grid_ready(m: str, grid: np.ndarray):
            prep_futs[m] = prep_ex.submit(profiling.carried(_prep_stage2_monument), m, grid, scenes[m].views,
                                          device=device)

        grids: Dict[str, np.ndarray] = {}
        t_share: Optional[float] = None
        if batch_stage1 and len(monuments) > 1:
            try:
                t0 = time.perf_counter()
                with profiling.span("stage1"):
                    grids = carve_monuments_batched(
                        {m: scenes[m].front for m in monuments}, on_grid=on_grid_ready, device=device)
                t_share = (time.perf_counter() - t0) / max(len(monuments), 1)
                print(f"[run_all] batched stage1 x{len(grids)}: {t_share * len(grids):.1f}s",
                      file=sys.stderr, flush=True)
            except Exception as e:
                if not tolerated(e):
                    prep_ex.shutdown(wait=False, cancel_futures=True)
                    raise
                grids = {}
                print("[run_all] batched stage1 FAILED, falling back to serial:", file=sys.stderr)
                traceback.print_exc()

        # The stage-3 pool exists BEFORE stage 2: part refinement depends only on
        # the front camera, so each monument's stage 3 is submitted the moment
        # that camera is final, beside the drone views' retry and polish rounds.
        ex3 = ThreadPoolExecutor(max_workers=max(1, stage3_workers))
        futs3: Dict[str, Future] = {}

        def stage3_task(m: str, cam_front: Dict):
            t0 = time.perf_counter()
            with profiling.span("stage3.body", monument=m), worker_stream(device):
                deforms, grid3 = run_stage3_body(
                    m, grids[m], scenes[m].views["front"], scenes[m].nb4, cam_front, out_dir,
                    device=device, **(stage3_kw or {}))
            t3 = time.perf_counter() - t0
            print(f"[{m}] stage3 {t3:.1f}s parts={len(deforms)}", file=sys.stderr, flush=True)
            return deforms, grid3, t3

        def on_front_final(m: str, params: Dict):
            futs3[m] = ex3.submit(profiling.carried(stage3_task, "stage3.queued", monument=m), m, params)

        cameras_all: Dict[str, Dict] = {}
        t2_share: Optional[float] = None
        if batch_stage2 and len(monuments) > 1 and len(grids) == len(monuments):
            try:
                t0 = time.perf_counter()
                kw2 = dict(stage2_kw or {})
                kw2.setdefault("deep_polish", max_dim is None or int(max_dim) > 256)
                with profiling.span("stage2"):
                    cameras_all = _stage2_all_batched(
                        monuments, grids, {m: scenes[m].views for m in monuments}, out_dir,
                        on_front_final=on_front_final, prep_futures=prep_futs, device=device, **kw2)
                t2_share = (time.perf_counter() - t0) / max(len(monuments), 1)
                print(f"[run_all] batched stage2 x{len(monuments)}: {t2_share * len(monuments):.1f}s",
                      file=sys.stderr, flush=True)
            except Exception as e:
                prep_ex.shutdown(wait=False, cancel_futures=True)
                if not tolerated(e):
                    ex3.shutdown(wait=False, cancel_futures=True)
                    raise
                cameras_all = {}
                print("[run_all] batched stage2 FAILED, falling back to serial:", file=sys.stderr)
                traceback.print_exc()
                # drain any early stage-3 work before the serial route redoes it
                for f in futs3.values():
                    try:
                        f.result()
                    except Exception as e3:
                        if _device_fault(e3):
                            raise
                futs3.clear()

        prep_ex.shutdown(wait=False)
        out: Dict[str, PipelineResult] = {}
        if not cameras_all:
            ex3.shutdown(wait=True)
            for m in monuments:
                try:
                    out[m] = run_pipeline_body(
                        m, scenes[m], out_dir, stage2_kw=stage2_kw, stage3_kw=stage3_kw,
                        grid_stage1=grids.get(m), stage1_time=t_share, device=device)
                except Exception as e:
                    if not tolerated(e):
                        raise
                    print(f"[run_all] {m} FAILED:", file=sys.stderr)
                    traceback.print_exc()
            return out

        # ---- stage 3: collect the overlapped tasks, submit any stragglers ----
        # (a monument whose front view was skipped takes another final view,
        # which is fixed only once stage 2 has returned)
        for m in monuments:
            cams = cameras_all.get(m)
            if m not in futs3 and cams and cams["final"]:
                cam_front = cams["final"].get("front") or next(iter(cams["final"].values()))
                on_front_final(m, cam_front)

        for m in monuments:
            try:
                cams = cameras_all.get(m)
                if m not in futs3 or not cams or not cams["final"]:
                    raise RuntimeError(f"{m}: no view passed camera estimation (all views skipped)")
                deforms, grid3, t3 = futs3[m].result()
                timings = {"stage1": t_share or 0.0, "stage2": t2_share or 0.0, "stage3": t3}
                out[m] = PipelineResult(m, grids[m], cams, deforms, grid3, timings)
            except Exception as e:
                if not tolerated(e):
                    ex3.shutdown(wait=False, cancel_futures=True)
                    raise
                print(f"[run_all] {m} stage3 FAILED:", file=sys.stderr)
                traceback.print_exc()
        ex3.shutdown(wait=True)

        if out_dir is not None:
            for m, r in out.items():
                _save_stage1(out_dir, m, r.grid_stage1)
        return out
