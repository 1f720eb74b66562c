"""Stage 1, production path: ``carve_monument_fused`` for one scene and
``carve_monuments_batched`` for several.

Port of ``pbr3d.carving.fused``.  The JAX version pads every grid, window and
mask to buckets so that monuments and component crops share compiled TPU
programs; PyTorch runs eagerly, so the port works at the true extents.  The
plans are origin-embedded and the padding is always empty, so this changes
no voxel: the result is bit-identical to the JAX package (and therefore to
the reference implementation).

Phases (reference: utils/voxel_carving_utils.py:269-400):

1. global carve + per-part-group re-carve (device sweeps);
2. component-guided carve: each part labelled on its occupied bbox
   (:func:`~pbr3d_torch.ops.components.label_part`), then the device
   sweeps of the component bbox windows;
3. interior extrusion of doors/windows in the four directions (device);
4. the persistent transpose+flip reorientation and the back-minaret
   recolor (device), then the grid's one download.

A CUDA grid stays on the card until that download: the labelling and the
component statistics run on the card, and only the parts' occupancy
profiles and the statistics cross to the host.  A CPU grid is labelled by
the host's scipy on its numpy view.

Batching.  Where the JAX package pads volumes to a common bucket and
``vmap``s, the port lays them side by side: a sweep works on an ``(H, W*D)``
plane and gathers along its second axis only, so several volumes become one
``(max H, sum of W*D)`` plane whose gather indices carry each volume's
offset.  No volume reads another's columns, rows past a volume's own height
hold nothing, and one set of launches sweeps them all.  The scenes of
``carve_monuments_batched`` and the windows of ``guided_carve_batched`` both
go through this layout (:func:`_stacked_plan_tensors`).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from pbr3d_torch import config
from pbr3d_torch.config import PART_IDS
from pbr3d_torch.ops.carve import _stacked_plans, sweep_scan
from pbr3d_torch.ops.components import label_part
from pbr3d_torch.utils import profiling
from pbr3d_torch.utils.streams import adopt, worker_stream

#: Bytes alive per plane element at the peak of the stacked global + group
#: carve: about nine uint8 planes (masks, grid, result, the group's
#: selection, occupancy and sweep state) and the sweep's int32 decision
#: plane, rounded up.
_SWEEP_BYTES_PER_ELEM = 16

#: ``mem_budget_bytes`` of :func:`carve_monuments_batched` on a CPU device;
#: on a CUDA device the default is half of the card's free memory.
_CPU_SWEEP_BUDGET = 4 << 30

#: Plane elements (max H x sum of W*D) per launch set of the guided windows.
_GUIDED_BATCH_ELEMS = 1 << 27


def _stacked_plan_tensors(whd: Sequence[Tuple[int, int, int]], angle: int, device):
    """Sweep plans of several ``(w, h, d)`` volumes laid side by side (see
    the module docstring): ``(idx (A, 4, N) int64, dec (A, N) int32, offsets)``
    with ``N = sum of w*d`` and ``offsets[i]`` volume i's first column."""
    offsets = np.concatenate([[0], np.cumsum([w * d for w, _, d in whd])]).astype(np.int64)
    plans = [_stacked_plans(w, d, int(angle)) for w, _, d in whd]
    idx = np.concatenate([p[0].astype(np.int64) + o for p, o in zip(plans, offsets)], axis=2)
    dec = np.concatenate([p[1] for p in plans], axis=1)
    return torch.from_numpy(idx).to(device), torch.from_numpy(dec).to(device), offsets


def _split_plane(plane: torch.Tensor, whd, offsets) -> List[torch.Tensor]:
    """The ``(w, h, d)`` views of a side-by-side plane."""
    return [
        plane[:h, int(o):int(o) + w * d].view(h, w, d).permute(1, 0, 2)
        for (w, h, d), o in zip(whd, offsets)
    ]


def _global_and_part_carve(
    mask_sets: Sequence,
    global_angle: int,
    group_ids: Tuple[Tuple[int, ...], ...],
    device,
) -> List[torch.Tensor]:
    """Global carve + per-group part carve of every scene in one set of
    launches; returns one contiguous ``(W, H, D)`` uint8 label grid a scene.

    All groups use the same (90°) sweep plans as the global carve — true for
    the reference's notebook preset (checked by the caller).
    """
    whd = [(ms.binary.shape[1], ms.binary.shape[0], ms.binary.shape[1]) for ms in mask_sets]
    idx, dec, offsets = _stacked_plan_tensors(whd, global_angle, device)
    shape = (max(h for _, h, _ in whd), int(offsets[-1]))

    def plane(masks_hw):
        """Each scene's (h, w) mask broadcast over depth into the layout."""
        out = torch.zeros(shape, dtype=torch.uint8, device=device)
        for m, (w, h, d), o in zip(masks_hw, whd, offsets):
            m = torch.from_numpy(np.ascontiguousarray(m, np.uint8)).to(device)
            out[:h, int(o):int(o) + w * d] = m[:, :, None].expand(h, w, d).reshape(h, w * d)
        return out

    binary = plane([ms.binary for ms in mask_sets])
    ext = plane([ms.exterior_labels for ms in mask_sets])
    grid = sweep_scan(torch.ones_like(binary), binary, idx, dec) * ext
    final = torch.zeros_like(grid)
    for ids in group_ids:
        m = torch.isin(ext, torch.tensor(ids, dtype=torch.uint8, device=device)).to(torch.uint8)
        sub = grid * m
        part = sub * sweep_scan((sub > 0).to(torch.uint8), m, idx, dec)
        final = torch.where(part > 0, part, final)
    return [g.contiguous() for g in _split_plane(final, whd, offsets)]


def _collect_guided_jobs(
    grid: torch.Tensor,  # (w, h, d) labels of one scene
    exterior_labels: np.ndarray,
    part_symmetry,
) -> List[Dict]:
    """One scene's window jobs of the component-guided carve (reference
    ``left_right_guided_carve``, voxel_carving_utils.py:163-210), without
    applying them: per component of each part its bbox window ``start``
    (full-frame), its own occupancy ``comp (w, h, d)`` bool, the bbox-cropped
    2D part mask ``m_wh (w, h)`` bool, both on the grid's device, and the
    sweep ``angle``.  Each part is labelled on its occupied bbox
    (:func:`~pbr3d_torch.ops.components.label_part`)."""
    jobs = []
    for part, angle in part_symmetry:
        target = PART_IDS[part]
        mask2d = exterior_labels == target
        if not mask2d.any():
            continue
        found = label_part(grid, target, "stage1.part", centroid_axes=(), part=part)
        if found is None:
            continue
        comp_c, n, stats, box = found
        X0, Y0, Z0 = (s.start for s in box)
        mask_hw = torch.from_numpy(mask2d).to(grid.device)
        for i in range(1, n + 1):
            # stats are in the crop frame; jobs carry full-frame coordinates
            lo = [int(v) for v in stats["bbox_min"][i]]
            hi = [int(v) + 1 for v in stats["bbox_max"][i]]
            x0, y0, z0 = lo[0] + X0, lo[1] + Y0, lo[2] + Z0
            x1, y1 = hi[0] + X0, hi[1] + Y0
            jobs.append(dict(
                start=(x0, y0, z0),
                comp=comp_c[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] == i,
                m_wh=mask_hw[y0:y1, x0:x1].T,
                angle=int(angle),
            ))
    return jobs


def _guided_erases(jobs: Sequence[Dict], angle: int, device) -> List[torch.Tensor]:
    """The carve decision of each window job (all of one ``angle``): the
    ``(w, h, d)`` bool voxels of its component that the sweep of the
    component's own occupancy against the window's part mask removes.  All
    windows go through one set of launches."""
    whd = [tuple(j["comp"].shape) for j in jobs]
    idx, dec, offsets = _stacked_plan_tensors(whd, angle, device)
    occ = torch.zeros((max(h for _, h, _ in whd), int(offsets[-1])), dtype=torch.uint8, device=device)
    mask = torch.zeros_like(occ)
    for j, (w, h, d), o in zip(jobs, whd, offsets):
        cols = slice(int(o), int(o) + w * d)
        occ[:h, cols] = j["comp"].permute(1, 0, 2).reshape(h, w * d)
        mask[:h, cols] = j["m_wh"].T[:, :, None].expand(h, w, d).reshape(h, w * d)
    carved = sweep_scan(occ, mask, idx, dec)
    return _split_plane((occ > 0) & (carved == 0), whd, offsets)


def _job_chunks(items):
    """Split ``(scene, job)`` items into runs whose side-by-side plane stays
    under ``_GUIDED_BATCH_ELEMS`` elements (a single larger window runs alone)."""
    chunk, hmax, cols = [], 0, 0
    for item in items:
        w, h, d = item[1]["comp"].shape
        if chunk and max(hmax, h) * (cols + w * d) > _GUIDED_BATCH_ELEMS:
            yield chunk
            chunk, hmax, cols = [], 0, 0
        chunk.append(item)
        hmax, cols = max(hmax, h), cols + w * d
    if chunk:
        yield chunk


def guided_carve_batched(
    grids: Mapping,  # scene -> (W, H, D) uint8 labels on the device; updated in place
    scene_jobs: Mapping,  # scene -> job list from _collect_guided_jobs
) -> Mapping:
    """Apply every scene's guided windows in a few sets of launches.

    Every window's carve decision reads only its own component's occupancy
    (the labels taken before any window ran are exact: a part's carve erases
    only its own voxels), so the decisions of all windows of one sweep angle
    are computed at once, ``_GUIDED_BATCH_ELEMS`` plane elements at a time.
    The write-backs only erase, each inside its own component, so no order
    of them can bring back a voxel that another window erased."""
    by_angle: Dict[int, list] = {}
    for scene, jobs in scene_jobs.items():
        for j in jobs:
            by_angle.setdefault(j["angle"], []).append((scene, j))
    for angle, items in sorted(by_angle.items()):
        for chunk in _job_chunks(items):
            device = grids[chunk[0][0]].device
            erases = _guided_erases([j for _, j in chunk], angle, device)
            for (scene, j), erase in zip(chunk, erases):
                (x0, y0, z0), (w, h, d) = j["start"], j["comp"].shape
                grids[scene][x0:x0 + w, y0:y0 + h, z0:z0 + d].masked_fill_(erase, 0)
    return grids


def guided_carve_all(
    grid: torch.Tensor,
    exterior_labels: np.ndarray,
    part_symmetry,
) -> torch.Tensor:
    """Component-guided carving of one scene for every part in
    ``part_symmetry``.  The grid stays on its device; each part is labelled
    where it lies (:func:`~pbr3d_torch.ops.components.label_part`).
    Updates ``grid`` in place and returns it."""
    return guided_carve_batched({0: grid}, {0: _collect_guided_jobs(grid, exterior_labels, part_symmetry)})[0]


def guided_carve_fused(
    grid: torch.Tensor,
    exterior_labels: np.ndarray,
    part_name: str,
    angle: int,
) -> torch.Tensor:
    """Single-part convenience wrapper over :func:`guided_carve_all`."""
    return guided_carve_all(grid, exterior_labels, [(part_name, angle)])


def _extrude(
    grid: torch.Tensor,  # (W, H, D) uint8 labels; updated in place
    mask_hw: torch.Tensor,  # (H, W) bool: the columns to extrude
    axis: int,
    positive: bool,
    depth: int,
    fill: int,
) -> None:
    """Set ``depth`` voxels to ``fill`` inward from the first occupied voxel
    of each masked column along ``axis`` (2 or 0), from the front (+) or the
    back (-) (reference extrude_from_surface, voxel_carving_utils.py:213-248).

    Empty columns start at index 0 (+) or size-1 (-), as in the reference:
    ``argmax`` over a uint8 axis returns the first maximal index in torch as
    in JAX.  The JAX version ORs ``depth`` one-voxel slabs; here the band is
    ``start <= c < start + depth`` (or its mirror), the same voxels since
    every coordinate lies inside the grid.  Along axis 0 the (H, W) mask is
    read as (H, D), the reference's quirk (stage-1 grids have W == D).
    """
    occ = (grid > 0).to(torch.uint8)
    size = grid.shape[axis]
    if positive:
        start = occ.argmax(dim=axis)
    else:
        start = (size - 1) - occ.flip(axis).argmax(dim=axis)
    coord = torch.arange(size, device=grid.device)
    if axis == 2:
        coord, start, valid = coord.view(1, 1, size), start[:, :, None], mask_hw.T[:, :, None]
    elif axis == 0:
        coord, start, valid = coord.view(size, 1, 1), start[None], mask_hw[None]
    else:
        raise ValueError("axis must be 0 or 2")
    if positive:
        band = (coord >= start) & (coord < start + depth)
    else:
        band = (coord <= start) & (coord > start - depth)
    grid.masked_fill_(band & valid, fill)


def _extrude_all(
    grid: torch.Tensor,  # (W, H, D) uint8 labels; updated in place
    sem_wh: torch.Tensor,  # (W, H) full-semantic labels (transposed)
    jobs: Tuple[Tuple[int, int], ...],  # (part_id, depth)
) -> torch.Tensor:
    """All interior extrusions (reference extrude_4dirs x parts,
    voxel_carving_utils.py:356-373): paint ``depth`` voxels inward from the
    first occupied voxel of each masked column along +Z, -Z, +X, -X."""
    for pid, depth in jobs:
        mask_hw = (sem_wh == pid).T
        for axis, positive in ((2, True), (2, False), (0, True), (0, False)):
            _extrude(grid, mask_hw, axis, positive, depth, pid)
    return grid


def recolor_back(
    g: torch.Tensor,  # (d, h, w) uint8, ALREADY reoriented; edited in place
    k: int = 2,
    sort_axis: int = 0,
    part_name: str = "front_minarets",
    new_part_name: str = "back_minarets",
) -> torch.Tensor:
    """Back-minaret recolor of an already-reoriented grid (reference
    voxel_carving_utils.py:252-266): all but the ``k`` front-most
    ``part_name`` components (smallest mean coordinate along ``sort_axis``,
    ties to the lower component id) become ``new_part_name``.  Labelling
    runs where the grid lies, on the part's occupied bbox
    (:func:`~pbr3d_torch.ops.components.label_part`); the downloaded
    centroids are ranked on the host and the recolor runs on the grid's
    device."""
    found = label_part(g, PART_IDS[part_name], "stage1.recolor", centroid_axes=(sort_axis,))
    if found is None or found[1] <= k:
        return g
    comp, n, stats, box = found
    # crop-frame centroids: the constant bbox offset does not change the
    # front-most ranking along sort_axis
    means = stats["centroid"][1 : n + 1, sort_axis]
    keep = set((np.argsort(means, kind="stable")[:k] + 1).tolist())
    recolor = torch.tensor([i for i in range(1, n + 1) if i not in keep], dtype=torch.int32, device=comp.device)
    g[box].masked_fill_(torch.isin(comp, recolor), PART_IDS[new_part_name])
    return g


def recolor_back_host(
    g: np.ndarray,  # (d, h, w) uint8, ALREADY reoriented, host; edited in place
    k: int = 2,
    sort_axis: int = 0,
    part_name: str = "front_minarets",
    new_part_name: str = "back_minarets",
) -> np.ndarray:
    """:func:`recolor_back` of a host grid (the JAX package's twin)."""
    if not g.flags.writeable:
        g = g.copy()
    recolor_back(torch.from_numpy(g), k, sort_axis, part_name, new_part_name)
    return g


def reorient(g: torch.Tensor) -> torch.Tensor:
    """The transpose(2,1,0)+flip(1) frame change the reference applies before
    recoloring and never undoes (voxel_carving_utils.py:383-386)."""
    return torch.flip(g.permute(2, 1, 0), (1,))


def reorient_recolor_host(
    grid_true: np.ndarray,  # (w, h, d) uint8, TRUE extent, host
    k: int = 2,
    sort_axis: int = 0,
) -> np.ndarray:
    """The persistent transpose(2,1,0)+flip(1) reorientation followed by the
    back-minaret recolor (reference voxel_carving_utils.py:252-266,383-393),
    entirely on host (the production route reorients on the device before
    the download and calls :func:`recolor_back_host` directly)."""
    g = np.flip(np.transpose(grid_true, (2, 1, 0)), axis=1).copy()
    return recolor_back_host(g, k, sort_axis)


def _preset_sweeps(preset: config.CarvePreset):
    """(group label ids, extrusion jobs) of a preset the fused path supports."""
    angles = {angle for _, angle in preset.group_jobs}
    if angles != {preset.global_angle_interval}:
        raise NotImplementedError(
            "fused stage 1 assumes group angles == global angle; for presets whose "
            "group angles differ use pbr3d_torch.carving.stage1.carve_monument"
        )
    group_ids = tuple(tuple(int(i) for i in config.part_ids(names)) for names, _ in preset.group_jobs)
    return group_ids, tuple((PART_IDS[p], int(depth)) for p, depth in preset.extrusion_depths)


def _finish_scene(grid: torch.Tensor, mask_set, preset: config.CarvePreset) -> np.ndarray:
    """Phases 2-4 of one scene from its global + group carve ``grid``
    (W, H, D), which may come from another thread's stream; returns the host
    grid, reoriented and recoloured, in the scene's one download."""
    adopt(grid)
    with profiling.span("stage1.guided"):
        grid = guided_carve_all(grid, mask_set.exterior_labels, preset.part_symmetry)
    jobs = _preset_sweeps(preset)[1]
    if jobs:
        sem_wh = torch.from_numpy(np.ascontiguousarray(mask_set.semantic_labels.T)).to(grid.device)
        with profiling.span("stage1.extrude"):
            grid = _extrude_all(grid, sem_wh, jobs)
    if preset.recolor_back_minarets:
        grid = reorient(grid)
        with profiling.span("stage1.recolor"):
            recolor_back(grid)
    with profiling.span("stage1.download"):
        return grid.cpu().numpy()


def carve_monument_fused(
    mask_set,
    preset: config.CarvePreset = config.DEFAULT_CARVE_PRESET,
    *,
    device,
) -> np.ndarray:
    """Full stage 1 for one monument on ``device``.  Returns the uint8 label
    grid as host numpy, true extent, reoriented frame — identical to
    ``pbr3d.carving.fused.carve_monument_fused``."""
    group_ids = _preset_sweeps(preset)[0]
    with profiling.span("stage1.sweep"):
        grid, = _global_and_part_carve([mask_set], preset.global_angle_interval, group_ids, device)
    return _finish_scene(grid, mask_set, preset)


def _sweep_working_set(mask_sets) -> int:
    """Bytes the stacked global + group carve of these scenes keeps alive at
    its peak: ``_SWEEP_BYTES_PER_ELEM`` per element of the side-by-side plane
    (max H x sum of W*D), plus its int64 gather plan (4 corners x 8 bytes per
    column for the one non-zero sweep angle of the default preset)."""
    hs, ws = zip(*(ms.binary.shape for ms in mask_sets))
    columns = sum(w * w for w in ws)
    return _SWEEP_BYTES_PER_ELEM * max(hs) * columns + 4 * 8 * columns


def carve_monuments_batched(
    mask_sets: Mapping,
    preset: config.CarvePreset = config.DEFAULT_CARVE_PRESET,
    mem_budget_bytes: Optional[int] = None,
    on_grid: Optional[Callable[[str, np.ndarray], None]] = None,
    *,
    device,
) -> Dict[str, np.ndarray]:
    """Stage 1 for MANY monuments on ``device``; ``{monument: MaskSet}`` in,
    ``{monument: label grid}`` out, each grid bit-identical to
    :func:`carve_monument_fused`'s.

    When the side-by-side plane of all scenes fits ``mem_budget_bytes`` of
    sweep working set (:func:`_sweep_working_set`; default: half of the
    card's free memory, ``_CPU_SWEEP_BUDGET`` on a CPU device), the global +
    group carves of all scenes run as one set of launches; else each scene
    sweeps on its own.  Either way two worker threads, each on a CUDA stream
    of its own, take the scenes through their remaining phases, so scene i's
    host work (launches, statistics and downloads) overlaps scene i+1's
    device work; one worker when two scenes' sweeps would not fit.

    ``on_grid(monument, grid)`` is called in the caller's thread, in the
    order of ``mask_sets``, as each scene finalizes, so per-scene downstream
    work can start while the remaining scenes finish."""
    names = list(mask_sets)
    if not names:
        return {}
    device = torch.device(device)
    if mem_budget_bytes is None:
        mem_budget_bytes = (torch.cuda.mem_get_info(device)[0] // 2 if device.type == "cuda"
                            else _CPU_SWEEP_BUDGET)
    group_ids = _preset_sweeps(preset)[0]
    sets = [mask_sets[m] for m in names]
    workers = 2
    if _sweep_working_set(sets) <= mem_budget_bytes:
        with profiling.span("stage1.sweep"):
            grids = _global_and_part_carve(sets, preset.global_angle_interval, group_ids, device)
        tasks = [lambda g=g, ms=ms: _finish_scene(g, ms, preset) for g, ms in zip(grids, sets)]
        del grids
    else:
        tasks = [lambda ms=ms: carve_monument_fused(ms, preset, device=device) for ms in sets]
        if 2 * max(_sweep_working_set([ms]) for ms in sets) > mem_budget_bytes:
            workers = 1

    submitter = torch.cuda.current_stream(device) if device.type == "cuda" else None

    def run(task):
        with worker_stream(device, after=submitter):
            return task()

    out = {}
    with ThreadPoolExecutor(max_workers=min(workers, len(names))) as ex:
        futs = [ex.submit(profiling.carried(run), task) for task in tasks]
        del tasks
        try:
            for m, fut in zip(names, futs):
                out[m] = fut.result()
                if on_grid is not None:
                    on_grid(m, out[m])
        except BaseException:
            ex.shutdown(wait=True, cancel_futures=True)
            raise
    return out
