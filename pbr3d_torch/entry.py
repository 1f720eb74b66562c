"""The condensed forward of the whole pipeline, as ``__graft_entry__.entry()``.

``entry(device=...)`` returns ``(forward, args)`` on the same deterministic
64³ synthetic scene as the JAX package's entry point; ``forward(*args)``
chains the compute spine of all three stages:

1. stage 1: the global carve, the per-group part carve
   (``DEFAULT_CARVE_PRESET.group_jobs``) and one component-guided window
   carve at 45°, swept at its true extent with ``sweep_volume``;
2. the splat of the carved grid and its mean part IoU against the
   exterior labels, and one stage-2 population of 8 cameras scored by the
   mask-IoU search's objective (``camera.align._batch_iou``: on the card the
   hand-written ``splat_iou_kernel``);
3. one stage-3 candidate batch of 4 deforms of the dome, scored by the
   visible-IoU objective against its own identity silhouette rolled 3 rows
   down (the planted optimum is the shift_y = 3 candidate).

It returns ``(grid, mean part IoU, best camera IoU, best deform IoU)`` —
the same grid and scalars as the JAX forward.  The JAX package's
``dryrun_multichip`` is not ported: the port runs on one card.
"""

from __future__ import annotations

import numpy as np
import torch

from pbr3d_torch import config
from pbr3d_torch.camera.align import _batch_iou
from pbr3d_torch.carving.stage1 import global_carve, part_carve
from pbr3d_torch.deform.search import _batch_deform_visible_iou
from pbr3d_torch.ops.carve import _stacked_plans, plans_to_device, sweep_volume
from pbr3d_torch.ops.components import _host_component_stats, _host_scipy_label
from pbr3d_torch.ops.projection import partwise_iou, splat_labels, zbuffer

_PARTS = ("full_building", "dome", "front_minarets")


def _synthetic_masks(h: int, w: int):
    """A deterministic monument-like (binary, exterior labels) mask pair."""
    ext = np.full((h, w), config.BACKGROUND_ID, np.uint8)
    ext[h // 4: h - 2, w // 4: 3 * w // 4] = config.PART_IDS["full_building"]
    ext[h // 8: h // 4 + 2, 3 * w // 8: 5 * w // 8] = config.PART_IDS["dome"]
    ext[h // 6: h - 2, w // 8: w // 8 + 2] = config.PART_IDS["front_minarets"]
    ext[h // 6: h - 2, w - w // 8 - 2: w - w // 8] = config.PART_IDS["front_minarets"]
    return (ext != config.BACKGROUND_ID).astype(np.uint8), ext


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def entry(*, device):
    """(forward, (binary, exterior labels, camera 9-vector)) on ``device``."""
    H = W = 64
    binary, ext = _synthetic_masks(H, W)
    cam = np.array(
        [W / 2, H / 2, -3.0 * W, W / 2, H / 2, W / 2, 2.0 * W, W / 2, H / 2], np.float32)
    # the full lattice as (x, y, z) points in x-major order: point n =
    # a*(H*W) + b*W + c is (a, b, c) and carries grid[c, b, a]
    xs, ys, zs = np.meshgrid(np.arange(W), np.arange(H), np.arange(W), indexing="ij")
    pts = torch.as_tensor(np.stack([xs, ys, zs], -1).reshape(-1, 3).astype(np.float32),
                          device=device)

    # Host prep of the guided window: the largest front-minaret component
    # of the global carve, its bbox and the 45° plans at its true extent.
    # The JAX forward slices a window of the 16-rounded extent with
    # ``dynamic_slice``, which clamps the window into the grid; the carve's
    # erasures land where that window sits.
    g0 = global_carve(binary, ext, 90, device=device).cpu().numpy()
    target = config.PART_IDS["front_minarets"]
    comp, n = _host_scipy_label(g0 == target, "face")
    stats = _host_component_stats(comp, n)
    i = 1 + int(np.argmax(stats["count"][1:]))
    lo = [int(v) for v in stats["bbox_min"][i]]
    hi = [int(v) + 1 for v in stats["bbox_max"][i]]
    ext_true = [b - a for a, b in zip(lo, hi)]
    at = [max(0, min(a, s - _round_up(e, 16))) for a, e, s in zip(lo, ext_true, g0.shape)]
    occ = torch.as_tensor(comp[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] == i, device=device)
    m_wh = torch.as_tensor(np.ascontiguousarray((ext == target)[lo[1]:hi[1], lo[0]:hi[0]].T),
                           device=device)
    plans = plans_to_device(_stacked_plans(ext_true[0], ext_true[2], 45), device)
    window = tuple(slice(a, a + e) for a, e in zip(at, ext_true))

    cam_pop = np.tile(cam, (8, 1)).astype(np.float32)
    cam_pop[1:, 2] += np.linspace(-8, 8, 7)
    cam_pop[1:, 6] += np.linspace(-10, 10, 7)
    deform_pop = np.array(
        [[1.0, 0.0, 1.0, 0.0], [1.1, 0.0, 1.0, 0.0],
         [1.0, 3.0, 1.0, 0.0], [0.9, 0.0, 1.1, 1.0]], np.float32)
    dome_id = config.PART_IDS["dome"]
    lf0 = torch.as_tensor(g0, device=device).permute(2, 1, 0).reshape(-1)
    zb0 = zbuffer(pts, lf0 == dome_id, cam[0:3], cam[3:6], cam[6], cam[7], cam[8], H, W)
    gt_dome = torch.as_tensor(np.roll(np.isfinite(zb0.cpu().numpy()), 3, axis=0), device=device)
    part_ids = [config.PART_IDS[p] for p in _PARTS]

    def forward(binary_hw: np.ndarray, ext_hw: np.ndarray, cam_vec: np.ndarray):
        # --- stage 1: global + group carve + one guided window ---
        grid = global_carve(binary_hw, ext_hw, 90, device=device)
        grid = part_carve(grid, ext_hw, config.DEFAULT_CARVE_PRESET.group_jobs, device=device)
        carved = sweep_volume(occ.to(torch.uint8), m_wh, plans)
        grid[window].masked_fill_(occ & (carved == 0), 0)

        ext_t = torch.as_tensor(ext_hw, device=device)
        cv = torch.as_tensor(cam_vec, device=device)
        labels_flat = grid.permute(2, 1, 0).reshape(-1)
        img = splat_labels(pts, labels_flat, labels_flat > 0, cv[0:3], cv[3:6], cv[6], cv[7],
                           cv[8], H, W)
        _, mean_iou = partwise_iou(img, ext_t, part_ids)

        # --- stage 2: one population step of the mask-IoU camera search ---
        occupied = labels_flat > 0
        cam_ious = _batch_iou(torch.as_tensor(cam_pop, device=device), pts[occupied],
                              labels_flat[occupied], ext_t, part_ids, H, W)

        # --- stage 3: one candidate batch of the deform search ---
        dome = pts[labels_flat == dome_id]
        center = (dome.to(torch.float64).sum(0).to(torch.float32)
                  / torch.tensor(float(max(dome.shape[0], 1)), device=device))
        deform_ious = _batch_deform_visible_iou(
            torch.as_tensor(deform_pop, device=device), dome, cv, gt_dome,
            torch.full((H, W), float("inf"), device=device), (H, W), (W, H, W), center,
        )
        return grid, mean_iou, cam_ious.max(), deform_ious.max()

    return forward, (binary, ext, cam)
