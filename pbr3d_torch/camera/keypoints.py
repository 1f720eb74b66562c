"""Minaret anchor extraction — 3D components in the voxel grid, 2D regions in
the mask — and top/bottom keypoints, as in ``pbr3d.camera.keypoints``.

The 3D components are labelled and measured where the grid lies (the
components kernels for a CUDA grid, the host's scipy otherwise); the 2D
regions and the keypoints are host numpy/scipy work on host label planes.
The keypoint dicts equal the JAX package's.

Conventions preserved from the reference (utils/camera_estimation.py:20-50,
176-210, 247-344):

* 3D: components of each minaret color (face connectivity), ranked by height
  (extent along dim 1); >= 4 required; the 4 tallest split left/right by
  centroid dim-0, each side ordered by centroid dim-2 -> LM1, LM2, RM1, RM2.
  Component point sets stay in ``np.argwhere`` (d0, d1, d2) order — the
  reference feeds these raw index triples to the projector, and downstream
  eval (notebook 4) depends on that convention.
* 2D: 8-connected regions of each minaret color, area >= min_area; sorted
  left-to-right by centroid x and split at the midpoint; front/back chosen by
  (color priority, then smaller centroid y).
* keypoints: bottom/top = mean of the component's points at min/max dim-1
  (3D) and of the region's pixels at min/max row (2D).  The stage-2 filter
  keeps M1 top+bottom and M2 top only.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from pbr3d_torch import config
from pbr3d_torch.ops.components import component_stats, connected_components, label_part

MINARET_PARTS = ("front_minarets", "back_minarets")


def _component_coords(comp: torch.Tensor, stats, cid: int, off: np.ndarray) -> np.ndarray:
    """(M, 3) int64 coords of component ``cid`` of the crop labels ``comp``
    in the grid's frame (crop offset ``off``), in np.argwhere's raster
    order: ``torch.nonzero`` over the component's bbox slice of the crop,
    moved to the grid's frame where the crop lies, and one download."""
    lo = stats["bbox_min"][cid]
    sl = tuple(slice(int(a), int(b) + 1) for a, b in zip(lo, stats["bbox_max"][cid]))
    # the shift is added before the download: on the host each add makes a
    # new array of the component's size (~15 MB at 512), slower than the card
    shift = torch.from_numpy(lo + off).to(comp.device)
    return (torch.nonzero(comp[sl] == cid) + shift).cpu().numpy()


def extract_minaret_voxels_by_label(
    grid_labels,
    minaret_parts: Sequence[str] = MINARET_PARTS,
) -> Dict[str, np.ndarray]:
    """name -> (M, 3) int64 component coords in (d0, d1, d2) order.

    ``grid_labels``: an array or a tensor.  Each part is labelled and
    measured where the grid lies, on its occupied bbox (:func:`label_part`,
    spans ``stage2.minarets.*``): a CUDA grid by the components kernels,
    each crop counted as ``stage2.device_labels``; a CPU tensor or an array
    by the host's scipy.  Only the four tallest components' coordinates
    are taken, each on the grid's device, and cross to the host."""
    grid = grid_labels if isinstance(grid_labels, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(grid_labels))
    # (centroid, height, (crop labels, statistics, cid, crop offset))
    components: List[Tuple[np.ndarray, int, tuple]] = []
    for part in minaret_parts:
        found = label_part(grid, config.PART_IDS[part], "stage2.minarets", part=part)
        if found is None:
            continue
        comp, n, stats, box = found
        off = np.array([s.start for s in box], np.int64)
        for cid in range(1, n + 1):
            if stats["count"][cid] == 0:
                continue
            centroid = stats["centroid"][cid] + off
            height = int(stats["bbox_max"][cid, 1] - stats["bbox_min"][cid, 1])
            components.append((centroid, height, (comp, stats, cid, off)))

    if len(components) < 4:
        raise ValueError(f"Expected >=4 minarets, found {len(components)}")

    top4 = sorted(components, key=lambda c: -c[1])[:4]
    centroids = np.stack([c[0] for c in top4])
    coord_sets = [_component_coords(*c[2]) for c in top4]

    order_x = np.argsort(centroids[:, 0])
    left = sorted(order_x[:2], key=lambda i: centroids[i, 2])
    right = sorted(order_x[2:], key=lambda i: centroids[i, 2])
    return {
        "LM1": coord_sets[left[0]],
        "LM2": coord_sets[left[1]],
        "RM1": coord_sets[right[0]],
        "RM2": coord_sets[right[1]],
    }


def extract_minaret_masks_by_label(
    mask_labels: np.ndarray,
    minaret_parts: Sequence[str] = MINARET_PARTS,
    min_area: int = 50,
) -> Dict[str, np.ndarray]:
    """name -> (H, W) uint8 binary region mask."""
    mask_labels = np.asarray(mask_labels)
    regions = []
    comps = {}
    for color_idx, part in enumerate(minaret_parts):
        pid = config.PART_IDS[part]
        comp, n = connected_components(mask_labels == pid, "full")  # 8-conn
        comps[color_idx] = comp
        if n == 0:
            continue
        stats = component_stats(comp, n)
        for cid in range(1, n + 1):
            area = stats["count"][cid]
            if area < min_area:
                continue
            regions.append(
                {
                    "color_idx": color_idx,
                    "centroid": tuple(stats["centroid"][cid]),  # (y, x)
                    "label": cid,
                }
            )

    if len(regions) < 2:
        raise ValueError("Not enough minarets for camera alignment")

    regions.sort(key=lambda r: r["centroid"][1])
    mid = len(regions) // 2
    halves = [regions[:mid], regions[mid:]]

    def pick(side):
        if len(side) == 1:
            return side[0], None
        side = sorted(side, key=lambda r: (r["color_idx"], r["centroid"][0]))
        return side[0], side[1]

    (lm1, lm2), (rm1, rm2) = pick(halves[0]), pick(halves[1])

    out = {}
    for name, region in (("LM1", lm1), ("RM1", rm1), ("LM2", lm2), ("RM2", rm2)):
        if region is None:
            continue
        out[name] = (comps[region["color_idx"]] == region["label"]).astype(np.uint8)
    return out


def extract_top_bottom_voxel_points(
    voxel_parts: Dict[str, np.ndarray]
) -> Dict[str, np.ndarray]:
    """{name}_bottom / {name}_top: mean point at min/max dim-1
    (reference: camera_estimation.py:329-335)."""
    out = {}
    for name, coords in voxel_parts.items():
        ys = coords[:, 1]
        out[f"{name}_bottom"] = coords[ys == ys.min()].mean(axis=0)
        out[f"{name}_top"] = coords[ys == ys.max()].mean(axis=0)
    return out


def extract_top_bottom_image_points(
    mask_parts: Dict[str, np.ndarray]
) -> Dict[str, Tuple[float, float]]:
    """{name}_top / {name}_bottom: (mean x at extreme row, extreme row)
    (reference: camera_estimation.py:338-344)."""
    out = {}
    for name, mask in mask_parts.items():
        ys, xs = np.nonzero(mask)
        out[f"{name}_top"] = (float(xs[ys == ys.min()].mean()), float(ys.min()))
        out[f"{name}_bottom"] = (float(xs[ys == ys.max()].mean()), float(ys.max()))
    return out


def extract_minaret_kps_for_view(
    grid_labels: np.ndarray,
    mask_labels: np.ndarray,
    minaret_parts: Sequence[str] = MINARET_PARTS,
    voxel_parts: Dict[str, np.ndarray] | None = None,
) -> Tuple[Dict[str, np.ndarray], Dict[str, Tuple[float, float]]]:
    """Matched voxel/image keypoints for one view, with the stage-2 filter:
    M1 anchors keep top+bottom, M2 anchors keep top only
    (reference: camera_estimation.py:20-50).

    ``voxel_parts`` optionally injects the 3D minaret components — they
    depend only on the grid, so callers processing several views of one
    monument compute them once (the 3D labeling is the stage-2 host
    hot spot, SURVEY §6: ~13 s at 512³ in the reference)."""
    if voxel_parts is None:
        voxel_parts = extract_minaret_voxels_by_label(grid_labels, minaret_parts)
    mask_parts = extract_minaret_masks_by_label(mask_labels, minaret_parts)

    # The reference's `list(set & set)` (camera_estimation.py:29) leaves the
    # pairing order to the per-process string-hash seed; float residual
    # summation order then perturbs the LM fit in the last bits, which the
    # downstream random search amplifies to visibly different cameras.
    # Sorting fixes the order (the SELECTION is identical) so runs are
    # reproducible across processes.
    common = sorted(set(voxel_parts) & set(mask_parts))
    if len(common) < 2:
        raise ValueError("Not enough visible minarets")

    voxel_kps = extract_top_bottom_voxel_points({k: voxel_parts[k] for k in common})
    image_kps = extract_top_bottom_image_points({k: mask_parts[k] for k in common})

    voxel_sel, image_sel = {}, {}
    for k in voxel_kps:
        m = k.split("_")[0]
        if ("1" in m) or ("2" in m and "top" in k):
            voxel_sel[k] = voxel_kps[k]
            image_sel[k] = image_kps[k]
    if len(voxel_sel) < 2:
        raise ValueError("Not enough keypoints after filtering")
    return voxel_sel, image_sel
