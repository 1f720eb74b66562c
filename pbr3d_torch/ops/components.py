"""Connected components on the host (scipy/numpy) — the production path.

Copied from ``pbr3d.ops.components`` (whose module imports jax): the
scipy-identical labeller and the bbox/count/centroid statistics that stage 1's
component-guided carve and back-minaret recolor and stage 2's minaret
keypoints consume.  The JAX package's device labeller is not ported;
production routes labelling to the host, and so do the public
:func:`connected_components` and :func:`component_stats` here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_BIG = np.int32(2**30)


def _host_component_stats(labels: np.ndarray, n: int, centroid_axes=None):
    """Host bbox/centroid/count: find_objects (fast C) for the bboxes, then
    counts/centroids via weighted bincounts — O(N) total, independent of the
    component count (the previous per-component argwhere loop cost ~10 s on
    scenes with many components on this container's weak CPU).

    ``centroid_axes``: which centroid columns to fill (None = all axes,
    () = none).  Each axis materializes a float64 weight array the size of
    ``labels`` — on near-full-grid crops that is a ~134 MB temporary whose
    allocation intermittently stalls for seconds on this box (memory
    compaction), so callers that only need bboxes/counts skip it."""
    import scipy.ndimage

    nd = labels.ndim
    rows = n + 1
    mins = np.full((rows, nd), _BIG, np.int64)
    maxs = np.full((rows, nd), -1, np.int64)

    slices = scipy.ndimage.find_objects(labels, max_label=n)
    vol = 0
    for i, sl in enumerate(slices, start=1):
        if sl is None:
            continue
        mins[i] = [s.start for s in sl]
        maxs[i] = [s.stop - 1 for s in sl]
        vol += int(np.prod([s.stop - s.start for s in sl]))

    counts = np.zeros((rows,), np.float64)
    centroid = np.zeros((rows, nd), np.float64)
    axes = tuple(range(nd)) if centroid_axes is None else tuple(centroid_axes)

    if vol * (1 + len(axes)) < labels.size:
        # sparse components (e.g. minaret columns inside a near-full-grid
        # crop): per-slice reductions touch only the bbox volumes —
        # axis profiles via sum() then a dot with arange, no argwhere
        for i, sl in enumerate(slices, start=1):
            if sl is None:
                continue
            local = labels[sl] == i
            c = float(local.sum())
            counts[i] = c
            if c == 0.0:
                continue
            for ax in axes:
                other = tuple(a for a in range(nd) if a != ax)
                prof_ax = local.sum(axis=other, dtype=np.float64)
                idx = np.arange(sl[ax].start, sl[ax].stop, dtype=np.float64)
                centroid[i, ax] = float(prof_ax @ idx) / c
        return {
            "bbox_min": mins,
            "bbox_max": maxs,
            "centroid": centroid,
            "count": counts,
        }

    # np.bincount fast-paths ONLY intp input: on this numpy (2.0.2) an int32
    # array goes through a ~500x slower path (measured 10.4 s vs 0.018 s on
    # 5.9M elements) — always upcast
    flat = labels.ravel().astype(np.intp, copy=False)
    counts = np.bincount(flat, minlength=rows)[:rows].astype(np.float64)
    counts[0] = 0.0  # background is not a component
    occupied = counts > 0
    for ax in axes:
        shape = [1] * nd
        shape[ax] = labels.shape[ax]
        w = np.broadcast_to(
            np.arange(labels.shape[ax], dtype=np.float64).reshape(shape),
            labels.shape,
        )
        sums = np.bincount(flat, weights=w.ravel(), minlength=rows)[:rows]
        centroid[occupied, ax] = sums[occupied] / counts[occupied]
    return {
        "bbox_min": mins,
        "bbox_max": maxs,
        "centroid": centroid,
        "count": counts,
    }


#: Below this voxel count the axis-0 divide-and-conquer in
#: ``_host_scipy_label`` stops paying for its occupancy scan.
_LABEL_SPLIT_MIN = 1 << 21


def _host_scipy_label(mask_np: np.ndarray, connectivity: str) -> Tuple[np.ndarray, int]:
    """Connected components, scipy-identical output (labels AND numbering).

    Large 3-D inputs are split along axis 0 at an EMPTY slab when one
    exists: no component can cross an all-empty plane (under either face
    or full connectivity), and scipy numbers components by first-voxel
    scan order with axis 0 outermost, so labeling the two sides
    independently and offsetting the right side's ids reproduces scipy's
    exact numbering.  The carving parts this labels (e.g. minarets at the
    grid's x-extremes inside a near-full-grid bbox) typically halve, and
    each side then recurses on its own tight x-range — the multi-second
    full-grid labels on this 1-core host drop to the occupied slices."""
    import scipy.ndimage

    structure = None
    if connectivity == "full":
        structure = np.ones((3,) * mask_np.ndim, dtype=bool)

    if mask_np.ndim == 3 and mask_np.size >= _LABEL_SPLIT_MIN:
        colocc = mask_np.any(axis=(1, 2))
        nz = np.flatnonzero(colocc)
        if nz.size == 0:
            return np.zeros(mask_np.shape, np.int32), 0
        x0, x1 = int(nz[0]), int(nz[-1]) + 1
        # largest interior empty run within the occupied x-range
        runs = np.flatnonzero(~colocc[x0:x1])
        split = None
        if runs.size:
            breaks = np.flatnonzero(np.diff(runs) > 1)
            starts = np.concatenate([[0], breaks + 1])
            ends = np.concatenate([breaks, [runs.size - 1]])
            lens = runs[ends] - runs[starts] + 1
            k = int(np.argmax(lens))
            split = x0 + int(runs[starts[k]])  # first empty x of the run
        out = np.zeros(mask_np.shape, np.int32)
        if split is not None:
            left, nl = _host_scipy_label(mask_np[x0:split], connectivity)
            right, nr = _host_scipy_label(mask_np[split:x1], connectivity)
            out[x0:split] = left
            np.add(right, np.int32(nl), out=right, where=right > 0)
            out[split:x1] = right
            return out, nl + nr
        if x1 - x0 < mask_np.shape[0]:
            inner, n = _host_scipy_label(mask_np[x0:x1], connectivity)
            out[x0:x1] = inner
            return out, n

    labels, n = scipy.ndimage.label(mask_np, structure=structure)
    return labels.astype(np.int32), int(n)


def connected_components(mask, connectivity: str = "face") -> Tuple[np.ndarray, int]:
    """Label connected components of a boolean 2D/3D host mask.

    ``connectivity``: "face" (scipy default: 4-conn in 2D, 6-conn in 3D) or
    "full" (3^d box: 8-conn in 2D, 26-conn in 3D).  Returns ``(labels int32,
    n)``: 0 is background, 1..n in scipy raster order."""
    return _host_scipy_label(np.asarray(mask), connectivity)


def component_stats(labels: np.ndarray, n: int):
    """Per-component ``bbox_min``, ``bbox_max`` (inclusive), ``centroid`` and
    ``count``, host arrays indexed by component id 1..n (row 0 unused)."""
    return _host_component_stats(np.asarray(labels), n)
