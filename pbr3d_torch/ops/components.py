"""Connected components and their statistics, on the host and on the card.

Port of ``pbr3d.ops.components`` (whose module imports jax).  Which route
each entry takes:

* :func:`connected_components_device` labels a tensor where it lies: a
  CUDA tensor through the hand-written kernel
  (:func:`pbr3d_torch.ops.cuda_kernels.components_kernel`, which raises on
  a failed build or launch), a CPU tensor through its plain PyTorch version
  (:func:`pbr3d_torch.ops.cuda_kernels.components_plain`).  The labels stay
  on the tensor's device, for the unfused stage-1 route, which slices them
  there (:mod:`pbr3d_torch.carving.stage1`).
* :func:`connected_components` returns host numpy: a numpy mask goes to the
  host labeller :func:`_host_scipy_label`, a tensor through
  :func:`connected_components_device`.
* :func:`component_stats` returns host numpy: numpy labels go to
  :func:`_host_component_stats`, a tensor to the device statistics
  (:func:`pbr3d_torch.ops.cuda_kernels.component_stats_kernel` on the
  card, :func:`~pbr3d_torch.ops.cuda_kernels.component_stats_plain` on the
  CPU), whose values are bit-equal to the host's.

Every route numbers components 1..n in scipy's raster order (the order of
each component's first voxel).  Both stage-1 routes and stage 2's 3D
minarets label a part of a label grid through :func:`label_part`, which
sends a CUDA grid to the kernels and a CPU grid to the host helpers; the
voxel helpers and the morphology call the host helpers explicitly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pbr3d_torch.ops.cuda_kernels import (
    COMPONENTS_BIG, component_stats_kernel, component_stats_plain, components_kernel, components_plain,
)
from pbr3d_torch.utils import profiling

_BIG = np.int32(COMPONENTS_BIG)


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


def _volume(t: torch.Tensor, what: str) -> torch.Tensor:
    """A 2- or 3-D tensor as a contiguous (X, Y, Z) volume; a plane (H, W)
    becomes (1, H, W)."""
    if t.dim() not in (2, 3):
        raise ValueError(f"{what} must have 2 or 3 dims, got shape {tuple(t.shape)}")
    return t.contiguous().reshape((1,) * (3 - t.dim()) + tuple(t.shape))


def connected_components_device(mask, connectivity: str = "face", max_k: int = 256):
    """Like :func:`connected_components` but keeping the labels on the
    mask's device, for consumers that slice or compare them there.

    ``mask``: a bool or uint8 tensor (any other dtype: non-zero is set) of
    2 or 3 dims; an array goes to the CPU.  Returns ``(labels int32 of the
    mask's shape on its device, n)``: 0 is background, 1..n in scipy raster
    order, as :func:`_host_scipy_label`.  A CUDA tensor goes to the
    kernel, a CPU tensor to its plain version.  ``max_k`` is accepted for
    the JAX signature's sake and has no effect: the JAX package's static
    shapes cap the component count there (and fall back to the host past
    it); here nothing is static, so no cap and no fallback exist."""
    del max_k
    mask = torch.as_tensor(mask)
    m = mask if mask.dtype in (torch.bool, torch.uint8) else mask != 0
    vol = _volume(m, "mask").view(torch.uint8)
    full = connectivity == "full"
    if vol.device.type == "cuda":
        labels, n = components_kernel(vol, full)
    elif vol.device.type == "cpu":
        labels, n = components_plain(vol, full)
    else:
        raise ValueError(f"connected_components_device: unsupported device {vol.device}")
    return labels.view(mask.shape), n


def connected_components(mask, connectivity: str = "face") -> Tuple[np.ndarray, int]:
    """Label connected components of a boolean 2D/3D mask.

    ``connectivity``: "face" (scipy default: 4-conn in 2D, 6-conn in 3D) or
    "full" (3^d box: 8-conn in 2D, 26-conn in 3D).  Returns ``(labels int32,
    n)`` as host numpy: 0 is background, 1..n in scipy raster order.  A
    numpy mask is labelled on the host, a tensor where it lies
    (:func:`connected_components_device`)."""
    if isinstance(mask, torch.Tensor):
        labels, n = connected_components_device(mask, connectivity)
        return labels.cpu().numpy(), n
    return _host_scipy_label(np.asarray(mask), connectivity)


def component_stats(labels, n: int):
    """Per-component ``bbox_min``, ``bbox_max`` (inclusive), ``centroid`` and
    ``count``, host arrays indexed by component id 0..n (row 0 and empty
    ids: bbox 2**30 / -1, centroid 0, count 0).  Numpy labels are measured
    on the host; a tensor of 2 or 3 dims where it lies, in exact int64
    counts and sums, which give the host's values bit for bit."""
    if not isinstance(labels, torch.Tensor):
        return _host_component_stats(np.asarray(labels), n)
    nd = labels.dim()
    vol = _volume(labels.to(torch.int32), "labels")
    if vol.device.type == "cuda":
        stats = component_stats_kernel(vol, n)
    elif vol.device.type == "cpu":
        stats = component_stats_plain(vol, n)
    else:
        raise ValueError(f"component_stats: unsupported device {vol.device}")
    mins, maxs, count, sums = (t.cpu().numpy() for t in stats)
    mins, maxs, sums = (np.ascontiguousarray(a[:, 3 - nd:]) for a in (mins, maxs, sums))
    counts = count.astype(np.float64)
    centroid = np.zeros((n + 1, nd), np.float64)
    occupied = count > 0
    # exact integers in float64 (below 2**53), one division each: the host's
    # float64 bincounts and dot products give these bits
    centroid[occupied] = sums[occupied].astype(np.float64) / counts[occupied][:, None]
    return {"bbox_min": mins, "bbox_max": maxs, "centroid": centroid, "count": counts}


def label_part(grid: torch.Tensor, part_id: int, span: str, centroid_axes=None, **attrs):
    """The face components of ``grid == part_id``, labelled on the part's
    occupied bbox (the grid's components, numbered in the same raster
    order): ``(labels int32 of the crop on the grid's device, n, statistics
    as host arrays indexed 0..n, the crop's slices)``, or None when the
    part is absent.  Finding the bbox downloads the three occupancy
    profiles.

    The labeller follows the grid's device.  A CUDA grid is labelled and
    measured on the card (:func:`connected_components_device`,
    :func:`component_stats`), each crop counted as ``<stage>.device_labels``
    after the span's first word (``stage1.part`` counts
    ``stage1.device_labels``); a CPU grid by the host's scipy on its numpy
    view, much faster there than the plain relaxation.  Both give the same labels and the same statistics
    bit for bit.  ``centroid_axes`` limits the centroid columns the host
    fills (None: all; the card fills all).  The spans are
    ``<span>.{eqbbox,label,stats}`` with ``attrs``."""
    with profiling.span(span + ".eqbbox", **attrs):
        part = grid == part_id
        profiles = torch.cat([part.any(dim=tuple(a for a in range(3) if a != ax)) for ax in range(3)])
        occupied = [np.flatnonzero(p) for p in np.split(profiles.cpu().numpy(), np.cumsum(grid.shape)[:-1])]
    if occupied[0].size == 0:
        return None
    box = tuple(slice(int(o[0]), int(o[-1]) + 1) for o in occupied)
    with profiling.span(span + ".label", **attrs):
        if grid.is_cuda:
            labels, n = connected_components_device(part[box], "face")
            profiling.count(span.split(".", 1)[0] + ".device_labels")
        else:
            host, n = _host_scipy_label(part[box].numpy(), "face")
            labels = torch.from_numpy(host)
    with profiling.span(span + ".stats", **attrs):
        stats = component_stats(labels, n) if grid.is_cuda else _host_component_stats(host, n, centroid_axes)
    return labels, n, stats, box
