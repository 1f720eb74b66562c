"""Voxel-grid -> point-set utilities (label domain), as in
``pbr3d.carving.voxel``.

Coordinate convention preserved from the reference: a label grid is indexed
(d0, d1, d2); point lists are columns (x, y, z) = (d2, d1, d0) in the raster
order of ``np.where`` (reference: utils/voxel_utils.py:17-18,41-43), which
``torch.nonzero`` shares.  That order matters: the splat's last-write-wins
collision rule depends on it.

The extractions run on ``device`` and return device tensors.  Their consumers
(the mask-IoU camera search, the z-buffers) run there, and a 512-grid pass
(83 M voxels) is a handful of elementwise kernels on the card against
seconds of numpy on the host; the grid may already be a device tensor, and
then nothing is uploaded.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from pbr3d_torch import config


def _xyz_f32(d0: torch.Tensor, d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """(N, 3) float32 (x, y, z) from nonzero index triples."""
    return torch.stack([d2, d1, d0], dim=1).to(torch.float32)


def _selected(grid_labels, part_names: Sequence[str], device) -> Tuple[torch.Tensor, torch.Tensor]:
    g = torch.as_tensor(grid_labels, device=device)
    ids = torch.as_tensor(config.part_ids(part_names), device=device).to(g.dtype)
    return g, torch.isin(g, ids)


def all_points(grid_labels, *, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """All occupied voxels as (x, y, z) float32 points + uint8 labels, on
    ``device`` (reference: eval_helpers_intra.py:138-139)."""
    g = torch.as_tensor(grid_labels, device=device)
    d0, d1, d2 = torch.nonzero(g > 0, as_tuple=True)
    return _xyz_f32(d0, d1, d2), g[d0, d1, d2]


def points_by_parts(
    grid_labels, part_names: Sequence[str], *, device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, y, z) float32 points + uint8 labels of the selected parts, in
    raster order, on ``device`` (reference ``get_voxel_points_by_parts``,
    utils/voxel_utils.py:7-21, in the label domain)."""
    g, sel = _selected(grid_labels, part_names, device)
    d0, d1, d2 = torch.nonzero(sel, as_tuple=True)
    return _xyz_f32(d0, d1, d2), g[d0, d1, d2]


def surface_points_by_parts(
    grid_labels, part_names: Sequence[str], *, device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 6-connected surface shell of the selected parts' solid: the
    selected voxels with at least one face neighbour unselected or off the
    grid, as (x, y, z) float32 points + uint8 labels in raster order, on
    ``device``.  Any ray entering the solid passes through a shell voxel
    first, so the shell's splat silhouette is the solid's, at O(V²) points."""
    g, sel = _selected(grid_labels, part_names, device)
    rows = [sel.any(dim=dims).nonzero()[:, 0] for dims in ((1, 2), (0, 2), (0, 1))]
    if rows[0].numel() == 0:
        return torch.empty((0, 3), dtype=torch.float32, device=device), g.new_empty((0,))
    # Crop to the selection's bbox: the shell inside it is the same, and the
    # six neighbour tests touch only the crop.
    lo = [int(r[0]) for r in rows]
    hi = [int(r[-1]) + 1 for r in rows]
    box = sel[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
    pad = torch.nn.functional.pad(box.to(torch.uint8), (1, 1, 1, 1, 1, 1)).bool()
    interior = box.clone()
    for ax in range(3):
        for start in (0, 2):
            sl = [slice(1, -1)] * 3
            sl[ax] = slice(start, start + box.shape[ax])
            interior &= pad[tuple(sl)]
    d0, d1, d2 = torch.nonzero(box & ~interior, as_tuple=True)
    d0, d1, d2 = d0 + lo[0], d1 + lo[1], d2 + lo[2]
    return _xyz_f32(d0, d1, d2), g[d0, d1, d2]


def bucket_size(m: int, minimum: int = 1024) -> int:
    """Next power of two >= m (>= minimum).  The port pads nothing; the
    camera search keeps the JAX package's population rule, which is stated
    in these buckets."""
    n = minimum
    while n < m:
        n *= 2
    return n
