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

import numpy as np
import torch

from pbr3d_torch import config
from pbr3d_torch.ops.components import component_stats, connected_components


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


def grid_to_points(grid_labels, stride: int = 2, *, device):
    """Strided occupied-voxel extraction for visualization
    (reference ``voxel_grid_to_points``, utils/voxel_utils.py:35-51):
    (x, y, z) float32 points in grid units, their labels, and (H, W, D)."""
    g = torch.as_tensor(grid_labels, device=device)
    W, H, D = g.shape[:3]
    ds = g[::stride, ::stride, ::stride]
    d0, d1, d2 = torch.nonzero(ds > 0, as_tuple=True)
    return _xyz_f32(d0, d1, d2) * stride, ds[d0, d1, d2], (H, W, D)


def extract_top_k_components(grid_labels, part_name: str, k: int = 4) -> np.ndarray:
    """Keep only the k tallest 26-connected components of one part
    (reference: utils/voxel_utils.py:24-33; height = extent along dim 1).
    Host labelling, as everywhere in the port; a host grid is returned."""
    grid_labels = (grid_labels.cpu().numpy() if isinstance(grid_labels, torch.Tensor)
                   else np.asarray(grid_labels))
    comp, n = connected_components(grid_labels == config.PART_IDS[part_name], "full")
    if n == 0:
        return grid_labels.copy()
    stats = component_stats(comp, n)
    heights = (stats["bbox_max"][1:, 1] - stats["bbox_min"][1:, 1]).astype(np.int64)
    top = np.argsort(-heights, kind="stable")[:k] + 1
    out = grid_labels.copy()
    out[(comp > 0) & ~np.isin(comp, top)] = 0
    return out


def meshify_colored_voxel_grid(grid_labels, stride: int = 1, *, device):
    """Surface mesh of a label grid with nearest-voxel vertex colours.

    Reference ``meshify_colored_voxel_grid`` (utils/voxel_utils.py:53-95):
    marching cubes on the (strided) occupancy at level 0.5, vertices
    reordered (d0,d1,d2) -> (x,y,z), the stage-1 transpose+flip mirror
    compensated by ``z -> D - z``, vertex colours from the nearest occupied
    voxel (the k-nearest-neighbour kernel at k = 1), normalized to [0, 1].
    Returns tensors on ``device``: (verts (N,3) f32, faces (M,3) i32,
    vertex_colors (N,3) f64 in [0,1], normals (M,3) f32 per face)."""
    from pbr3d_torch.ops.isosurface import cross_rows, marching_cubes
    from pbr3d_torch.ops.neighbors import knn

    grid_labels = torch.as_tensor(grid_labels, device=device)
    g = grid_labels[::stride, ::stride, ::stride] if stride > 1 else grid_labels
    occ = g > 0
    verts, faces = marching_cubes(occ.to(torch.float32), 0.5, device=device)
    verts = verts * stride

    # (d0, d1, d2) -> (x, y, z), then undo the stage-1 reorientation mirror.
    verts = verts[:, [2, 1, 0]].clone()
    verts[:, 2] = grid_labels.shape[2] - verts[:, 2]

    filled = torch.nonzero(occ).to(torch.float32)  # (K, 3) in (d0, d1, d2)
    palette = torch.as_tensor(config.PALETTE, device=device)
    colors = palette[g[occ].to(torch.int64)]
    _, idx = knn(verts[:, [2, 1, 0]] / stride, filled, 1, device=device)
    vertex_colors = colors[idx[:, 0]].to(torch.float64)
    if vertex_colors.numel() and float(vertex_colors.max()) > 1:
        # by a tensor: a CUDA division by a Python scalar multiplies by its
        # reciprocal, which is not the correctly rounded quotient
        vertex_colors = vertex_colors / torch.tensor(255.0, dtype=torch.float64, device=vertex_colors.device)

    tri = verts[faces.to(torch.int64)]
    normals = cross_rows(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    normals = normals / (torch.linalg.norm(normals, dim=1, keepdim=True) + 1e-8)
    return verts, faces, vertex_colors, normals


def bucket_size(m: int, minimum: int = 1024) -> int:
    """Next power of two >= m (>= minimum).  The port pads nothing; the
    camera search keeps the JAX package's population rule, which is stated
    in these buckets."""
    n = minimum
    while n < m:
        n *= 2
    return n
