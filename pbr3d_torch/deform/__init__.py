"""Stage 3 — part-wise symmetry-preserving 3D refinement."""

from pbr3d_torch.deform.warp import deform_coords, scatter_part, build_deformed_grid
from pbr3d_torch.deform.search import optimize_part_deform, refine_parts

__all__ = [
    "deform_coords",
    "scatter_part",
    "build_deformed_grid",
    "optimize_part_deform",
    "refine_parts",
]
