"""Stage 1 — orthographic semantic voxel carving."""

from pbr3d_torch.carving.stage1 import (
    global_carve,
    part_carve,
    component_guided_carve,
    extrude_interior_parts,
    recolor_backward_components,
    partwise_carve,
)

__all__ = [
    "global_carve",
    "part_carve",
    "component_guided_carve",
    "extrude_interior_parts",
    "recolor_backward_components",
    "partwise_carve",
]
