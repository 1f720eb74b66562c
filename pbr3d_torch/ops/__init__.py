"""Compute primitives: host rotation planners and the device rotations, the
carve sweep, connected components and their statistics (host scipy, and on
the device a hand-written CUDA labeller), camera math and the projection
core (splat, z-buffers, part IoUs), and the hand-written CUDA
nearest-neighbour kernels."""

from pbr3d_torch.ops.rotate import rotate_y, rotate_y_binary_u8
from pbr3d_torch.ops.carve import carve_with_mask, rotate_carve_sweep

__all__ = [
    "rotate_y",
    "rotate_y_binary_u8",
    "carve_with_mask",
    "rotate_carve_sweep",
]
