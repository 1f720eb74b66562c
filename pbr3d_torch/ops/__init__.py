"""Compute primitives: host rotation planners, the carve sweep, host
connected components, camera math and the projection core (splat,
z-buffers, part IoUs), and the hand-written CUDA nearest-neighbour kernel."""
