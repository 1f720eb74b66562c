"""Compute primitives: host rotation planners, the carve sweep, host
connected components, and the hand-written CUDA nearest-neighbour kernel."""
