"""Stage 1 — orthographic semantic voxel carving."""
