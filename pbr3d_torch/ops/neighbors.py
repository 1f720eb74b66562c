"""Exact nearest-neighbour distances, as in ``pbr3d.ops.neighbors``.

A CUDA tensor goes through the hand-written kernel
(:func:`pbr3d_torch.ops.cuda_kernels.min_dist2_kernel`) or raises; a CPU
tensor goes through the plain PyTorch version.  There is no fallback from
the kernel to the plain version, and no spot check against it.
"""

from __future__ import annotations

import numpy as np
import torch

from pbr3d_torch.ops.cuda_kernels import min_dist2_kernel, min_dist2_plain


def min_dist2(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """min_j |A[i] - B[j]|² for A (N, 3), B (M, 3) float32 tensors on one
    device; (N,) float32, +inf where M = 0."""
    if A.device.type == "cuda":
        return min_dist2_kernel(A, B)
    if A.device.type == "cpu" and B.device.type == "cpu":
        return min_dist2_plain(A, B)
    raise ValueError(f"min_dist2: unsupported devices {A.device}, {B.device}")


def min_dist(A: np.ndarray, B: np.ndarray, *, device) -> np.ndarray:
    """Exact nearest-neighbor distance from each point of A to B (float32),
    computed on ``device``."""
    A = torch.as_tensor(np.ascontiguousarray(A, np.float32), device=device)
    B = torch.as_tensor(np.ascontiguousarray(B, np.float32), device=device)
    return min_dist2(A, B).clamp_min_(0.0).sqrt_().cpu().numpy()
