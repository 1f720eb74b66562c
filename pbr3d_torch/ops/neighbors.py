"""Exact nearest-neighbour distances and k nearest neighbours, as in
``pbr3d.ops.neighbors``.

A CUDA tensor goes through a hand-written kernel
(:func:`pbr3d_torch.ops.cuda_kernels.min_dist2_kernel`,
:func:`pbr3d_torch.ops.cuda_kernels.knn_kernel`) or raises; a CPU tensor
goes through the plain PyTorch version.  There is no fallback from a kernel
to its plain version, and no spot check against it.

Distances are direct differences in float32, not the JAX package's
|a|² + |b|² − 2a·b: on integer coordinates both are exact, elsewhere two
neighbours whose distances lie within the expansion's error of each other
may come out in the other order there.
"""

from __future__ import annotations

import numpy as np
import torch

from pbr3d_torch.ops.cuda_kernels import knn_kernel, knn_plain, min_dist2_kernel, min_dist2_plain


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


def _points(P, device) -> torch.Tensor:
    """(N, 3) contiguous float32 points on ``device`` from an array or tensor."""
    if not isinstance(P, torch.Tensor):
        P = np.ascontiguousarray(P, np.float32)
    return torch.as_tensor(P, device=device).to(torch.float32).contiguous()


def knn2(A: torch.Tensor, B: torch.Tensor, k: int):
    """The k smallest |A[i] - B[j]|² and their j for A (N, 3), B (M, 3)
    float32 tensors on one device: (N, k) float32 ascending and (N, k) int64,
    exact ties to the lower index; where k > M the trailing distances are
    +inf and their indices the nearest neighbour's."""
    if A.device.type == "cuda":
        return knn_kernel(A, B, k)
    if A.device.type == "cpu" and B.device.type == "cpu":
        return knn_plain(A, B, k)
    raise ValueError(f"knn2: unsupported devices {A.device}, {B.device}")


def knn(A, B, k: int, *, device):
    """k nearest neighbours in B for each point of A, on ``device``: tensors
    (distances (N, k) float32 ascending, indices (N, k) int64)."""
    d2, idx = knn2(_points(A, device), _points(B, device), k)
    return d2.clamp_min_(0.0).sqrt_(), idx


def self_nn_dist(P, *, device) -> torch.Tensor:
    """Distance of each point to its nearest OTHER point (k=2 self-query)."""
    P = _points(P, device)
    return knn(P, P, 2, device=device)[0][:, 1]
