"""Inter-method point-cloud / surface metrics (notebook 5), as in
``pbr3d.eval.inter``.

* chamfer distance, F-score@τ and F1(τ) curves ride the exact
  nearest-neighbour engine of :mod:`pbr3d_torch.ops.neighbors` (the
  hand-written CUDA kernels on the card) instead of cKDTree/sklearn
  (reference: eval_helpers.py:36-67, 248-296);
* pairwise voxel IoU at a shared grid with cross-element dilation
  (reference :83-107);
* NN-regularity statistics (reference :114-126);
* PCA shape similarity via a 3x3 eigendecomposition (reference :70-76);
* point cloud -> smoothed density grid -> marching-cubes surface + normal /
  roughness / curvature statistics (reference :178-244).

Clouds may be numpy arrays or tensors; they are moved to ``device`` and stay
there.  Where the JAX package computes in float64 numpy on the host (the
voxel indices, the covariances and their eigenvalues), the port computes in
float64 on the device.

Downsampling keeps numpy's ``default_rng(seed).choice`` on the host, so the
port and the JAX package pick the same points; only the chosen indices go to
the device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from pbr3d_torch.ops.isosurface import cross_rows, marching_cubes
from pbr3d_torch.ops.morphology import binary_dilation, gaussian_filter
from pbr3d_torch.ops.neighbors import knn, min_dist2, self_nn_dist


def _downsample(P: torch.Tensor, n: int, seed: int = 0) -> torch.Tensor:
    if len(P) <= n:
        return P
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(P), n, replace=False)
    return P[torch.from_numpy(idx).to(P.device)]


def _cloud(P, n: int, seed: int, device) -> torch.Tensor:
    """Downsampled (≤ n, 3) contiguous float32 cloud on ``device``."""
    P = _downsample(torch.as_tensor(P, device=device), n, seed)
    return P.to(torch.float32).contiguous()


def _nn_dist(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return min_dist2(A, B).clamp_min_(0.0).sqrt_()


def _frac_below(d: torch.Tensor, t) -> float:
    """``np.mean(d < t)`` for a float32 ``d``, with numpy's promotion of
    ``t``: a Python float compares in float32, a numpy float64 in float64."""
    dtype = torch.float64 if np.result_type(np.float32, t) == np.float64 else torch.float32
    below = d.to(dtype) < torch.tensor(float(t), dtype=dtype, device=d.device)
    return int(below.sum()) / d.numel()


def _f1(prec: float, rec: float) -> float:
    return 0.0 if prec + rec == 0 else 2 * prec * rec / (prec + rec)


# ---------------------------------------------------------------------------
# Accuracy
# ---------------------------------------------------------------------------


def chamfer_distance(
    A, B, max_points: int = 20000, squared: bool = True, seed: int = 0, *, device,
) -> float:
    A = _cloud(A, max_points, seed, device)
    B = _cloud(B, max_points, seed + 1, device)
    dA = _nn_dist(A, B)
    dB = _nn_dist(B, A)
    if squared:
        dA, dB = dA * dA, dB * dB
    return float(dA.mean(dtype=torch.float64) + dB.mean(dtype=torch.float64))


def fscore_with_threshold(
    A, B, tau: float = 0.03, max_points: int = 20000, seed: int = 0, *, device,
) -> Tuple[float, float, float]:
    A = _cloud(A, max_points, seed, device)
    B = _cloud(B, max_points, seed + 1, device)
    precision = _frac_below(_nn_dist(A, B), tau)
    recall = _frac_below(_nn_dist(B, A), tau)
    return _f1(precision, recall), precision, recall


def compute_nn_distances(
    A, B, max_points: int = 50000, seed: int = 0, *, device,
) -> Tuple[torch.Tensor, torch.Tensor]:
    A = _cloud(A, max_points, seed, device)
    B = _cloud(B, max_points, seed, device)
    return _nn_dist(A, B), _nn_dist(B, A)


def f1_curve_from_distances(d_AB, d_BA, thresholds):
    """(recalls, precisions, f1s) numpy arrays over ``thresholds``."""
    d_AB, d_BA = torch.as_tensor(d_AB), torch.as_tensor(d_BA)
    precs, recs, f1s = [], [], []
    for t in thresholds:
        prec = _frac_below(d_AB, t)
        rec = _frac_below(d_BA, t)
        f1s.append(_f1(prec, rec))
        precs.append(prec)
        recs.append(rec)
    return np.asarray(recs), np.asarray(precs), np.asarray(f1s)


def compute_f1_curve(A, B, thresholds, max_points: int = 50000, seed: int = 0, *, device):
    d_AB, d_BA = compute_nn_distances(A, B, max_points, seed, device=device)
    return f1_curve_from_distances(d_AB, d_BA, thresholds)


def pca_shape_similarity(A, B, *, device) -> float:
    """1 - L1 distance of explained-variance ratios (reference :70-76)."""

    def ratios(P):
        P = torch.as_tensor(P, device=device).to(torch.float64)
        C = torch.cov((P - P.mean(0)).T)
        w = torch.linalg.eigvalsh(C).flip(0)
        return w / w.sum()

    return float(1.0 - (ratios(A) - ratios(B)).abs().sum())


# ---------------------------------------------------------------------------
# Completeness
# ---------------------------------------------------------------------------


def voxel_iou(A, B, resolution: int = 96, dilate_frac: float = 0.01, *, device) -> float:
    """Occupancy IoU on a shared grid with relative dilation
    (reference :83-107).  The voxel indices are float64 truncated toward
    zero, as numpy's ``astype(int)``."""
    A, B = torch.as_tensor(A, device=device), torch.as_tensor(B, device=device)
    dtype = torch.promote_types(A.dtype, B.dtype)  # numpy's, of ``np.vstack([A, B])``
    dtype = dtype if dtype.is_floating_point else torch.float64
    both = torch.cat([A.to(dtype), B.to(dtype)])
    A, B = both[: len(A)], both[len(A):]
    lo, hi = both.amin(0), both.amax(0)
    step = (hi - lo).amax() / resolution

    def occ(P):
        idx = ((P - lo) / step).to(torch.int64).clamp_(0, resolution - 1)
        g = torch.zeros((resolution,) * 3, dtype=torch.bool, device=device)
        g[idx[:, 0], idx[:, 1], idx[:, 2]] = True
        return g

    occA, occB = occ(A), occ(B)
    if dilate_frac > 0:
        iters = max(1, int(round(dilate_frac * float(torch.linalg.norm(hi - lo)) / float(step))))
        occA = binary_dilation(occA, iters, device=device)
        occB = binary_dilation(occB, iters, device=device)
    union = int((occA | occB).sum())
    return float(int((occA & occB).sum()) / union) if union else float("nan")


# ---------------------------------------------------------------------------
# Regularity
# ---------------------------------------------------------------------------


def compute_nn_stats(pts, max_points: int = 50000, seed: int = 0, *, device) -> Dict:
    nn = self_nn_dist(_cloud(pts, max_points, seed, device), device=device)
    mean, std = float(nn.mean()), float(nn.std(correction=0))
    return {
        "NN Mean ↓": mean,
        "NN Std ↓": std,
        "NN CV ↓": float(np.float32(std) / (np.float32(mean) + 1e-8)),
    }


# ---------------------------------------------------------------------------
# Surface
# ---------------------------------------------------------------------------


def normalize_preserve_aspect(points, *, device) -> torch.Tensor:
    """(pts − min)/(size.max()+1e-8), then drop y so its max is 0, in float64
    on ``device`` (recovered reference: utils/preprocess_helpers bytecode
    L19-25)."""
    p = torch.as_tensor(points, device=device).to(torch.float64)
    mn = p.amin(0)
    size = p.amax(0) - mn
    norm = (p - mn) / (size.amax() + 1e-8)
    norm[:, 1] -= norm[:, 1].amax()
    return norm


def pointcloud_to_voxel_grid(points, grid_size: int = 128, sigma: float = 1.0, *, device) -> torch.Tensor:
    """Density grid of the aspect-normalized cloud, Gaussian-smoothed, with
    clamped boundary (reference :178-189); float32 on ``device``."""
    norm = normalize_preserve_aspect(points, device=device)
    # float64 truncated toward zero; y is <= 0 after the normalisation and
    # indexes from the end of its axis, as a negative index does in numpy
    vox = torch.remainder((norm * (grid_size - 1)).to(torch.int64), grid_size)
    grid = torch.zeros((grid_size,) * 3, dtype=torch.float32, device=device)
    # counts are small integers, exact in float32 in any order
    grid.index_put_((vox[:, 0], vox[:, 1], vox[:, 2]), torch.ones((), device=device), accumulate=True)
    if sigma > 0:
        grid = gaussian_filter(grid, sigma, device=device)
    grid[[0, -1], :, :] = 0
    grid[:, [0, -1], :] = 0
    grid[:, :, [0, -1]] = 0
    return grid


def get_marching_cubes_mesh(
    points, grid_size: int = 128, sigma: float = 1.0, level: float = 0.1, *, device,
):
    """Point cloud -> density grid -> iso-surface (reference :191-195), by
    classic marching cubes (:func:`pbr3d_torch.ops.isosurface.marching_cubes`)."""
    grid = pointcloud_to_voxel_grid(points, grid_size, sigma, device=device)
    verts, faces = marching_cubes(grid, level, device=device)
    return verts / grid_size, faces


def filter_mesh(vertices: torch.Tensor, faces: torch.Tensor, y_thresh: float = 0.2):
    """Keep vertices with y <= y_thresh and faces fully inside
    (reference :18-23).  As there, the kept faces keep their indices into
    the unfiltered vertices."""
    mask = vertices[:, 1] <= y_thresh
    face_mask = mask[faces.to(torch.int64)].all(dim=1)
    return vertices[mask], faces[face_mask]


def compute_triangle_normals(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    f = faces.to(torch.int64)
    v0, v1, v2 = (vertices[f[:, i]] for i in range(3))
    n = cross_rows(v1 - v0, v2 - v0)
    return n / (torch.linalg.norm(n, dim=1, keepdim=True) + 1e-8)


def compute_vertex_normals(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    tri = compute_triangle_normals(vertices, faces)
    vnorm = torch.zeros_like(vertices)
    vnorm.index_add_(0, faces.to(torch.int64).reshape(-1), tri.repeat_interleave(3, dim=0))
    return vnorm / (torch.linalg.norm(vnorm, dim=1, keepdim=True) + 1e-8)


def _smallest_eigenvalue_sym3(A: torch.Tensor) -> torch.Tensor:
    """The smallest eigenvalue of each symmetric 3x3 matrix of ``A``
    (N, 3, 3) float64, by the trigonometric closed form: elementwise tensor
    ops on the device, good to about 1e-16 of the largest eigenvalue."""
    q = (A[:, 0, 0] + A[:, 1, 1] + A[:, 2, 2]) / 3.0
    p1 = A[:, 0, 1] ** 2 + A[:, 0, 2] ** 2 + A[:, 1, 2] ** 2
    p2 = (A[:, 0, 0] - q) ** 2 + (A[:, 1, 1] - q) ** 2 + (A[:, 2, 2] - q) ** 2 + 2.0 * p1
    p = torch.sqrt(p2 / 6.0)
    B = (A - q[:, None, None] * torch.eye(3, dtype=A.dtype, device=A.device)) / p.clamp_min(1e-300)[:, None, None]
    det = (B[:, 0, 0] * (B[:, 1, 1] * B[:, 2, 2] - B[:, 1, 2] * B[:, 2, 1])
           - B[:, 0, 1] * (B[:, 1, 0] * B[:, 2, 2] - B[:, 1, 2] * B[:, 2, 0])
           + B[:, 0, 2] * (B[:, 1, 0] * B[:, 2, 1] - B[:, 1, 1] * B[:, 2, 0]))
    phi = torch.arccos((det / 2.0).clamp(-1.0, 1.0)) / 3.0
    return torch.where(p > 0, q + 2.0 * p * torch.cos(phi + 2.0 * np.pi / 3.0), q)


def compute_surface_metrics(vertices, faces, k: int = 20, *, device) -> Dict:
    """Normal spread / PCA roughness λ3 / Laplacian curvature over k-NN
    neighbourhoods (the reference loops per vertex, :215-244).  The
    neighbourhood statistics are float32 as in the JAX package; the smallest
    covariance eigenvalue is taken in float64, in closed form."""
    vertices = torch.as_tensor(vertices, device=device).to(torch.float32).contiguous()
    faces = torch.as_tensor(faces, device=device)
    normals = compute_vertex_normals(vertices, faces)
    _, idx = knn(vertices, vertices, k, device=device)
    nbr = vertices[idx]  # (N, k, 3)

    nbr_normals = normals[idx]  # (N, k, 3)
    dots = (nbr_normals * normals[:, None, :]).sum(-1).clamp(-1.0, 1.0)
    angles = torch.rad2deg(torch.arccos(dots))
    normal_std = angles.std(dim=1, correction=0)

    centered = nbr - nbr.mean(dim=1, keepdim=True)
    cov = (centered[:, :, :, None] * centered[:, :, None, :]).sum(1) / nbr.shape[1]
    # sklearn's PCA divides by (k - 1); the covariance above used k.
    roughness = _smallest_eigenvalue_sym3(cov.to(torch.float64)) * nbr.shape[1] / (nbr.shape[1] - 1)

    laplace = nbr.mean(dim=1) - vertices
    curvature = torch.linalg.norm(laplace, dim=1)

    return {
        "Normal StdDev (°)": float(normal_std.mean()),
        "Mean Roughness (λ₃)": float(roughness.mean()),
        "Mean Curvature": float(curvature.mean()),
    }
