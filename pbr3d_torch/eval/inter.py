"""Inter-method point-cloud metrics (notebook 5), as in ``pbr3d.eval.inter``.

Chamfer distance, F-score@τ and F1(τ) curves ride the exact nearest-neighbour
engine of :mod:`pbr3d_torch.ops.neighbors` (the hand-written CUDA kernel on
the card) instead of cKDTree/sklearn (reference: eval_helpers.py:36-67,
248-296).  Clouds may be numpy arrays or tensors; they are moved to
``device`` and stay there.

Downsampling keeps numpy's ``default_rng(seed).choice`` on the host, so the
port and the JAX package pick the same points; only the chosen indices go to
the device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pbr3d_torch.ops.neighbors import min_dist2


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
