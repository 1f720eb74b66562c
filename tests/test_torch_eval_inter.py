"""The port's notebook-5 metrics against ``pbr3d.eval.inter`` on the CPU.

Downsampling picks the same points in both packages, so the values differ
only by the JAX package's |a|²+|b|²−2a·b error (about 8·ε·(|a|²+|b|²) per
point).  Chamfer is held to rtol 1e-2 (tests/test_eval.py:49).  A fraction
below τ may differ only by the points whose distance lies within that error
of τ; the tests count them and allow exactly that many."""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from pbr3d.eval import inter as jax_inter
from pbr3d_torch.eval import inter

pytest_plugins = ["torch_threads"]

EPS = float(np.finfo(np.float32).eps)
THRESHOLDS = np.linspace(0.005, 0.1, 20)


def _clouds(rng, n=3000):
    A = rng.normal(size=(n, 3)).astype(np.float32)
    B = (A + rng.normal(scale=0.02, size=A.shape)).astype(np.float32)
    return A, B[: n - 500]


def _flip_budget(A, B, thresholds, max_points, seed_a, seed_b):
    """Per threshold, the fraction of A→B distances within the expansion
    error of it (either direction's fraction may move by at most that)."""
    a = inter._cloud(A, max_points, seed_a, "cpu").numpy().astype(np.float64)
    b = inter._cloud(B, max_points, seed_b, "cpu").numpy().astype(np.float64)
    out = []
    for P, Q in ((a, b), (b, a)):
        d2 = cKDTree(Q).query(P, k=1)[0] ** 2
        err = 8 * EPS * ((P**2).sum(1) + (Q**2).sum(1).max())
        out.append([np.mean(np.abs(d2 - t * t) <= err) for t in thresholds])
    return np.maximum(*np.asarray(out)) + 1e-12


def test_chamfer_matches_jax_and_kdtree(rng):
    A, B = _clouds(rng)
    ours = inter.chamfer_distance(A, B, max_points=2000, device="cpu")
    np.testing.assert_allclose(ours, jax_inter.chamfer_distance(A, B, max_points=2000), rtol=1e-2)
    a = inter._cloud(A, 2000, 0, "cpu").numpy().astype(np.float64)
    b = inter._cloud(B, 2000, 1, "cpu").numpy().astype(np.float64)
    dA, dB = cKDTree(b).query(a)[0], cKDTree(a).query(b)[0]
    np.testing.assert_allclose(ours, np.mean(dA**2) + np.mean(dB**2), rtol=1e-5)
    unsq = inter.chamfer_distance(A, B, max_points=2000, squared=False, device="cpu")
    np.testing.assert_allclose(unsq, np.mean(dA) + np.mean(dB), rtol=1e-5)


@pytest.mark.parametrize("tau", [0.01, 0.03, 0.05])
def test_fscore_matches_jax(rng, tau):
    A, B = _clouds(rng)
    ours = np.asarray(inter.fscore_with_threshold(A, B, tau, max_points=2000, device="cpu"))
    ref = np.asarray(jax_inter.fscore_with_threshold(A, B, tau, max_points=2000))
    budget = _flip_budget(A, B, [tau], 2000, 0, 1)[0]
    assert np.all(np.abs(ours[1:] - ref[1:]) <= budget)
    assert ours[1] > 0 and ours[2] > 0


def test_f1_curve_matches_jax(rng):
    A, B = _clouds(rng)
    ours = np.stack(inter.compute_f1_curve(A, B, THRESHOLDS, max_points=1500, device="cpu"))
    ref = np.stack(jax_inter.compute_f1_curve(A, B, THRESHOLDS, max_points=1500))
    budget = _flip_budget(A, B, THRESHOLDS, 1500, 0, 0)
    assert np.all(np.abs(ours[:2] - ref[:2]) <= budget[None, :])


def test_f1_curve_from_distances_threshold_promotion():
    """Distances sitting exactly on a threshold: a Python float compares in
    float32, a numpy float64 in float64 — as numpy does."""
    d = np.asarray([0.1, 0.2, 0.3, 0.05], np.float32)
    for thresholds in ([0.1, 0.3], np.asarray([0.1, 0.3]), [np.float32(0.3)]):
        ours = inter.f1_curve_from_distances(torch.from_numpy(d), torch.from_numpy(d[::-1].copy()),
                                             thresholds)
        ref = jax_inter.f1_curve_from_distances(d, d[::-1], thresholds)
        for o, r in zip(ours, ref):
            np.testing.assert_array_equal(o, r)


def test_normalize_and_pca_match_jax(rng):
    P = rng.normal(size=(500, 3)) * np.array([3.0, 1.0, 0.5]) + 7.0
    ours = inter.normalize_preserve_aspect(P.astype(np.float32), device="cpu")
    assert ours.dtype == torch.float64
    np.testing.assert_array_equal(ours.numpy(), jax_inter.normalize_preserve_aspect(P.astype(np.float32)))
    Q = rng.normal(size=(400, 3)) * np.array([1.0, 2.0, 0.7])
    np.testing.assert_allclose(inter.pca_shape_similarity(P, Q, device="cpu"),
                               jax_inter.pca_shape_similarity(P, Q), rtol=1e-9)


def test_slice_akbar_128_stage1_then_metrics():
    """The slice end to end on the CPU: Akbar at 128 through both packages'
    stage 1 (bit-equal), then both packages' metrics against the committed
    stage-3 model."""
    from pathlib import Path

    from pbr3d.carving.fused import carve_monument_fused as jax_carve
    from pbr3d.carving.voxel import all_points as jax_all_points
    from pbr3d_torch.carving.fused import carve_monument_fused
    from pbr3d_torch.carving.voxel import all_points
    from pbr3d_torch.io.artifacts import load_voxel_grid_labels
    from pbr3d_torch.io.masks import MaskSet
    from tests.test_torch_stage1 import _recover_labels

    repo = Path(__file__).resolve().parents[1]
    oracle = np.load(repo / "tests/fixtures/oracle_Akbar_128.npz")
    masks = MaskSet.from_labels(*_recover_labels()(oracle["colored"], oracle["final"]))
    grid = carve_monument_fused(masks, device="cpu")
    jax_grid = jax_carve(masks)
    np.testing.assert_array_equal(grid, jax_grid)
    gold3 = load_voxel_grid_labels(
        repo / "results_temp_golden/3.Part-wise_3D_Refinement/Akbar_deformed_voxel_grid.npz")

    pts, labels = all_points(grid, device="cpu")
    jpts, jlabels = jax_all_points(jax_grid)
    np.testing.assert_array_equal(pts.numpy(), jpts)
    np.testing.assert_array_equal(labels.numpy(), jlabels)

    A = inter.normalize_preserve_aspect(pts, device="cpu")
    B = inter.normalize_preserve_aspect(all_points(gold3, device="cpu")[0], device="cpu")
    jA = jax_inter.normalize_preserve_aspect(jpts)
    jB = jax_inter.normalize_preserve_aspect(jax_all_points(gold3)[0])
    np.testing.assert_array_equal(A.numpy(), jA)
    np.testing.assert_array_equal(B.numpy(), jB)

    n = 4000
    np.testing.assert_allclose(inter.chamfer_distance(A, B, n, device="cpu"),
                               jax_inter.chamfer_distance(jA, jB, n), rtol=1e-2)
    ours = np.asarray(inter.fscore_with_threshold(A, B, 0.03, n, device="cpu"))
    ref = np.asarray(jax_inter.fscore_with_threshold(jA, jB, 0.03, n))
    assert np.all(np.abs(ours[1:] - ref[1:]) <= _flip_budget(A, B, [0.03], n, 0, 1)[0])
    curve = np.stack(inter.compute_f1_curve(A, B, THRESHOLDS, n, device="cpu"))
    jcurve = np.stack(jax_inter.compute_f1_curve(jA, jB, THRESHOLDS, n))
    assert np.all(np.abs(curve[:2] - jcurve[:2]) <= _flip_budget(A, B, THRESHOLDS, n, 0, 0)[None])
