"""``pbr3d_torch.eval.preprocess`` against ``pbr3d.eval.preprocess`` on the
same seeded clouds.

The RANSAC candidates come from a ``jax.random`` key there, which cannot be
reproduced: the port is fed the JAX package's triples and must find its
plane (1e-5: float32 normals, products in another order) and its inliers;
its own generator is held by the plane it finds.  ICP's transform is held to
1e-5 of the JAX package's (float32 correspondences from another distance
form, float64 Kabsch in both)."""

import numpy as np
import pytest
import torch

import jax

from pbr3d.eval import preprocess as jax_pre
from pbr3d.io import artifacts as jax_artifacts
from pbr3d.io import pointcloud as jax_pc
from pbr3d_torch import config
from pbr3d_torch.eval import preprocess as pre
from pbr3d_torch.io import artifacts
from pbr3d_torch.utils import profiling

pytest_plugins = ["torch_threads"]


@pytest.fixture
def rng():
    """Fresh for every test, so no test's data depends on which ran before."""
    return np.random.default_rng(0)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _facade(rng, n=3000):
    """A wall (z ~ 0.3) with clutter in front of it, tilted and moved."""
    wall = np.column_stack([rng.random(n), rng.random(n) * 0.6, 0.3 + rng.normal(scale=0.002, size=n)])
    clutter = rng.random((n // 3, 3)) * np.array([1.0, 0.6, 0.3])
    p = np.vstack([wall, clutter])
    R = jax_pre.rodrigues_rotation(np.array([0.3, 1.0, 0.2]), 0.4)
    return p @ R.T + np.array([0.1, -0.2, 0.05])


def _shell(rng, n=600):
    """The four walls of a square-footed box, jittered, tilted and moved: a
    cloud whose quarter turns lie on itself, as a monument's do."""
    u, v = rng.random(n), rng.random(n) * 0.6
    wall = rng.integers(0, 4, n)
    x = np.where(wall == 0, 0.0, np.where(wall == 1, 1.0, u))
    z = np.where(wall == 2, 0.0, np.where(wall == 3, 1.0, u))
    p = np.column_stack([x, v, z]) + rng.normal(scale=0.0005, size=(n, 3))
    R = jax_pre.rodrigues_rotation(np.array([0.3, 1.0, 0.2]), 0.4)
    return p @ R.T + np.array([0.1, -0.2, 0.05])


def _monument(rng, n=2500):
    """A lopsided cloud with structure in every direction (ICP needs it)."""
    box = rng.random((n, 3)) * np.array([1.0, 0.5, 0.7])
    tower = rng.random((n // 4, 3)) * np.array([0.1, 0.9, 0.1]) + np.array([0.8, 0.0, 0.1])
    return np.vstack([box, tower])


def test_small_helpers_equal(rng):
    P = rng.normal(size=(50, 3))
    np.testing.assert_array_equal(_np(pre.flip_y_axis(P, device="cpu")), jax_pre.flip_y_axis(P))
    for axis, angle in (([0, 1, 0], 0.7), ([1, 2, 3], -2.0), ([0, 0, 1], np.pi / 2)):
        np.testing.assert_array_equal(pre.rodrigues_rotation(axis, angle), jax_pre.rodrigues_rotation(axis, angle))
    np.testing.assert_array_equal(pre.CAD_AXIS_SWAP, jax_pre.CAD_AXIS_SWAP)
    Q = rng.normal(size=(30, 3))
    np.testing.assert_array_equal(_np(pre.ground_align_y(P, Q, device="cpu")), jax_pre.ground_align_y(P, Q))
    ours, ref = pre.symmetric_completion(P, device="cpu"), jax_pre.symmetric_completion(P)
    assert list(ours) == list(ref)
    for k in ref:
        np.testing.assert_allclose(_np(ours[k]), ref[k], rtol=0, atol=1e-14)
    for plane in (np.array([0.1, -0.3, 0.9, 0.2]), np.array([0.0, 0.0, -2.0, 1.0]), np.array([0.0, 0.0, 1.0, 0.0])):
        np.testing.assert_allclose(_np(pre.align_plane_to_z(P, plane, device="cpu")),
                                   jax_pre.align_plane_to_z(P, plane), rtol=0, atol=1e-14)


@pytest.mark.parametrize("seed", [0, 3])
def test_segment_plane_on_the_jax_triples(rng, seed):
    P = _facade(rng)
    triples = np.array(jax.random.randint(jax.random.PRNGKey(seed), (1000, 3), 0, len(P)))
    plane, idx = pre.segment_plane(P, 0.01, 1000, seed, triples, device="cpu")
    jplane, jidx = jax_pre.segment_plane(P, 0.01, 1000, seed)
    np.testing.assert_allclose(plane, jplane, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    assert len(jidx) > 2500
    normals, d, inliers = pre._ransac_plane_scores(
        torch.from_numpy(P.astype(np.float32)), torch.from_numpy(triples).long(), 0.01)
    jn, jd, ji = jax_pre._ransac_plane_scores(P.astype(np.float32), jax.random.PRNGKey(seed), 0.01, 1000)
    tri = P[triples]
    solid = np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1) > 1e-3
    assert solid.sum() > 990  # a sliver's float32 normal is rounding noise in both packages
    np.testing.assert_allclose(normals.numpy()[solid], np.asarray(jn)[solid], rtol=0, atol=1e-5)
    # a point within float32 rounding of the threshold may count on one side only
    assert np.abs(inliers.numpy() - np.asarray(ji))[solid].max() <= 2
    # the port's own generator finds the same wall
    own, own_idx = pre.segment_plane(P, 0.01, 1000, seed, device="cpu")
    assert abs(np.dot(own[:3], jplane[:3])) > 0.9999 and len(own_idx) > 0.95 * len(jidx)
    again, _ = pre.segment_plane(P, 0.01, 1000, seed, device="cpu")
    np.testing.assert_array_equal(own, again)


def test_ransac_rejects_collinear_triples():
    P = np.column_stack([np.arange(6.0), np.zeros(6), np.zeros(6)]).astype(np.float32)
    _, _, inliers = pre._ransac_plane_scores(torch.from_numpy(P), torch.tensor([[0, 1, 2], [3, 3, 3]]), 0.01)
    assert inliers.tolist() == [-1, -1]


def test_icp_recovers_a_planted_motion_and_matches_jax(rng):
    target = _monument(rng)
    R = jax_pre.rodrigues_rotation(np.array([0.2, 1.0, -0.1]), 0.03)
    t = np.array([0.01, -0.008, 0.012])
    source = (target - t) @ R  # so that R @ source + t == target
    moved, T = pre.icp_point_to_point(source, target, 0.05, device="cpu")
    jmoved, jT = jax_pre.icp_point_to_point(source, target, 0.05)
    np.testing.assert_allclose(T, jT, rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(moved), jmoved, rtol=0, atol=1e-5)
    np.testing.assert_allclose(T[:3, :3], R, rtol=0, atol=1e-4)
    np.testing.assert_allclose(T[:3, 3], t, rtol=0, atol=1e-4)
    assert np.abs(_np(moved) - target).max() < 1e-4
    # too few correspondences: nothing moves
    far, T0 = pre.icp_point_to_point(source + 10.0, target, 0.05, device="cpu")
    np.testing.assert_array_equal(T0, np.eye(4))
    np.testing.assert_array_equal(_np(far), source + 10.0)


def test_build_taj_clouds_on_written_files(rng, tmp_path):
    """ICP is chaotic in its correspondences: where a source point has two
    targets within the JAX package's expansion error of each other the two
    packages may pair it differently, the sides of a completion lie ~0.02
    from each other, and one such pair sends the transforms 1e-4 to 1e-2
    apart (about half of the seeds tried).  This seed has no such pair, and
    then the clouds agree to float64 rounding of float32 neighbours."""
    sparse = _shell(np.random.default_rng(2))
    dense = np.vstack([sparse + rng.normal(scale=0.003, size=sparse.shape), rng.random((300, 3)) * 3 - 1])
    jax_pc.save_ply(tmp_path / "segmented_point_cloud_final.ply", sparse)
    jax_pc.save_ply(tmp_path / "fused.ply", dense)
    grid = np.zeros((9, 8, 7), np.uint8)
    grid[2:7, 1:6, 2:6] = config.PART_IDS["full_building"]
    grid[3:5, 6:8, 3:5] = config.PART_IDS["dome"]
    jax_artifacts.save_voxel_grid(tmp_path / "Taj_voxel_grid.npz", grid)
    (tmp_path / "synthetic_taj.obj").write_text(
        "v 0 0 0\nv 1 0 0\nv 1 0 1\nv 0 0 1\nv 0.5 1 0.5\n"
        "f 1 2 3 4\nf 1 2 5\nf 2 3 5\nf 3 4 5\nf 4 1 5\n")
    triples = np.array(jax.random.randint(jax.random.PRNGKey(0), (1000, 3), 0, len(sparse)))
    with profiling.recording() as spans:
        ours = pre.build_taj_clouds(tmp_path, cad_samples=2000, seed=0, triples=triples, device="cpu")
    ref = jax_pre.build_taj_clouds(tmp_path, cad_samples=2000, seed=0)
    (clouds,) = [s for s in spans if s.name == "clouds"]
    assert clouds.parent is None and {s.trace for s in spans} == {clouds.trace}
    names = [s.name for s in spans]
    assert names.count("io.load_ply") == 2 and "io.load_obj" in names and "io.load_voxel_grid" in names
    assert "clouds.plane_fit" in names
    assert [s.attrs["side"] for s in spans if s.name == "clouds.icp"] == ["left", "right", "back"]
    assert list(ours) == list(ref) == ["Sparse", "Dense (Cropped)", "Completed (ICP Aligned)", "Carved Grid",
                                      "Synthetic"]
    for k in ref:
        assert ours[k].dtype == torch.float64 and tuple(ours[k].shape) == ref[k].shape, k
        np.testing.assert_allclose(_np(ours[k]), ref[k], rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(_np(ours["Carved Grid"]), ref["Carved Grid"])
    # inputs missing from disk are skipped
    (tmp_path / "fused.ply").unlink()
    (tmp_path / "synthetic_taj.obj").unlink()
    assert list(pre.build_taj_clouds(tmp_path, triples=triples, device="cpu")) == \
        ["Sparse", "Completed (ICP Aligned)", "Carved Grid"]


def test_build_taj_clouds_carved_grid_equal_on_both_label_routes(tmp_path, monkeypatch):
    """The card's route (the npz inflated in steps, the palette decoded by
    torch) run on the CPU gives the host route's ``"Carved Grid"``."""
    jax_pc.save_ply(tmp_path / "segmented_point_cloud_final.ply", _shell(np.random.default_rng(2)))
    grid = np.zeros((9, 8, 7), np.uint8)
    grid[2:7, 1:6, 2:6] = config.PART_IDS["full_building"]
    grid[3:5, 6:8, 3:5] = config.PART_IDS["dome"]
    grid[1, 1, 1] = config.PART_IDS["windows"]
    jax_artifacts.save_voxel_grid(tmp_path / "Taj_voxel_grid.npz", grid)
    host = pre.build_taj_clouds(tmp_path, device="cpu")["Carved Grid"]
    monkeypatch.setattr(artifacts, "_STREAM_CHUNK", 30)  # 10 voxels a step, 51 steps
    real = pre.load_voxel_grid_labels
    monkeypatch.setattr(pre, "load_voxel_grid_labels", lambda path: real(path, device="cpu"))
    with profiling.recording() as spans:
        streamed = pre.build_taj_clouds(tmp_path, device="cpu")["Carved Grid"]
    assert [s.counts for s in spans if s.name == "io.load_voxel_grid"] == [{"io.load_voxel_grid.device": 1}]
    assert streamed.dtype == host.dtype == torch.float64 and len(host) == int((grid > 0).sum())
    assert torch.equal(streamed, host)
