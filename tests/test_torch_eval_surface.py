"""The rest of ``pbr3d_torch.eval.inter`` (voxel IoU, NN statistics, density
grid, marching-cubes mesh, normals, surface metrics), the mesh and component
helpers of ``pbr3d_torch.carving.voxel`` and ``pbr3d_torch.io.pointcloud``
against the JAX package on the same seeded inputs.

Integer and file work is equal.  ``compute_nn_stats`` and
``compute_surface_metrics`` are held to 1e-3 relative: their neighbours come
from the direct difference instead of the JAX package's expansion, and their
float32 means are summed in another order."""

from pathlib import Path

import numpy as np
import pytest
import torch

from pbr3d.carving import voxel as jax_voxel
from pbr3d.eval import inter as jax_inter
from pbr3d.io import artifacts as jax_artifacts
from pbr3d.io import pointcloud as jax_pc
from pbr3d_torch import config
from pbr3d_torch.carving import voxel
from pbr3d_torch.eval import inter
from pbr3d_torch.io import artifacts
from pbr3d_torch.io import pointcloud as pc

pytest_plugins = ["torch_threads"]

REPO = Path(__file__).resolve().parents[1]
AKBAR = REPO / "results_temp/1.Orthographic_Voxel_Carving/Akbar_voxel_grid.npz"


@pytest.fixture
def rng():
    """Fresh for every test, so no test's data depends on which ran before."""
    return np.random.default_rng(0)


def _shape_cloud(rng, n=6000):
    """Points on a box-and-dome shape, anisotropic like a monument."""
    p = rng.random((n, 3)) * np.array([1.0, 0.45, 0.8])
    dome = rng.normal(size=(n // 3, 3))
    dome = 0.2 * dome / np.linalg.norm(dome, axis=1, keepdims=True) + np.array([0.5, 0.5, 0.4])
    return np.vstack([p, dome])


def _toy_grid():
    g = np.zeros((14, 12, 10), np.uint8)
    g[2:11, 1:8, 2:8] = config.PART_IDS["full_building"]
    g[4:9, 8:11, 3:7] = config.PART_IDS["dome"]
    for i, (x, z, h) in enumerate([(0, 0, 9), (12, 0, 7), (0, 8, 5), (12, 8, 3), (6, 0, 2)]):
        g[x:x + 2, 1:1 + h, z:z + 2] = config.PART_IDS["front_minarets"]
    return g


@pytest.mark.parametrize("resolution,dilate_frac", [(96, 0.01), (32, 0.0), (48, 0.05)])
def test_voxel_iou_equal(rng, resolution, dilate_frac):
    A = _shape_cloud(rng)
    B = A[:4000] + rng.normal(scale=0.01, size=(4000, 3))
    ours = inter.voxel_iou(A, B, resolution, dilate_frac, device="cpu")
    assert ours == jax_inter.voxel_iou(A, B, resolution, dilate_frac)
    a32, b32 = A.astype(np.float32), B.astype(np.float32)
    assert inter.voxel_iou(a32, b32, resolution, dilate_frac, device="cpu") == \
        jax_inter.voxel_iou(a32, b32, resolution, dilate_frac)


def test_nn_stats_within_1e_3(rng):
    P = _shape_cloud(rng, 4000)
    ours = inter.compute_nn_stats(P, max_points=3000, device="cpu")
    ref = jax_inter.compute_nn_stats(P, max_points=3000)
    assert list(ours) == list(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-3)


def test_density_grid_and_mesh_equal(rng):
    P = _shape_cloud(rng)
    ours = inter.pointcloud_to_voxel_grid(P, 40, 1.0, device="cpu").numpy()
    ref = jax_inter.pointcloud_to_voxel_grid(P, 40, 1.0)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-5 * ref.max())
    np.testing.assert_array_equal(inter.pointcloud_to_voxel_grid(P, 40, 0.0, device="cpu").numpy(),
                                  jax_inter.pointcloud_to_voxel_grid(P, 40, 0.0))
    # an unsmoothed density holds integers: both extractors see the same grid
    verts, faces = inter.get_marching_cubes_mesh(P, 40, sigma=0.0, level=0.5, device="cpu")
    jverts, jfaces = jax_inter.get_marching_cubes_mesh(P, 40, sigma=0.0, level=0.5)
    np.testing.assert_array_equal(verts.numpy(), jverts)
    np.testing.assert_array_equal(faces.numpy(), jfaces)


def _mesh(rng):
    P = _shape_cloud(rng)
    verts, faces = jax_inter.get_marching_cubes_mesh(P, 48, sigma=1.0, level=0.2)
    return verts.astype(np.float32), faces


def test_filter_and_normals_equal(rng):
    verts, faces = _mesh(rng)
    tv, tf = torch.from_numpy(verts), torch.from_numpy(faces)
    v, f = inter.filter_mesh(tv, tf, 0.8)
    jv, jf = jax_inter.filter_mesh(verts, faces, 0.8)
    assert 0 < len(jv) < len(verts)
    np.testing.assert_array_equal(v.numpy(), jv)
    np.testing.assert_array_equal(f.numpy(), jf)
    np.testing.assert_allclose(inter.compute_triangle_normals(tv, tf).numpy(),
                               jax_inter.compute_triangle_normals(verts, faces), rtol=0, atol=1e-6)
    np.testing.assert_allclose(inter.compute_vertex_normals(tv, tf).numpy(),
                               jax_inter.compute_vertex_normals(verts, faces), rtol=0, atol=1e-5)


@pytest.mark.parametrize("k", [8, 20])
def test_surface_metrics_within_1e_3(rng, k):
    verts, faces = _mesh(rng)
    ours = inter.compute_surface_metrics(verts, faces, k, device="cpu")
    ref = jax_inter.compute_surface_metrics(verts, faces, k)
    assert list(ours) == list(ref)
    for name in ref:
        np.testing.assert_allclose(ours[name], ref[name], rtol=1e-3)


def _grids():
    return {"toy": _toy_grid(), "Akbar": artifacts.load_voxel_grid_labels(AKBAR)}


@pytest.mark.parametrize("name", ["toy", "Akbar"])
def test_grid_to_points_and_top_k_components_equal(name):
    g = _grids()[name]
    for stride in (1, 2, 3):
        pts, labels, dims = voxel.grid_to_points(g, stride, device="cpu")
        jpts, jlabels, jdims = jax_voxel.grid_to_points(g, stride)
        np.testing.assert_array_equal(pts.numpy(), jpts)
        np.testing.assert_array_equal(labels.numpy(), jlabels)
        assert dims == jdims
    for part, k in (("front_minarets", 4), ("front_minarets", 2), ("dome", 1), ("plinth", 3)):
        np.testing.assert_array_equal(voxel.extract_top_k_components(g, part, k),
                                      jax_voxel.extract_top_k_components(g, part, k))


@pytest.mark.parametrize("name,stride", [("toy", 1), ("toy", 2), ("Akbar", 4)])
def test_meshify_equal(name, stride):
    g = _grids()[name]
    ours = voxel.meshify_colored_voxel_grid(g, stride, device="cpu")
    ref = jax_voxel.meshify_colored_voxel_grid(g, stride)
    for o, r, what in zip(ours, ref, ("vertices", "faces", "colours", "normals")):
        assert o.numpy().dtype == r.dtype, what
        if what == "normals":
            np.testing.assert_allclose(o.numpy(), r, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(o.numpy(), r, err_msg=what)


def test_load_voxel_grid_rgb_equal():
    np.testing.assert_array_equal(artifacts.load_voxel_grid_rgb(AKBAR), jax_artifacts.load_voxel_grid_rgb(AKBAR))


def test_ply_and_obj_cross_read(rng, tmp_path):
    pts = rng.normal(size=(257, 3))
    cols = rng.integers(0, 256, size=(257, 3)).astype(np.uint8)
    for writer, reader in ((pc, jax_pc), (jax_pc, pc), (pc, pc)):
        writer.save_ply(tmp_path / "a.ply", pts, cols)
        back = reader.load_ply(tmp_path / "a.ply")
        np.testing.assert_array_equal(back["points"], pts)
        np.testing.assert_array_equal(back["colors"], cols)
        writer.save_ply(tmp_path / "b.ply", pts)
        assert list(reader.load_ply(tmp_path / "b.ply")) == ["points"]
    assert (tmp_path / "a.ply").read_bytes() != b""
    pc.save_ply(tmp_path / "t.ply", torch.from_numpy(pts), torch.from_numpy(cols))
    jax_pc.save_ply(tmp_path / "j.ply", pts, cols)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    (tmp_path / "ascii.ply").write_text(
        "ply\nformat ascii 1.0\ncomment x\nelement vertex 2\nproperty float x\nproperty float y\n"
        "property float z\nproperty float nx\nproperty float ny\nproperty float nz\nend_header\n"
        "0 1 2 0 0 1\n3 4 5 1 0 0\n")
    a, b = pc.load_ply(tmp_path / "ascii.ply"), jax_pc.load_ply(tmp_path / "ascii.ply")
    assert list(a) == list(b) == ["points", "normals"]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    (tmp_path / "m.obj").write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0.5\nvn 0 0 1\nf 1 2 3 4\nf 1/1 3/2 -1/3\n")
    v, f = pc.load_obj(tmp_path / "m.obj")
    jv, jf = jax_pc.load_obj(tmp_path / "m.obj")
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    assert f.shape == (3, 3)
    with pytest.raises(ValueError, match="not a PLY"):
        pc.load_ply(tmp_path / "m.obj")


@pytest.mark.parametrize("seed", [0, 7])
def test_sample_mesh_surface_equal(rng, seed):
    verts, faces = _mesh(rng)
    ours = pc.sample_mesh_surface(verts.astype(np.float64), faces, 5000, seed)
    np.testing.assert_array_equal(ours, jax_pc.sample_mesh_surface(verts.astype(np.float64), faces, 5000, seed))
    np.testing.assert_array_equal(
        pc.sample_mesh_surface(torch.from_numpy(verts.astype(np.float64)), torch.from_numpy(faces), 5000, seed), ours)
