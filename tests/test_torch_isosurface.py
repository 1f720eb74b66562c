"""``pbr3d_torch.ops.isosurface`` against ``pbr3d.ops.isosurface`` on the
same grids: vertices and faces equal (same float32 interpolation, same cell,
triangle and vertex order)."""

import numpy as np
import pytest

from pbr3d.ops import isosurface as jax_iso
from pbr3d_torch.ops import isosurface as iso

pytest_plugins = ["torch_threads"]


def _volumes():
    rng = np.random.default_rng(3)
    x = np.linspace(-1, 1, 30)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    blob = np.zeros((24, 20, 22), np.float32)
    blob[5:17, 4:15, 6:18] = 1
    blob[9:12, 8:10, 0:22] = 1  # touches the border
    return {
        "sphere": ((0.6 - np.sqrt(X**2 + Y**2 + Z**2)).astype(np.float32), 0.0),
        "random": (rng.random((40, 14, 11)).astype(np.float32), 0.5),
        "occupancy": ((rng.random((18, 18, 18)) > 0.55).astype(np.float32), 0.5),
        "blob": (blob, 0.5),
        "empty": (np.zeros((6, 6, 6), np.float32), 0.5),
        "thin": (rng.random((1, 8, 8)).astype(np.float32), 0.5),
    }


def test_tables_equal_the_jax_packages():
    np.testing.assert_array_equal(iso._MC_TABLE, jax_iso._MC_TABLE)
    np.testing.assert_array_equal(iso._CASES, jax_iso._CASES)
    assert iso._MC_MAXT == jax_iso._MC_MAXT


@pytest.mark.parametrize("name", list(_volumes()))
@pytest.mark.parametrize("fn", ["marching_cubes", "marching_tetrahedra"])
@pytest.mark.parametrize("slab", [64, 7])
def test_vertices_and_faces_equal(name, fn, slab):
    vol, level = _volumes()[name]
    verts, faces = getattr(iso, fn)(vol, level, slab, device="cpu")
    jverts, jfaces = getattr(jax_iso, fn)(vol, level, slab)
    assert verts.numpy().dtype == np.float32 and faces.numpy().dtype == np.int32
    np.testing.assert_array_equal(verts.numpy(), jverts)
    np.testing.assert_array_equal(faces.numpy(), jfaces)


def test_sphere_is_closed_and_outward():
    vol, level = _volumes()["sphere"]
    verts, faces = (t.numpy() for t in iso.marching_cubes(vol, level, device="cpu"))
    edges = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert np.all(counts == 2)  # watertight
    tri = verts[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    assert np.all((n * (tri.mean(1) - 14.5)).sum(1) > 0)  # normals point away from the centre
