"""The port's figures (``pbr3d_torch.utils.viz``) against the JAX package's
on Akbar@128: the committed ``results_temp_golden/`` grid and cameras and the
planted front plane of ``tests/fixtures/torch_port_study.npz``.

Tolerance: none for every image array, title and IoU, which are equal.
Projected keypoints are the one exception: the JAX package projects them op
by op (eager, each product and sum rounded apart), the port in XLA's fused
pattern (``ops/cameramath._fma``), so a plotted keypoint and its pixel error
may differ by a few float32 ulps: they are held to ``KP_ATOL`` pixels.
"""

from pathlib import Path

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from pbr3d.utils import viz as jviz  # noqa: E402
from pbr3d_torch.io.artifacts import load_camera_json, load_voxel_grid_labels  # noqa: E402
from pbr3d_torch.utils import viz as tviz  # noqa: E402

pytest_plugins = ["torch_threads"]

REPO = Path(__file__).resolve().parents[1]
RES = REPO / "results_temp_golden"
M = "Akbar"
MINARETS = ("LM1", "RM1", "LM2", "RM2")
#: Pixels: a plotted projected keypoint and its error, port vs JAX.
KP_ATOL = 1e-4


@pytest.fixture(scope="module")
def scene():
    grid = load_voxel_grid_labels(RES / "1.Orthographic_Voxel_Carving" / f"{M}_voxel_grid.npz")
    plane = np.load(REPO / "tests/fixtures/torch_port_study.npz")[f"golden_{M}_front"]
    cams = {t: load_camera_json(RES / "2.Perspective_Camera_Estimation" / f"{M}_camera_params_{t}.json",
                                "front") for t in ("init", "kp", "final")}
    rng = np.random.default_rng(0)
    names = [f"{m}_{e}" for m in MINARETS for e in ("top", "bottom")]
    voxel_kps = {n: (rng.random(3) * np.array(grid.shape)[::-1]).astype(np.float32) for n in names}
    H, W = plane.shape
    image_kps = {n: (float(rng.random() * W), float(rng.random() * H)) for n in names if n != "RM2_bottom"}
    return grid, plane, cams, voxel_kps, image_kps


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def _axes_equal(fig_ours, fig_ref, points_atol=0.0):
    assert len(fig_ours.axes) == len(fig_ref.axes)
    for a, b in zip(fig_ours.axes, fig_ref.axes):
        assert a.get_title() == b.get_title()
        assert len(a.images) == len(b.images)
        for ia, ib in zip(a.images, b.images):
            np.testing.assert_array_equal(ia.get_array(), ib.get_array())
        assert len(a.lines) == len(b.lines)
        for la, lb in zip(a.lines, b.lines):
            np.testing.assert_allclose(la.get_xydata(), lb.get_xydata(), rtol=0, atol=points_atol)
            assert la.get_color() == lb.get_color()
        assert len(a.collections) == len(b.collections)
        for ca, cb in zip(a.collections, b.collections):
            np.testing.assert_array_equal(ca.get_facecolor(), cb.get_facecolor())
            if hasattr(ca, "_offsets3d"):
                for x, y in zip(ca._offsets3d, cb._offsets3d):
                    np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
            else:
                np.testing.assert_allclose(ca.get_offsets(), cb.get_offsets(), rtol=0, atol=points_atol)


@pytest.mark.parametrize("mode", ["part_on_whole", "part_on_part", "whole_on_whole", "whole_on_whole_color"])
def test_voxel_projection_iou(scene, mode):
    grid, plane, cams, _, _ = scene
    parts = ["dome", "front_minarets", "back_minarets", "full_building", "windows"]
    ours = tviz.visualize_voxel_projection_iou(grid, parts, plane, cams["final"], mode, device="cpu")
    ref = jviz.visualize_voxel_projection_iou(grid, parts, plane, cams["final"], mode)
    assert [t for _, t in ours] == [t for _, t in ref]
    assert len(ours) >= 1
    for (fo, _), (fr, _) in zip(ours, ref):
        _axes_equal(fo, fr)


def test_outline_and_iou(scene):
    _, plane, _, _, _ = scene
    rng = np.random.default_rng(4)
    gt = plane == 1
    pr = np.roll(gt, 3, axis=1) & (rng.random(gt.shape) < 0.9)
    base = rng.integers(0, 255, (*gt.shape, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tviz._outline(base.copy(), gt, pr, device="cpu"),
                                  jviz._outline(base.copy(), gt, pr))
    assert tviz._iou(gt, pr) == jviz._iou(gt, pr)
    assert tviz._iou(np.zeros(3, bool), np.zeros(3, bool)) == 0.0


def test_reprojection(scene):
    _, plane, cams, voxel_kps, image_kps = scene
    fo, eo = tviz.visualize_reprojection(plane, voxel_kps, image_kps, cams["kp"], "Akbar kp", device="cpu")
    fr, er = jviz.visualize_reprojection(plane, voxel_kps, image_kps, cams["kp"], "Akbar kp")
    assert list(eo) == list(er)
    np.testing.assert_allclose(list(eo.values()), list(er.values()), rtol=0, atol=KP_ATOL)
    _axes_equal(fo, fr, KP_ATOL)


@pytest.mark.parametrize("back_top_only", [False, True])
def test_minaret_kp(scene, back_top_only):
    _, plane, cams, voxel_kps, image_kps = scene
    args = (M, "init", cams["init"], plane, voxel_kps, image_kps, MINARETS, back_top_only)
    _axes_equal(tviz.visualize_minaret_kp(*args, device="cpu"), jviz.visualize_minaret_kp(*args), KP_ATOL)


def test_minarets_all_cams(scene):
    grid, plane, cams, _, _ = scene
    fo, io = tviz.visualize_minarets_all_cams(grid, plane, cams, device="cpu")
    fr, ir = jviz.visualize_minarets_all_cams(grid, plane, cams)
    assert io == ir and list(io) == ["init", "kp", "final"]
    assert max(io.values()) > 0
    _axes_equal(fo, fr)


def test_side_by_side(scene):
    _, plane, _, _, _ = scene
    gt = plane > 0
    pr0, pr1 = np.roll(gt, 2, axis=0), np.roll(gt, -1, axis=1)
    args = (gt, pr0, pr1, "whole", 0.81234, 0.9)
    _axes_equal(tviz.visualize_side_by_side(*args), jviz.visualize_side_by_side(*args))


def test_plot_voxel_and_grid(scene):
    grid, _, _, _, _ = scene
    _axes_equal(tviz.plot_voxel_grid(grid, 4, "Akbar", device="cpu"), jviz.plot_voxel_grid(grid, 4, "Akbar"))
    rng = np.random.default_rng(1)
    pts = rng.random((700, 3)) * 50
    cols = rng.integers(0, 255, (700, 3))
    _axes_equal(tviz.plot_voxel(pts, cols, "t", max_points=300, seed=3),
                jviz.plot_voxel(pts, cols, "t", max_points=300, seed=3))


def test_meshes():
    rng = np.random.default_rng(2)
    verts = rng.random((30, 3)).astype(np.float32)
    faces = rng.integers(0, 30, (40, 3))
    colors = rng.random((30, 3))
    fo = tviz.visualize_mesh_matplotlib(verts, faces, colors, "mesh")
    fr = jviz.visualize_mesh_matplotlib(verts, faces, colors, "mesh")
    _axes_equal(fo, fr)
    for mod in (tviz, jviz):
        with pytest.raises(ImportError, match="plotly is not installed"):
            mod.visualize_mesh_plotly(verts, faces, colors, "mesh")
