"""The port's stage-2 modules (``carving/voxel`` extraction, host components,
``camera/{geometry,keypoints,estimate,align}``) against the JAX package on
Akbar at 128: the oracle's ``final`` grid, the recovered front mask and a
drone view planted through the committed Akbar drone camera
(``scripts/make_torch_port_stage2_fixture.py::akbar_128``).

Tolerances: extraction, components, keypoints and the bbox init are exact.
The LM fit's loss agrees within rtol 1e-3 and its camera within 1e-3 of the
camera vector's norm: the keypoint objective has a near-flat ridge (the
target slides along the view ray), along which the JAX fit itself moves by
up to 0.02 for a 1e-6 relative change of its init, so float32 rounding in
another order lands elsewhere on it.  Candidate IoUs agree within 1e-6, and
a search fed the JAX package's draws returns the same camera and IoU."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbr3d import pipeline as jpipe
from pbr3d.camera import align as jalign
from pbr3d.camera import estimate as jest
from pbr3d.camera import geometry as jgeo
from pbr3d.camera import keypoints as jkp
from pbr3d.carving import voxel as jvox
from pbr3d.ops import components as jcomp
from pbr3d_torch import pipeline as tpipe
from pbr3d_torch.camera import align as talign
from pbr3d_torch.camera import estimate as test_
from pbr3d_torch.camera import geometry as tgeo
from pbr3d_torch.camera import keypoints as tkp
from pbr3d_torch.carving import voxel as tvox
from pbr3d_torch.ops import components as tcomp

REPO = Path(__file__).resolve().parents[1]
PARTS = ["front_minarets", "back_minarets"]
VIEWS = ("front", "drone")


def _fixture_module():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_stage2_fixture", REPO / "scripts" / "make_torch_port_stage2_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fx():
    return _fixture_module()


@pytest.fixture(scope="module")
def akbar(fx):
    return fx.akbar_128()


@pytest.fixture(scope="module")
def kp(akbar):
    """Per view: (voxel kps, image kps, JAX init, JAX kp fit)."""
    grid, views = akbar
    out = {}
    for view, mask in views.items():
        vk, ik = jkp.extract_minaret_kps_for_view(grid, mask)
        init = jest.auto_compute_initial_params_matching_bbox(grid, mask, PARTS)
        out[view] = (vk, ik, init, jest.optimize_camera_with_keypoints(vk, ik, mask.shape, init))
    return out


def _vec(cam):
    return jgeo.params_to_vector(cam)


@pytest.mark.parametrize("parts", [PARTS, ["front_minarets"], ["dome", "plinth"], ["windows"]])
def test_point_extraction_bit_exact(akbar, parts):
    grid = akbar[0]
    for jf, tf in ((jvox.points_by_parts, tvox.points_by_parts),
                   (jvox.surface_points_by_parts, tvox.surface_points_by_parts)):
        rp, rl = jf(grid, parts)
        tp, tl = tf(torch.from_numpy(grid), parts, device="cpu")
        np.testing.assert_array_equal(tp.numpy(), rp)
        np.testing.assert_array_equal(tl.numpy(), rl)
    assert tvox.bucket_size(len(rp)) == jvox.bucket_size(len(rp))


def test_surface_points_empty_selection():
    pts, labels = tvox.surface_points_by_parts(np.zeros((4, 5, 6), np.uint8), PARTS, device="cpu")
    assert pts.shape == (0, 3) and labels.shape == (0,)


@pytest.mark.parametrize("connectivity", ["face", "full"])
def test_components_match_jax(akbar, connectivity):
    for mask in (akbar[0] == 5, akbar[1]["drone"] == 6):
        rl, rn = jcomp.connected_components(mask, connectivity)
        tl, tn = tcomp.connected_components(mask, connectivity)
        assert tn == rn > 0
        np.testing.assert_array_equal(tl, rl)
        rs, ts = jcomp.component_stats(rl, rn), tcomp.component_stats(tl, tn)
        for k in ("bbox_min", "bbox_max", "count"):
            np.testing.assert_array_equal(ts[k][1: tn + 1], rs[k][1: rn + 1])
        np.testing.assert_allclose(ts["centroid"][1: tn + 1], rs["centroid"][1: rn + 1], rtol=1e-5)


@pytest.mark.parametrize("view", VIEWS)
def test_keypoints_and_init_equal(akbar, kp, view):
    grid, views = akbar
    vox_parts = tkp.extract_minaret_voxels_by_label(grid)
    ref_parts = jkp.extract_minaret_voxels_by_label(grid)
    assert list(vox_parts) == list(ref_parts)
    for k in ref_parts:
        np.testing.assert_array_equal(vox_parts[k], ref_parts[k])
    vk, ik = tkp.extract_minaret_kps_for_view(grid, views[view], voxel_parts=vox_parts)
    rvk, rik, rinit, _ = kp[view]
    assert list(vk) == list(rvk) and len(vk) == 6
    for k in rvk:
        np.testing.assert_array_equal(vk[k], rvk[k])
    assert ik == rik
    init = test_.auto_compute_initial_params_matching_bbox(grid, views[view], PARTS, device="cpu")
    assert list(init) == list(rinit)
    for k in rinit:
        np.testing.assert_array_equal(init[k], rinit[k])


@pytest.mark.parametrize("view", VIEWS)
def test_keypoint_lm_fit_matches_jax(akbar, kp, view):
    vk, ik, init, ref = kp[view]
    ours = test_.optimize_camera_with_keypoints(vk, ik, akbar[1][view].shape, init, device="cpu")
    assert abs(ours["loss"] - ref["loss"]) <= 1e-3 * ref["loss"], (ours["loss"], ref["loss"])
    x, rx = _vec(ours), _vec(ref)
    assert np.linalg.norm(x - rx) <= 1e-3 * np.linalg.norm(rx), (x, rx)
    lo, hi = jest.default_bounds(*akbar[1][view].shape)
    assert np.all(x >= lo) and np.all(x <= hi)


def test_lm_state_freezes_after_convergence():
    """200 masked steps give the result of a loop that stops at |delta| <=
    1e-10: steps past convergence change nothing."""
    rng = np.random.default_rng(3)
    cam = {"cam_pos": np.array([40.0, 30.0, -300.0]), "target": np.array([60.0, 50.0, 64.0]),
           "f": 300.0, "cx": 64.0, "cy": 60.0}
    vox = rng.uniform(10, 110, (6, 3)).astype(np.float32)
    u, v, _ = jgeo.project_points(jnp.asarray(vox), **cam)
    img = np.stack([np.asarray(u), np.asarray(v)], 1)
    x0 = torch.tensor(_vec(cam) + np.float32(3.0))
    lo, hi = (torch.tensor(a) for a in jest.default_bounds(128, 128))
    args = (torch.from_numpy(vox), torch.from_numpy(img), torch.ones(6), lo, hi)
    x200, l200 = test_._lm_fit(x0, *args)
    x300, l300 = test_._lm_fit(x0, *args, max_iters=300)
    assert float(l200) < 1e-3
    assert torch.equal(x200, x300) and torch.equal(l200, l300)


@pytest.mark.parametrize("view", VIEWS)
def test_batch_iou_matches_jax(fx, akbar, kp, view):
    grid, views = akbar
    rng = np.random.default_rng(7)
    steps = np.array([50, 50, 100, 50, 50, 100, 50, 20, 20], np.float32)
    cams = (_vec(kp[view][3]) + rng.uniform(-1, 1, (32, 9)).astype(np.float32) * steps * 0.1)
    ref = fx.jax_shell_ious(grid, views[view], cams)
    pts, labels = tvox.surface_points_by_parts(grid, PARTS, device="cpu")
    gt = torch.from_numpy(talign.mask_labels_selected(views[view], PARTS))
    ours = talign._batch_iou(torch.from_numpy(cams), pts, labels, gt, [5, 6], *views[view].shape)
    assert ref.max() > 0.3
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-6)
    rv = jalign.evaluate_camera_iou(grid, views[view], PARTS, kp[view][3])
    tv = talign.evaluate_camera_iou(grid, views[view], PARTS, kp[view][3], device="cpu")
    assert abs(tv - rv) <= 1e-6


@pytest.mark.parametrize("view, extra", [
    ("front", {}), ("drone", {}),
    ("front", {"lock_xy_equal": True}), ("drone", {"cd_mags": (1.0, 0.25, 4.0), "step_scale": 2.0}),
])
def test_refine_with_jax_draws_matches_jax(fx, akbar, kp, view, extra):
    grid, views = akbar
    start = kp[view][3]
    kw = dict(generations=4, population=16, cd_rounds=2, seed=0, **extra)
    ref, ref_iou = jalign.refine_camera_mask_iou(grid, views[view], PARTS, start, **kw)
    ours, iou = talign.refine_camera_mask_iou(
        grid, views[view], PARTS, start, draws={0: fx.jax_draws(0, 4, 16)}, device="cpu", **kw)
    assert abs(iou - ref_iou) <= 1e-6
    np.testing.assert_array_equal(_vec(ours), _vec(ref))
    assert (ours["H"], ours["W"]) == (ref["H"], ref["W"]) == views[view].shape


def test_refine_coarse_to_native_for_large_planes(fx):
    """Planes over 512² px search at half resolution, then polish at native
    resolution (tests/test_camera.py's scene).  One part: there the JAX
    package's one-hot objective of the half-resolution search is the exact
    splat, so the trajectories agree."""
    grid = np.zeros((40, 40, 40), np.uint8)
    grid[8:32, 6:34, 6:14] = 5
    H = W = 560
    assert H * W > talign._COARSE_PLANE_PIXELS
    mask = np.zeros((H, W), np.uint8)
    mask[140:420, 160:400] = 5
    init = dict(cam_pos=np.array([20.0, 20.0, -120.0]), target=np.array([20.0, 20.0, 20.0]),
                f=600.0, cx=280.0, cy=280.0)
    kw = dict(generations=2, population=16, cd_rounds=2, seed=0)
    ref, ref_iou = jalign.refine_camera_mask_iou(grid, mask, ["front_minarets"], init, **kw)
    ours, iou = talign.refine_camera_mask_iou(
        grid, mask, ["front_minarets"], init, draws={0: fx.jax_draws(0, 2, 16)}, device="cpu", **kw)
    assert (ours["H"], ours["W"]) == (H, W)
    assert abs(iou - ref_iou) <= 1e-6 and iou > 0
    np.testing.assert_array_equal(_vec(ours), _vec(ref))


def test_own_generator_draws(akbar, kp):
    grid, views = akbar
    u = talign._uniform_draws(None, 5, 3, 16, "cpu")
    assert u.shape == (3, 16, 9) and u.dtype == torch.float32
    assert float(u.min()) >= -1.0 and float(u.max()) < 1.0
    assert torch.equal(u, talign._uniform_draws(None, 5, 3, 16, "cpu"))
    assert not torch.equal(u, talign._uniform_draws(None, 6, 3, 16, "cpu"))
    start = kp["front"][3]
    kw = dict(generations=3, population=16, cd_rounds=1, seed=0, device="cpu")
    a = talign.refine_camera_mask_iou(grid, views["front"], PARTS, start, **kw)
    b = talign.refine_camera_mask_iou(grid, views["front"], PARTS, start, **kw)
    assert a[1] == b[1] and np.array_equal(_vec(a[0]), _vec(b[0]))
    assert a[1] >= talign.evaluate_camera_iou(grid, views["front"], PARTS, start, device="cpu") - 0.05
    with pytest.raises(ValueError, match="draws for seed 0"):
        talign.refine_camera_mask_iou(grid, views["front"], PARTS, start,
                                      draws={0: np.zeros((2, 16, 9), np.float32)}, **kw)


def test_population_rounding_matches_jax():
    for n, pop in ((1000, 64), (96_620, 64), (600_000, 64), (5_000_000, 64), (3_000, 20)):
        chunk = max(1, min(pop, (1 << 26) // jvox.bucket_size(n)))
        chunk = 1 << (chunk.bit_length() - 1)
        assert talign._pop_chunk(n, pop) == (chunk, max(chunk, (pop // chunk) * chunk))


def test_geometry_helpers_match_jax(akbar):
    cam = {"cam_pos": np.array([300.0, 200.0, -900.0]), "target": np.array([128.0, 100.0, 128.0]),
           "f": 800.0, "cx": 161.0, "cy": 208.0}
    for ours, ref in (
        (tgeo.yaw_camera_about_center(cam, (64, 60, 70), 90.0),
         jgeo.yaw_camera_about_center(cam, (64, 60, 70), 90.0)),
        (tgeo.dolly_zoom(cam, 2.0), jgeo.dolly_zoom(cam, 2.0)),
        (tgeo.reparam_principal_point(cam, 3.0, 7.0), jgeo.reparam_principal_point(cam, 3.0, 7.0)),
    ):
        assert list(ours) == list(ref)
        for k in ref:
            np.testing.assert_array_equal(ours[k], ref[k])
    vec = tgeo.params_to_vector(cam)
    np.testing.assert_array_equal(vec, jgeo.params_to_vector(cam))
    back = tgeo.vector_to_params(torch.from_numpy(vec), H=5, W=6)
    ref = jgeo.vector_to_params(vec, H=5, W=6)
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k])
    pt = np.array([20.0, 9.0, 4.0], np.float32)
    np.testing.assert_array_equal(tgeo.project_point(pt, cam, device="cpu").numpy(),
                                  np.asarray(jgeo.project_point(pt, cam)))


@pytest.mark.parametrize("view", VIEWS)
def test_retry_starts_match_jax(akbar, kp, view):
    grid, views = akbar
    start = kp[view][3]
    ref = jpipe._retry_starts(start, grid.shape, view, mask_hw=views[view].shape,
                              grid_labels=grid, mask_labels=views[view])
    ours = tpipe._retry_starts(start, grid.shape, view, mask_hw=views[view].shape,
                               grid_labels=torch.from_numpy(grid), mask_labels=views[view],
                               device="cpu")
    assert [t for t, _, _ in ours] == [t for t, _, _ in ref]
    assert "elev+" in [t for t, _, _ in ours] or view == "front"
    for (_, p, s), (_, rp, rs) in zip(ours, ref):
        assert s == rs and list(p) == list(rp)
        for k in rp:
            np.testing.assert_array_equal(p[k], rp[k])
    # no minaret voxels: the classic family only, as the JAX package
    empty = np.zeros_like(grid)
    assert [t for t, _, _ in tpipe._retry_starts(start, grid.shape, "drone", grid_labels=empty,
                                                 mask_labels=views[view], device="cpu")] == \
        [t for t, _, _ in jpipe._retry_starts(start, grid.shape, "drone", grid_labels=empty,
                                              mask_labels=views[view])]
