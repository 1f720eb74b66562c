"""Akbar@128 cases shared by the tests of stage 2's kernels
(``test_torch_stage2_kernels.py``, ``test_torch_stage2_emulated.py``): the
oracle's grid, the recovered front mask and a planted drone view
(``scripts/make_torch_port_stage2_fixture.py::akbar_128``), their keypoints
and JAX fits, the alignment parts' shell, and seeded cameras, points and
fit rows around them."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from pbr3d.camera import estimate as jest
from pbr3d.camera import geometry as jgeo
from pbr3d.camera import keypoints as jkp
from pbr3d_torch.camera import estimate as test_
from pbr3d_torch.carving import voxel as tvox

REPO = Path(__file__).resolve().parents[1]
PARTS = ["front_minarets", "back_minarets"]
IDS = [5, 6]
VIEWS = ("front", "drone")
STEPS = np.array([50, 50, 100, 50, 50, 100, 50, 20, 20], np.float32)


@pytest.fixture(scope="module")
def fx():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_stage2_fixture", REPO / "scripts" / "make_torch_port_stage2_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


@pytest.fixture(scope="module")
def shell(akbar):
    return tvox.surface_points_by_parts(akbar[0], PARTS, device="cpu")


def _cams(kp, view, n, seed, scale=0.1):
    """(n, 9) cameras around the view's JAX keypoint fit, the same in every
    run."""
    rng = np.random.default_rng([seed, n])
    base = jgeo.params_to_vector(kp[view][3]).astype(np.float32)
    return base + rng.uniform(-1, 1, (n, 9)).astype(np.float32) * STEPS * scale


def _hard_cams(kp, view, shell_pts):
    """A degenerate-up camera (straight above its target), one inside the
    shell (points behind it and on its plane Z = 0), one whose focal length
    sends most points off the plane, and one looking away from the shell."""
    base = jgeo.params_to_vector(kp[view][3]).astype(np.float32)
    centre = shell_pts.mean(dim=0).numpy()
    up = base.copy()
    up[0:3], up[3:6] = centre + np.float32([0, -300, 0]), centre
    inside = base.copy()
    inside[0:3] = centre
    wide = base.copy()
    wide[6] = 2000.0
    away = base.copy()
    away[0:3], away[3:6] = centre + np.float32([0.5, 0.25, -300]), centre + np.float32([0.5, 0.25, -600])
    return np.stack([up, inside, wide, away]).astype(np.float32)


def _hard_points(pts, labels, seed):
    """The shell, then copies of some of its points with other labels (the
    same pixel under every camera: the later copy wins), then points far
    behind and far beside the cameras."""
    rng = np.random.default_rng(seed)
    pick = rng.choice(pts.shape[0], 200, replace=False)
    dup_l = torch.from_numpy(rng.choice(np.array([0, 5, 6, 9], np.uint8), 200))
    far = torch.from_numpy(rng.uniform(-1e4, 1e4, (50, 3)).astype(np.float32))
    far[:25, 2] = -5e4
    return (torch.cat([pts, pts[pick], far]),
            torch.cat([labels, dup_l, torch.from_numpy(rng.choice(np.array([5, 6], np.uint8), 50))]))


def _fit_rows(kp, views):
    """Three fits' inputs, (9,) / (K, 3) / ... numpy each: the two views, and
    the front view from another start with two of its keypoints masked out
    (their coordinates junk), as a padded view."""
    rows = []
    for view in VIEWS:
        vk, ik, init, _ = kp[view]
        rows.append(test_.keypoint_fit_inputs(vk, ik, views[view].shape, init))
    x0, vox, img, mask, lo, hi = (a.copy() for a in rows[0])
    x0 += np.float32([4, -3, 6, 2, 1, -5, 20, 3, -2])
    mask[-2:] = 0
    vox[-2:] = 1e3
    img[-2:] = -7.0
    rows.append((x0, vox, img, mask, lo, hi))
    return rows
