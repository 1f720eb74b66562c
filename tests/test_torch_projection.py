"""The port's projection core (``ops/cameramath.py``, ``ops/projection.py``)
against the JAX package, on the same seeded numpy inputs.

Tolerances: projections agree to 1e-3 px (they are bit-equal on the CPU:
the port fuses the multiply-adds as XLA's CPU backend does).  Splat and
z-buffer planes are equal up to pixels that sit on a rounding tie — each
differing pixel must be traced to a point within 1e-3 px of a .5 boundary,
and at most 10 may differ per plane.  IoUs are exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbr3d.ops import cameramath as jcm
from pbr3d.ops import projection as jproj
from pbr3d_torch.camera.align import _search_one
from pbr3d_torch.ops import cameramath as tcm
from pbr3d_torch.ops import projection as tproj

pytest_plugins = ["torch_threads"]

H, W = 64, 80
MAX_TIE_PIXELS = 10


def _cams(rng, n):
    """n seeded cameras looking at a 32-voxel cube from all around."""
    eye = rng.uniform(-60, 90, (n, 3)).astype(np.float32)
    eye[:, 2] = rng.uniform(-120, -40, n)
    tgt = rng.uniform(8, 24, (n, 3)).astype(np.float32)
    f = rng.uniform(60, 200, n).astype(np.float32)
    cx = rng.uniform(20, 60, n).astype(np.float32)
    cy = rng.uniform(20, 44, n).astype(np.float32)
    return eye, tgt, f, cx, cy


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture()
def cloud(rng):
    pts = rng.uniform(0, 32, (3000, 3)).astype(np.float32)
    labels = rng.integers(1, 11, 3000).astype(np.uint8)
    return pts, labels


def _near_tie(pts, cam, pix_flat):
    """True iff some point landing on (or next to) each pixel of
    ``pix_flat`` has u or v within 1e-3 px of a .5 boundary."""
    u, v, _ = (np.asarray(a, np.float64) for a in jcm.project_points(jnp.asarray(pts), *cam))
    tie = (np.abs(u - np.floor(u) - 0.5) < 1e-3) | (np.abs(v - np.floor(v) - 0.5) < 1e-3)
    near = {(int(y), int(x)) for y, x in zip(np.floor(v[tie] + 0.5), np.floor(u[tie] + 0.5))}
    near |= {(int(y), int(x)) for y, x in zip(np.floor(v[tie] + 0.5) - 1, np.floor(u[tie] + 0.5))}
    near |= {(int(y), int(x)) for y, x in zip(np.floor(v[tie] + 0.5), np.floor(u[tie] + 0.5) - 1)}
    return all((int(p) // W, int(p) % W) in near for p in pix_flat)


def _count_ties(ours, ref, pts, cam):
    diff = np.flatnonzero(np.asarray(ours).ravel() != np.asarray(ref).ravel())
    assert len(diff) <= MAX_TIE_PIXELS, f"{len(diff)} pixels differ"
    assert _near_tie(pts, cam, diff), f"pixels {diff} differ without a rounding tie"
    return len(diff)


def test_look_at_rotation_bit_equal(rng):
    eye, tgt, *_ = _cams(rng, 500)
    eye[:3] = tgt[:3] + np.array([0, -30, 0], np.float32)  # view along +y: fallback up
    eye[3:6] = tgt[3:6] + np.array([0, 30, 0], np.float32)  # and along -y
    ref = np.asarray(jax.jit(jax.vmap(jcm.look_at_rotation))(eye, tgt))
    ours = tcm.look_at_rotation(*_t(eye, tgt)).numpy()
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_allclose(tcm.look_at_rotation_np(eye[0], tgt[0]),
                               jcm.look_at_rotation_np(eye[0], tgt[0]), rtol=0, atol=0)


def test_project_points_match_jax(rng, cloud):
    pts, _ = cloud
    cams = _cams(rng, 16)
    proj = jax.jit(jax.vmap(jcm.project_points, in_axes=(None, 0, 0, 0, 0, 0)))
    ref = [np.asarray(a) for a in proj(jnp.asarray(pts), *cams)]
    ours = [a.numpy() for a in tcm.project_points(torch.from_numpy(pts), *_t(*cams))]
    for o, r in zip(ours, ref):
        assert o.shape == r.shape == (16, len(pts))
        np.testing.assert_allclose(o, r, rtol=0, atol=1e-3)
        assert np.mean(o == r) == 1.0  # bit-equal on the CPU
    # one camera, host-array parameters, as the JAX callers pass them
    e, t, f, cx, cy = (c[0] for c in cams)
    ref1 = jcm.project_points(jnp.asarray(pts), e.astype(np.float64), t, float(f), float(cx), float(cy))
    ours1 = tcm.project_points(torch.from_numpy(pts), e.astype(np.float64), t, float(f), float(cx), float(cy))
    for o, r in zip(ours1, ref1):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=1e-3)
    # camera_rays: the camera-frame coordinates (JAX: a HIGHEST matmul)
    rays = tcm.camera_rays(torch.from_numpy(pts), e, t).numpy()
    np.testing.assert_allclose(rays, np.asarray(jcm.camera_rays(jnp.asarray(pts), e, t)), atol=1e-3)


@pytest.mark.parametrize("trial", range(4))
def test_splat_labels_match_jax(rng, cloud, trial):
    pts, labels = cloud
    valid = rng.random(len(pts)) > 0.1
    cam = [c[0] for c in _cams(rng, 1)]
    ref = np.asarray(jproj.splat_labels(jnp.asarray(pts), jnp.asarray(labels), jnp.asarray(valid),
                                        *cam, H, W))
    ours = tproj.splat_labels(*_t(pts, labels, valid), *cam, H, W)
    assert ours.dtype == torch.uint8 and ours.shape == (H, W)
    assert (ref > 0).sum() > 100
    _count_ties(ours.numpy(), ref, pts, cam)


def test_splat_camera_batch_equals_single(rng, cloud):
    pts, labels = cloud
    cams = _cams(rng, 5)
    batch = tproj.splat_labels(*_t(pts, labels), None, *_t(*cams), H, W)
    assert batch.shape == (5, H, W)
    for i in range(5):
        single = tproj.splat_labels(*_t(pts, labels), None, *(c[i] for c in cams), H, W)
        assert torch.equal(batch[i], single)


def test_splat_last_write_wins_on_collisions():
    """Three points on one pixel: the last in point order wins, whatever
    the labels' order; a point off the plane lands in the dump bucket."""
    pts = np.array([[5, 5, 5], [5, 5, 5], [5, 5, 5], [500, 5, 5]], np.float32)
    cam = (np.array([5.0, 5.0, -50.0]), np.array([5.0, 5.0, 5.0]), 100.0, 8.0, 8.0)
    for labels in ([3, 9, 4, 7], [9, 4, 3, 7]):
        img = tproj.splat_labels(torch.from_numpy(pts), torch.tensor(labels, dtype=torch.uint8),
                                 None, *cam, 16, 16)
        assert int(img[8, 8]) == labels[2]
        assert int((img > 0).sum()) == 1


def test_zbuffer_and_visible_match_jax(rng, cloud):
    pts, _ = cloud
    valid = rng.random(len(pts)) > 0.1
    cam = [c[0] for c in _cams(rng, 1)]
    ref = np.asarray(jproj.zbuffer(jnp.asarray(pts), jnp.asarray(valid), *cam, H, W))
    ours = tproj.zbuffer(*_t(pts, valid), *cam, H, W).numpy()
    assert np.isinf(ref).any() and np.isfinite(ref).sum() > 100
    _count_ties(np.isfinite(ours), np.isfinite(ref), pts, cam)
    both = np.isfinite(ours) & np.isfinite(ref)
    np.testing.assert_allclose(ours[both], ref[both], rtol=1e-6)  # tests/test_projection.py's
    xs, ys, zs = _t(*(np.ascontiguousarray(pts[:, i]) for i in range(3)))
    assert torch.equal(tproj.zbuffer_soa(xs, ys, zs, torch.from_numpy(valid), *cam, H, W),
                       torch.from_numpy(ours))

    sub = pts[:800]
    ref_vis = np.asarray(jproj.project_visible(jnp.asarray(sub), jnp.ones(800, bool),
                                               jnp.asarray(ref), *cam))
    ours_vis = tproj.project_visible(torch.from_numpy(sub), None, torch.from_numpy(ref.copy()), *cam)
    assert ref_vis.sum() > 50
    _count_ties(ours_vis.numpy(), ref_vis, sub, cam)


def test_partwise_zbuffers_match_jax(rng):
    grid = np.zeros((24, 20, 28), np.uint8)
    grid[2:20, 3:17, 2:9] = 5
    grid[6:14, 4:18, 15:26] = 6
    grid[16:22, 1:8, 10:20] = 3  # a part outside part_ids: the dump row
    d0, d1, d2 = np.nonzero(grid)
    pts = np.stack([d2, d1, d0], 1).astype(np.float32)
    labels = grid[d0, d1, d2]
    ids = np.array([5, 6], np.int32)
    cam = (np.array([30.0, 25.0, -60.0], np.float32), np.array([14.0, 10.0, 12.0], np.float32),
           np.float32(90.0), np.float32(40.0), np.float32(30.0))
    ref = np.asarray(jproj.partwise_zbuffers(jnp.asarray(pts), jnp.asarray(labels),
                                             jnp.ones(len(pts), bool), *cam, jnp.asarray(ids), H, W))
    ours = tproj.partwise_zbuffers(*_t(pts, labels), None, *cam, ids, H, W).numpy()
    assert ours.shape == (2, H, W) and np.isfinite(ref).sum() > 200
    for k in range(2):
        _count_ties(np.isfinite(ours[k]), np.isfinite(ref[k]), pts, cam)
        both = np.isfinite(ours[k]) & np.isfinite(ref[k])
        np.testing.assert_allclose(ours[k][both], ref[k][both], rtol=1e-6)
    vec = np.concatenate([cam[0], cam[1], [cam[2], cam[3], cam[4]]]).astype(np.float32)
    ref_g = np.asarray(jproj.partwise_zbuffers_grid(
        jnp.asarray(grid), jnp.asarray(vec), jnp.asarray(ids), jnp.asarray([H, W], jnp.int32), H, W))
    ours_g = tproj.partwise_zbuffers_grid(torch.from_numpy(grid), torch.from_numpy(vec), ids, H, W)
    np.testing.assert_array_equal(ours_g.numpy(), ours)
    for k in range(2):
        _count_ties(np.isfinite(ours[k]), np.isfinite(ref_g[k]), pts, cam)
        both = np.isfinite(ours[k]) & np.isfinite(ref_g[k])
        np.testing.assert_allclose(ours[k][both], ref_g[k][both], rtol=1e-6)


def test_partwise_iou_and_binary_iou_exact(rng):
    a = rng.integers(0, 5, (3, 32, 32)).astype(np.uint8)
    b = rng.integers(0, 5, (32, 32)).astype(np.uint8)
    a[2][a[2] == 4] = 0  # part 4 absent from one prediction ...
    b[b == 3] = 1  # ... and part 3 from the ground truth
    ids = np.array([1, 2, 3, 4], np.int32)
    per, mean = tproj.partwise_iou(*_t(a, b), ids)
    assert per.shape == (3, 4) and mean.shape == (3,)
    for i in range(3):
        rp, rm = jproj.partwise_iou(jnp.asarray(a[i]), jnp.asarray(b), jnp.asarray(ids))
        np.testing.assert_array_equal(per[i].numpy(), np.asarray(rp))
        assert float(mean[i]) == float(rm)
    empty = np.zeros((8, 8), np.uint8)
    per0, mean0 = tproj.partwise_iou(*_t(empty, empty), ids)
    assert per0.tolist() == [0.0] * 4 and float(mean0) == 0.0

    x, y = rng.random((2, 16, 16)) > 0.5
    assert float(tproj.binary_iou(*_t(x, y))) == float(jproj.binary_iou(jnp.asarray(x), jnp.asarray(y)))
    z = torch.zeros((4, 4), dtype=torch.bool)
    assert torch.isnan(tproj.binary_iou(z, z))


def test_round_half_to_even_like_jax():
    u = np.array([-0.5, 0.5, 1.5, 2.5, 3.5, 62.5, 63.5, 79.5, 80.5], np.float32)
    v = np.full_like(u, 10.5)
    pix, ok = tproj._pixel_index(*_t(u, v), None, H, W)
    rpix, rok = jproj._pixel_index(jnp.asarray(u), jnp.asarray(v), jnp.ones(len(u), bool), H, W)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    np.testing.assert_array_equal(pix.numpy(), np.asarray(rpix))


def test_argmax_ties_pick_the_first_like_jax():
    """``jnp.argmax`` returns the first maximum; so does ``torch.argmax``,
    and the search's accept step therefore takes the first of tied
    candidates."""
    ious = np.array([0.1, 0.7, 0.3, 0.7, 0.7, 0.2], np.float32)
    assert int(torch.argmax(torch.from_numpy(ious))) == int(jnp.argmax(ious)) == 1
    # Candidates 1, 3 and 4 all move the one point onto the one ground-truth
    # pixel (IoU 1.0, a tie); the search must take candidate 1's camera.
    pts = torch.tensor([[5.0, 5.0, 5.0]])
    gt = torch.zeros((16, 16), dtype=torch.uint8)
    gt[8, 8] = 5
    x0 = np.array([5, 5, -50, 5, 5, 5, 100, 9, 8], np.float32)  # splats to (8, 9)
    u = np.zeros((1, 6, 9), np.float32)
    u[0, :, 7] = 0.5  # cx + 10: misses
    u[0, [1, 3, 4], 7] = -0.05  # cx - 1: hits
    u[0, [1, 3, 4], 8] = [0.0, 0.001, 0.002]  # cy + 0, 0.02, 0.04: still hits
    best, biou = _search_one(torch.from_numpy(x0), pts, torch.tensor([5], dtype=torch.uint8), gt, [5],
                             torch.from_numpy(u), 0, False, 8)
    steps = np.array([50, 50, 100, 50, 50, 100, 50, 20, 20], np.float64)
    expect = (x0 + u[0, 1].astype(np.float64) * steps).astype(np.float32)
    assert float(biou) == 1.0
    np.testing.assert_array_equal(best.numpy(), expect)
