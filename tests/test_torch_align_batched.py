"""The port's grouped camera search (``refine_cameras_batched``) against the
JAX package's on Akbar at 128: the recovered front view and a planted drone
view, from the JAX keypoint fits, at generations 4 and population 16, fed the
JAX draws.

The JAX package scores its grouped coarse searches with a one-hot matmul
surrogate of the splat; the port splats exactly.  So the exact comparisons
switch the surrogate off in the JAX package (``_MM_PLANE_MAX = 0``, read at
call time): then both run one trajectory, the cameras match within rtol 1e-5
and each returned IoU is the JAX objective's score of the returned camera.
One case leaves the surrogate on and bounds how far the two end apart."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from pbr3d.camera import align as jalign
from pbr3d.camera import estimate as jest
from pbr3d.camera.geometry import params_to_vector
from pbr3d.camera.keypoints import extract_minaret_kps_for_view
from pbr3d.carving.voxel import surface_points_by_parts
from pbr3d_torch.camera import align as talign

pytest_plugins = ["torch_threads"]

REPO = Path(__file__).resolve().parents[1]
PARTS = ["front_minarets", "back_minarets"]
KW = dict(generations=4, population=16, seed=0)


@pytest.fixture(scope="module")
def fx():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_stage2_fixture", REPO / "scripts" / "make_torch_port_stage2_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scene(fx):
    """(grid, views, jobs keyed (monument, view), JAX draws provider)."""
    grid, views = fx.akbar_128()
    shell = surface_points_by_parts(grid, PARTS)
    jobs = {}
    for view, mask in views.items():
        vk, ik = extract_minaret_kps_for_view(grid, mask)
        init = jest.auto_compute_initial_params_matching_bbox(grid, mask, PARTS)
        kp = jest.optimize_camera_with_keypoints(vk, ik, mask.shape[:2], init)
        jobs[("Akbar", view)] = dict(grid_labels=grid, mask_labels=mask, parts=PARTS,
                                     init_params=kp, points=shell)
    cache = {}

    def draws(seed, generations, population):
        key = (seed, generations, population)
        if key not in cache:
            cache[key] = fx.jax_draws(*key)
        return cache[key]

    return grid, views, jobs, draws


CASES = {
    "default": {},
    "triage": dict(polish=False, point_cap=16384, plane_cap=80_000),
    "cd_mags": dict(cd_mags=(1.0, 0.25, 4.0)),
    "half_plane": dict(plane_cap=8000),
    "half_plane_triage": dict(plane_cap=8000, polish=False),
    "point_stride": dict(point_cap=1024, coarse_stride=3),
    "lock_xy": dict(lock_xy_equal=True, cd_rounds=3),
}


def _compare(fx, scene, jobs, kw, monkeypatch):
    grid, views, _, draws = scene
    monkeypatch.setattr(jalign, "_MM_PLANE_MAX", 0)
    ref = jalign.refine_cameras_batched(jobs, **KW, **kw)
    ours = talign.refine_cameras_batched(jobs, **KW, **kw, draws=draws, device="cpu")
    assert list(ours) == list(ref)
    for k in ref:
        (cam, iou), (rcam, riou) = ours[k], ref[k]
        mask = views[k[1] if k[1] in views else k[0][1]]  # (monument, view) or ((m, view), start)
        assert list(cam) == list(rcam) and (cam["H"], cam["W"]) == mask.shape
        np.testing.assert_allclose(params_to_vector(cam), params_to_vector(rcam), rtol=1e-5)
        if kw.get("polish", True):  # the native objective's score of the returned camera
            assert iou == float(fx.jax_shell_ious(grid, mask, params_to_vector(cam)[None])[0])
        assert iou == pytest.approx(riou, abs=1e-6)
    return ours, ref


@pytest.mark.parametrize("case", list(CASES))
def test_grouped_search_matches_jax_with_the_surrogate_off(fx, scene, case, monkeypatch):
    jobs = scene[2]
    ours, _ = _compare(fx, scene, jobs, CASES[case], monkeypatch)
    if "half_plane" in case:  # s = 2: f, cx, cy came back in native pixels
        for k, (cam, _) in ours.items():
            assert 0.5 < cam["f"] / jobs[k]["init_params"]["f"] < 2.0


def test_per_job_step_scale_and_points_from_the_grid(fx, scene, monkeypatch):
    """A second start of the drone view at twice the step scale shares the
    drone's group (V = 2, same draws); the front job extracts its own shell."""
    jobs = dict(scene[2])
    jobs[("Akbar", "front")] = {k: v for k, v in jobs[("Akbar", "front")].items() if k != "points"}
    jobs[(("Akbar", "drone"), "dolly2")] = dict(jobs[("Akbar", "drone")], step_scale=2.0)
    ours, _ = _compare(fx, scene, jobs, {}, monkeypatch)
    a = params_to_vector(ours[("Akbar", "drone")][0])
    b = params_to_vector(ours[(("Akbar", "drone"), "dolly2")][0])
    assert not np.array_equal(a, b)


def test_results_come_in_the_jobs_order_not_the_groups(fx, scene, monkeypatch):
    """A job between two of another point bucket sits in a group of its own;
    the results (and so the views of the camera JSONs) keep the jobs' order."""
    jobs = scene[2]
    front, drone = jobs[("Akbar", "front")], jobs[("Akbar", "drone")]
    thin = tuple(a[::8] for a in front["points"])
    assert talign.bucket_size(len(thin[0][::2])) < talign.bucket_size(len(front["points"][0][::2]))
    mixed = {("Akbar", "drone"): drone, ("Akbar", "front"): dict(front, points=thin),
             (("Akbar", "drone"), "again"): dict(drone)}
    ours, _ = _compare(fx, scene, mixed, dict(polish=False), monkeypatch)
    assert list(ours) == list(mixed)


def _jax_population(bucket, views, population, budget):
    """``pbr3d/camera/align.py:343-345`` with the 2^26 written as ``budget``."""
    pop_chunk = max(1, min(population, budget // max(1, bucket * views)))
    pop_chunk = 1 << (pop_chunk.bit_length() - 1)
    return pop_chunk, max(pop_chunk, (population // pop_chunk) * pop_chunk)


@pytest.mark.parametrize("views", [1, 2, 10])
def test_population_rounding_follows_jax(scene, views, monkeypatch):
    """The grouped search asks for draws of the JAX package's rounded
    population, which depends on the group's size once the budget binds."""
    for bucket, population in ((32768, 192), (32768, 64), (131072, 256), (1024, 24), (65536, 100)):
        assert talign._pop_chunk(bucket, population, views) == \
            _jax_population(bucket, views, population, 1 << 26)
    _, _, jobs, _ = scene
    job = jobs[("Akbar", "drone")]
    bucket = talign.bucket_size(len(job["points"][0][::2]))
    monkeypatch.setattr(talign, "_POINT_BUDGET", bucket * 40)
    asked = []

    def draws(seed, generations, population):
        asked.append((seed, generations, population))
        return np.zeros((generations, population, 9), np.float32)

    many = {i: dict(job) for i in range(views)}
    out = talign.refine_cameras_batched(many, generations=1, population=24, seed=7, cd_rounds=0,
                                        draws=draws, device="cpu")
    expect = _jax_population(bucket, views, 24, bucket * 40)[1]
    assert asked == [(7, 1, expect)] and expect == {1: 16, 2: 16, 10: 24}[views]
    first = params_to_vector(out[0][0])
    assert all(np.array_equal(params_to_vector(out[i][0]), first) for i in range(views))


def test_distance_from_jax_with_its_surrogate(fx, scene, capsys):
    """With its surrogate on, the JAX package's coarse search ranks by
    another collision rule and may end at another camera; scored exactly,
    the port ends no more than 0.01 below it."""
    grid, views, jobs, draws = scene
    ref = jalign.refine_cameras_batched(jobs, **KW)
    ours = talign.refine_cameras_batched(jobs, **KW, draws=draws, device="cpu")
    for k in ref:
        exact = float(fx.jax_shell_ious(grid, views[k[1]], params_to_vector(ref[k][0])[None])[0])
        with capsys.disabled():
            print(f"\n[surrogate] {k}: port {ours[k][1]:.6f}  jax-with-surrogate {ref[k][1]:.6f} "
                  f"(re-scored exactly {exact:.6f})")
        assert ref[k][1] == pytest.approx(exact, abs=1e-6)  # its polish scores exactly
        assert ours[k][1] >= exact - 0.01
