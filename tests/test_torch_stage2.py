"""The port's stage 2 (``pipeline.run_stage2``) against the JAX package's on
Akbar at 128: the recovered front mask and a planted drone view
(``scripts/make_torch_port_stage2_fixture.py::akbar_128``), written as PNGs
in the reference layout, at generations 4 and population 16.

The port's searches take the JAX package's own draws, so given the same
keypoint fit the two runs follow one trajectory: every camera of every tag
matches within rtol 1e-5, and the JSON artifacts have the same layout.  The
keypoint fit itself lands within 1e-3 of the camera's norm of the JAX fit
(see tests/test_torch_camera.py), and from there the final search IoUs agree
within 0.01."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from pbr3d import pipeline as jpipe
from pbr3d.camera import estimate as jest
from pbr3d.camera.geometry import params_to_vector
from pbr3d_torch import pipeline as tpipe
from pbr3d_torch.camera import align as talign

REPO = Path(__file__).resolve().parents[1]
KW = dict(generations=4, population=16, seed=0)
STAGE2_DIR = "2.Perspective_Camera_Estimation"


@pytest.fixture(scope="module")
def fx():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_stage2_fixture", REPO / "scripts" / "make_torch_port_stage2_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scene(fx, tmp_path_factory):
    """(grid, views, data root, JAX output dir, JAX cameras, JAX draws)."""
    grid, views = fx.akbar_128()
    root = tmp_path_factory.mktemp("data")
    fx.write_mask_pngs(root, "Akbar", views)
    out = tmp_path_factory.mktemp("jax")
    cams = jpipe.run_stage2("Akbar", grid, root, out, **KW)
    draws = {s: fx.jax_draws(s, 4, 16) for s in (0, 1, 3)}
    return grid, views, root, out, cams, draws


def test_run_stage2_matches_jax_given_the_keypoint_fit(scene, tmp_path, monkeypatch):
    grid, views, root, jax_out, ref, draws = scene
    assert set(ref["final"]) == {"front", "drone"}
    monkeypatch.setattr(
        tpipe, "optimize_camera_with_keypoints",
        lambda vk, ik, hw, init, device: jest.optimize_camera_with_keypoints(vk, ik, hw, init))
    ours = tpipe.run_stage2("Akbar", grid, root, tmp_path, draws=draws, device="cpu", **KW)
    assert list(ours) == list(ref) == ["init", "kp", "final"]
    for tag in ref:
        assert list(ours[tag]) == list(ref[tag])
        for view in ref[tag]:
            assert list(ours[tag][view]) == list(ref[tag][view])
            np.testing.assert_allclose(params_to_vector(ours[tag][view]),
                                       params_to_vector(ref[tag][view]), rtol=1e-5)
        saved = json.loads((tmp_path / STAGE2_DIR / f"Akbar_camera_params_{tag}.json").read_text())
        saved_ref = json.loads((jax_out / STAGE2_DIR / f"Akbar_camera_params_{tag}.json").read_text())
        assert saved.keys() == saved_ref.keys()
        for view in saved_ref:
            assert saved[view].keys() == saved_ref[view].keys()
            for k in saved_ref[view]:
                np.testing.assert_allclose(saved[view][k], saved_ref[view][k], rtol=1e-5)
    assert ours["final"]["drone"]["H"] == views["drone"].shape[0]


def test_run_stage2_body_end_to_end(fx, scene):
    grid, views, _, _, ref, draws = scene
    cams, ious = tpipe.run_stage2_views("Akbar", grid, views, draws=draws, device="cpu", **KW)
    for view, mask in views.items():
        for k in ref["init"][view]:
            np.testing.assert_array_equal(cams["init"][view][k], ref["init"][view][k])
        x, rx = params_to_vector(cams["kp"][view]), params_to_vector(ref["kp"][view])
        assert np.linalg.norm(x - rx) <= 1e-3 * np.linalg.norm(rx)
        ref_iou = float(fx.jax_shell_ious(grid, mask, params_to_vector(ref["final"][view])[None])[0])
        assert abs(ious[view] - ref_iou) <= 0.01, (view, ious[view], ref_iou)
        # the returned IoU is the final camera's score on the search's objective
        assert ious[view] == float(fx.jax_shell_ious(grid, mask, params_to_vector(
            cams["final"][view])[None])[0])


def test_run_stage2_skips_views_without_minarets(scene, capsys):
    grid, views, *_ = scene
    blank = np.zeros_like(views["front"])
    cams, ious = tpipe.run_stage2_views(
        "Akbar", grid, {"front": blank}, device="cpu", generations=1, population=8)
    assert cams == {"init": {}, "kp": {}, "final": {}} and ious == {}
    assert "[stage2] Akbar/front skipped" in capsys.readouterr().err
    assert talign.mask_labels_selected(views["front"], ["front_minarets"]).max() == 5
