"""The check that decides ``correct``, on the CPU at a size a test run holds:
a sound run of each mix passes it; the control (the plain reference computed
in bfloat16, one precision below the program's float32, in the program's
place) fails it; and each fault that a cell can have, planted in the timed
path underneath a whole run, turns ``correct`` false.  The limits are the
cells' own (``portbench/limits``).  A cell runs on one card, so the fault
of an exchange between cards is not among them.

    python -m pytest portbench/tests/test_checks.py -q -p xdist -n 4
"""

from __future__ import annotations

import json
from unittest import mock

import numpy as np
import pytest
import torch

from conftest import REPO, tiny_nb5, tiny_study

LIMITS = REPO / "portbench" / "limits"


def _limits(cell: str) -> dict:
    return json.loads((LIMITS / f"{cell}.json").read_text())


# ---- the study --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sound_study(tmp_path_factory):
    from conftest import Tree

    tree = Tree(tmp_path_factory.mktemp("study"))
    cell = tiny_study(tree)
    got = {}

    def after(run, driver):
        got["control"] = driver.control(run)
        got["units"] = run.units
        got["scenes"] = run.state["scenes"]

    line = tree.run(cell, after=after)
    return line, got


def test_a_sound_study_is_correct(sound_study):
    line, _ = sound_study
    assert line["correct"] is True, line["compared"]
    assert line["attempted"] == 1 and line["failed"] == 0
    assert 0.5 < line["metrics"]["part_iou"]["value"] <= 1.0


def test_the_reference_part_ious_are_the_deform_parameters(sound_study):
    """The notebook-4 parts' IoUs equal the program's exactly; the other
    parts' IoUs in the deform parameters are the search's estimate on the
    warped point sets, so the reference's recomputation from the rebuilt grid
    may differ there (PERF.md records by how much)."""
    from portbench.drivers import study
    from portbench.harness import study_reference as sref

    _, got = sound_study
    r = got["units"][0]["results"]["Akbar"]
    grid1, grid3 = r["grid1"], r["grid3"]
    cam = r["cams"]["final"]["front"]
    ious = sref.visible_part_ious(grid1, grid3, cam, got["scenes"]["Akbar"].nb4, device="cpu")
    nb4 = {p: v for p, v in ious.items() if p in sref.NB4_PARTS}
    assert nb4 and all(r["deform"][p]["iou"] == v for p, v in nb4.items())
    others = {p: round(abs(r["deform"][p]["iou"] - v), 4) for p, v in ious.items() if p not in sref.NB4_PARTS}
    print("non-notebook-4 parts, |deform_params iou - reference|:", others)
    assert study.monument_numbers(r, got["scenes"]["Akbar"], None, "", "cpu")["part_iou_gap"] == 0.0


def test_the_studys_control_fails_its_limits(sound_study):
    _, got = sound_study
    lim = _limits("study-256.study")
    assert any(got["control"][k] > lim[k] for k in ("splat_iou_gap", "lm_loss_gap", "part_iou_gap")), got["control"]


def _stage3_unchanged(real):
    def broken(monument, grid_labels, *a, **kw):
        deforms, grid3 = real(monument, grid_labels, *a, **kw)
        pad = grid3.shape[1] - grid_labels.shape[1]
        return deforms, np.pad(grid_labels, ((0, 0), (0, pad), (0, 0)))
    return broken


def _part_iou_altered(real):
    def broken(*a, **kw):
        deforms, grid3 = real(*a, **kw)
        p = next(q for q in ("dome", "chhatris", "main_door", "windows", "plinth") if q in deforms)
        deforms[p]["iou"] = deforms[p]["iou"] * 0.9
        return deforms, grid3
    return broken


def _half_the_points(real):
    def broken(cams, pts, labels, valid, gt, part_ids, hw=None):
        n = pts.shape[1] // 2
        return real(cams, pts[:, :n].contiguous(), labels[:, :n].contiguous(),
                    None if valid is None else valid[:, :n].contiguous(), gt, part_ids, hw)
    return broken


def _voxel_flipped(real):
    def broken(*a, **kw):
        g = real(*a, **kw).copy()
        g[tuple(np.argwhere(g > 0)[0])] = 0
        return g
    return broken


def _fit_unchanged(real):
    def broken(x0, vox, img, mask, lo, hi, loss_type="L2", max_iters=200):
        return real(x0, vox, img, mask, lo, hi, loss_type=loss_type, max_iters=0)
    return broken


STUDY_FAULTS = {
    # a step that returns its state unchanged: stage 3 gives back the padded stage-1 grid
    "stage3_state_unchanged": ("pbr3d_torch.pipeline.run_stage3_body", _stage3_unchanged),
    # ... and the keypoint fit gives back its start
    "keypoint_fit_state_unchanged": ("pbr3d_torch.camera.estimate.lm_fit_plain", _fit_unchanged),
    # half of the batch left out: the splat-IoU over half of each view's points
    "splat_iou_half_the_points": ("pbr3d_torch.camera.align.splat_iou_plain", _half_the_points),
    # an answer altered where it is produced
    "part_iou_altered": ("pbr3d_torch.pipeline.run_stage3_body", _part_iou_altered),
    "stage1_voxel_altered": ("pbr3d_torch.pipeline.carve_monument_fused", _voxel_flipped),
}


@pytest.mark.parametrize("fault", sorted(STUDY_FAULTS))
def test_a_fault_in_the_studys_timed_path_is_not_correct(fault, tree):
    import importlib

    target, make = STUDY_FAULTS[fault]
    mod_name, attr = target.rsplit(".", 1)
    mod = importlib.import_module(mod_name)
    cell = tiny_study(tree)
    with mock.patch.object(mod, attr, make(getattr(mod, attr))):
        line = tree.run(cell)
    failed = [k for k, v in line["compared"].items() if not v["ok"]]
    print(fault, "fails", failed, line["compared"])
    assert line["correct"] is False and failed


# ---- notebook 5 --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sound_nb5(tmp_path_factory):
    from conftest import Tree

    tree = Tree(tmp_path_factory.mktemp("nb5"))
    cell = tiny_nb5(tree)
    got = {}
    line = tree.run(cell, after=lambda run, driver: got.update(driver.control(run)))
    return line, got


def test_a_sound_nb5_pass_is_correct(sound_nb5):
    line, _ = sound_nb5
    assert line["correct"] is True, line["compared"]


def test_the_nb5_control_fails_its_limits(sound_nb5):
    _, control = sound_nb5
    lim = _limits("study-golden.nb5")
    assert any(control[k] > lim[k] for k in ("pair_gap", "nn_gap", "surface_gap")), control
    # the clouds' making in bfloat16 fails the numbers that it reaches
    failed = {k for k in ("sparse_rigid_gap", "cloud_points_gap", "cad_ground_gap", "cad_off_mesh")
              if control[k] > lim[k]}
    assert failed == {"sparse_rigid_gap", "cloud_points_gap", "cad_ground_gap", "cad_off_mesh"}, control


def _icp_unchanged(real):
    def broken(source, target, *a, device, **kw):
        return torch.as_tensor(source, device=device).to(torch.float64).clone(), np.eye(4)
    return broken


def _min_dist_half(real):
    def broken(A, B):
        return real(A, B[: max(1, B.shape[0] // 2)].contiguous())
    return broken


def _chamfer_altered(real):
    def broken(*a, **kw):
        return real(*a, **kw) * 1.01
    return broken


def _knn_altered(real):
    def broken(A, B, k):
        d2, idx = real(A, B, k)
        return d2 * 1.01, idx
    return broken


def _icp_one_step(real):
    def broken(source, target, max_correspondence_distance=0.05, max_iterations=30, tol=1e-7, *, device):
        return real(source, target, max_correspondence_distance, 1, tol, device=device)
    return broken


def _plane_first_triple(real):
    def broken(points, distance_threshold=0.01, num_iterations=1000, seed=0, triples=None, *, device):
        return real(points, distance_threshold, 1, seed, triples, device=device)
    return broken


def _alignment_scaled(real):
    def broken(*a, **kw):
        return real(*a, **kw) * 1.001
    return broken


def _grid_half_the_voxels(real):
    def broken(path):
        g = np.array(real(path))
        g[: g.shape[0] // 2] = 0
        return g
    return broken


def _cad_half_the_mesh(real):
    def broken(verts, faces, n, seed=0):
        return real(verts, faces[: len(faces) // 2], n, seed)
    return broken


def _cad_ground_shifted(real):
    def broken(points, reference, *, device):
        p = real(points, reference, device=device)
        p[:, 1] += 1e-3
        return p
    return broken


NB5_FAULTS = {
    "icp_state_unchanged": ("pbr3d_torch.eval.preprocess.icp_point_to_point", _icp_unchanged),
    # an ICP that stops after its first step
    "icp_one_step": ("pbr3d_torch.eval.preprocess.icp_point_to_point", _icp_one_step),
    # a plane fit that keeps its first candidate, and an alignment that is no rotation
    "plane_fit_first_triple": ("pbr3d_torch.eval.preprocess.segment_plane", _plane_first_triple),
    "alignment_not_rigid": ("pbr3d_torch.eval.preprocess.align_plane_to_z", _alignment_scaled),
    # half of the batch left out: the carved grid's voxels, the CAD mesh's triangles
    "grid_half_the_voxels": ("pbr3d_torch.eval.preprocess.load_voxel_grid_labels", _grid_half_the_voxels),
    "cad_samples_half_the_mesh": ("pbr3d_torch.eval.preprocess.sample_mesh_surface", _cad_half_the_mesh),
    "cad_ground_shifted": ("pbr3d_torch.eval.preprocess.ground_align_y", _cad_ground_shifted),
    "min_dist_half_the_points": ("pbr3d_torch.eval.inter.min_dist2", _min_dist_half),
    "chamfer_altered": ("pbr3d_torch.eval.inter.chamfer_distance", _chamfer_altered),
    "knn_distances_altered": ("pbr3d_torch.ops.neighbors.knn2", _knn_altered),
}


@pytest.mark.parametrize("fault", sorted(NB5_FAULTS))
def test_a_fault_in_the_nb5_timed_path_is_not_correct(fault, tree):
    import importlib

    target, make = NB5_FAULTS[fault]
    mod_name, attr = target.rsplit(".", 1)
    mod = importlib.import_module(mod_name)
    cell = tiny_nb5(tree)
    with mock.patch.object(mod, attr, make(getattr(mod, attr))):
        line = tree.run(cell)
    failed = [k for k, v in line["compared"].items() if not v["ok"]]
    print(fault, "fails", failed, line["compared"])
    assert line["correct"] is False and failed
