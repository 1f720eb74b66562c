"""The notebook-4 tables of ``pbr3d_torch.eval.intra`` against
``pbr3d.eval.intra`` on Akbar's committed artifacts (``results_temp/`` and
``results_temp_golden/``).  The PNG masks are not in the repository: both
packages' mask loaders are patched, in this process, to return the planted
front plane of ``tests/fixtures/torch_port_study.npz``.  Cells compare as
printed; the third table's cells must be ``verify.nb4_exact_cells``'s."""

import json
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

import pbr3d.eval.intra as jax_intra
from pbr3d_torch.deform import verify
from pbr3d_torch.eval import intra
from pbr3d_torch.io.artifacts import load_camera_json, load_voxel_grid_labels

REPO = Path(__file__).resolve().parents[1]
RESULTS = {"256": REPO / "results_temp", "golden": REPO / "results_temp_golden"}
M = "Akbar"


def _roots(tag):
    res = RESULTS[tag]
    return dict(monuments=[M], view="front", root_voxels=str(res / "1.Orthographic_Voxel_Carving"),
                root_masks="", cam_dir=str(res / "2.Perspective_Camera_Estimation")), \
        str(res / "3.Part-wise_3D_Refinement")


@pytest.fixture(scope="module")
def planes():
    fx = np.load(REPO / "tests/fixtures/torch_port_study.npz")
    return {tag: fx[f"{tag}_{M}_front"] for tag in RESULTS}


@pytest.fixture(scope="module", params=list(RESULTS))
def case(request, planes):
    """(tag, the JAX package's frames, the port's frames, the scene)."""
    tag = request.param
    kw, deformed = _roots(tag)
    plane = planes[tag]
    with mock.patch.object(jax_intra, "_load_mask_labels_for_grid", lambda *a: plane):
        ref = {"kp": jax_intra.run_minaret_kp_evaluation(**kw),
               "iou": jax_intra.run_minaret_iou_evaluation(**kw),
               "part": jax_intra.run_part_minaret_binary_iou(deformed_voxels=deformed, **kw)}
    with mock.patch.object(intra, "load_mask_labels_for_grid", lambda *a: plane):
        ours = {"kp": intra.run_minaret_kp_evaluation(**kw, device="cpu"),
                "iou": intra.run_minaret_iou_evaluation(**kw, device="cpu"),
                "part": intra.run_part_minaret_binary_iou(deformed_voxels=deformed, **kw, device="cpu")}
    res = RESULTS[tag]
    scene = intra.Scene(
        load_voxel_grid_labels(res / "1.Orthographic_Voxel_Carving" / f"{M}_voxel_grid.npz"),
        load_voxel_grid_labels(res / "3.Part-wise_3D_Refinement" / f"{M}_deformed_voxel_grid.npz"),
        plane,
        {t: load_camera_json(res / "2.Perspective_Camera_Estimation" / f"{M}_camera_params_{t}.json", "front")
         for t in ("init", "kp", "final")})
    return tag, ref, ours, scene


@pytest.mark.parametrize("table", ["kp", "iou", "part"])
def test_table_frames_equal_jax_as_printed(case, table):
    _, ref, ours, _ = case
    assert list(ours[table].index) == list(ref[table].index)
    assert list(ours[table].columns) == list(ref[table].columns) == ["AT"]
    assert ours[table]["AT"].tolist() == ref[table]["AT"].tolist()


def test_bodies_on_in_memory_inputs_give_the_tables_cells(case):
    _, ref, _, scene = case
    cells = {"kp": intra.minaret_kp_cells({M: scene}, device="cpu"),
             "iou": intra.minaret_iou_cells({M: scene}, device="cpu"),
             "part": intra.part_minaret_binary_cells({M: scene}, device="cpu")}
    for table, frame in ref.items():
        assert {row: c[M] for row, c in cells[table].items()} == frame["AT"].to_dict()
    assert list(cells["kp"]) == list(cells["iou"]) == intra.MINARETS + ["Average"]
    assert list(cells["part"]) == intra.PARTS + ["minarets", "whole"]


def test_third_table_is_nb4_exact_cells(case):
    _, _, ours, scene = case
    exact = verify.nb4_exact_cells(scene.grid, scene.deformed, scene.mask, scene.cams["final"], device="cpu")
    for row, cell in ours["part"]["AT"].items():
        want = "→".join(f"{x:.3f}" for x in exact[row]) if row in exact else "--"
        assert cell == want, row
    assert "--" in ours["part"]["AT"].tolist()  # Akbar has no plinth in its mask


def test_cells_equal_the_eval_fixture(case):
    """The fixture the on-card smoke holds the port against was made by the
    same JAX functions over all five monuments."""
    tag, ref, _, _ = case
    fixture = json.loads((REPO / "tests/fixtures/torch_port_eval.json").read_text())["nb4"][tag]
    for table, frame in ref.items():
        assert {row: cells[M] for row, cells in fixture[table].items()} == frame["AT"].to_dict()
    assert sorted(fixture["part"]["whole"]) == sorted(intra.MONUMENT_SHORT)


def test_project_keypoints_and_constants(case):
    _, _, _, scene = case
    kps = {"a_top": np.array([3.0, 50.0, 7.0]), "b_bottom": np.array([100.5, 2.0, 64.0])}
    ours = intra.project_keypoints(kps, scene.cams["kp"], device="cpu")
    ref = jax_intra.project_keypoints(kps, scene.cams["kp"])
    for k in kps:
        np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=1e-4)  # px; a few float32 ulp
    assert intra.MINARETS == jax_intra.MINARETS and intra.MONUMENT_SHORT == jax_intra.MONUMENT_SHORT
    assert intra.BACK_TOP_ONLY == jax_intra.BACK_TOP_ONLY
