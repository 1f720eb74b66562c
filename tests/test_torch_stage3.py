"""The port's stage 3 (``pipeline.run_stage3``) against the JAX package's on
Akbar at 128: the recovered front mask of
``scripts/make_torch_port_stage2_fixture.py::akbar_128``, written as a PNG in
the reference layout, under the committed golden front camera.

Both runs take the cut search knobs of the verify notes with the exact nb4
verify on; stage 3 draws nothing at random, so the two packages take the
same decisions: identical deform dicts, nb4 cells equal within 1e-6, and
artifacts that each package reads back from the other.  A JAX-written
``deform_params.json`` replays through the port's ``overrides``."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from pbr3d import pipeline as jpipe
from pbr3d.deform import verify as jverify
from pbr3d.io import artifacts as jart
from pbr3d_torch import pipeline as tpipe
from pbr3d_torch.deform import verify as tverify
from pbr3d_torch.io import artifacts as tart
from pbr3d_torch.io.masks import load_mask_labels_for_grid

pytest_plugins = ["torch_threads"]

REPO = Path(__file__).resolve().parents[1]
CAMS = REPO / "results_temp_golden/2.Perspective_Camera_Estimation"
STAGE3_DIR = "3.Part-wise_3D_Refinement"
KW = dict(search_stride=8, chunk=32, scale_range=(0.9, 1.1, 3), shift_range=(-20, 20, 3),
          refine_steps=3)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """(grid, front camera, data root, JAX output dir, JAX deforms, JAX grid)."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_stage2_fixture", REPO / "scripts" / "make_torch_port_stage2_fixture.py")
    fx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fx)
    grid, views = fx.akbar_128()
    cam = json.loads((CAMS / "Akbar_camera_params_final.json").read_text())["front"]
    root = tmp_path_factory.mktemp("data")
    fx.write_mask_pngs(root, "Akbar", {"front": views["front"]})
    out = tmp_path_factory.mktemp("jax")
    deforms, deformed = jpipe.run_stage3("Akbar", grid, cam, root, out, **KW)
    return grid, cam, root, out, deforms, np.asarray(deformed)


def _files(out):
    base = Path(out) / STAGE3_DIR
    return base / "Akbar_deformed_voxel_grid.npz", base / "Akbar_deform_params.json"


def test_run_stage3_matches_jax(scene, tmp_path):
    grid, cam, root, jax_out, ref, ref_grid = scene
    ours, ours_grid = tpipe.run_stage3("Akbar", grid, cam, root, tmp_path, device="cpu", **KW)
    assert ours == ref
    moved = [p for p, d in ref.items() if d["deform"] != {"scale_y": 1.0, "shift_y": 0.0,
                                                          "scale_xz": 1.0, "shift_xz": 0.0}]
    assert len(moved) >= 2, moved  # the runs have real decisions to agree on
    np.testing.assert_array_equal(ours_grid, ref_grid)

    mask_nb4 = load_mask_labels_for_grid(root, "Akbar", "front", grid.shape)
    cells = tverify.nb4_exact_cells(grid, ours_grid, mask_nb4, cam, device="cpu")
    ref_cells = jverify.nb4_exact_cells(grid, ref_grid, mask_nb4, cam)
    assert list(cells) == list(ref_cells)
    for k in ref_cells:
        np.testing.assert_allclose(cells[k], ref_cells[k], rtol=0, atol=1e-6)
        assert cells[k][1] + {"whole": 0.01, "minarets": 0.005}.get(k, 1e-6) >= cells[k][0]

    # artifacts: the same layout, and each package reads the other's
    (npz, js), (ref_npz, ref_js) = _files(tmp_path), _files(jax_out)
    np.testing.assert_array_equal(jart.load_voxel_grid_labels(npz), ref_grid)
    np.testing.assert_array_equal(tart.load_voxel_grid_labels(ref_npz), ours_grid)
    saved, saved_ref = json.loads(js.read_text()), json.loads(ref_js.read_text())
    assert saved == saved_ref
    assert all(d.keys() == {"deform", "iou", "gt_px"} for d in saved.values())


def test_jax_deform_params_replay_through_overrides(scene):
    grid, cam, root, jax_out, ref, ref_grid = scene
    _, params = _files(jax_out)
    ours, ours_grid = tpipe.run_stage3("Akbar", grid, cam, root, device="cpu",
                                       overrides=params, **KW)
    assert {p: d["deform"] for p, d in ours.items()} == {p: d["deform"] for p, d in ref.items()}
    np.testing.assert_array_equal(ours_grid, ref_grid)


def test_run_stage3_body_needs_the_nb4_mask_for_the_verify(scene):
    grid, cam, *_ = scene
    with pytest.raises(ValueError, match="mask_nb4"):
        tpipe.run_stage3_body("Akbar", grid, np.zeros((123, 128), np.uint8), None, cam,
                              device="cpu", exact_verify=True)
