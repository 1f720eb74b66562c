"""The per-monument cell (``study-golden.single-bibi``, driver ``pipeline``) on
the CPU at a size a test run holds: its pieces found by name; the stage-3
reference imports nothing of the program; a sound pass is correct; the
control (the plain reference in bfloat16 in the program's place) fails the
limits; each fault planted in the timed path turns ``correct`` false.

    python -m pytest portbench/tests/test_single.py -q -p xdist -n 4
"""

from __future__ import annotations

import contextlib
import importlib
import json
from unittest import mock

import numpy as np
import pytest
import torch

from conftest import REPO, Tree, bench_json
from test_checks import _stage3_unchanged

from portbench.harness.bench import cell_pieces

CELL = "study-golden.single-bibi"
LIMITS = json.loads((REPO / "portbench" / "limits" / f"{CELL}.json").read_text())
#: Akbar at 256 (the study fixture's 247 x 256 front planes and its planted
#: views), stage 2 at 4 generations of 16 and stage 3 at the cut knobs of the
#: tiny study, where it moves parts: a pass takes ~20 s here.
TINY_CONFIG = {"scenes": "256", "front_mask": None,
               "run_pipeline": {"stage2_kw": {"generations": 4, "population": 16},
                                "stage3_kw": {"search_stride": 8, "chunk": 32, "scale_range": [0.9, 1.1, 3],
                                              "shift_range": [-20, 20, 3], "refine_steps": 3}}}
TINY_MIX = {"monument": "Akbar"}


def test_the_cell_reports_study_s_part_iou_setup_s_and_its_layers():
    _, entry, config, mix, driver, e2e, layers = cell_pieces(bench_json(), CELL)
    assert entry["name"] == config["name"] == "pipeline-golden-bibi" and config["reduced"] == []
    assert config["run_pipeline"] == {"stage2_kw": {}, "stage3_kw": {}}
    assert (mix["driver"], mix["monument"], mix["passes_per_unit"]) == ("pipeline", "Bibi", 2)
    assert all(hasattr(driver, f) for f in ("setup", "unit", "install_probes", "check", "control"))
    assert sorted(m["name"] for m in e2e) == ["part_iou", "setup_s", "study_s"]
    assert sorted(m["name"] for m in layers) == [
        "device_idle_share.study", "single.candidates", "single.chains", "single.search_s", "single.verify_s",
        "splat_iou.roofline", "stage1_s", "stage2_s", "stage3.round_trips", "stage3_body_s"]


def test_the_cell_feeds_the_dataset_front_mask_to_stages_2_and_3_and_notebook_4():
    from types import SimpleNamespace

    from portbench.drivers import study

    _, _, config, mix, driver, _, _ = cell_pieces(bench_json(), CELL)
    run = SimpleNamespace(config=config, mix=mix, seed=2**31 + 5, state={})
    driver.setup(run)
    scene = run.state["scene"]
    with np.load(REPO / config["front_mask"]["file"]) as fx:
        dataset = fx[config["front_mask"]["key"]]
    with np.load(REPO / "tests/fixtures/torch_port_Bibi_512_stage2.npz") as fx:
        assert np.array_equal(fx["front_mask"], dataset)  # the mask of the JAX stage-2 and stage-3 fixtures
    with np.load(REPO / "tests/fixtures/torch_port_Bibi_512.npz") as fx:
        assert np.array_equal(fx["semantic_labels"], dataset)  # the label plane of the stage-1 fixture
    with np.load(study.STUDY) as fxs:
        planted = {v: fxs[f"golden_Bibi_{v}"] for v in ("front", "drone")}
    assert scene.nb4 is scene.views["front"] and np.array_equal(scene.views["front"], dataset)
    assert not np.array_equal(dataset, planted["front"]) and np.array_equal(scene.views["drone"], planted["drone"])
    assert run.state["kw"]["stage2_kw"]["seed"] == 2**31 + 5 and run.state["expected_sha"]


def test_the_stage3_reference_imports_nothing_of_the_program():
    import ast

    tree = ast.parse((REPO / "portbench/harness/stage3_reference.py").read_text())
    mods = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    mods |= {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    assert mods <= {"__future__", "numpy", "torch", "scipy", "portbench.harness.study_reference"}, mods


def tiny_single(tree: Tree) -> str:
    base = json.loads((REPO / "portbench/configs/pipeline-golden-bibi.json").read_text())
    tree.write("configs/tiny-single.json", {**base, **TINY_CONFIG, "name": "tiny-single"})
    mix = json.loads((REPO / "portbench/traffic/single-bibi.json").read_text())
    tree.write("traffic/tiny-single-akbar.json", {**mix, **TINY_MIX})
    tree.add_cell("tiny-single.akbar", "tiny-single", "tiny-single-akbar", CELL, e2e=("study_s", "part_iou"))
    return "tiny-single.akbar"


@pytest.fixture(scope="module")
def sound(tmp_path_factory):
    tree = Tree(tmp_path_factory.mktemp("single"))
    cell = tiny_single(tree)
    got = {}

    def after(run, driver):
        got["control"] = driver.control(run)
        got["units"] = run.units

    return tree.run(cell, after=after), got


def test_a_sound_pass_is_correct(sound):
    line, got = sound
    assert line["correct"] is True, line["compared"]
    passes = json.loads((REPO / "portbench/traffic/single-bibi.json").read_text())["passes_per_unit"]
    assert line["attempted"] == passes and line["failed"] == 0
    assert set(line["compared"]) == {"stage1_grids_differ", "splat_iou_gap", "lm_loss_gap", "lm_loss_ratio",
                                     "part_iou_gap", "deformed_voxels_differ", "nb4_parts_regressed",
                                     "stage3_units_unchanged"}
    assert 0.5 < line["metrics"]["part_iou"]["value"] <= 1.0
    results = got["units"][0]["results"]
    assert list(results) == ["Akbar"] + [f"Akbar#{i}" for i in range(2, passes + 1)]
    assert all(set(r["cams"]["final"]) == {"front", "drone"} for r in results.values())


def test_the_control_fails_the_limits(sound):
    _, got = sound
    control = got["control"]
    assert control["deformed_voxels_differ"] > LIMITS["deformed_voxels_differ"], control
    assert any(control[k] > LIMITS[k] for k in ("splat_iou_gap", "lm_loss_gap", "part_iou_gap")), control


def _warp_off_by_one(real):
    """The rebuild warps the first part of its order one voxel off along x."""
    def broken(part_points, deforms, centers, image_hw, voxel_shape, part_order):
        p = next(q for q in part_order if q in deforms)
        pts = dict(part_points)
        pts[p] = pts[p] + torch.tensor([1, 0, 0], dtype=pts[p].dtype, device=pts[p].device)
        return real(pts, deforms, centers, image_hw, voxel_shape, part_order)
    return broken


def _nb4_part_shrunk(real):
    """Stage 3 halves a notebook-4 part (the dome where there is one) and
    returns the program's own rebuild of that answer."""
    def broken(monument, grid_labels, mask, *a, device, **kw):
        from pbr3d_torch import config
        from pbr3d_torch.deform.search import _deform_vec
        from pbr3d_torch.deform.warp import build_deformed_grid_fused
        from pbr3d_torch.ops.point_table import build_point_table

        deforms, grid3 = real(monument, grid_labels, mask, *a, device=device, **kw)
        p = next(q for q in ("dome", "main_door", "chhatris", "windows", "plinth") if q in deforms)
        deforms[p]["deform"] = {"scale_y": 0.5, "shift_y": 0.0, "scale_xz": 0.5, "shift_xz": 0.0}
        pad = grid3.shape[1] - grid_labels.shape[1]
        table = build_point_table(np.pad(grid_labels, ((0, 0), (0, pad), (0, 0))), device=device)
        order = [q for q in config.PART_NAMES if q in deforms]
        ids = {q: config.PART_IDS[q] for q in order}
        grid = build_deformed_grid_fused({q: table.part_window(i) for q, i in ids.items()},
                                         {q: _deform_vec(deforms[q]["deform"]) for q in order},
                                         {q: table.center(i) for q, i in ids.items()}, mask.shape[:2],
                                         grid3.shape, order)
        return deforms, grid.cpu().numpy()
    return broken


#: fault -> (where it is planted, the maker of the broken function).
SINGLE_FAULTS = {
    "warp_off_by_one": ("pbr3d_torch.pipeline.build_deformed_grid_fused", _warp_off_by_one),
    "stage3_returns_its_input": ("pbr3d_torch.pipeline.run_stage3_body", _stage3_unchanged),
    "nb4_part_regressed": ("pbr3d_torch.pipeline.run_stage3_body", _nb4_part_shrunk),
}
#: the number each fault must fail
FAULT_NUMBER = {"warp_off_by_one": "deformed_voxels_differ", "stage3_returns_its_input": "stage3_units_unchanged",
                "nb4_part_regressed": "nb4_parts_regressed"}


@contextlib.contextmanager
def planted(fault: str):
    target, make = SINGLE_FAULTS[fault]
    mod_name, attr = target.rsplit(".", 1)
    mod = importlib.import_module(mod_name)
    with mock.patch.object(mod, attr, make(getattr(mod, attr))):
        yield


@pytest.mark.parametrize("fault", sorted(SINGLE_FAULTS))
def test_a_fault_in_the_timed_path_is_not_correct(fault, tree):
    cell = tiny_single(tree)
    with planted(fault):
        line = tree.run(cell)
    failed = [k for k, v in line["compared"].items() if not v["ok"]]
    print(fault, "fails", failed, line["compared"])
    assert line["correct"] is False and FAULT_NUMBER[fault] in failed
