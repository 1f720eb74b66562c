"""The notebook 1-2 cell (``study-golden.stage12``, driver ``stage12``) on the
CPU at a size a test run holds: its pieces found by name; a sound pass is
correct; the control (the plain reference in bfloat16 in the program's place)
fails the limits; each fault planted in the timed path turns ``correct``
false.

    python -m pytest portbench/tests/test_stage12.py -q -p xdist -n 4
"""

from __future__ import annotations

import contextlib
import importlib
import json
from unittest import mock

import pytest

from conftest import REPO, Tree, bench_json
from test_checks import _fit_unchanged, _voxel_flipped

from portbench.harness.bench import cell_pieces

CELL = "study-golden.stage12"
LIMITS = json.loads((REPO / "portbench" / "limits" / f"{CELL}.json").read_text())
#: Akbar at 256 (the study fixture's, 123 x 128 x 128 planes) with stage 2 at
#: 4 generations of 16: a pass takes ~9 s here.
TINY = {"scenes": "256", "monuments": ["Akbar"]}
TINY_MIX = {"generations": 4, "population": 16}
#: ``camera_iou_shortfall`` of the tiny pass: its keypoint starts sit nearer
#: the planted cameras than the golden drone views' (a search that returns
#: its start reads ~0.17 there, a sound pass ~0.09), so the cell's own limit,
#: set between the golden readings, cannot tell them apart; this one can.
TINY_SHORTFALL = 0.13


def test_the_cell_reports_study_s_setup_s_and_its_five_layers_and_no_study_metric():
    _, entry, config, mix, driver, e2e, layers = cell_pieces(bench_json(), CELL)
    assert entry["name"] == config["name"] == "notebooks12-golden" and config["reduced"] == []
    assert mix["driver"] == "stage12" and (mix["generations"], mix["population"]) == (40, 64)
    assert sorted(m["name"] for m in e2e) == ["setup_s", "study_s"]
    assert sorted(m["name"] for m in layers) == ["device_idle_share.stage12", "stage12.carve_s",
                                                "stage12.search_s", "stage12.searches", "stage12.splat_calls"]


def test_the_notebook_reference_imports_nothing_of_the_program():
    import ast

    tree = ast.parse((REPO / "portbench/harness/stage12_reference.py").read_text())
    mods = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    mods |= {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    assert mods <= {"__future__", "numpy", "torch", "portbench.harness"}, mods


def tiny_stage12(tree: Tree) -> str:
    base = json.loads((REPO / "portbench/configs/notebooks12-golden.json").read_text())
    tree.write("configs/tiny-nb12.json", {**base, **TINY, "name": "tiny-nb12"})
    mix = json.loads((REPO / "portbench/traffic/stage12.json").read_text())
    tree.write("traffic/tiny-stage12.json", {**mix, **TINY_MIX})
    tree.add_cell("tiny-nb12.tiny-stage12", "tiny-nb12", "tiny-stage12", CELL, e2e=("study_s",))
    tree.write("limits/tiny-nb12.tiny-stage12.json", {**LIMITS, "camera_iou_shortfall": TINY_SHORTFALL})
    return "tiny-nb12.tiny-stage12"


@pytest.fixture(scope="module")
def sound(tmp_path_factory):
    tree = Tree(tmp_path_factory.mktemp("stage12"))
    cell = tiny_stage12(tree)
    got = {}

    def after(run, driver):
        got["control"] = driver.control(run)
        got["units"] = run.units

    return tree.run(cell, after=after), got


def test_a_sound_pass_is_correct(sound):
    line, got = sound
    assert line["correct"] is True, line["compared"]
    assert line["attempted"] == 1 and line["failed"] == 0
    assert set(line["compared"]) == {"stage1_grids_differ", "splat_iou_gap", "lm_loss_gap", "lm_loss_ratio",
                                     "camera_iou_gap", "camera_iou_shortfall"}
    assert set(got["units"][0]["results"]["Akbar"]["ious"]) == {"front", "drone"}


def test_the_control_fails_the_limits(sound):
    _, got = sound
    control = got["control"]
    assert all(control[k] > LIMITS[k] for k in ("splat_iou_gap", "lm_loss_gap", "camera_iou_gap")), control
    assert control["camera_iou_shortfall"] > TINY_SHORTFALL, control


def _search_unmoved(real):
    def broken(*a, **kw):
        return real(*a, **{**kw, "generations": 0, "cd_rounds": 0})
    return broken


def _iou_altered(real):
    def broken(*a, **kw):
        params, iou = real(*a, **kw)
        return params, iou + 0.05
    return broken


#: fault -> [(where it is planted, the maker of the broken function)]
STAGE12_FAULTS = {
    "stage1_voxel_altered": [("pbr3d_torch.pipeline.carve_monument_fused", _voxel_flipped)],
    # a fit that returns its start, on the CPU's plain fit and the card's kernel
    "keypoint_fit_state_unchanged": [("pbr3d_torch.camera.estimate.lm_fit_plain", _fit_unchanged),
                                     ("pbr3d_torch.camera.estimate.lm_fit_kernel", _fit_unchanged)],
    # a search that returns its start: the keypoint camera, or a retry's start
    "search_returns_its_start": [("pbr3d_torch.pipeline.refine_camera_mask_iou", _search_unmoved)],
    "camera_iou_altered": [("pbr3d_torch.pipeline.refine_camera_mask_iou", _iou_altered)],
}


@contextlib.contextmanager
def planted(fault: str):
    with contextlib.ExitStack() as stack:
        for target, make in STAGE12_FAULTS[fault]:
            mod_name, attr = target.rsplit(".", 1)
            mod = importlib.import_module(mod_name)
            stack.enter_context(mock.patch.object(mod, attr, make(getattr(mod, attr))))
        yield


@pytest.mark.parametrize("fault", sorted(STAGE12_FAULTS))
def test_a_fault_in_the_timed_path_is_not_correct(fault, tree):
    cell = tiny_stage12(tree)
    with planted(fault):
        line = tree.run(cell)
    failed = [k for k, v in line["compared"].items() if not v["ok"]]
    print(fault, "fails", failed, line["compared"])
    assert line["correct"] is False and failed
