"""Notebooks 1-3 for one monument through ``run_pipeline_body``, held to the
benchmark's float64 plain reference of stage 3
(``portbench/harness/stage3_reference.py``, ``study_reference.py``), and the
stage-3 counters the per-monument cell reads.

Akbar at 128 from the study fixture (``tests/fixtures/torch_port_study.npz``),
stage 2 at generations 4 and population 16, stage 3 at its defaults for a
grid of max dim <= 256 (the fast profile, the (0, 1) schedule, the exact
verify), run once for the module.
"""

import json
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from pbr3d_torch import config
from pbr3d_torch import pipeline as tpipe
from pbr3d_torch.deform import verify
from pbr3d_torch.deform.search import _deform_vec
from pbr3d_torch.deform.warp import build_deformed_grid_fused
from pbr3d_torch.io.masks import MaskSet
from pbr3d_torch.ops.point_table import build_point_table
from pbr3d_torch.utils import profiling
from portbench.drivers import pipeline as single
from portbench.harness import stage3_reference as ref3
from portbench.harness import study_reference as sref

pytest_plugins = ["torch_threads"]

REPO = Path(__file__).resolve().parents[1]
LIMITS = json.loads((REPO / "portbench/limits/study-golden.single-bibi.json").read_text())
IDENTITY = {"scale_y": 1.0, "shift_y": 0.0, "scale_xz": 1.0, "shift_xz": 0.0}


@pytest.fixture(scope="module")
def scene():
    with np.load(REPO / "tests/fixtures/torch_port_study.npz") as f:
        planes = [f[f"golden_Akbar_{k}"] for k in ("binary", "exterior", "semantic")]
        views = {v: f[f"golden_Akbar_{v}"] for v in ("front", "drone")}
    return tpipe.SceneMasks(MaskSet.from_labels(*planes), views, views["front"])


@pytest.fixture(scope="module")
def routed(scene):
    """(the pass as the benchmark's driver keeps it, the spans recorded)."""
    with profiling.recording() as spans:
        r = tpipe.run_pipeline_body("Akbar", scene, stage2_kw=dict(generations=4, population=16, seed=0),
                                    device="cpu")
    return (dict(grid1=r.grid_stage1, grid3=r.grid_stage3, deform=r.deform_params, cams=r.cameras),
            list(spans))


def _program_rebuild(padded: np.ndarray, deforms: dict, mask_hw) -> np.ndarray:
    """The program's rebuild of ``deforms``, as ``run_stage3_body`` makes it."""
    table = build_point_table(padded, device="cpu")
    order = [p for p in config.PART_NAMES if p in deforms]
    ids = {p: config.PART_IDS[p] for p in order}
    return build_deformed_grid_fused({p: table.part_window(i) for p, i in ids.items()},
                                     {p: _deform_vec(deforms[p]["deform"]) for p in order},
                                     {p: table.center(i) for p, i in ids.items()}, mask_hw, padded.shape,
                                     order).numpy()


def test_the_plain_rebuild_of_the_returned_parameters_is_the_stage3_grid(scene, routed):
    r, _ = routed
    rebuilt = ref3.rebuild(single._padded(r), r["deform"], scene.views["front"].shape)
    assert set(r["cams"]["final"]) == {"front", "drone"}
    assert np.count_nonzero(rebuilt != r["grid3"]) <= LIMITS["deformed_voxels_differ"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_plain_rebuild_is_the_programs_on_planted_deforms(scene, routed, seed):
    """Every part moved (scales and shifts whose copies fall on halves, and
    thirds), the grid padded as stage 3 pads it: the float64 rebuild is the
    program's float32 one within the cell's tie count, and the bfloat16
    control is not."""
    r, _ = routed
    padded = np.pad(r["grid1"], ((0, 0), (0, 20), (0, 0)))
    rng = np.random.default_rng(seed)
    deforms = {p: {"deform": {"scale_y": float(np.float32(rng.choice([0.8125, 0.9, 1.0, 1.15]))),
                              "shift_y": float(np.float32(rng.choice([-16.666666, 0.0, 3.25, 12.5]))),
                              "scale_xz": float(np.float32(rng.choice([0.95, 1.0, 1.1]))),
                              "shift_xz": float(np.float32(rng.choice([-4.0, 0.0, 8.25, 16.666666])))}}
               for p in sref.present_parts(padded)}
    hw = scene.views["front"].shape
    want = ref3.rebuild(padded, deforms, hw)
    assert np.count_nonzero(want != padded) > 10_000
    assert np.count_nonzero(_program_rebuild(padded, deforms, hw) != want) <= LIMITS["deformed_voxels_differ"]
    low = ref3.rebuild(padded, deforms, hw, dtype=torch.bfloat16)
    assert np.count_nonzero(low != want) > 100 * LIMITS["deformed_voxels_differ"]


def test_no_notebook4_part_regresses_from_the_stage1_grid(scene, routed):
    r, _ = routed
    got = single.stage3_numbers(r, scene, "cpu")
    assert got["margins"] and got["regressed"] == 0, got


def test_the_stage3_counters_are_recorded_under_the_study_trace(routed):
    _, spans = routed
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["study"] and {s.trace for s in spans} == {roots[0].trace}
    counts = {k: sum(s.counts.get(k, 0) for s in spans) for k in ("stage3.candidates", "stage3.chains")}
    chains = [s for s in spans if s.name == "stage3.refine_parts"]
    assert counts["stage3.chains"] == len(chains) >= 1
    assert all(s.counts.get("stage3.chains") == 1 for s in chains)
    assert counts["stage3.candidates"] > 0
    # the search's candidates are counted inside its chains
    by_id = {s.id: s for s in spans}

    def chain_of(s):
        while s is not None and s.name != "stage3.refine_parts":
            s = by_id.get(s.parent)
        return s

    assert all(chain_of(s) is not None for s in spans if s.counts.get("stage3.candidates"))


@pytest.fixture(scope="module")
def regressing(scene, routed):
    """``enforce_no_regression``'s arguments for the pass's grid with its
    largest notebook-4 part halved: a deform that lowers that part's IoU."""
    r, _ = routed
    padded = single._padded(r)
    deforms = {p: {"deform": dict(IDENTITY)} for p in sref.present_parts(padded)}
    shrunk = max((p for p in sref.NB4_PARTS if p in deforms), key=lambda p: np.count_nonzero(
        padded == sref.PART_IDS[p]))
    deforms[shrunk]["deform"] = {"scale_y": 0.5, "shift_y": 0.0, "scale_xz": 0.5, "shift_xz": 0.0}
    hw = scene.views["front"].shape

    def build_fn(vecs):
        dd = {p: {"deform": dict(zip(("scale_y", "shift_y", "scale_xz", "shift_xz"), map(float, v)))}
              for p, v in vecs.items()}
        return torch.as_tensor(_program_rebuild(padded, dd, hw))

    cam = r["cams"]["final"]["front"]
    return padded, deforms, shrunk, cam, build_fn


def test_a_reverted_part_is_counted(scene, regressing):
    padded, deforms, shrunk, cam, build_fn = regressing
    dd = json.loads(json.dumps(deforms))
    with profiling.recording() as spans:
        with profiling.span("stage3.exact_verify"):
            out, _ = verify.enforce_no_regression(padded, dd, scene.nb4, cam, build_fn, device="cpu")
    assert out[shrunk]["deform"] == IDENTITY
    assert sum(s.counts.get("stage3.reverts", 0) for s in spans) == 1


def test_nothing_is_recorded_with_recording_off(scene, regressing):
    """Off, a counter is one global read: no span is made, and the same
    revert goes through."""
    padded, deforms, shrunk, cam, build_fn = regressing
    dd = json.loads(json.dumps(deforms))
    assert profiling._rec is None
    with mock.patch.object(profiling, "Span", side_effect=AssertionError("a span was made")):
        out, _ = verify.enforce_no_regression(padded, dd, scene.nb4, cam, build_fn, device="cpu")
        profiling.count("stage3.candidates", 5)
    assert out[shrunk]["deform"] == IDENTITY
    assert profiling._rec is None
