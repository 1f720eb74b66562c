"""The notebook route of the port, one monument at a time: ``run_stage1`` over
its in-memory body ``run_stage1_body``, ``run_stage2_views``, their traces and
the stage-2 counters, and ``run_pipeline_body``'s spans once the stage spans
moved into the bodies.

Akbar at 128 from the study fixture (``tests/fixtures/torch_port_study.npz``):
its front masks, its front view and its 526 x 526 drone view, whose plane is
over the search's half-resolution bound; stage 2 at generations 4 and
population 16.  The answers are held to the benchmark's float64 plain
reference (``portbench/harness/study_reference.py``, ``stage12_reference.py``).
"""

from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from pbr3d_torch import pipeline as tpipe
from pbr3d_torch.camera import estimate
from pbr3d_torch.carving.fused import carve_monument_fused
from pbr3d_torch.config import labels_to_rgb
from pbr3d_torch.io.artifacts import load_voxel_grid_labels
from pbr3d_torch.io.masks import MaskSet, prepare_masks
from pbr3d_torch.utils import profiling
from portbench.harness import stage12_reference as ref12
from portbench.harness import study_reference as sref

pytest_plugins = ["torch_threads"]

REPO = Path(__file__).resolve().parents[1]
KW = dict(generations=4, population=16, seed=0)


@pytest.fixture(scope="module")
def scene():
    with np.load(REPO / "tests/fixtures/torch_port_study.npz") as f:
        planes = [f[f"golden_Akbar_{k}"] for k in ("binary", "exterior", "semantic")]
        views = {v: f[f"golden_Akbar_{v}"] for v in ("front", "drone")}
        sha = str(f["golden_Akbar_sha256"])
    return MaskSet.from_labels(*planes), views, sha


@pytest.fixture(scope="module")
def recorded(scene):
    """(grid, cameras, IoUs, the keypoint fits' inputs and outputs, the spans)
    of the two notebook bodies called one after the other, recorded."""
    front, views, _ = scene
    fits = []
    real = estimate.lm_fit_plain

    def fit(*a, **kw):
        out = real(*a, **kw)
        fits.append((a, kw, out))
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(estimate, "lm_fit_plain", fit)
    try:
        with profiling.recording() as spans:
            grid = tpipe.run_stage1_body("Akbar", front, device="cpu")
            cams, ious = tpipe.run_stage2_views("Akbar", grid, views, device="cpu", **KW)
    finally:
        mp.undo()
    return grid, cams, ious, fits, list(spans)


def test_run_stage1_is_its_body_over_the_dataset_masks_and_the_body_is_the_fused_carve(scene, recorded, tmp_path):
    """Bit for bit: the entry on a PNG, the body and the fused carve on that
    PNG's masks; the body on the fixture's masks is the JAX package's carve."""
    front, _, sha = scene
    d = tmp_path / "Akbar" / "masks"
    d.mkdir(parents=True)
    cv2.imwrite(str(d / "Akbar_front_mask.png"), labels_to_rgb(front.semantic_labels)[:, :, ::-1])
    entry = tpipe.run_stage1("Akbar", tmp_path, 128, out_dir=tmp_path / "out", device="cpu")
    masks = prepare_masks(tmp_path, "Akbar", "front", 128)
    np.testing.assert_array_equal(entry, tpipe.run_stage1_body("Akbar", masks, device="cpu"))
    np.testing.assert_array_equal(entry, carve_monument_fused(masks, device="cpu"))
    saved = load_voxel_grid_labels(tmp_path / "out/1.Orthographic_Voxel_Carving/Akbar_voxel_grid.npz")
    np.testing.assert_array_equal(saved, entry)
    assert sref.grid_sha256(recorded[0]) == sha


def test_each_returned_iou_and_fit_loss_is_the_plain_references(scene, recorded):
    _, views, _ = scene
    grid, cams, ious, fits, _ = recorded
    assert set(ious) == set(cams["final"]) == {"front", "drone"}
    shell = ref12.shell(grid, device="cpu")
    for v, cam in cams["final"].items():
        # the plain splat projects in float32: a pixel whose rounding flips
        # against float64 moves the IoU by ~1/2,000 of a part's union
        assert ious[v] == pytest.approx(ref12.camera_iou(cam, shell, views[v]), abs=1e-3), v
    assert len(fits) == 2
    for (x0, vox, img, mask, lo, hi), kw, (x, loss, _) in fits:
        # float32 residuals of ~10^2 pixels, squared and summed: ~1e-5 relative
        want = sref.keypoint_loss(x, vox, img, mask, kw.get("loss_type", "L2"))
        torch.testing.assert_close(loss.double(), want, rtol=1e-3, atol=0.0)


def test_each_body_is_a_trace_of_its_monument_and_the_searches_are_counted(recorded):
    spans = recorded[-1]
    roots = [s for s in spans if s.parent is None]
    assert sorted(s.name for s in roots) == ["stage1", "stage2"]
    assert all(s.attrs == {"monument": "Akbar"} for s in roots) and len({s.trace for s in roots}) == 2
    assert {s.trace for s in spans} == {s.trace for s in roots}
    searches = [s for s in spans if s.name in ("stage2.search", "stage2.polish")]
    assert sum(s.counts.get("stage2.searches", 0) for s in spans) == len(searches) >= 4
    assert all(s.counts.get("stage2.splat_calls", 0) > 0 for s in searches)


@pytest.mark.parametrize("injected", [False, True])
def test_run_pipeline_body_keeps_its_span_names_and_nesting(scene, recorded, injected, monkeypatch):
    """One study trace: stage 1, stage 2 and the stage-3 body under it, each
    once, and stage 2's own spans under stage 2 (the front view alone; stage
    3's body stubbed, its spans are its own)."""
    front, views, _ = scene
    grid = recorded[0]
    monkeypatch.setattr(tpipe, "carve_monument_fused", lambda *a, **k: grid)
    monkeypatch.setattr(tpipe, "run_stage3_body", lambda m, g, *a, **k: ({}, g))
    with profiling.recording() as spans:
        tpipe.run_pipeline_body("Akbar", tpipe.SceneMasks(front, {"front": views["front"]}), stage2_kw=KW,
                                grid_stage1=grid if injected else None, stage1_time=1.0, device="cpu")
    by_id = {s.id: s for s in spans}
    edges = sorted({(s.name, by_id[s.parent].name if s.parent else None) for s in spans})
    assert edges == [("stage1", "study"), ("stage2", "study"), ("stage2.keypoint_lm", "stage2"),
                     ("stage2.labelling", "stage2"), ("stage2.polish", "stage2"), ("stage2.search", "stage2"),
                     ("stage3.body", "study"), ("study", None)]
    assert [s.name for s in spans].count("stage1") == [s.name for s in spans].count("stage2") == 1
    assert len({s.trace for s in spans}) == 1
