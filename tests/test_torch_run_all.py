"""The port's study entries (``pipeline.run_all``) on two small monuments
(``torch_run_all_cases``): against the JAX package's ``run_all``, against
each monument's stage 3 alone, and the batched stage 2's order of events.

Against the JAX package the port takes the JAX draws and the JAX keypoint fit
(the LM sits on a flat ridge), and the JAX package's one-hot surrogate
objective is switched off (``_MM_PLANE_MAX = 0``): then both packages take the
same decisions, and the cameras and deform dicts are identical."""

import json
from pathlib import Path

import numpy as np
import pytest

from pbr3d import pipeline as jpipe
from pbr3d.camera import align as jalign
from pbr3d.camera.geometry import params_to_vector
from pbr3d_torch import pipeline as tpipe
from pbr3d_torch.io.artifacts import load_voxel_grid_labels
from pbr3d_torch.utils import profiling

from torch_run_all_cases import (  # noqa: F401  (fixtures: fx, draws, root, jax_keypoint_fit)
    KW2, KW3, MONUMENTS, _scenes, draws, fx, jax_keypoint_fit, root,
)

pytest_plugins = ["torch_threads"]

DIRS = ("1.Orthographic_Voxel_Carving", "2.Perspective_Camera_Estimation",
        "3.Part-wise_3D_Refinement")


@pytest.fixture(scope="module")
def recorded_port_run(root, draws, jax_keypoint_fit, tmp_path_factory):
    """(results, out_dir, the spans recorded) of the port's ``run_all``."""
    out = tmp_path_factory.mktemp("torch")
    with profiling.recording() as spans:
        res = tpipe.run_all(MONUMENTS, strict=True, data_root=root, max_dim=128, out_dir=out,
                            stage2_kw=dict(KW2, draws=draws), stage3_kw=KW3, device="cpu")
    return res, out, spans


@pytest.fixture(scope="module")
def port_run(recorded_port_run):
    """(results, out_dir) of the port's ``run_all``."""
    return recorded_port_run[:2]


@pytest.fixture(scope="module")
def jax_run(root, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax")
    mp = pytest.MonkeyPatch()
    mp.setattr(jalign, "_MM_PLANE_MAX", 0)
    try:
        res = jpipe.run_all(MONUMENTS, strict=True, data_root=root, max_dim=128, out_dir=out,
                            stage2_kw=KW2, stage3_kw=KW3)
    finally:
        mp.undo()
    return res, out


def test_run_all_ends_at_the_jax_cameras_and_deforms(port_run, jax_run):
    (ours, out), (ref, ref_out) = port_run, jax_run
    assert list(ours) == list(ref) == MONUMENTS
    for m in MONUMENTS:
        a, b = ours[m], ref[m]
        assert isinstance(a, tpipe.PipelineResult) and a.monument == m
        np.testing.assert_array_equal(a.grid_stage1, b.grid_stage1)
        assert list(a.cameras) == list(b.cameras) == ["init", "kp", "final"]
        for tag in b.cameras:
            assert list(a.cameras[tag]) == list(b.cameras[tag]) == ["front", "drone"]
            for view in b.cameras[tag]:
                assert list(a.cameras[tag][view]) == list(b.cameras[tag][view])
                np.testing.assert_allclose(params_to_vector(a.cameras[tag][view]),
                                           params_to_vector(b.cameras[tag][view]), rtol=1e-5)
        assert a.deform_params == b.deform_params
        np.testing.assert_array_equal(a.grid_stage3, np.asarray(b.grid_stage3))
        assert list(a.timings) == list(b.timings) == ["stage1", "stage2", "stage3"]
    # timings: stages 1 and 2 as equal shares of the batch, stage 3 its own
    assert ours["Akbar"].timings["stage1"] == ours["Bibi"].timings["stage1"] > 0
    assert ours["Akbar"].timings["stage2"] == ours["Bibi"].timings["stage2"] > 0
    moved = [(m, p) for m in MONUMENTS for p, d in ours[m].deform_params.items()
             if d["deform"]["scale_y"] != 1.0]
    assert len(moved) >= 3, moved  # the runs had real decisions to agree on


def test_run_all_records_its_spans_under_one_trace(recorded_port_run):
    """One study, one stage 1 and one stage 2 a call; each monument waits for
    and runs its stage-3 body under the call's trace; the stage-3 downloads
    are counted; the timings still read the stages' walls."""
    res, _, spans = recorded_port_run
    named = lambda n: [s for s in spans if s.name == n]  # noqa: E731
    (study,), (stage1,), (stage2,) = named("study"), named("stage1"), named("stage2")
    assert study.parent is None and stage1.parent == stage2.parent == study.id
    assert {s.trace for s in spans} == {study.trace}
    for n in ("stage3.queued", "stage3.body", "stage2.prep"):
        assert sorted(s.attrs["monument"] for s in named(n)) == MONUMENTS, n
    by_id = {s.id: s for s in spans}
    for body in named("stage3.body"):
        assert by_id[body.parent].name in ("stage2", "study") and body.tid != study.tid
        queued = next(q for q in named("stage3.queued") if q.attrs == body.attrs)
        assert queued.parent == body.parent and queued.end_ns <= body.start_ns
    for prep in named("stage2.prep"):
        assert by_id[prep.parent].name.startswith("stage1")
    assert sum(s.counts.get("stage3.round_trips", 0) for s in spans) > 0
    # the timings: the batched carve's and stage 2's walls shared evenly, each body's own wall
    for m in MONUMENTS:
        t = res[m].timings
        assert list(t) == ["stage1", "stage2", "stage3"]
        assert t["stage1"] * len(MONUMENTS) == pytest.approx(stage1.seconds, abs=0.05)
        assert t["stage2"] * len(MONUMENTS) == pytest.approx(stage2.seconds, abs=0.05)
        body = next(b for b in named("stage3.body") if b.attrs["monument"] == m)
        assert t["stage3"] == pytest.approx(body.seconds, abs=0.05)


def test_run_all_writes_the_reference_layout(port_run, jax_run):
    (ours, out), (_, ref_out) = port_run, jax_run
    files = sorted(str(p.relative_to(out)) for p in Path(out).rglob("*") if p.is_file())
    assert files == sorted(str(p.relative_to(ref_out)) for p in Path(ref_out).rglob("*") if p.is_file())
    assert len(files) == 2 * (1 + 3 + 2) and {f.split("/")[0] for f in files} == set(DIRS)
    for m in MONUMENTS:
        np.testing.assert_array_equal(
            load_voxel_grid_labels(out / DIRS[0] / f"{m}_voxel_grid.npz"), ours[m].grid_stage1)
        np.testing.assert_array_equal(
            load_voxel_grid_labels(out / DIRS[2] / f"{m}_deformed_voxel_grid.npz"), ours[m].grid_stage3)
        for tag in ("init", "kp", "final"):
            name = f"{m}_camera_params_{tag}.json"
            saved = json.loads((out / DIRS[1] / name).read_text())
            saved_ref = json.loads((ref_out / DIRS[1] / name).read_text())
            assert saved.keys() == saved_ref.keys()
            for view in saved_ref:
                assert saved[view].keys() == saved_ref[view].keys()
                for k in saved_ref[view]:
                    np.testing.assert_allclose(saved[view][k], saved_ref[view][k], rtol=1e-5)
        name = f"{m}_deform_params.json"
        assert json.loads((out / DIRS[2] / name).read_text()) == \
            json.loads((ref_out / DIRS[2] / name).read_text())


@pytest.mark.parametrize("m", MONUMENTS)
def test_a_monument_in_the_pool_gets_the_deforms_it_gets_alone(port_run, root, m):
    """Stage 3 of each monument ran beside the other's and beside the drone
    retries; alone, under the same front camera, it decides the same."""
    res = port_run[0][m]
    deforms, grid3 = tpipe.run_stage3(m, res.grid_stage1, res.cameras["final"]["front"], root,
                                      device="cpu", **KW3)
    assert deforms == res.deform_params
    np.testing.assert_array_equal(grid3, res.grid_stage3)



def _recorded_stage2(port_run, root, draws, monkeypatch, **kw):
    """``_stage2_all_batched`` on the run's grids with every grouped search
    and every ``on_front_final`` recorded in order."""
    events = []
    search = tpipe.refine_cameras_batched

    def spy(jobs, **k):
        views = sorted({(key if isinstance(key[0], str) else key[0])[1] for key in jobs})
        events.append(("triage" if k.get("polish") is False else "search", tuple(views)))
        return search(jobs, **k)

    monkeypatch.setattr(tpipe, "refine_cameras_batched", spy)
    grids = {m: port_run[0][m].grid_stage1 for m in MONUMENTS}
    cams = tpipe._stage2_all_batched(
        MONUMENTS, grids, {m: s.views for m, s in _scenes(root).items()}, None,
        on_front_final=lambda m, p: events.append(("front_final", m, params_to_vector(p))),
        draws=draws, device="cpu", **KW2, **kw)
    return cams, events


def test_on_front_final_fires_before_the_drone_retries(port_run, root, draws, jax_keypoint_fit,
                                                       monkeypatch, capsys):
    cams, events = _recorded_stage2(port_run, root, draws, monkeypatch)
    assert "retrying [('Bibi', 'drone')]" in capsys.readouterr().err
    kinds = [e[0] for e in events]
    # main search, fine polish, both fronts final, then the drone's retry
    # family: triage, polish of the top two, re-search of the top one, polish
    assert kinds == ["search", "search", "front_final", "front_final",
                     "triage", "search", "search", "search"]
    assert [e[1] for e in events if e[0] == "front_final"] == MONUMENTS
    assert all(e[1] == ("drone",) for e in events[4:])
    for e in events[2:4]:  # fired with the camera that ends up final
        np.testing.assert_array_equal(e[2], params_to_vector(cams[e[1]]["final"]["front"]))
    for m in MONUMENTS:  # and the call gives what run_all's stage 2 gave
        for view, cam in port_run[0][m].cameras["final"].items():
            np.testing.assert_array_equal(params_to_vector(cams[m]["final"][view]),
                                          params_to_vector(cam))


def test_deep_polish_fires_the_fronts_between_its_front_and_drone_trials(
        port_run, root, draws, jax_keypoint_fit, monkeypatch):
    monkeypatch.setattr(tpipe, "DEEP_POLISH_TRIALS", ((2, 0.5, 0, (1.0, 0.25, 4.0), 2),
                                                       (0, 0.0625, 9, (1.0, 0.25, 0.0625, 16.0), 3)))
    calls = []
    search = tpipe.refine_cameras_batched
    monkeypatch.setattr(tpipe, "refine_cameras_batched",
                        lambda jobs, **k: calls.append(k) or search(jobs, **k))
    cams, events = _recorded_stage2(port_run, root, draws, monkeypatch, deep_polish=True)
    tail = [e[:2] for e in events[-6:]]
    assert tail == [("search", ("front",)), ("search", ("front",)),
                    ("front_final", "Akbar"), ("front_final", "Bibi"),
                    ("search", ("drone",)), ("search", ("drone",))]
    assert [e[0] for e in events].count("front_final") == 2  # not after the main search as well
    deep = [k for k in calls if k["population"] == 256]
    assert [(k["generations"], k["seed"], k["cd_rounds"], k["cd_mags"]) for k in deep] == 2 * [
        (2, 0, 2, (1.0, 0.25, 4.0)), (0, 9, 3, (1.0, 0.25, 0.0625, 16.0))]
    for e in events:
        if e[0] == "front_final":
            np.testing.assert_array_equal(e[2], params_to_vector(cams[e[1]]["final"]["front"]))
    for m in MONUMENTS:  # a trial is kept only where it scored higher
        assert set(cams[m]["final"]) == {"front", "drone"}
