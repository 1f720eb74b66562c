"""The port's study entries (``pipeline.run_pipeline`` and ``run_all``) on two
small monuments, against its own stages and against the JAX package's
``run_all``.

Scenes, written as PNGs in the reference layout: Akbar at 128 (the oracle's
recovered front mask and a planted drone view,
``scripts/make_torch_port_stage2_fixture.py::akbar_128``) and Bibi's recovered
masks strided to 128 x 80 with a drone view planted through the committed Bibi
drone camera at a quarter of its scale.  Knobs are cut as in the verify notes:
stage 2 at generations 4 and population 16, stage 3 on a 3 x 3 lattice.  Bibi's
drone view lands under its retry floor, so the retry family runs.

Against the JAX package the port takes the JAX draws and the JAX keypoint fit
(the LM sits on a flat ridge), and the JAX package's one-hot surrogate
objective is switched off (``_MM_PLANE_MAX = 0``): then both packages take the
same decisions, and the cameras and deform dicts are identical."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pbr3d import pipeline as jpipe
from pbr3d.camera import align as jalign
from pbr3d.camera import estimate as jest
from pbr3d.camera.geometry import params_to_vector
from pbr3d_torch import pipeline as tpipe
from pbr3d_torch.carving.fused import carve_monument_fused
from pbr3d_torch.io.artifacts import load_voxel_grid_labels
from pbr3d_torch.io.masks import MaskSet
from pbr3d_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
CAMS = REPO / "results_temp_golden/2.Perspective_Camera_Estimation"
MONUMENTS = ["Akbar", "Bibi"]
KW2 = dict(generations=4, population=16, seed=0)
KW3 = dict(search_stride=8, chunk=32, scale_range=(0.9, 1.1, 3), shift_range=(-20, 20, 3),
           refine_steps=3)
DIRS = ("1.Orthographic_Voxel_Carving", "2.Perspective_Camera_Estimation",
        "3.Part-wise_3D_Refinement")


@pytest.fixture(scope="module")
def fx():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_stage2_fixture", REPO / "scripts" / "make_torch_port_stage2_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def draws(fx):
    cache = {}

    def provider(seed, generations, population):
        key = (seed, generations, population)
        if key not in cache:
            cache[key] = fx.jax_draws(*key)
        return cache[key]

    return provider


@pytest.fixture(scope="module")
def root(fx, tmp_path_factory):
    """The data root with both monuments' front and drone PNGs."""
    _, akbar = fx.akbar_128()
    bibi = np.load(REPO / "tests/fixtures/torch_port_Bibi_512.npz")
    planes = [bibi[k][::4, ::4] for k in ("binary", "exterior_labels", "semantic_labels")]
    grid = carve_monument_fused(MaskSet.from_labels(*planes), device="cpu")
    cam = json.loads((CAMS / "Bibi_camera_params_final.json").read_text())["drone"]
    cam = {k: np.asarray(v, np.float64) / 4 for k, v in cam.items() if k not in ("H", "W")}
    root = tmp_path_factory.mktemp("data")
    fx.write_mask_pngs(root, "Akbar", akbar)
    fx.write_mask_pngs(root, "Bibi", {"front": planes[2], "drone": fx.planted_view(grid, cam, 84, 123)})
    return root


@pytest.fixture(scope="module")
def jax_keypoint_fit():
    """The port's pipeline with the JAX package's keypoint fit patched in."""
    mp = pytest.MonkeyPatch()
    mp.setattr(tpipe, "optimize_camera_with_keypoints",
               lambda vk, ik, hw, init, device: jest.optimize_camera_with_keypoints(vk, ik, hw, init))
    yield
    mp.undo()


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


@pytest.fixture(scope="module")
def chained(root, draws, jax_keypoint_fit):
    """Akbar through the port's three stages, one call after the other."""
    grid = tpipe.run_stage1("Akbar", root, 128, device="cpu")
    cams = tpipe.run_stage2("Akbar", grid, root, draws=draws, device="cpu", **KW2)
    deforms, grid3 = tpipe.run_stage3("Akbar", grid, cams["final"]["front"], root, device="cpu", **KW3)
    return grid, cams, deforms, grid3


def _same_as_chained(res, chained):
    grid, cams, deforms, grid3 = chained
    np.testing.assert_array_equal(res.grid_stage1, grid)
    for tag in cams:
        for view in cams[tag]:
            np.testing.assert_array_equal(params_to_vector(res.cameras[tag][view]),
                                          params_to_vector(cams[tag][view]))
    assert res.deform_params == deforms
    np.testing.assert_array_equal(res.grid_stage3, grid3)


def test_run_pipeline_equals_chaining_the_stages(chained, root, draws, tmp_path, capsys):
    res = tpipe.run_pipeline("Akbar", root, 128, tmp_path, stage2_kw=dict(KW2, draws=draws),
                             stage3_kw=KW3, device="cpu")
    _same_as_chained(res, chained)
    assert all(res.timings[k] > 0 for k in ("stage1", "stage2", "stage3"))
    err = capsys.readouterr().err
    assert "[Akbar] stage1" in err and "grid=(128, 123, 128)" in err
    assert "[Akbar] stage2" in err and "views=['front', 'drone']" in err
    assert "[Akbar] stage3" in err and "parts=6" in err
    assert len([p for p in tmp_path.rglob("*") if p.is_file()]) == 1 + 3 + 2


def test_run_all_of_one_monument_takes_the_serial_route_with_an_injected_grid(
        chained, root, draws, monkeypatch):
    """One monument alone batches nothing; ``run_pipeline`` with a grid and
    its time injected skips stage 1 and reports the given time."""
    calls = []
    body = tpipe.run_pipeline_body
    monkeypatch.setattr(tpipe, "run_pipeline_body", lambda *a, **k: calls.append(k) or body(*a, **k))
    res = tpipe.run_all(["Akbar"], strict=True, data_root=root, max_dim=128,
                        stage2_kw=dict(KW2, draws=draws), stage3_kw=KW3, device="cpu")
    assert list(res) == ["Akbar"] and len(calls) == 1 and calls[0]["grid_stage1"] is None
    _same_as_chained(res["Akbar"], chained)
    monkeypatch.setattr(tpipe, "carve_monument_fused", None)  # stage 1 must not run
    inj = tpipe.run_pipeline("Akbar", root, 128, grid_stage1=chained[0], stage1_time=1.25,
                             stage2_kw=dict(KW2, draws=draws), stage3_kw=KW3, device="cpu")
    assert inj.timings["stage1"] == 1.25 and inj.grid_stage1 is chained[0]
    _same_as_chained(inj, chained)


def _scenes(root):
    return {m: tpipe.load_scene_masks(root, m, 128) for m in MONUMENTS}


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


TINY2 = dict(generations=1, population=8, seed=0)
TINY3 = dict(KW3, part_names=["chhatris"], exact_verify=False)


def _with_blank(root):
    scenes = _scenes(root)
    blank = {v: np.zeros_like(mask) for v, mask in scenes["Akbar"].views.items()}
    return {"Blank": tpipe.SceneMasks(scenes["Akbar"].front, blank, scenes["Akbar"].nb4),
            "Akbar": scenes["Akbar"]}


def test_a_monument_whose_views_all_fail_raises_under_strict(root):
    with pytest.raises(RuntimeError, match="Blank: no view passed camera estimation"):
        tpipe.run_all_body(_with_blank(root), strict=True, max_dim=128, stage2_kw=TINY2,
                           stage3_kw=TINY3, device="cpu")


@pytest.mark.parametrize("batch_stage2", [True, False])
def test_a_monument_whose_views_all_fail_is_skipped_without_strict(root, batch_stage2, capsys):
    res = tpipe.run_all_body(_with_blank(root), strict=False, batch_stage2=batch_stage2, max_dim=128,
                             stage2_kw=TINY2, stage3_kw=TINY3, device="cpu")
    assert list(res) == ["Akbar"] and list(res["Akbar"].deform_params) == ["chhatris"]
    err = capsys.readouterr().err
    assert "[stage2] Blank/front skipped" in err and "[stage2] Blank/drone skipped" in err
    assert "Blank: no view passed camera estimation" in err
    assert ("[run_all] Blank stage3 FAILED" if batch_stage2 else "[run_all] Blank FAILED") in err


@pytest.mark.parametrize("fault", [torch.OutOfMemoryError("CUDA out of memory"),
                                   RuntimeError("CUDA error: an illegal memory access"),
                                   ValueError("no such part")])
def test_a_device_fault_is_raised_whatever_strict_says(root, fault, monkeypatch, capsys):
    """``strict=False`` reports and skips a monument that fails, but never a
    device fault."""
    body = tpipe.run_stage3_body

    def stage3(m, *a, **k):
        if m == "Bibi":
            raise fault
        return body(m, *a, **k)

    monkeypatch.setattr(tpipe, "run_stage3_body", stage3)
    run = lambda: tpipe.run_all_body(_scenes(root), strict=False, max_dim=128, stage2_kw=TINY2,
                                     stage3_kw=TINY3, device="cpu")
    if isinstance(fault, ValueError):
        assert list(run()) == ["Akbar"]
        assert "[run_all] Bibi stage3 FAILED" in capsys.readouterr().err
    else:
        with pytest.raises(type(fault), match="CUDA"):
            run()
