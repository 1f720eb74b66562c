"""The port's multi-scene stage 1 (``carve_monuments_batched``) against its
own per-scene carve and against the JAX package's ``carve_monuments_batched``,
voxel for voxel, on three scenes of different extents: Akbar at 128
(123 x 128, recovered from the reference oracle), Bibi's recovered masks
strided to 128 (80 x 128) and a taller-than-wide scene (a synthetic mask
transposed to 128 x 96).  Both routes (all scenes' sweeps side by side; one
scene at a time) are forced through ``mem_budget_bytes``."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import scipy.ndimage

import __graft_entry__ as ge
from pbr3d.carving import fused as jax_fused
from pbr3d_torch import config
from pbr3d_torch.carving import fused as torch_fused
from pbr3d_torch.config import PART_IDS
from pbr3d_torch.io.masks import MaskSet

pytest_plugins = ["torch_threads"]

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
PRESET = config.DEFAULT_CARVE_PRESET


def _recover_labels():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_fixture", REPO / "scripts" / "make_torch_port_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.recover_labels


@pytest.fixture(scope="module")
def scenes():
    oracle = np.load(FIXTURES / "oracle_Akbar_128.npz")
    bibi = np.load(FIXTURES / "torch_port_Bibi_512.npz")
    binary, ext = ge._synthetic_masks(96, 128)
    sem = ext.copy()
    sem[80:92, 60:68] = PART_IDS["main_door"]
    out = {
        "Akbar": MaskSet.from_labels(*_recover_labels()(oracle["colored"], oracle["final"])),
        "Bibi": MaskSet.from_labels(*(bibi[k][::4, ::4] for k in
                                      ("binary", "exterior_labels", "semantic_labels"))),
        "Tall": MaskSet.from_labels(*(np.ascontiguousarray(m.T) for m in (binary, ext, sem))),
    }
    assert [ms.binary.shape for ms in out.values()] == [(123, 128), (80, 128), (128, 96)]
    return out


@pytest.fixture(scope="module")
def per_scene(scenes):
    return {m: torch_fused.carve_monument_fused(ms, device="cpu") for m, ms in scenes.items()}


@pytest.fixture(scope="module")
def jax_batched(scenes):
    return {m: np.asarray(g) for m, g in jax_fused.carve_monuments_batched(scenes).items()}


def _budgets(scenes):
    sets = list(scenes.values())
    total = torch_fused._sweep_working_set(sets)
    largest = max(torch_fused._sweep_working_set([ms]) for ms in sets)
    assert 2 * largest < total  # so the middle budget takes two workers
    return {"stacked": total, "per_scene_two_workers": total - 1, "per_scene_one_worker": 0}


@pytest.mark.parametrize("route", ["stacked", "per_scene_two_workers", "per_scene_one_worker"])
def test_batched_equals_per_scene_and_jax(scenes, per_scene, jax_batched, route, monkeypatch):
    stacked_calls = []
    sweep = torch_fused._global_and_part_carve
    monkeypatch.setattr(torch_fused, "_global_and_part_carve",
                        lambda sets, *a: stacked_calls.append(len(sets)) or sweep(sets, *a))
    fired = []
    out = torch_fused.carve_monuments_batched(
        scenes, mem_budget_bytes=_budgets(scenes)[route],
        on_grid=lambda m, g: fired.append((m, g)), device="cpu")
    assert stacked_calls == ([3] if route == "stacked" else [1, 1, 1])
    assert list(out) == list(scenes) == [m for m, _ in fired]
    for m, g in fired:
        assert g is out[m]
    for m in scenes:
        assert out[m].dtype == np.uint8 and out[m].shape == jax_batched[m].shape
        np.testing.assert_array_equal(out[m], per_scene[m])
        np.testing.assert_array_equal(out[m], jax_batched[m])
    h, w = scenes["Tall"].binary.shape
    assert out["Tall"].shape == (w, h, w) and h > w
    for m in scenes:  # the guided carve and the recolour had work to do
        assert (out[m] == PART_IDS["dome"]).any() or (out[m] == PART_IDS["front_minarets"]).any()


def test_default_budget_on_the_cpu_is_the_stated_constant(scenes, per_scene, monkeypatch):
    seen = []
    ws = torch_fused._sweep_working_set
    monkeypatch.setattr(torch_fused, "_sweep_working_set", lambda s: seen.append(len(s)) or ws(s))
    out = torch_fused.carve_monuments_batched({"Bibi": scenes["Bibi"]}, device="cpu")
    np.testing.assert_array_equal(out["Bibi"], per_scene["Bibi"])
    assert seen == [1] and ws([scenes["Bibi"]]) < torch_fused._CPU_SWEEP_BUDGET == 4 << 30
    assert torch_fused.carve_monuments_batched({}, device="cpu") == {}


def test_working_set_counts_the_side_by_side_plane(scenes):
    sets = list(scenes.values())
    columns = 128 * 128 + 128 * 128 + 96 * 96
    assert torch_fused._sweep_working_set(sets) == 16 * 128 * columns + 32 * columns


def _sweep_grid(ms):
    group_ids = torch_fused._preset_sweeps(PRESET)[0]
    grid, = torch_fused._global_and_part_carve([ms], PRESET.global_angle_interval, group_ids, "cpu")
    return grid


@pytest.mark.parametrize("name", ["Akbar", "Bibi", "Tall"])
def test_collect_guided_jobs_gives_the_windows_of_full_grid_labelling(scenes, name):
    """Labelling each part on its occupied bbox gives the components, in the
    order and with the windows, of labelling the whole grid."""
    ms = scenes[name]
    grid = _sweep_grid(ms)
    jobs = torch_fused._collect_guided_jobs(grid, ms.exterior_labels, PRESET.part_symmetry)
    expect = []
    for part, angle in PRESET.part_symmetry:
        if not (ms.exterior_labels == PART_IDS[part]).any():
            continue
        comp, n = scipy.ndimage.label(grid.numpy() == PART_IDS[part])
        for i, sl in enumerate(scipy.ndimage.find_objects(comp), start=1):
            expect.append((tuple(s.start for s in sl), comp[sl] == i, int(angle),
                           (ms.exterior_labels == PART_IDS[part])[sl[1], sl[0]].T))
    assert len(jobs) == len(expect) > 0
    for j, (start, comp, angle, m_wh) in zip(jobs, expect):
        assert j["start"] == start and j["angle"] == angle
        np.testing.assert_array_equal(j["comp"], comp)
        np.testing.assert_array_equal(j["m_wh"], m_wh)


def test_guided_windows_in_chunks_and_across_scenes(scenes, monkeypatch):
    """The windows of two scenes applied together, in launch sets of at most
    a few windows, erase what each scene's own guided carve erases."""
    names = ["Akbar", "Tall"]
    grids = {m: _sweep_grid(scenes[m]) for m in names}
    alone = {m: torch_fused.guided_carve_all(
        grids[m].clone(), scenes[m].exterior_labels, PRESET.part_symmetry) for m in names}
    jobs = {m: torch_fused._collect_guided_jobs(
        grids[m], scenes[m].exterior_labels, PRESET.part_symmetry) for m in names}
    calls = []
    erases = torch_fused._guided_erases
    monkeypatch.setattr(torch_fused, "_guided_erases",
                        lambda js, *a: calls.append(len(js)) or erases(js, *a))
    monkeypatch.setattr(torch_fused, "_GUIDED_BATCH_ELEMS", 1 << 16)
    before = {m: grids[m].clone() for m in names}
    out = torch_fused.guided_carve_batched(grids, jobs)
    assert len(calls) > len({j["angle"] for js in jobs.values() for j in js})  # really chunked
    assert sum(calls) == sum(len(js) for js in jobs.values())
    for m in names:
        assert out[m] is grids[m]
        np.testing.assert_array_equal(out[m].numpy(), alone[m].numpy())
        assert int((before[m] != out[m]).sum()) > 0


def test_refusal_of_a_preset_with_other_group_angles_names_no_missing_route():
    preset = config.CarvePreset(group_jobs=((("full_building",), 45),))
    with pytest.raises(NotImplementedError, match="group angles differ") as err:
        torch_fused._preset_sweeps(preset)
    # the route it names exists
    assert "pbr3d_torch.carving.stage1.carve_monument" in str(err.value)
    from pbr3d_torch.carving import stage1

    assert callable(stage1.carve_monument)
