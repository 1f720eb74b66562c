"""``bench_torch.py``, the port's study bench, on the CPU.

(a) The three gates of ``pbr3d_torch.eval.gates`` against ``bench.py``'s
formulas, rebuilt here from the JAX package's own pieces (``bench.py`` itself
is not imported: at import it points a persistent JAX compilation cache into
the repository), on the committed grids and cameras of ``results_temp/`` and
``results_temp_golden/``; the whole-IoU mask's shape rule against the
notebook-4 loader's resize, and the study's front planes under it.

(b) The bench on Akbar at 128 (the oracle's recovered masks and a planted
drone view, ``scripts/make_torch_port_stage2_fixture.py::akbar_128``) at the
cut knobs of ``tests/torch_run_all_cases.py``, two passes, through ``main()``:
every key, the protocol, the gates of the returned results, the last line,
no file written.  A front plane of another shape than its grid's notebook-4
mask is refused; the trace and ``main()`` without a card fail."""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import types
from pathlib import Path
from unittest import mock

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, set up by conftest)
import numpy as np
import pytest

import bench_torch
from pbr3d import config as jconfig
from pbr3d.camera.geometry import params_to_vector
from pbr3d.deform.verify import _part_zbufs_grid
from pbr3d.eval.intra import _iou_bool, compute_binary_gt, resize_mask_to_voxel_grid
from pbr3d.io.artifacts import load_camera_json, voxel_grid_iou
from pbr3d_torch import pipeline as tpipe
from pbr3d_torch.config import labels_to_rgb, rgb_to_labels
from pbr3d_torch.eval import gates
from pbr3d_torch.io.artifacts import load_voxel_grid_labels
from pbr3d_torch.io.masks import MaskSet, voxel_grid_mask_shape
from pbr3d_torch.io.masks import resize_mask_to_voxel_grid as torch_resize
from pbr3d_torch.pipeline import SceneMasks

pytest_plugins = ["torch_threads"]

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "results_temp_golden"
AT_256 = REPO / "results_temp"
STAGE1 = "1.Orthographic_Voxel_Carving"
KW = dict(max_dim=128, stage2_kw=dict(generations=4, population=16, seed=0),
          stage3_kw=dict(search_stride=8, chunk=32, scale_range=(0.9, 1.1, 3), shift_range=(-20, 20, 3),
                         refine_steps=3))
#: Fake seconds of the two passes (the bench's clock is replaced).
PASS_S = (7.25, 3.5)


# ---- (a) the gates against bench.py's formulas -------------------------------

def bench_stage1_iou(grid, gold):
    """``bench.py:77-104`` after the golden's load."""
    if max(gold.shape) >= max(grid.shape):
        factor = max(1, round(max(gold.shape) / max(grid.shape)))
        gold = gold[::factor, ::factor, ::factor]
    else:
        factor = max(1, round(max(grid.shape) / max(gold.shape)))
        grid = grid[::factor, ::factor, ::factor]
    if any(abs(a - b) > 2 for a, b in zip(gold.shape, grid.shape)):
        return None
    lo = tuple(min(a, b) for a, b in zip(gold.shape, grid.shape))
    gold = gold[: lo[0], : lo[1], : lo[2]]
    grid = np.asarray(grid)[: lo[0], : lo[1], : lo[2]]
    return voxel_grid_iou(grid, gold)


def bench_stage3_whole_iou(grid3, cam, mask, grid1):
    """``bench.py:107-136`` after the mask's load."""
    H, W = mask.shape[:2]
    present = [int(v) for v in np.unique(grid3) if 0 < v < 10]
    names = [p for p, i in jconfig.PART_IDS.items() if i in present]
    zbs = _part_zbufs_grid(grid3, cam, H, W, names)
    zb = np.minimum.reduce(list(zbs.values()))
    pr = np.isfinite(zb)[:H, :W]
    return _iou_bool(compute_binary_gt(mask, grid1), pr)


def bench_mean_part_iou(deform_params):
    """``bench.py:185-187``."""
    scored = [d["iou"] for d in deform_params.values() if d.get("gt_px", 1) > 0]
    return float(sum(scored) / max(len(scored), 1))


def _grid(root, m):
    """The port's loader: its palette lookup table decodes a 512 grid in about a
    second, the JAX package's palette loop in about twenty."""
    return load_voxel_grid_labels(root / STAGE1 / f"{m}_voxel_grid.npz")


@pytest.mark.parametrize("case", ["golden_larger", "grid_larger", "charminar_truncation", "incomparable"])
def test_stage1_gate_is_bench_formula(case):
    if case == "golden_larger":  # a 256 grid against its 512 golden
        grid, gold = _grid(AT_256, "Bibi"), _grid(GOLDEN, "Bibi")
    elif case == "grid_larger":  # Akbar's golden is at 128
        grid, gold = _grid(AT_256, "Akbar"), _grid(GOLDEN, "Akbar")
    elif case == "charminar_truncation":  # 355 strided by 2 is 178 against 177
        grid, gold = _grid(AT_256, "Charminar"), _grid(GOLDEN, "Charminar")
        assert gold[::2, ::2, ::2].shape[0] == 178 and grid.shape[0] == 177
    else:
        grid, gold = _grid(GOLDEN, "Akbar")[:100, :, :100], _grid(GOLDEN, "Akbar")
    want = bench_stage1_iou(grid, gold)
    got = gates.stage1_iou_vs_golden(grid, gold)
    if case == "incomparable":
        assert want is None and got is None
    else:
        assert want is not None and 0.9 < want < 1.0
        assert got == want


@pytest.fixture(scope="module")
def study():
    with np.load(REPO / "tests/fixtures/torch_port_study.npz") as f:
        return {k: f[k] for k in f.files if k.endswith("_front")}


def test_stage3_whole_gate_is_bench_formula(study):
    """Akbar@128: the committed stage-1 and deformed grids under the committed
    final front camera, on the study fixture's front plane."""
    grid1 = _grid(GOLDEN, "Akbar")
    grid3 = load_voxel_grid_labels(GOLDEN / "3.Part-wise_3D_Refinement/Akbar_deformed_voxel_grid.npz")
    cam = load_camera_json(GOLDEN / "2.Perspective_Camera_Estimation/Akbar_camera_params_final.json", "front")
    mask = study["golden_Akbar_front"]
    want = bench_stage3_whole_iou(grid3, cam, mask, grid1)
    got = gates.stage3_whole_iou(grid3, cam, mask, grid1, device="cpu")
    assert 0.8 < want < 1.0
    assert abs(got - want) <= 1e-6, (got, want)


@pytest.mark.parametrize("root", [GOLDEN, AT_256], ids=["golden", "256"])
def test_mean_part_gate_is_bench_formula(root):
    for m in jconfig.MONUMENTS:
        params = json.loads((root / "3.Part-wise_3D_Refinement" / f"{m}_deform_params.json").read_text())
        assert gates.mean_part_iou(params) == bench_mean_part_iou(params)
    # a part with an empty ground truth is not scored; no part scores 0
    params = {"dome": {"iou": 0.5, "gt_px": 10}, "plinth": {"iou": 0.0, "gt_px": 0}, "chhatris": {"iou": 0.75}}
    assert gates.mean_part_iou(params) == bench_mean_part_iou(params) == 0.625
    assert gates.mean_part_iou({}) == bench_mean_part_iou({}) == 0.0


@pytest.mark.parametrize("plane, grid", [((700, 1000), (256, 179, 256)), ((1000, 700), (179, 256, 179)),
                                         ((526, 526), (128, 123, 128)), ((318, 512), (256, 159, 256)),
                                         ((123, 128), (512, 318, 512)), ((123, 128), (128, 123, 128))])
def test_whole_iou_mask_resize_is_the_notebook4_loaders(plane, grid):
    """The shape rule the bench holds its front planes to, and the port's
    resize, against the JAX package's notebook-4 resize."""
    rgb = labels_to_rgb(np.random.default_rng(sum(plane)).integers(0, 12, size=plane, dtype=np.uint8))
    want = resize_mask_to_voxel_grid(rgb, grid)
    assert voxel_grid_mask_shape(plane, grid) == want.shape[:2]
    np.testing.assert_array_equal(torch_resize(rgb, grid), want)


def test_study_front_planes_have_their_grids_notebook4_shape(study):
    """So the notebook-4 resize of the front PNG that ``bench.py`` scores the
    whole IoU on is the plane itself in all ten scenes, as the smoke's is."""
    with np.load(REPO / "tests/fixtures/torch_port_study.npz") as f:
        shapes = {k[: -len("_shape")]: tuple(f[k]) for k in f.files if k.endswith("_shape")}
    assert len(shapes) == 10
    for key, shape in shapes.items():
        plane = study[f"{key}_front"]
        assert voxel_grid_mask_shape(plane.shape, shape) == plane.shape, key
        np.testing.assert_array_equal(rgb_to_labels(resize_mask_to_voxel_grid(labels_to_rgb(plane), shape)), plane,
                                      err_msg=key)


# ---- (b) the bench on the CPU ------------------------------------------------

def _script(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scenes():
    _, views = _script("make_torch_port_stage2_fixture").akbar_128()
    oracle = np.load(REPO / "tests/fixtures/oracle_Akbar_128.npz")
    planes = _script("make_torch_port_fixture").recover_labels(oracle["colored"], oracle["final"])
    return {"Akbar": SceneMasks(MaskSet.from_labels(*planes), views, views["front"])}


@pytest.fixture(scope="module")
def run(scenes, tmp_path_factory):
    """``main(["--device", "cpu"])`` on the Akbar scene at ``KW``, two passes,
    the bench's clock advanced by ``PASS_S`` per pass, from an empty working
    directory; (JSON line, stdout, stderr, what each ``run_all_body`` call got
    and returned, what the directory holds after)."""
    clock, calls = [0.0], []
    real = tpipe.run_all_body

    def recording(scenes_, **kw):
        res = real(scenes_, **kw)
        calls.append((scenes_, kw, res))
        clock[0] += PASS_S[len(calls) - 1]
        return res

    cwd = tmp_path_factory.mktemp("bench_cwd")
    out, err = io.StringIO(), io.StringIO()
    with mock.patch.object(tpipe, "run_all_body", recording), \
            mock.patch.object(bench_torch, "time", types.SimpleNamespace(perf_counter=lambda: clock[0])), \
            mock.patch.object(bench_torch, "study_scenes", lambda fxs, tag: scenes), \
            mock.patch.dict(bench_torch.CONFIGS, {"256": KW}), \
            mock.patch.dict(os.environ, {"PBR3D_BENCH_PASSES": "2"}), \
            contextlib.redirect_stdout(out), contextlib.redirect_stderr(err), contextlib.chdir(cwd):
        os.environ.pop("PBR3D_BENCH_MAX_DIM", None)
        rc = bench_torch.main(["--device", "cpu"])
    assert rc == 0
    lines = out.getvalue().splitlines()
    return types.SimpleNamespace(json=json.loads(lines[-1]), lines=lines, err=err.getvalue(), calls=calls,
                                 written=sorted(cwd.iterdir()))


def test_bench_prints_every_key(run):
    assert list(run.json) == list(bench_torch.KEYS)
    assert run.json["metric"] == "full_3stage_pipeline_1monuments_maxdim128"
    assert run.json["unit"] == "s" and run.json["passes"] == 2 and run.json["device"] == "cpu"
    # no device number from a CPU run
    assert run.json["card"] is None and run.json["peak_allocated_bytes"] is None
    assert run.json["stage1_golden_dir"] == f"results_temp_golden/{STAGE1}"
    assert run.json["masks"] == bench_torch.STUDY_MASKS


def test_bench_protocol_cold_pass_then_median(run):
    j = run.json
    assert j["cold_s"] == PASS_S[0]
    assert j["value"] == j["value_min"] == j["value_max"] == PASS_S[1]
    assert j["vs_baseline"] == round(148.5 / PASS_S[1], 3)
    assert "[bench] pass 1/2: 7.2s" in run.err and "[bench] pass 2/2: 3.5s" in run.err
    last = run.calls[-1][2]
    assert "[bench] per-monument stage timings: " + json.dumps(
        {m: {k: round(v, 3) for k, v in r.timings.items()} for m, r in last.items()}) in run.err
    assert j["stage_s"] == {k: round(last["Akbar"].timings[k], 3) for k in ("stage1", "stage2", "stage3")}
    assert j["stage1_s"] == j["stage_s"]["stage1"]


def test_bench_quality_is_the_gates_of_the_returned_results(run):
    scenes_, kw, results = run.calls[-1]
    assert len(run.calls) == 2 and kw == dict(KW, out_dir=None, device="cpu")
    r = results["Akbar"]
    s1 = gates.stage1_iou_vs_golden(r.grid_stage1, _grid(GOLDEN, "Akbar"))
    whole = gates.stage3_whole_iou(r.grid_stage3, r.cameras["final"]["front"], scenes_["Akbar"].views["front"],
                                   r.grid_stage1, device="cpu")
    part = gates.mean_part_iou(r.deform_params)
    assert run.json["quality"] == {"Akbar": {
        "stage1_iou_vs_golden": round(s1, 4), "stage3_whole_iou": round(whole, 4),
        "stage3_mean_part_iou": round(part, 4), "views": ["drone", "front"]}}
    j = run.json
    assert (j["stage1_iou_min"], j["stage3_whole_iou_min"], j["stage3_mean_part_iou_min"]) == \
        (round(s1, 4), round(whole, 4), round(part, 4))
    assert j["quality_ok"] == (s1 >= gates.STAGE1_IOU_MIN and whole >= gates.STAGE3_WHOLE_IOU_MIN
                               and part >= gates.STAGE3_MEAN_PART_IOU_MIN) is True
    # the same scene through the same stages: the passes agree
    first = run.calls[0][2]["Akbar"]
    assert first.deform_params == r.deform_params
    np.testing.assert_array_equal(params_to_vector(first.cameras["final"]["front"]),
                                  params_to_vector(r.cameras["final"]["front"]))


def test_main_prints_the_json_last(run):
    assert run.lines == [json.dumps(run.json)]


def test_bench_writes_no_file(run):
    """No artifact: ``run_all_body`` gets no ``out_dir``, and nothing appears
    where the bench ran."""
    assert all(kw["out_dir"] is None for _, kw, _ in run.calls)
    assert run.written == []


def test_a_front_plane_off_its_grids_notebook4_shape_is_refused(scenes, tmp_path):
    """The whole IoU is scored on the front plane as it is: one of another
    shape than the unpadded stage-1 grid's notebook-4 mask raises."""
    akbar = scenes["Akbar"]
    grid = _grid(GOLDEN, "Akbar")
    assert voxel_grid_mask_shape(akbar.views["front"].shape, grid.shape) == akbar.views["front"].shape
    off = {"Akbar": SceneMasks(akbar.front, dict(akbar.views, front=akbar.views["front"][:, :-3]), akbar.nb4)}
    r = types.SimpleNamespace(grid_stage1=grid, cameras={"final": {"front": None}}, timings={})
    with mock.patch.object(tpipe, "run_all_body", lambda scenes_, **kw: {"Akbar": r}), \
            pytest.raises(ValueError, match="notebook-4 shape"):
        bench_torch.bench(off, KW, 1, device="cpu", golden_dir=tmp_path)


def test_the_trace_needs_a_card(scenes):
    with pytest.raises(ValueError, match="CUDA device"):
        bench_torch.bench(scenes, KW, 1, device="cpu", golden_dir=bench_torch.GOLDEN_DIR, trace=True)


def test_a_lost_monument_fails_the_quality_gate(scenes):
    with mock.patch.object(tpipe, "run_all_body", lambda scenes_, **kw: {}):
        j = bench_torch.bench(scenes, KW, 1, device="cpu", golden_dir=bench_torch.GOLDEN_DIR)
    assert j["quality_ok"] is False and j["quality"] == {}
    assert j["stage1_iou_min"] is None and j["stage3_whole_iou_min"] is None


def test_bench_without_a_card_exits_nonzero():
    """No fallback to the CPU: no result line, a message, a non-zero code."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr
