"""The harness on the CPU: every piece found by name, a new mix, driver and
metric picked up as files, the result line's keys, the roofline arithmetic,
the copies against their originals, and what the benchmark imports.

    python -m pytest portbench/tests -q -p xdist -n 4
"""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import REPO, bench_json

from portbench.harness import roofline
from portbench.harness import study_reference as sref
from portbench.harness.bench import cell_pieces, load_module

PB = REPO / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


# ---- the contract's shape -------------------------------------------------------------

def test_benchmark_json_has_the_contracts_keys_and_names():
    b = bench_json()
    assert list(b) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"]
    assert b["paths"] == ["portbench"] and b["command"] == ["python3", "portbench/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in b[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["file"].startswith("portbench/")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["moves"] in {e["name"] for e in b["end_to_end"]}
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in bench_json()["workloads"]])
def test_every_piece_of_a_cell_is_found_by_name(cell):
    b = bench_json()
    _, entry, config, mix, driver, e2e, layers = cell_pieces(b, cell)
    assert config["name"] == entry["name"] and config["reduced"] == entry["reduced"]
    for fn in ("setup", "unit", "install_probes", "check", "control"):
        assert callable(getattr(driver, fn))
    assert json.loads((PB / "limits" / f"{cell}.json").read_text())
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layers
    for m in e2e + layers:
        assert callable(load_module(PB / "metrics" / f"{m['name']}.py").read)
    # each per-layer metric moves an end-to-end metric that its cells report
    for m in layers:
        assert m["moves"] in {e["name"] for e in e2e}


# ---- data-driven: a new mix, driver and metric are files ----------------------------

DUMMY_DRIVER = '''
from portbench.harness.bench import Number, Verdict

def setup(run):
    run.state["n"] = 0

def unit(run):
    run.state["n"] += 1
    return {"n": run.state["n"], "size": run.mix["size"]}

def install_probes(run):
    return []

def check(run):
    return Verdict(len(run.units), 0, [Number("size_gap", 0.0, run.limits["size_gap"])])

def control(run):
    return {"size_gap": 1.0}
'''


def test_a_new_config_mix_driver_and_metric_are_picked_up_without_an_edit(tree):
    tree.write("drivers/dummy.py", DUMMY_DRIVER)
    tree.write("traffic/dummy-mix.json", {"driver": "dummy", "size": 3})
    tree.write("configs/dummy-config.json", {"name": "dummy-config", "reduced": []})
    tree.write("metrics/dummy_units.py", "def read(run):\n    return float(sum(u['size'] for u in run.units))\n")
    tree.write("limits/dummy-config.dummy-mix.json", {"size_gap": 0.5})
    tree.bench["configs"].append({"name": "dummy-config", "source": "https://example.org/d",
                                  "file": "portbench/configs/dummy-config.json", "reduced": [], "why": "test"})
    tree.bench["workloads"].append({"name": "dummy-config.dummy-mix", "config": "dummy-config",
                                    "traffic": "dummy-mix", "chips": 1, "why": "test"})
    tree.bench["end_to_end"].append({"name": "dummy_units", "unit": "units", "better": "higher", "bound": 0.1,
                                     "source": "host_clock", "workloads": ["dummy-config.dummy-mix"]})
    before = {p: p.read_bytes() for p in PB.rglob("*") if p.is_file() and "__pycache__" not in p.parts}
    line = tree.run("dummy-config.dummy-mix")
    assert line["correct"] is True and line["attempted"] >= 1
    assert set(line["metrics"]) == {"dummy_units", "setup_s"}
    assert line["metrics"]["dummy_units"]["value"] == 3.0 * line["attempted"]
    # the repository's own files were not touched
    assert before == {p: p.read_bytes() for p in PB.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_the_result_line_has_the_five_keys_then_the_numbers_compared(tree):
    tree.write("drivers/dummy.py", DUMMY_DRIVER)
    tree.write("traffic/dummy-mix.json", {"driver": "dummy", "size": 1})
    tree.write("limits/study-256.dummy-mix.json", {"size_gap": 0.5})
    tree.bench["workloads"].append({"name": "study-256.dummy-mix", "config": "study-256", "traffic": "dummy-mix",
                                    "chips": 1, "why": "test"})
    line = tree.run("study-256.dummy-mix")
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["compared"] == {"size_gap": {"value": 0.0, "limit": 0.5, "ok": True}}
    assert json.loads(json.dumps(line)) == line


def test_without_a_card_the_run_exits_nonzero_and_prints_no_result(tmp_path):
    proc = subprocess.run([sys.executable, str(PB / "run.py"), "--workload", "study-256.study", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=REPO,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_with_only_the_benchmark_files_the_run_exits_nonzero_and_prints_no_result(tmp_path):
    import shutil

    shutil.copytree(PB, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copyfile(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "study-256.study", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


# ---- the roofline arithmetic -------------------------------------------------------------

def test_neighbour_rooflines_are_eight_flops_a_pair_or_the_bytes():
    # 20k x 20k: 8 * 4e8 flops at 67e12 a second; the bytes (560 kB) are far less
    assert roofline.min_dist2_least_s(20000, 20000) == pytest.approx(8 * 20000 * 20000 / 67e12, rel=1e-12)
    # 185,750 x 1,450,802 at k = 1
    assert roofline.knn_least_s(185750, 1450802, 1) == pytest.approx(8 * 185750 * 1450802 / 67e12, rel=1e-12)
    # a shape where the bytes bound it: 1,000,000 queries against 1 point, k = 20
    n = 1_000_000
    assert roofline.knn_least_s(n, 1, 20) == pytest.approx((12 * n + 12 + 12 * n * 20) / 3.35e12, rel=1e-12)
    assert roofline.min_dist2_least_s(n, 1) == pytest.approx((12 * n + 12 + 4 * n) / 3.35e12, rel=1e-12)


def test_splat_iou_roofline_is_chip_smokes_bound_without_the_plane():
    # 64 cameras at Bibi's 318 x 512 front plane, 96,620 shell points, two parts
    V, P, nv, N, H, W, K = 1, 64, 96620, 96620, 318, 512, 2
    flops = P * (nv * 30 + V * H * W * (4 * K + 2))
    nbytes = V * P * 36 + V * N * 13 + V * H * W + 4 * V * P
    assert roofline.splat_iou_least_s(V, P, nv, N, H, W, K, False) == pytest.approx(
        max(flops / 67e12, nbytes / 3.35e12), rel=1e-12)
    # PERF.md's 0.0043 ms for that call
    assert roofline.splat_iou_least_s(V, P, nv, N, H, W, K, False) * 1e3 == pytest.approx(0.0043, abs=5e-5)


def test_a_rooflines_time_is_its_kernels_device_time_by_name():
    from portbench.harness import device

    names = {
        "void (anonymous namespace)::knn1_scan_kernel<8>(float const*, long, float4 const*, long, long, "
        "unsigned long long*)": "(anonymous namespace)::knn1_scan_kernel",
        "(anonymous namespace)::min_dist2_kernel(float const*, long, float4 const*, long, long, int*)":
            "(anonymous namespace)::min_dist2_kernel",
        "Memcpy HtoD (Pageable -> Device)": "Memcpy",
    }
    assert {n: device.kernel_base(n) for n in names} == names
    ts = device.TraceSummary(window_s=1.0, busy_s=0.5, device_ops=[], idle_gaps=[], records=3, first_s=0.0,
                             last_s=0.0, kernel_s={"(anonymous namespace)::min_dist2_kernel": 2e-3,
                                                   "(anonymous namespace)::pack_kernel": 1e-3, "Memcpy": 5.0})
    kernels = ("(anonymous namespace)::pack_kernel", "(anonymous namespace)::min_dist2_kernel")
    assert roofline.share_pct(1.5e-3, ts, kernels) == pytest.approx(50.0, rel=1e-12)
    # nothing to read: no trace, no call counted, or none of the kernels in the trace
    assert roofline.share_pct(1.5e-3, None, kernels) is None
    assert roofline.share_pct(0.0, ts, kernels) is None
    assert roofline.share_pct(1.5e-3, ts, ("(anonymous namespace)::splat_kernel",)) is None


# ---- the copies against their originals -----------------------------------------------

def original(path: Path, name: str, namespace: dict):
    """The function ``name`` of the file ``path``, compiled alone from its
    source (the file itself is not imported)."""
    tree = ast.parse(path.read_text())
    node = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)
    src = textwrap.dedent(ast.get_source_segment(path.read_text(), node))
    ns = dict(namespace)
    exec(compile("from __future__ import annotations\n" + src, str(path), "exec"), ns)
    return ns[name]


#: The benchmark's data (its yardstick's inputs, frozen under ``paths``) and
#: the repository's files they were copied from.
DATA_ORIGINALS = {
    "torch_port_study.npz": "tests/fixtures/torch_port_study.npz",
    "taj/Taj_deformed_voxel_grid.npz": "results_temp_golden/3.Part-wise_3D_Refinement/Taj_deformed_voxel_grid.npz",
    **{f"stage1_golden/{m}_voxel_grid.npz": f"results_temp_golden/1.Orthographic_Voxel_Carving/{m}_voxel_grid.npz"
       for m in ("Akbar", "Bibi", "Charminar", "Itimad", "Taj")},
}


@pytest.mark.parametrize("copy", sorted(DATA_ORIGINALS))
def test_the_benchmarks_data_are_the_repositorys_files(copy):
    """A change to an original shows here: the benchmark keeps its copy."""
    assert (PB / "data" / copy).read_bytes() == (REPO / DATA_ORIGINALS[copy]).read_bytes()


def test_the_benchmarks_data_are_only_those_copies():
    assert sorted(p.relative_to(PB / "data").as_posix() for p in (PB / "data").rglob("*") if p.is_file()) \
        == sorted(DATA_ORIGINALS)


def test_the_study_scenes_are_bench_torchs():
    from pbr3d_torch import config
    from pbr3d_torch.io.masks import MaskSet
    from pbr3d_torch.pipeline import SceneMasks

    from portbench.drivers import study

    theirs = original(REPO / "bench_torch.py", "study_scenes",
                      {"config": config, "SceneMasks": SceneMasks, "MaskSet": MaskSet})
    with np.load(REPO / "tests/fixtures/torch_port_study.npz") as a, np.load(PB / "data/torch_port_study.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for tag in ("256", "golden"):
            x, y = theirs(a, tag), study.study_scenes(b, tag, config.MONUMENTS)
            for m in config.MONUMENTS:
                for attr in ("binary", "exterior", "semantic"):
                    np.testing.assert_array_equal(getattr(x[m].front, attr), getattr(y[m].front, attr))
                for v in ("front", "drone"):
                    np.testing.assert_array_equal(x[m].views[v], y[m].views[v])
                np.testing.assert_array_equal(x[m].nb4, y[m].nb4)


def test_the_nb5_stand_ins_are_chip_smokes():
    from pbr3d_torch.eval import inter, preprocess

    from portbench.drivers import nb5

    mix = json.loads((PB / "traffic/nb5.json").read_text())
    NB5 = dict(seed=0, sparse_points=mix["sparse_points"], noise=mix["noise"])
    theirs = original(REPO / "chip_smoke.py", "nb5_sparse_cloud", {"np": np, "NB5": NB5, "preprocess": preprocess})
    shell = np.random.default_rng(3).normal(size=(300_000, 3)).astype(np.float32)
    np.testing.assert_array_equal(theirs(shell), nb5.sparse_cloud(shell, mix["sparse_points"], mix["noise"], 0))
    verts = torch.rand(500, 3, dtype=torch.float64)
    faces = torch.randint(0, 500, (900, 3))
    their_cf = original(REPO / "chip_smoke.py", "compact_faces", {"torch": torch, "inter": inter})
    for a, b in zip(their_cf(verts, faces, 0.6), nb5.compact_faces(inter, verts, faces, 0.6)):
        assert torch.equal(a, b)
    their_obj = original(REPO / "chip_smoke.py", "write_obj", {"np": np})
    with tempfile.TemporaryDirectory() as tmp:
        their_obj(Path(tmp) / "a.obj", verts.numpy(), faces.numpy())
        nb5.write_obj(Path(tmp) / "b.obj", verts.numpy(), faces.numpy())
        assert (Path(tmp) / "a.obj").read_bytes() == (Path(tmp) / "b.obj").read_bytes()


def test_the_nb5_constants_are_chip_smokes():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    node = next(n for n in tree.body if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "NB5")
    theirs = {k.arg: ast.literal_eval(k.value) for k in node.value.keywords}
    mix = json.loads((PB / "traffic/nb5.json").read_text())
    for k in ("sparse_points", "noise", "mesh_stride", "cad_samples", "tau", "grid_size", "k", "y_thresh"):
        assert mix[k] == theirs[k], k
    assert mix["clouds_seed"] == theirs["seed"]


def _random_grid(rng, shape, labels=(1, 2, 3, 4, 9)):
    g = np.zeros(shape, np.uint8)
    occ = rng.random(shape) < 0.3
    g[occ] = rng.choice(labels, size=int(occ.sum()))
    return g


@pytest.mark.parametrize("shapes", [((40, 30, 40), (40, 30, 40)), ((20, 15, 20), (40, 30, 40)),
                                    ((40, 31, 40), (20, 15, 20)), ((40, 30, 40), (20, 10, 20))])
def test_the_stage1_gate_is_the_programs(shapes):
    from pbr3d_torch.eval import gates

    rng = np.random.default_rng(5)
    grid, gold = _random_grid(rng, shapes[0]), _random_grid(rng, shapes[1])
    assert sref.stage1_iou(grid, gold > 0) == gates.stage1_iou_vs_golden(grid, gold)


def test_the_whole_gate_and_the_visible_part_ious_are_the_programs():
    from pbr3d_torch.deform import verify
    from pbr3d_torch.eval import gates

    rng = np.random.default_rng(6)
    grid1 = _random_grid(rng, (48, 40, 48))
    grid3 = _random_grid(rng, (48, 40, 48))
    mask = rng.choice(np.array([0, 1, 2, 3, 4, 9, 10], np.uint8), size=(40, 48))
    cam = {"cam_pos": [24.5, 20.25, -90.0], "target": [24.0, 19.5, 24.0], "f": 60.0, "cx": 24.0, "cy": 20.0}
    assert sref.whole_iou(grid3, cam, mask, grid1, device="cpu") == pytest.approx(
        gates.stage3_whole_iou(grid3, cam, mask, grid1, device="cpu"), abs=1e-12)
    cells = verify.nb4_exact_cells(grid1, grid3, mask, cam, device="cpu")
    mine = sref.visible_part_ious(grid1, grid3, cam, mask, device="cpu")
    for p, (_, d) in cells.items():
        if p in mine:
            assert mine[p] == pytest.approx(d, abs=1e-12), p


def test_the_reference_splat_is_the_plain_splat_iou():
    from pbr3d_torch.ops.cuda_kernels import splat_iou_plain

    rng = np.random.default_rng(8)
    V, P, N, H, W = 2, 5, 3000, 30, 40
    pts = torch.as_tensor(rng.uniform(0, 40, size=(V, N, 3)), dtype=torch.float32)
    labels = torch.as_tensor(rng.choice([1, 2, 5], size=(V, N)), dtype=torch.uint8)
    valid = torch.as_tensor(rng.random((V, N)) < 0.9)
    gt = torch.as_tensor(rng.choice([0, 1, 2, 5], size=(V, H, W)), dtype=torch.uint8)
    cams = torch.tensor([[20.0, 20.0, -60.0, 20.0, 20.0, 20.0, 45.0, 20.0, 15.0]]).repeat(V, P, 1)
    cams[..., :3] += torch.as_tensor(rng.normal(scale=2.0, size=(V, P, 3)), dtype=torch.float32)
    hw = torch.tensor([[H, W], [H - 3, W - 5]], dtype=torch.int32)
    theirs = splat_iou_plain(cams, pts, labels, valid, gt, [1, 2, 5], hw)
    mine = sref.splat_mean_iou(cams, pts, labels, valid, gt, [1, 2, 5], hw)
    assert float((theirs.double() - mine).abs().max()) < 1e-6


# ---- what the benchmark imports -----------------------------------------------------------

FORBIDDEN = ("jax", "pbr3d", "bench", "bench_torch", "chip_smoke")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(p.relative_to(PB).as_posix() for p in PB.rglob("*.py")))
def test_the_benchmark_imports_neither_jax_nor_the_jax_package_nor_the_old_benches(path):
    for mod in _imports(PB / path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {mod}"


@pytest.mark.parametrize("path", ["harness/study_reference.py", "harness/nb5_reference.py", "harness/roofline.py"])
def test_the_references_and_the_yardstick_import_nothing_of_the_program(path):
    for mod in _imports(PB / path):
        assert mod.split(".")[0] in ("__future__", "hashlib", "numpy", "torch", "scipy"), f"{path} imports {mod}"
