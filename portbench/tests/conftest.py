"""Shared pieces of the benchmark's CPU tests: a copy of ``portbench/`` in a
temporary directory, with cells, configurations and limits added as files,
and a run of one of its cells on the CPU (the plain versions of the
program's kernels stand in for the card's)."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

#: The study at a size a CPU test holds: Akbar at 256 (stage 3 moves parts
#: there), stage 2 and stage 3 at cut knobs.
TINY_STUDY = {
    "scenes": "256", "monuments": ["Akbar"],
    "run_all": {"max_dim": 256, "stage2_kw": {"generations": 4, "population": 16, "seed": 0},
                "stage3_kw": {"search_stride": 8, "chunk": 32, "scale_range": [0.9, 1.1, 3],
                              "shift_range": [-20, 20, 3], "refine_steps": 3}},
}
#: Notebook 5 at a size a CPU test holds: golden Taj's artifacts, fewer
#: points and a coarser mesh and density grid.
TINY_NB5 = {"sparse_points": 5000, "cad_samples": 5000, "pair_points": 2000, "nn_points": 5000,
            "grid_size": 32, "mesh_stride": 8}


def bench_json() -> dict:
    with open(REPO / "BENCHMARK.json") as fh:
        return json.load(fh)


class Tree:
    """A copy of ``portbench/`` and a ``BENCHMARK.json`` of its own."""

    def __init__(self, root: Path):
        self.root = root
        shutil.copytree(REPO / "portbench", root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
        self.bench = bench_json()

    @property
    def pb(self) -> Path:
        return self.root / "portbench"

    def write(self, rel: str, obj) -> None:
        path = self.pb / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(obj if isinstance(obj, str) else json.dumps(obj))

    def add_cell(self, name: str, config: str, traffic: str, limits_from: str, e2e=(), layers=()):
        """A cell of ``config`` (a file under configs/) and ``traffic``, with
        the limits of the cell ``limits_from``."""
        if config not in {c["name"] for c in self.bench["configs"]}:
            self.bench["configs"].append({"name": config, "source": "https://example.org/tiny",
                                          "file": f"portbench/configs/{config}.json", "reduced": [], "why": "test"})
        self.bench["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1,
                                        "why": "test"})
        for m in self.bench["end_to_end"]:
            if m["name"] in e2e and "workloads" in m:
                m["workloads"].append(name)
        for m in self.bench["per_layer"]:
            if m["name"] in layers:
                m["workloads"].append(name)
        shutil.copyfile(self.pb / "limits" / f"{limits_from}.json", self.pb / "limits" / f"{name}.json")

    def run(self, cell: str, seed: int = 2**31 + 77, after=None):
        from portbench.harness.bench import execute

        (self.root / "BENCHMARK.json").write_text(json.dumps(self.bench))
        return execute(self.bench, cell, seed, 0.01, False, device="cpu", root=self.pb, after=after)


@pytest.fixture
def tree(tmp_path):
    return Tree(tmp_path)


def tiny_study(tree: Tree) -> str:
    base = json.loads((REPO / "portbench/configs/study-256.json").read_text())
    tree.write("configs/tiny-study.json", {**base, **TINY_STUDY, "name": "tiny-study"})
    tree.add_cell("tiny-study.study", "tiny-study", "study", "study-256.study",
                  e2e=("study_s", "part_iou"), layers=())
    return "tiny-study.study"


def tiny_nb5(tree: Tree) -> str:
    mix = json.loads((REPO / "portbench/traffic/nb5.json").read_text())
    tree.write("traffic/tiny-nb5.json", {**mix, **TINY_NB5})
    tree.add_cell("study-golden.tiny-nb5", "study-golden", "tiny-nb5", "study-golden.nb5", e2e=("nb5_s",))
    return "study-golden.tiny-nb5"
