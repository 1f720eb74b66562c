"""The example twins (``examples/torch/``) against the JAX package's example
scripts, each run as a user runs it (a subprocess from the repository root).

The reference's PNG masks are not in the repository: the test writes
Akbar@128's front mask (``labels_to_rgb`` of the study fixture's semantic
plane) into a temporary ``data_root``.  Twin 1 (``--device cpu``) and
``examples/1_*.py`` save the same npz grid; twin 6 and ``examples/6_*.py``
save the same PNG bytes.  Twins 2-5 need artifacts and inputs the repository
does not hold (PNG masks of every view, the notebook-5 PLY/OBJ), so they are
only checked to parse ``--help`` with jax and the JAX package unavailable.
Tolerance: none (equal arrays and bytes).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest_plugins = ["torch_threads"]

REPO = Path(__file__).resolve().parents[1]
TWINS = sorted((REPO / "examples" / "torch").glob("[1-6]_*.py"))
JAX_SCRIPTS = sorted((REPO / "examples").glob("[1-6]_*.py"))


def _run(script, *args, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(script), *map(str, args)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_twins_mirror_the_jax_scripts():
    assert [p.name for p in TWINS] == [p.name for p in JAX_SCRIPTS]


def test_stage1_twin_saves_the_jax_grid(tmp_path):
    import cv2

    from pbr3d_torch.config import labels_to_rgb
    from pbr3d_torch.io.artifacts import load_voxel_grid_labels

    fx = np.load(REPO / "tests/fixtures/torch_port_study.npz")
    masks = tmp_path / "data" / "Akbar" / "masks"
    masks.mkdir(parents=True)
    rgb = labels_to_rgb(fx["golden_Akbar_semantic"])
    cv2.imwrite(str(masks / "Akbar_front_mask.png"), cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
    common = ["--monument", "Akbar", "--data-root", tmp_path / "data", "--max-dim", 128]
    _run(JAX_SCRIPTS[0], *common, "--out", tmp_path / "jax")
    said = _run(TWINS[0], *common, "--out", tmp_path / "port", "--device", "cpu")
    rel = Path("1.Orthographic_Voxel_Carving") / "Akbar_voxel_grid.npz"
    ours = load_voxel_grid_labels(tmp_path / "port" / rel)
    ref = load_voxel_grid_labels(tmp_path / "jax" / rel)
    assert ours.shape == ref.shape and (ours > 0).sum() > 0
    np.testing.assert_array_equal(ours, ref)
    assert f"occupied voxels: {(ours > 0).sum():,}" in said
    with np.load(tmp_path / "port" / rel) as a, np.load(tmp_path / "jax" / rel) as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_segmentation_twin_saves_the_jax_png(tmp_path):
    import cv2

    rng = np.random.default_rng(6)
    half = rng.integers(0, 255, (40, 30, 3)).astype(np.uint8)
    img = np.concatenate([half, half[:, ::-1]], axis=1)  # symmetric about x = 30
    args = ["--crop", 12, 4, 40, 36, "--part", "dome", "--polygon", 3, 3, 20, 4, 22, 25, 5, 28,
            "--close", 5, "--min-area", 4]
    saved = {}
    for who, script, extra in (("jax", JAX_SCRIPTS[5], []), ("port", TWINS[5], ["--device", "cpu"])):
        d = tmp_path / who
        d.mkdir()
        cv2.imwrite(str(d / "Bibi_front.png"), img)
        said = _run(script, d / "Bibi_front.png", *args, *extra)
        assert "symmetry axis: x=30" in said
        saved[who] = sorted((d / "masks").glob("*.png"))
    assert [p.name for p in saved["port"]] == [p.name for p in saved["jax"]] == ["Bibi_front_mask_0_0_36_32.png"]
    assert saved["port"][0].read_bytes() == saved["jax"][0].read_bytes()


_HELP = """
import runpy, sys
for name in ("jax", "jaxlib", "pbr3d", "cv2", "matplotlib", "plotly", "segment_anything"):
    sys.modules[name] = None
sys.argv = [sys.argv[1], "--help"]
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "pbr3d") and sys.modules[m] is not None)
assert not leaked, leaked
"""


@pytest.mark.parametrize("twin", [p.name for p in TWINS[1:5]])
def test_twins_parse_help_without_jax(twin):
    out = subprocess.run([sys.executable, "-c", _HELP, str(REPO / "examples" / "torch" / twin)],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "--device" in out.stdout and "usage:" in out.stdout
