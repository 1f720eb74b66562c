"""pbr3d_torch, the example twins and chip_smoke import with jax, cv2,
pandas, tabulate, matplotlib, plotly, segment_anything and the JAX package
unavailable (the card's machine has none of the first seven, and the port
keeps its own copies of what it needs from ``pbr3d``), and build no kernel on
import; so does ``bench_torch.py``, the port's study bench."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

MODULES = [
    "pbr3d_torch",
    "pbr3d_torch.config",
    "pbr3d_torch.io.artifacts",
    "pbr3d_torch.io.masks",
    "pbr3d_torch.ops.rotate",
    "pbr3d_torch.ops.carve",
    "pbr3d_torch.ops.components",
    "pbr3d_torch.ops.cuda_kernels",
    "pbr3d_torch.ops.neighbors",
    "pbr3d_torch.utils.profiling",
    "pbr3d_torch.utils.streams",
    "pbr3d_torch.eval.gates",
    "pbr3d_torch.carving.stage1",
    "pbr3d_torch.carving.fused",
    "pbr3d_torch.carving.voxel",
    "pbr3d_torch.ops.cameramath",
    "pbr3d_torch.ops.projection",
    "pbr3d_torch.camera",
    "pbr3d_torch.camera.geometry",
    "pbr3d_torch.camera.keypoints",
    "pbr3d_torch.camera.estimate",
    "pbr3d_torch.camera.align",
    "pbr3d_torch.eval.inter",
    "pbr3d_torch.ops.morphology",
    "pbr3d_torch.ops.isosurface",
    "pbr3d_torch.io.pointcloud",
    "pbr3d_torch.eval.preprocess",
    "pbr3d_torch.eval.intra",
    "pbr3d_torch.ops.point_table",
    "pbr3d_torch.deform",
    "pbr3d_torch.deform.warp",
    "pbr3d_torch.deform.search",
    "pbr3d_torch.deform.verify",
    "pbr3d_torch.entry",
    "pbr3d_torch.pipeline",
    "pbr3d_torch.carving",
    "pbr3d_torch.io",
    "pbr3d_torch.ops",
    "pbr3d_torch.eval",
    "pbr3d_torch.segmentation",
    "pbr3d_torch.segmentation.state",
    "pbr3d_torch.segmentation.crop",
    "pbr3d_torch.segmentation.cleanup",
    "pbr3d_torch.segmentation.sam",
    "pbr3d_torch.utils",
    "pbr3d_torch.utils.viz",
    "bench_torch",
    "chip_smoke",
]
BLOCKED = ("jax", "cv2", "pbr3d", "pandas", "tabulate", "matplotlib", "plotly", "segment_anything")
TWINS = sorted(str(p) for p in (REPO / "examples" / "torch").glob("[1-6]_*.py"))

_PROBE = f"""
import importlib, importlib.util, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
for name in {MODULES!r}:
    importlib.import_module(name)
for i, path in enumerate({TWINS!r}):
    spec = importlib.util.spec_from_file_location(f"twin_{{i}}", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {BLOCKED + ("jaxlib",)!r}
                and sys.modules[m] is not None)
assert not leaked, leaked
from pbr3d_torch.ops.cuda_kernels import load_extension
assert load_extension.cache_info().currsize == 0
print("ok")
"""


def test_port_imports_without_jax_and_cv2():
    """Also without ``pbr3d``: no ``pbr3d.*`` module is loaded after every
    port module, the six example twins, ``chip_smoke`` and ``bench_torch``
    are imported."""
    assert len(TWINS) == 6
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
