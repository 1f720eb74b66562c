"""pbr3d_torch and chip_smoke import with jax, cv2, pandas, tabulate and the
JAX package unavailable (the card's machine has none of the first four, and
the port keeps its own copies of what it needs from ``pbr3d``), and build no
kernel on import."""

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
    "chip_smoke",
]

_PROBE = f"""
import importlib, sys
sys.modules["jax"] = None
sys.modules["cv2"] = None
sys.modules["pbr3d"] = None
sys.modules["pandas"] = None
sys.modules["tabulate"] = None
for name in {MODULES!r}:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cv2", "pbr3d", "pandas", "tabulate")
                and sys.modules[m] is not None)
assert not leaked, leaked
from pbr3d_torch.ops.cuda_kernels import load_extension
assert load_extension.cache_info().currsize == 0
print("ok")
"""


def test_port_imports_without_jax_and_cv2():
    """Also without ``pbr3d``: no ``pbr3d.*`` module is loaded after every
    port module and ``chip_smoke`` are imported."""
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
