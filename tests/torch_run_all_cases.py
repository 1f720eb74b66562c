"""Two small monuments shared by the tests of the port's study entries
(``test_torch_run_all.py``, ``test_torch_run_serial.py``), written as PNGs in
the reference layout: Akbar at 128 (the oracle's recovered front mask and a
planted drone view, ``scripts/make_torch_port_stage2_fixture.py::akbar_128``)
and Bibi's recovered masks strided to 128 x 80 with a drone view planted
through the committed Bibi drone camera at a quarter of its scale.  Knobs are
cut as in the verify notes: stage 2 at generations 4 and population 16, stage
3 on a 3 x 3 lattice.  Bibi's drone view lands under its retry floor, so the
retry family runs.

Against the JAX package the port takes the JAX draws and the JAX keypoint fit
(the LM sits on a flat ridge)."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from pbr3d.camera import estimate as jest
from pbr3d_torch import pipeline as tpipe
from pbr3d_torch.carving.fused import carve_monument_fused
from pbr3d_torch.io.masks import MaskSet

REPO = Path(__file__).resolve().parents[1]
CAMS = REPO / "results_temp_golden/2.Perspective_Camera_Estimation"
MONUMENTS = ["Akbar", "Bibi"]
KW2 = dict(generations=4, population=16, seed=0)
KW3 = dict(search_stride=8, chunk=32, scale_range=(0.9, 1.1, 3), shift_range=(-20, 20, 3),
           refine_steps=3)


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


def _scenes(root):
    return {m: tpipe.load_scene_masks(root, m, 128) for m in MONUMENTS}
