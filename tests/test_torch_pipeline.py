"""The port's stage-1 entry point, mask preparation and artifacts against the
JAX package, on a small synthetic PNG dataset in the reference layout."""

import cv2
import numpy as np
import pytest

import __graft_entry__ as ge
from pbr3d import pipeline as jax_pipeline
from pbr3d.config import PART_IDS, labels_to_rgb
from pbr3d.io import artifacts as jax_artifacts
from pbr3d.io import masks as jax_masks
from pbr3d_torch import pipeline
from pbr3d_torch.io import artifacts, masks
from pbr3d_torch.utils import profiling

pytest_plugins = ["torch_threads"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """``{root}/Syn/masks/Syn_front_mask.png``: the synthetic monument with a
    door and windows, written at 2x so the INTER_LINEAR resize quirk blends."""
    h, w = 80, 96
    _, ext = ge._synthetic_masks(h, w)
    sem = ext.copy()
    sem[h - 14 : h - 2, w // 2 - 4 : w // 2 + 4] = PART_IDS["main_door"]
    sem[h // 2 : h // 2 + 6, w // 3 : w // 3 + 4] = PART_IDS["windows"]
    rgb = labels_to_rgb(np.kron(sem, np.ones((2, 2), np.uint8)))
    root = tmp_path_factory.mktemp("data")
    (root / "Syn" / "masks").mkdir(parents=True)
    cv2.imwrite(str(root / "Syn" / "masks" / "Syn_front_mask.png"), rgb[:, :, ::-1])
    return root


def test_prepare_masks_matches_jax(dataset):
    ours = masks.prepare_masks(dataset, "Syn", "front", 96)
    ref = jax_masks.prepare_masks(dataset, "Syn", "front", 96)
    for field in ("semantic", "exterior", "binary", "semantic_labels", "exterior_labels"):
        np.testing.assert_array_equal(getattr(ours, field), getattr(ref, field))
    assert ours.hw == ref.hw


def test_run_stage1_matches_jax(dataset, tmp_path):
    ours = pipeline.run_stage1("Syn", dataset, 96, out_dir=tmp_path / "torch", device="cpu")
    ref = jax_pipeline.run_stage1("Syn", dataset, 96, out_dir=tmp_path / "jax")
    np.testing.assert_array_equal(ours, ref)
    rel = "1.Orthographic_Voxel_Carving/Syn_voxel_grid.npz"
    saved = np.load(tmp_path / "torch" / rel)["voxel_grid"]
    np.testing.assert_array_equal(saved, np.load(tmp_path / "jax" / rel)["voxel_grid"])
    np.testing.assert_array_equal(artifacts.load_voxel_grid_labels(tmp_path / "torch" / rel), ours)


def test_grid_ious_match_jax(rng):
    a = rng.integers(0, 4, (12, 9, 12), dtype=np.uint8)
    b = np.where(rng.random(a.shape) < 0.8, a, rng.integers(0, 4, a.shape)).astype(np.uint8)
    for x, y in ((a, b), (labels_to_rgb(a), labels_to_rgb(b)), (a, labels_to_rgb(b))):
        assert artifacts.voxel_grid_iou(x, y) == jax_artifacts.voxel_grid_iou(x, y)
        assert artifacts.colored_voxel_grid_iou(x, y) == jax_artifacts.colored_voxel_grid_iou(x, y)
    with pytest.raises(ValueError):
        artifacts.voxel_grid_iou(a, b[:-1])


def test_prof_prints_only_when_enabled(capsys):
    with profiling.span("off"):
        pass
    assert capsys.readouterr().err == ""
    with profiling.printing():
        with profiling.span("on", view="front"):
            pass
    assert capsys.readouterr().err.startswith("[prof] on[view=front]: ")
