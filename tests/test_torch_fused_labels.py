"""The part labelling of the fused stage-1 route follows the grid's device
(``pbr3d_torch.ops.components.label_part``): a CPU grid is labelled by the
host's scipy, a CUDA grid by the components kernels, and either way the
guided carve's windows and the back-minaret recolour are those of the host
route that labels a downloaded grid, and the JAX package's.

The CPU cases need JAX (``jax_fused``); the card case needs no JAX and runs
on the card with ``python -m pytest --noconftest -m card
tests/test_torch_fused_labels.py``.  Grids and windows are compared bit for
bit.
"""

import hashlib
from pathlib import Path

import numpy as np
import pytest
import scipy.ndimage
import torch

from pbr3d_torch import config
from pbr3d_torch.carving import fused
from pbr3d_torch.config import PART_IDS
from pbr3d_torch.io.masks import MaskSet
from pbr3d_torch.ops import components
from pbr3d_torch.utils import profiling

pytest_plugins = ["torch_threads"]

STUDY = Path(__file__).resolve().parent / "fixtures" / "torch_port_study.npz"
FB, FM, BM = PART_IDS["full_building"], PART_IDS["front_minarets"], PART_IDS["back_minarets"]
DOME = PART_IDS["dome"]
SYMMETRY = config.DEFAULT_CARVE_PRESET.part_symmetry
W, H = 24, 16  # guided scenes are (W, H, W), as a stage-1 grid is


@pytest.fixture(scope="module")
def jax_fused():
    """The JAX package's fused route (imported here: the card's machine has
    no JAX)."""
    import jax.numpy as jnp

    from pbr3d.carving import fused as jax_fused

    return jax_fused, jnp


def _guided_scene(kind):
    """(grid (W, H, W) uint8, exterior labels (H, W)) of one guided-carve
    case; the exterior's part columns are a little off the parts' voxels so
    that the carve erases some."""
    rng = np.random.default_rng(["many", "overlapping", "border", "absent"].index(kind))
    g = np.zeros((W, H, W), np.uint8)
    g[2:22, 4:, 2:22] = (rng.random((20, H - 4, 20)) < 0.6) * FB
    ext = np.full((H, W), FB, np.uint8)
    if kind == "many":  # twelve minaret columns, a few of them joined
        for x, z in rng.integers(1, W - 2, (12, 2)):
            y0 = int(rng.integers(0, H // 2))
            g[x:x + 2, y0:, z:z + 2] = FM
            ext[y0:, x:x + 2 + int(rng.integers(-1, 2))] = FM
    elif kind == "overlapping":  # an L of dome and a block inside its bbox
        g[2:15, 2:6, 8:15] = DOME
        g[2:5, 2:13, 8:15] = DOME
        g[8:12, 8:12, 7:16] = DOME
        ext[1:12, 2:13] = np.where(rng.random((11, 11)) < 0.8, DOME, FB)
    elif kind == "border":  # components on the grid's faces: the crop's border is the grid's
        g[0:3, :, 0:3] = FM
        g[W - 2:, 3:, W - 4:] = FM
        g[10:13, 0:2, 0:W] = FM
        ext[:, 0:3] = ext[:, W - 2:] = ext[0:2, 9:14] = FM
    else:  # chhatris in the mask but not in the grid; small minarets the other way round
        g[5:8, 2:9, 5:8] = PART_IDS["small_minarets"]
        g[14:18, 1:5, 14:18] = DOME
        ext[0:3, 4:9] = PART_IDS["chhatris"]
        ext[1:6, 13:19] = DOME
    return g, ext


def _host_windows(g, ext):
    """The guided windows of the host route: each part labelled on the
    whole downloaded grid by scipy, in raster order: (start, component
    occupancy, window mask (w, h), angle)."""
    out = []
    for part, angle in SYMMETRY:
        mask2d = ext == PART_IDS[part]
        if not mask2d.any():
            continue
        comp, _ = scipy.ndimage.label(g == PART_IDS[part])
        for i, sl in enumerate(scipy.ndimage.find_objects(comp), start=1):
            out.append((tuple(s.start for s in sl), comp[sl] == i, mask2d[sl[1], sl[0]].T, int(angle)))
    return out


@pytest.mark.parametrize("kind", ["many", "overlapping", "border", "absent"])
def test_guided_carve_on_a_cpu_grid_equals_the_host_route_and_jax(kind, jax_fused):
    jax_fused, jnp = jax_fused
    g, ext = _guided_scene(kind)
    jobs = fused._collect_guided_jobs(torch.from_numpy(g), ext, SYMMETRY)
    expect = _host_windows(g, ext)
    assert len(jobs) == len(expect) > 0
    for j, (start, comp, m_wh, angle) in zip(jobs, expect):
        assert j["start"] == start and j["angle"] == angle
        np.testing.assert_array_equal(j["comp"].numpy(), comp)
        np.testing.assert_array_equal(j["m_wh"].numpy(), m_wh)
    ours = fused.guided_carve_all(torch.from_numpy(g.copy()), ext, SYMMETRY).numpy()
    padded = np.zeros((64, 64, 64), np.uint8)  # the JAX route reads 32-voxel windows
    padded[:W, :H, :W] = g
    ref = np.asarray(jax_fused.guided_carve_all(jnp.asarray(padded), ext, SYMMETRY))[:W, :H, :W]
    np.testing.assert_array_equal(ours, ref)
    assert int((ours != g).sum()) > 0


def _minaret_columns(extents, shape=(16, 12, 12)):
    """A reoriented grid with one front-minaret column a ``(x0, x1)``
    extent along axis 0, each on its own (y, z) row (ids in that order)."""
    g = np.zeros(shape, np.uint8)
    g[:, shape[1] - 2:, :] = FB
    for i, (x0, x1) in enumerate(extents):
        g[x0:x1, i, 2 * (i % 6):2 * (i % 6) + 2] = FM
    return g


def _recolor_scene(kind):
    if kind == "tie":  # means 5.5 (id 1), 2.5, 5.5 (ties id 1 at the cut of k = 2), 9
        return _minaret_columns([(1, 11), (2, 4), (5, 7), (8, 11)])
    if kind == "n_at_most_k":
        return _minaret_columns([(1, 3), (6, 9)])
    if kind == "many":
        rng = np.random.default_rng(5)
        return _minaret_columns([tuple(sorted(rng.choice(16, 2, replace=False))) for _ in range(10)])
    if kind == "border":  # columns on the grid's first and last x, one on its first y and z
        return _minaret_columns([(0, 4), (12, 16), (0, 16), (3, 6)], shape=(16, 12, 8))
    return _minaret_columns([])  # absent


def _recolor_reference(g, k=2):
    """The host route's recolour on the whole grid: exact centroids along
    axis 0, a stable ranking."""
    comp, n = scipy.ndimage.label(g == FM)
    if n <= k:
        return g.copy()
    x = np.broadcast_to(np.arange(g.shape[0], dtype=np.int64)[:, None, None], g.shape)
    count = np.bincount(comp.ravel(), minlength=n + 1)[1:]
    sums = np.bincount(comp.ravel(), weights=x.ravel().astype(np.float64), minlength=n + 1)[1:]
    keep = np.argsort(sums / count, kind="stable")[:k] + 1
    out = g.copy()
    out[(comp > 0) & ~np.isin(comp, keep)] = BM
    return out


@pytest.mark.parametrize("kind", ["tie", "n_at_most_k", "many", "border", "absent"])
def test_recolor_on_a_cpu_grid_equals_the_host_route_and_jax(kind, jax_fused):
    jax_fused = jax_fused[0]
    g = _recolor_scene(kind)
    ours = fused.recolor_back(torch.from_numpy(g.copy())).numpy()
    np.testing.assert_array_equal(ours, _recolor_reference(g))
    np.testing.assert_array_equal(ours, jax_fused.recolor_back_host(g.copy()))
    np.testing.assert_array_equal(fused.recolor_back_host(g.copy()), ours)
    assert (ours == BM).any() == (kind in ("tie", "many", "border"))
    if kind == "tie":  # ids 1 and 2 stay; id 3, level with id 1, goes
        comp, _ = scipy.ndimage.label(g == FM)
        np.testing.assert_array_equal(ours == BM, np.isin(comp, [3, 4]))


def _synthetic(h, w):
    """A monument-like mask set: building, dome, two minarets (six columns
    wide, so that four minaret components outlive the carve), a door and a
    window."""
    ext = np.full((h, w), PART_IDS["background"], np.uint8)
    ext[h // 4:h - 2, w // 4:3 * w // 4] = FB
    ext[h // 8:h // 4 + 2, 3 * w // 8:5 * w // 8] = DOME
    ext[h // 6:h - 2, w // 8:w // 8 + 6] = FM
    ext[h // 6:h - 2, w - w // 8 - 6:w - w // 8] = FM
    sem = ext.copy()
    sem[h - 12:h - 2, w // 2 - 3:w // 2 + 3] = PART_IDS["main_door"]
    sem[h // 2:h // 2 + 4, w // 3:w // 3 + 3] = PART_IDS["windows"]
    return MaskSet.from_labels((ext != PART_IDS["background"]).astype(np.uint8), ext, sem)


def _device_labels(spans):
    return sum(s.counts.get("stage1.device_labels", 0) for s in spans)


@pytest.mark.parametrize("route", ["single", "batched"])
def test_a_cpu_grid_is_labelled_on_the_host(route, monkeypatch):
    """On a CPU grid the labelling is host scipy, never the plain
    relaxation, and nothing counts as a card labelling."""
    monkeypatch.setattr(components, "connected_components_device",
                        lambda *a: pytest.fail("a CPU grid reached the plain labeller"))
    masks = {"a": _synthetic(48, 48), "b": _synthetic(40, 56)}
    with profiling.recording() as spans, profiling.trace("cpu"):
        if route == "single":
            fused.carve_monument_fused(masks["a"], device="cpu")
        else:
            fused.carve_monuments_batched(masks, device="cpu")
    names = {s.name for s in spans}
    assert {"stage1.part.label", "stage1.recolor.label", "stage1.download"} <= names
    assert {s.attrs["part"] for s in spans if s.name == "stage1.part.label"} == {"dome", "front_minarets"}
    assert not any(n.startswith("stage1.host_label") for n in names)
    assert _device_labels(spans) == 0


def _card_scenes():
    fx = np.load(STUDY)
    akbar = MaskSet.from_labels(*(fx[f"golden_Akbar_{k}"] for k in ("binary", "exterior", "semantic")))
    return {"synthetic64": _synthetic(64, 64), "synthetic96x128": _synthetic(96, 128),
            "akbar128": akbar}, str(fx["golden_Akbar_sha256"])


def _labelled_crops(ms, grid):
    """Crops a fused carve labels: each part of the preset in both the
    exterior mask and the swept grid, and the recolour's minarets."""
    preset = config.DEFAULT_CARVE_PRESET
    sweep = fused._global_and_part_carve([ms], preset.global_angle_interval, fused._preset_sweeps(preset)[0], "cpu")[0]
    parts = sum(bool((ms.exterior_labels == PART_IDS[p]).any() and (sweep == PART_IDS[p]).any().item())
                for p, _ in SYMMETRY)
    return parts + int(np.isin(grid, [FM, BM]).any())


@pytest.mark.card
@pytest.mark.parametrize("route", ["single", "batched"])
def test_fused_carve_on_the_card_equals_the_cpu_carve(route):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    scenes, akbar_sha256 = _card_scenes()
    cpu = {m: fused.carve_monument_fused(ms, device="cpu") for m, ms in scenes.items()}
    assert hashlib.sha256(np.ascontiguousarray(cpu["akbar128"]).tobytes()).hexdigest() == akbar_sha256
    with profiling.recording() as spans, profiling.trace("card"):
        if route == "single":
            card = {m: fused.carve_monument_fused(ms, device="cuda") for m, ms in scenes.items()}
        else:
            card = fused.carve_monuments_batched(scenes, device="cuda")
    for m in scenes:
        np.testing.assert_array_equal(card[m], cpu[m])
    assert _device_labels(spans) == sum(_labelled_crops(scenes[m], cpu[m]) for m in scenes)
