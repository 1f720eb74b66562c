"""Stage 2's 3D minaret components follow the grid's device
(``pbr3d_torch.camera.keypoints.extract_minaret_voxels_by_label`` over
``pbr3d_torch.ops.components.label_part``): an array or a CPU tensor is
labelled by the host's scipy, a CUDA grid by the components kernels, and
either way the ``{LM1, LM2, RM1, RM2}`` coordinate sets are the JAX
package's: keys, order, every coordinate and its order, bit for bit.

The CPU cases need JAX (``jax_kp``); the card case needs no JAX and runs on
the card with ``python -m pytest --noconftest -m card
tests/test_torch_minaret_labels.py``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from pbr3d_torch.camera import keypoints
from pbr3d_torch.config import PART_IDS
from pbr3d_torch.io.artifacts import load_voxel_grid_labels
from pbr3d_torch.ops import components
from pbr3d_torch.utils import profiling

pytest_plugins = ["torch_threads"]

REPO = Path(__file__).resolve().parents[1]
GOLDEN_AKBAR = REPO / "portbench" / "data" / "stage1_golden" / "Akbar_voxel_grid.npz"
STUDY = REPO / "tests" / "fixtures" / "torch_port_study.npz"
FB, FM, BM = PART_IDS["full_building"], PART_IDS["front_minarets"], PART_IDS["back_minarets"]


@pytest.fixture(scope="module")
def jax_kp():
    """The JAX package's keypoints (imported here: the card's machine has no
    JAX)."""
    from pbr3d.camera import keypoints as jax_kp

    return jax_kp


def _columns(shape, columns, bridge=None):
    """A grid of a building block with minaret columns ``(part id, x0, x1,
    y0, z0, z1)``, each from ``y0`` to the top, and ``bridge``, a box of
    slices set to its part id (a bar that joins two columns)."""
    X, Y, Z = shape
    g = np.zeros(shape, np.uint8)
    g[X // 4:3 * X // 4, Y // 3:, Z // 4:3 * Z // 4] = FB
    for pid, x0, x1, y0, z0, z1 in columns:
        g[x0:x1, y0:, z0:z1] = pid
    if bridge is not None:
        pid, box = bridge
        g[box] = pid
    return g


def _synthetic(kind, width=32):
    """The synthetic cases: a ``(width, 24, width)`` grid, heights along
    d1."""
    s = width // 32

    def col(pid, x, z, y0):
        return (pid, x * s, x * s + 2, y0, z * s, z * s + 2)

    four = [col(FM, 3, 4, 2), col(FM, 26, 5, 4), col(BM, 4, 25, 6), col(BM, 25, 26, 8)]
    bridge = None
    if kind == "four_columns":
        cols = four
    elif kind == "six_columns_tied":
        # heights 21, 19, 17, 17, 17, 15: three front columns tie at the cut
        # of four, and the first two in raster order make it
        cols = [col(FM, 3, 4, 2), col(FM, 26, 5, 6), col(FM, 14, 2, 6), col(FM, 8, 28, 6),
                col(BM, 4, 25, 4), col(BM, 25, 26, 8)]
    elif kind == "two_joined":  # five columns, the last two one component
        cols = four + [col(BM, 20, 26, 8)]
        bridge = (BM, np.s_[20 * s:25 * s + 2, 8:10, 26 * s:26 * s + 2])
    elif kind == "part_absent":  # front minarets alone
        cols = [(FM,) + c[1:] for c in four]
    elif kind == "fewer_than_four":
        cols = four[:3]
    else:
        raise ValueError(kind)
    return _columns((width, 24, width), cols, bridge)


def _grid(case):
    if case == "golden_akbar":
        return load_voxel_grid_labels(GOLDEN_AKBAR)
    return _synthetic(case)


def _assert_same(ours, ref):
    assert list(ours) == list(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k])


def _device_labels(spans):
    return sum(s.counts.get("stage2.device_labels", 0) for s in spans)


CASES = ["golden_akbar", "four_columns", "six_columns_tied", "two_joined", "part_absent", "fewer_than_four"]


@pytest.mark.parametrize("route", ["numpy", "cpu_tensor"])
@pytest.mark.parametrize("case", CASES)
def test_a_host_grid_gives_the_jax_packages_minarets(case, route, jax_kp, monkeypatch):
    """An array or a CPU tensor: the JAX package's components bit for bit,
    labelled by the host's scipy, never by the plain relaxation, and no
    crop counted as a card labelling."""
    monkeypatch.setattr(components, "connected_components_device",
                        lambda *a: pytest.fail("a CPU grid reached the plain labeller"))
    g = _grid(case)
    grid = g if route == "numpy" else torch.from_numpy(g.copy())
    with profiling.recording() as spans, profiling.trace("cpu"):
        if case == "fewer_than_four":
            with pytest.raises(ValueError, match="found 3"):
                keypoints.extract_minaret_voxels_by_label(grid)
            with pytest.raises(ValueError, match="found 3"):
                jax_kp.extract_minaret_voxels_by_label(g)
        else:
            _assert_same(keypoints.extract_minaret_voxels_by_label(grid), jax_kp.extract_minaret_voxels_by_label(g))
    labelled = {s.attrs["part"] for s in spans if s.name == "stage2.minarets.label"}
    assert labelled == ({"front_minarets"} if case == "part_absent" else {"front_minarets", "back_minarets"})
    assert _device_labels(spans) == 0


def test_the_synthetic_cases_hold_what_they_name():
    """The tie, the joined pair and the absent part are there: the cases
    test what their names say."""
    heights = {}
    for case in CASES[1:]:
        g = _synthetic(case)
        hs = []
        for pid in (FM, BM):
            comp, n = components.connected_components(g == pid, "face")
            stats = components.component_stats(comp, n)
            hs += [int(stats["bbox_max"][i, 1] - stats["bbox_min"][i, 1]) for i in range(1, n + 1)]
        heights[case] = sorted(hs, reverse=True)
    assert len(heights["four_columns"]) == 4 and len(heights["fewer_than_four"]) == 3
    tied = heights["six_columns_tied"]
    assert len(tied) == 6 and tied[3] == tied[4]
    assert len(heights["two_joined"]) == 4  # five columns, four components
    assert not (_synthetic("part_absent") == BM).any() and len(heights["part_absent"]) == 4


def _card_cases():
    """(grid, {view: label plane}) a card case: golden Akbar with its front
    and drone views from the study fixture, and a synthetic 512-wide grid
    with a plane of four minaret regions."""
    with np.load(STUDY) as f:
        views = {v: f[f"golden_Akbar_{v}"] for v in ("front", "drone")}
    wide = _synthetic("six_columns_tied", width=512)
    plane = np.full((24, 512), FB, np.uint8)
    for pid, x in ((FM, 40), (BM, 120), (BM, 380), (FM, 460)):
        plane[2:22, x:x + 12] = pid
    return {"golden_akbar": (load_voxel_grid_labels(GOLDEN_AKBAR), views),
            "synthetic512": (wide, {"front": plane})}


@pytest.mark.card
def test_a_cuda_grid_gives_the_cpu_grids_minarets_and_keypoints():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name, (g, views) in _card_cases().items():
        cpu = keypoints.extract_minaret_voxels_by_label(g)
        with profiling.recording() as spans, profiling.trace("card"):
            card = keypoints.extract_minaret_voxels_by_label(torch.from_numpy(g).cuda())
        _assert_same(card, cpu)
        assert _device_labels(spans) == 2, name
        for v, plane in views.items():
            want = keypoints.extract_minaret_kps_for_view(g, plane, voxel_parts=cpu)
            got = keypoints.extract_minaret_kps_for_view(g, plane, voxel_parts=card)
            assert list(got[0]) == list(want[0]) and got[1] == want[1], (name, v)
            for k in want[0]:
                np.testing.assert_array_equal(got[0][k], want[0][k])
