"""The port's point table (``pbr3d_torch.ops.point_table``) against the JAX
package's (``pbr3d.ops.point_table``): on Akbar at 128 (the oracle's final
grid) and on a random label grid, the table's coordinates, labels and
surface flags (in raster order), the per-part counts, shell counts, exact
sums and centres, and the strided part and shell windows are equal."""

import numpy as np
import pytest
import torch

from pbr3d import config
from pbr3d.config import rgb_to_labels
from pbr3d.ops.point_table import build_point_table as jax_table
from pbr3d_torch.ops.point_table import build_point_table

pytest_plugins = ["torch_threads"]

PIDS = [pid for pid in config.PART_IDS.values() if pid < 10]


def _akbar():
    from pathlib import Path

    oracle = np.load(Path(__file__).parent / "fixtures" / "oracle_Akbar_128.npz")
    return rgb_to_labels(oracle["final"])


def _random():
    rng = np.random.default_rng(7)
    return ((rng.random((40, 33, 40)) < 0.3).astype(np.uint8)
            * rng.integers(1, 10, (40, 33, 40)).astype(np.uint8))


@pytest.fixture(scope="module", params=["akbar_128", "random"])
def tables(request):
    grid = _akbar() if request.param == "akbar_128" else _random()
    return grid, jax_table(grid), build_point_table(grid, device="cpu")


def test_table_points_labels_and_surface(tables):
    grid, ref, ours = tables
    n = ref.n
    assert ours.n == n == int(np.count_nonzero(grid))
    np.testing.assert_array_equal(ours.coords.numpy(), np.asarray(ref.coords)[:n])
    assert ours.coords.dtype == torch.int16 and ours.coords.shape == (n, 3)
    np.testing.assert_array_equal(ours.labels.numpy(), np.asarray(ref.labels)[:n])
    np.testing.assert_array_equal(ours.surf.numpy(), np.asarray(ref.surf)[:n])
    assert ours.shape == ref.shape


def test_table_counts_sums_and_centres(tables):
    _, ref, ours = tables
    np.testing.assert_array_equal(ours.counts, ref.counts)
    np.testing.assert_array_equal(ours.shell_counts, ref.shell_counts)
    np.testing.assert_array_equal(ours.sums, ref.sums)
    for pid in PIDS:
        np.testing.assert_array_equal(ours.center(pid), ref.center(pid))
        if ours.count(pid):
            pts = ours.part_window(pid).numpy().astype(np.float64)
            np.testing.assert_allclose(ours.center(pid), pts.mean(axis=0), rtol=0, atol=1e-12)


@pytest.mark.parametrize("stride", [1, 3, 8])
def test_table_windows_match_jax(tables, stride):
    from pbr3d.carving.voxel import bucket_size

    _, ref, ours = tables
    for pid in PIDS:
        if ref.count(pid) == 0:
            continue
        for mine, theirs, n in (
            (ours.part_window(pid, stride), ref.part_window, ref.count(pid)),
            (ours.shell_window(pid, stride), ref.shell_window, ref.shell_count(pid)),
        ):
            want = -(-n // stride)
            c, v = theirs(pid, stride, bucket_size(want))
            c, v = np.asarray(c), np.asarray(v)
            assert v.sum() == want == mine.shape[0]
            np.testing.assert_array_equal(mine.numpy(), c[:want])
