"""``pbr3d_torch.io.artifacts.load_voxel_grid_labels`` with a device: the npz
member inflated in steps and each step decoded by the palette table where the
labels go, against ``pbr3d.config.rgb_to_labels`` of the whole member, bit for
bit.  On the CPU the streamed route runs the same torch decode as on the card,
without the pinned buffers.  The JAX package is imported where a test compares
with it, so the card's test runs where it is not installed."""

import io
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from pbr3d_torch import config
from pbr3d_torch.io import artifacts
from pbr3d_torch.utils import profiling

pytest_plugins = ["torch_threads"]

DATA = Path(__file__).resolve().parents[1] / "portbench" / "data"
COMMITTED = [DATA / "stage1_golden" / "Taj_voxel_grid.npz", DATA / "taj" / "Taj_deformed_voxel_grid.npz"]
COUNTER = "io.load_voxel_grid.device"


def _jax_labels(rgb, other_id=config.OTHER_ID):
    from pbr3d import config as jax_config

    return jax_config.rgb_to_labels(rgb, other_id)


def _load(path, device):
    """Labels and the counter of the call's ``io.load_voxel_grid`` span."""
    with profiling.recording() as spans:
        labels = artifacts.load_voxel_grid_labels(path, device=device)
    (span,) = [s for s in spans if s.name == "io.load_voxel_grid"]
    return labels, span.counts.get(COUNTER, 0)


def _colours(kind):
    """(n, 3) uint8 colours of one kind."""
    palette = config.PALETTE.astype(np.int64)
    if kind == "palette":  # black, every part, the OTHER_ID sentinel
        return palette.astype(np.uint8)
    if kind == "off_palette":
        return np.random.default_rng(0).integers(0, 256, (500, 3)).astype(np.uint8)
    # each channel of each palette colour one step off, either way
    near = [c + d * np.eye(3, dtype=np.int64)[ch] for c in palette for ch in range(3) for d in (-1, 1)]
    return np.clip(near, 0, 255).astype(np.uint8)


def _write(path, rgb, save=np.savez_compressed):
    save(path, voxel_grid=rgb)
    return path


def _grid(colours, shape):
    """A grid of ``shape`` voxels drawn from ``colours`` in a seeded order."""
    idx = np.random.default_rng(1).integers(0, len(colours), int(np.prod(shape)))
    return colours[idx].reshape(*shape, 3)


@pytest.fixture(scope="module", params=COMMITTED, ids=lambda p: p.stem)
def committed(request):
    path = request.param
    return path, _jax_labels(np.load(path)["voxel_grid"])


def test_streamed_labels_of_a_committed_grid_equal_jax(committed):
    path, ref = committed
    labels, n = _load(path, "cpu")
    assert labels.dtype == torch.uint8 and labels.device.type == "cpu" and n == 1
    np.testing.assert_array_equal(labels.numpy(), ref)


def test_host_labels_of_a_committed_grid_equal_jax(committed):
    path, ref = committed
    labels, n = _load(path, None)
    assert isinstance(labels, np.ndarray) and labels.dtype == np.uint8 and n == 0
    np.testing.assert_array_equal(labels, ref)


@pytest.mark.parametrize("save", [np.savez_compressed, np.savez], ids=["deflated", "stored"])
@pytest.mark.parametrize("kind", ["palette", "off_palette", "near_palette"])
def test_streamed_labels_of_each_colour_equal_jax(kind, save, tmp_path):
    rgb = _grid(_colours(kind), (7, 6, 5))
    path = _write(tmp_path / "grid.npz", rgb, save)
    labels, n = _load(path, "cpu")
    assert n == 1 and tuple(labels.shape) == (7, 6, 5)
    np.testing.assert_array_equal(labels.numpy(), _jax_labels(rgb))
    np.testing.assert_array_equal(labels.numpy(), artifacts.load_voxel_grid_labels(path))


@pytest.mark.parametrize("voxels", [30, 31, 32])
@pytest.mark.parametrize("chunk", [9, 10, 11])
def test_streamed_labels_across_step_edges(chunk, voxels, tmp_path, monkeypatch):
    """A step of 9 bytes (3 voxels) from a chunk 0, 1 or 2 bytes past it, and a
    grid that ends 0, 1 or 2 voxels past the last whole step."""
    monkeypatch.setattr(artifacts, "_STREAM_CHUNK", chunk)
    colours = np.concatenate([_colours("palette"), _colours("near_palette")])
    rgb = _grid(colours, (voxels, 1))
    labels, n = _load(_write(tmp_path / "grid.npz", rgb), "cpu")
    assert n == 1
    np.testing.assert_array_equal(labels.numpy(), _jax_labels(rgb))


@pytest.mark.parametrize("member", ["uint16", "float32", "int64", "fortran"])
def test_other_members_fall_back_to_the_host_route(member, tmp_path):
    rgb = _grid(np.concatenate([_colours("palette"), _colours("near_palette")]), (4, 5, 6))
    if member == "fortran":
        data = np.asfortranarray(rgb)
    else:
        data = rgb.astype(member)
        data[0, 0, 0] = [0.5, 0, 0] if member == "float32" else [256, 0, 0]  # no uint8 value: OTHER_ID
    path = _write(tmp_path / "grid.npz", data)
    labels, n = _load(path, "cpu")
    host, n_host = _load(path, None)
    assert isinstance(labels, torch.Tensor) and n == n_host == 0
    np.testing.assert_array_equal(labels.numpy(), host)
    if member != "fortran":
        assert host[0, 0, 0] == config.OTHER_ID


@pytest.mark.parametrize("fault", ["missing", "truncated"])
def test_a_missing_or_short_member_raises_on_both_routes(fault, tmp_path):
    path = tmp_path / "grid.npz"
    if fault == "missing":
        np.savez_compressed(path, other=np.zeros((2, 2, 2, 3), np.uint8))
    else:  # a header that promises more voxels than follow it
        member = io.BytesIO()
        np.save(member, np.zeros((5, 4, 4, 3), np.uint8))
        with zipfile.ZipFile(path, "w") as zf:
            zf.writestr("voxel_grid.npy", member.getvalue()[:-30])
    for device in (None, "cpu"):
        with pytest.raises(KeyError if fault == "missing" else ValueError):
            artifacts.load_voxel_grid_labels(path, device=device)


@pytest.mark.parametrize("other_id", [0, 5, 255])
def test_streamed_labels_with_another_other_id(other_id, tmp_path):
    rgb = _grid(np.concatenate([_colours("palette"), _colours("off_palette")]), (6, 6, 6))
    labels = artifacts._stream_labels(_write(tmp_path / "grid.npz", rgb), torch.device("cpu"), other_id)
    np.testing.assert_array_equal(labels.numpy(), _jax_labels(rgb, other_id))
    np.testing.assert_array_equal(labels.numpy(), config.rgb_to_labels(rgb, other_id))


def test_each_call_reads_the_file_again(tmp_path):
    path = tmp_path / "grid.npz"
    first = _grid(_colours("palette"), (5, 4, 3))
    second = first[::-1].copy()
    _write(path, first)
    a, _ = _load(path, "cpu")
    _write(path, second)
    b, _ = _load(path, "cpu")
    np.testing.assert_array_equal(a.numpy(), _jax_labels(first))
    np.testing.assert_array_equal(b.numpy(), _jax_labels(second))


@pytest.mark.parametrize("route", ["host", "streamed", "fallback"])
def test_the_counter_counts_the_streamed_route_alone(route, tmp_path):
    rgb = _grid(_colours("palette"), (3, 3, 3))
    path = _write(tmp_path / "grid.npz", rgb if route != "fallback" else rgb.astype(np.uint16))
    with profiling.recording() as spans:
        for _ in range(3):
            artifacts.load_voxel_grid_labels(path, device=None if route == "host" else "cpu")
    counts = [s.counts.get(COUNTER, 0) for s in spans if s.name == "io.load_voxel_grid"]
    assert counts == [int(route == "streamed")] * 3


@pytest.mark.card
def test_card_labels_of_the_committed_grid_equal_the_host_route():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    path = COMMITTED[0]
    labels, n = _load(path, "cuda")
    assert labels.device.type == "cuda" and n == 1
    np.testing.assert_array_equal(labels.cpu().numpy(), artifacts.load_voxel_grid_labels(path))
