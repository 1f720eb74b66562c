"""The port's own config against the JAX package's: the same public names
with the same values, and a lookup-table ``rgb_to_labels`` that returns
exactly what the JAX package's per-colour loop returns."""

import dataclasses
import inspect

import numpy as np
import pytest

from pbr3d import config as jcfg
from pbr3d_torch import config as tcfg


def _public(mod):
    """Names a module defines for its users: no imports, no private names."""
    return sorted(
        n for n, v in vars(mod).items()
        if not n.startswith("_") and n != "annotations" and not inspect.ismodule(v)
        and (not callable(v) or getattr(v, "__module__", None) == mod.__name__)
    )


PUBLIC = _public(jcfg)


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return isinstance(a, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, dict):
        return list(a) == list(b) and all(_equal(a[k], b[k]) for k in a)
    if dataclasses.is_dataclass(a):  # the two packages' own preset classes
        return type(a).__name__ == type(b).__name__ and dataclasses.asdict(a) == dataclasses.asdict(b)
    return type(a) is type(b) and a == b


def test_public_names_match():
    assert len(PUBLIC) > 20
    assert _public(tcfg) == PUBLIC


@pytest.mark.parametrize("name", [n for n in PUBLIC if not callable(getattr(jcfg, n))])
def test_value_equal(name):
    assert _equal(getattr(tcfg, name), getattr(jcfg, name)), name


def test_preset_fields_equal():
    ours, ref = tcfg.DEFAULT_CARVE_PRESET, jcfg.DEFAULT_CARVE_PRESET
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert dataclasses.asdict(tcfg.CarvePreset(global_angle_interval=45)) == \
        dataclasses.asdict(jcfg.CarvePreset(global_angle_interval=45))


def test_helpers_equal():
    names = ["dome", "plinth", "background", "full_building"]
    a, b = tcfg.part_ids(names), jcfg.part_ids(names)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    labels = np.arange(tcfg.NUM_LABELS, dtype=np.uint8).reshape(3, 4)
    assert np.array_equal(tcfg.labels_to_rgb(labels), jcfg.labels_to_rgb(labels))
    assert tcfg.data_root() == jcfg.data_root() and tcfg.golden_root() == jcfg.golden_root()
    assert tcfg.data_root("x") == jcfg.data_root("x")


def _mixed_rgb(rng, n):
    """Palette colours (the (1,1,1) sentinel included), black, colours one
    step off a palette colour, and random colours, shuffled."""
    pal = rng.choice(len(jcfg.PALETTE), n)
    rgb = jcfg.PALETTE[pal].copy()
    near = rng.random(n) < 0.2
    rgb[near, rng.integers(0, 3, int(near.sum()))] ^= 1
    rand = rng.random(n) < 0.3
    rgb[rand] = rng.integers(0, 256, (int(rand.sum()), 3), dtype=np.uint8)
    return rgb


@pytest.mark.parametrize("shape", [(1,), (257,), (33, 21), (5, 6, 7), (4, 9, 8, 3)])
def test_rgb_to_labels_bit_equal(rng, shape):
    rgb = _mixed_rgb(rng, int(np.prod(shape))).reshape(*shape, 3)
    ours = tcfg.rgb_to_labels(rgb)
    ref = jcfg.rgb_to_labels(rgb)
    assert ours.dtype == ref.dtype == np.uint8 and ours.shape == ref.shape == shape
    np.testing.assert_array_equal(ours, ref)


def test_rgb_to_labels_sentinel_black_and_other_id():
    rgb = np.array([[1, 1, 1], [0, 0, 0], [253, 248, 96], [216, 224, 251], [2, 1, 1]], np.uint8)
    np.testing.assert_array_equal(tcfg.rgb_to_labels(rgb),
                                  [tcfg.OTHER_ID, tcfg.EMPTY_ID, 1, tcfg.BACKGROUND_ID, tcfg.OTHER_ID])
    for other in (0, 7, 255):
        np.testing.assert_array_equal(tcfg.rgb_to_labels(rgb, other), jcfg.rgb_to_labels(rgb, other))


@pytest.mark.parametrize("offset", [-1, 0, 1])
def test_rgb_to_labels_chunk_edges(rng, monkeypatch, offset):
    """Inputs that end one voxel before, at and after a chunk edge, with a
    chunk cut small; and a (W, H, D, 3) grid over several chunks."""
    monkeypatch.setattr(tcfg, "_DECODE_CHUNK", 64)
    rgb = _mixed_rgb(rng, 3 * 64 + offset)
    np.testing.assert_array_equal(tcfg.rgb_to_labels(rgb), jcfg.rgb_to_labels(rgb))
    grid = _mixed_rgb(rng, 6 * 5 * 7).reshape(6, 5, 7, 3)
    np.testing.assert_array_equal(tcfg.rgb_to_labels(grid), jcfg.rgb_to_labels(grid))


def test_rgb_to_labels_other_dtypes():
    rgb = np.array([[253, 248, 96], [0, 0, 0], [256, 0, 0], [-1, 0, 0], [1, 220, 5]], np.int64)
    np.testing.assert_array_equal(tcfg.rgb_to_labels(rgb), jcfg.rgb_to_labels(rgb))
    f = rgb.astype(np.float32)
    f[4, 0] = 1.5
    with np.errstate(invalid="ignore"):
        np.testing.assert_array_equal(tcfg.rgb_to_labels(f), jcfg.rgb_to_labels(f))
