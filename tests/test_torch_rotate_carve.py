"""The port's rotation planners and carve sweep against the JAX package:
bit-equal on the same seeded inputs (integer work, no tolerance)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbr3d.carving import stage1 as jax_stage1
from pbr3d.config import rgb_to_labels
from pbr3d.ops import carve as jax_carve
from pbr3d.ops import rotate as jax_rotate
from pbr3d_torch.carving import stage1 as torch_stage1
from pbr3d_torch.ops import carve as torch_carve
from pbr3d_torch.ops import rotate as torch_rotate

pytest_plugins = ["torch_threads"]

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
PLAN_CASES = [(64, 64, 5.0), (64, 64, 45.0), (40, 56, 30.0), (33, 47, 90.0), (50, 50, 10.0)]


def _assert_same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("W,D,angle", PLAN_CASES)
def test_planners_bit_equal(W, D, angle):
    _assert_same(torch_rotate._coord_plan(W, D, angle), jax_rotate._coord_plan(W, D, angle))
    _assert_same(torch_rotate._binary_plan(W, D, angle), jax_rotate._binary_plan(W, D, angle))
    _assert_same(torch_rotate.lut_plan(W, D, angle), jax_rotate.lut_plan(W, D, angle))
    _assert_same(
        torch_rotate.lut_plan_embedded(W, D, W + 7, D + 9, angle),
        jax_rotate.lut_plan_embedded(W, D, W + 7, D + 9, angle),
    )
    np.testing.assert_array_equal(
        torch_rotate.rotation_matrix_inv(angle), jax_rotate.rotation_matrix_inv(angle)
    )


@pytest.mark.parametrize("interval", [90, 45, 5])
def test_sweep_scan_bit_equal(interval):
    rng = np.random.default_rng(interval)
    W, H, D = 24, 10, 20
    N = W * D
    g2 = (rng.random((H, N)) < 0.7).astype(np.uint8)
    m2 = (rng.random((H, N)) < 0.8).astype(np.uint8)
    idx, dec = jax_carve._stacked_plans(W, D, interval)
    ref = np.asarray(jax_carve._sweep_scan(jnp.asarray(g2), jnp.asarray(m2),
                                           jnp.asarray(idx), jnp.asarray(dec)))
    plans = torch_carve.plans_to_device(torch_carve._stacked_plans(W, D, interval), "cpu")
    ours = torch_carve.sweep_scan(torch.from_numpy(g2), torch.from_numpy(m2), *plans)
    assert ours.dtype == torch.uint8
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("bucket", [None, 16])
@pytest.mark.parametrize("interval", [90, 30])
def test_rotate_carve_sweep_bit_equal(bucket, interval):
    rng = np.random.default_rng(7)
    occ = (rng.random((21, 13, 27)) < 0.75).astype(np.float32)
    mask = (rng.random((21, 13)) < 0.85).astype(np.uint8)
    ref = np.asarray(jax_carve.rotate_carve_sweep(jnp.asarray(occ), jnp.asarray(mask),
                                                  interval, bucket=bucket))
    ours = torch_carve.rotate_carve_sweep(occ, mask, interval, bucket, device="cpu")
    assert ours.shape == (21, 13, 27) and ours.dtype == torch.uint8
    np.testing.assert_array_equal(ours.numpy(), ref.astype(np.uint8))


def test_part_carve_bit_equal():
    import __graft_entry__ as ge
    from pbr3d.config import DEFAULT_CARVE_PRESET

    binary, ext = ge._synthetic_masks(48, 40)
    g = np.asarray(jax_stage1.global_carve(binary, ext, 90))
    ref = np.asarray(jax_stage1.part_carve(jnp.asarray(g), ext, DEFAULT_CARVE_PRESET.group_jobs))
    ours = torch_stage1.part_carve(g, ext, DEFAULT_CARVE_PRESET.group_jobs, device="cpu")
    assert (ref > 0).any()
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_global_carve_matches_reference_oracle_akbar_128():
    """The exterior labels recovered from the reference's own global-carve
    output reproduce it voxel for voxel."""
    colored = rgb_to_labels(np.load(os.path.join(FIXTURES, "oracle_Akbar_128.npz"))["colored"])
    ext = colored.max(axis=2).T.copy()
    ours = torch_stage1.global_carve((ext > 0).astype(np.uint8), ext, 90, device="cpu")
    assert ours.dtype == torch.uint8
    np.testing.assert_array_equal(ours.numpy(), colored)
