"""The port's production stage 1 (``carve_monument_fused``) against the JAX
package: bit-equal label grids on the same masks."""

import importlib.util
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from pbr3d.carving import fused as jax_fused
from pbr3d.config import PART_IDS, rgb_to_labels
from pbr3d_torch.carving import fused as torch_fused
from pbr3d_torch.io.masks import MaskSet

pytest_plugins = ["torch_threads"]

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"


def _recover_labels():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_fixture", REPO / "scripts" / "make_torch_port_fixture.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.recover_labels


def _synthetic(h, w):
    binary, ext = ge._synthetic_masks(h, w)
    sem = ext.copy()
    sem[h - 12 : h - 2, w // 2 - 3 : w // 2 + 3] = PART_IDS["main_door"]
    sem[h // 2 : h // 2 + 4, w // 3 : w // 3 + 3] = PART_IDS["windows"]
    return MaskSet.from_labels(binary, ext, sem)


@pytest.mark.parametrize("hw", [(64, 64), (96, 128)])
def test_fused_bit_equal_synthetic(hw):
    masks = _synthetic(*hw)
    ref = jax_fused.carve_monument_fused(masks)
    ours = torch_fused.carve_monument_fused(masks, device="cpu")
    assert ours.dtype == np.uint8 and ours.shape == ref.shape
    assert (ref == PART_IDS["main_door"]).any() and (ref == PART_IDS["windows"]).any()
    np.testing.assert_array_equal(ours, ref)


def test_fused_bit_equal_akbar_128():
    """Masks recovered from the reference oracle (the fixture script's rule);
    both packages land on the same grid, 240 voxels off the oracle's ``final``
    because the semantic mask is only approximated."""
    oracle = np.load(FIXTURES / "oracle_Akbar_128.npz")
    masks = MaskSet.from_labels(*_recover_labels()(oracle["colored"], oracle["final"]))
    ref = jax_fused.carve_monument_fused(masks)
    ours = torch_fused.carve_monument_fused(masks, device="cpu")
    np.testing.assert_array_equal(ours, ref)
    assert int((ours != rgb_to_labels(oracle["final"])).sum()) == 240


def test_extrude_empty_columns_match_jax():
    """Empty columns start at index 0 (+) or size-1 (-), as in the reference:
    torch's argmax over uint8 returns the FIRST maximal index, like JAX."""
    rng = np.random.default_rng(3)
    W, H, D = 12, 9, 12
    grid = np.zeros((W, H, D), np.uint8)
    grid[2:9, 3:7, 4:10] = (rng.random((7, 4, 6)) < 0.6) * 3
    grid[:, 0, :] = 0  # a row of fully empty columns along both axes
    sem = np.full((W, H), 0, np.uint8)
    sem[:, 0] = PART_IDS["main_door"]
    sem[3:8, 4:6] = PART_IDS["main_door"]
    sem[1, 2] = PART_IDS["windows"]
    jobs = ((PART_IDS["main_door"], 4), (PART_IDS["windows"], 3))
    ref = np.asarray(jax_fused._extrude_all(
        jnp.asarray(grid), jnp.asarray(sem), jnp.asarray([W, H, D], jnp.int32), jobs))
    ours = torch_fused._extrude_all(torch.from_numpy(grid.copy()), torch.from_numpy(sem), jobs)
    np.testing.assert_array_equal(ours.numpy(), ref)
    # the empty plane y=0 was painted from index 0: +Z fills z < 4 in every
    # column, then +X fills x < 4 in the columns still empty along X
    painted = ours[:, 0, :].numpy() == PART_IDS["main_door"]
    expect = np.zeros((W, D), bool)
    expect[:, :4] = expect[:4, :] = True
    np.testing.assert_array_equal(painted, expect)


def test_argmax_first_index_on_uint8():
    x = torch.tensor([[0, 0, 0], [0, 1, 1], [1, 0, 1]], dtype=torch.uint8)
    assert x.argmax(dim=1).tolist() == [0, 1, 0]
    assert x.flip(1).argmax(dim=1).tolist() == [0, 0, 0]


@pytest.mark.slow
def test_fused_bit_equal_bibi_512_fixture():
    """Bibi at 512 against the JAX-made fixture grid (CPU; minutes)."""
    fx = np.load(FIXTURES / "torch_port_Bibi_512.npz")
    masks = MaskSet.from_labels(fx["binary"], fx["exterior_labels"], fx["semantic_labels"])
    np.testing.assert_array_equal(torch_fused.carve_monument_fused(masks, device="cpu"), fx["grid"])

