"""The port's unfused stage-1 route (``pbr3d_torch.carving.stage1``) and the
rotation, carve and mask helpers beside it, against the JAX package on the
same inputs.

Tolerances: label grids and every integer result are bit-equal (no
tolerance).  ``rotate_y`` is float32 work; it is held bit-equal too (0 ulp):
XLA's CPU backend does not fuse its ``out + w * g`` sum into FMAs, and the
port adds the same products in the same order.  The test counts the unequal
elements and requires 0.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

import __graft_entry__ as ge
from chip_smoke import OTHER_ANGLE_GROUPS
from pbr3d import config as jax_config
from pbr3d.carving import fused as jax_fused
from pbr3d.carving import stage1 as jax_stage1
from pbr3d.config import PART_IDS
from pbr3d.io import masks as jax_masks
from pbr3d.ops import carve as jax_carve
from pbr3d.ops import rotate as jax_rotate
from pbr3d_torch import config as torch_config
from pbr3d_torch.carving import fused as torch_fused
from pbr3d_torch.carving import stage1 as torch_stage1
from pbr3d_torch.io import masks as torch_masks
from pbr3d_torch.io.masks import MaskSet
from pbr3d_torch.ops import carve as torch_carve
from pbr3d_torch.ops import rotate as torch_rotate
from test_torch_stage1 import FIXTURES, _recover_labels

pytest_plugins = ["torch_threads"]

ANGLES = [0.0, 5.0, 30.0, 45.0, 90.0, 137.0, 180.0]


def _presets(name):
    """(JAX preset, port preset): the default, or the test preset whose group
    angles differ from the global angle."""
    if name == "default":
        return jax_config.DEFAULT_CARVE_PRESET, torch_config.DEFAULT_CARVE_PRESET
    return (dataclasses.replace(jax_config.DEFAULT_CARVE_PRESET, group_jobs=OTHER_ANGLE_GROUPS),
            dataclasses.replace(torch_config.DEFAULT_CARVE_PRESET, group_jobs=OTHER_ANGLE_GROUPS))


def _synthetic(h, w):
    binary, ext = ge._synthetic_masks(h, w)
    sem = ext.copy()
    sem[h - 12 : h - 2, w // 2 - 3 : w // 2 + 3] = PART_IDS["main_door"]
    sem[h // 2 : h // 2 + 4, w // 3 : w // 3 + 3] = PART_IDS["windows"]
    return MaskSet.from_labels(binary, ext, sem)


def _akbar():
    oracle = np.load(FIXTURES / "oracle_Akbar_128.npz")
    return MaskSet.from_labels(*_recover_labels()(oracle["colored"], oracle["final"]))


SCENES = {"akbar128": _akbar, "synthetic67x93": lambda: _synthetic(67, 93),
          "synthetic81x64": lambda: _synthetic(81, 64)}


@pytest.mark.parametrize("preset", ["default", "other_angles"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_carve_monument_bit_equal(scene, preset):
    """The unfused route equals the JAX ``carve_monument``; under the default
    preset it also equals the port's fused route, which refuses the other."""
    masks = SCENES[scene]()
    jax_preset, torch_preset = _presets(preset)
    ref = np.asarray(jax_stage1.carve_monument(masks, jax_preset))
    ours = torch_stage1.carve_monument(masks, torch_preset, device="cpu")
    assert isinstance(ours, np.ndarray) and ours.dtype == np.uint8 and ours.shape == ref.shape
    assert (ours == PART_IDS["full_building"]).any()
    np.testing.assert_array_equal(ours, ref)
    if preset == "default":
        np.testing.assert_array_equal(torch_fused.carve_monument_fused(masks, device="cpu"), ours)
    else:
        with pytest.raises(NotImplementedError, match="stage1.carve_monument"):
            torch_fused.carve_monument_fused(masks, torch_preset, device="cpu")


def test_partwise_carve_bit_equal_on_a_global_grid():
    masks = _synthetic(48, 40)
    g = np.asarray(jax_stage1.global_carve(masks.binary, masks.exterior_labels, 90))
    ref = np.asarray(jax_stage1.partwise_carve(jnp.asarray(g), masks.exterior_labels,
                                               masks.semantic_labels))
    ours = torch_stage1.partwise_carve(g, masks.exterior_labels, masks.semantic_labels, device="cpu")
    assert ours.dtype == torch.uint8
    np.testing.assert_array_equal(ours.numpy(), ref)


def _overlapping_components():
    """A grid whose dome (id 4) has an L-shaped component with a second,
    separate component inside the L's bbox, beside other parts' voxels; and
    an exterior plane whose dome pixels cover part of both."""
    W, H, D = 24, 16, 24
    g = np.zeros((W, H, D), np.uint8)
    g[1:20, 0:14, 4:20] = PART_IDS["full_building"]
    dome = PART_IDS["dome"]
    g[2:15, 2:6, 8:15] = dome  # the L's horizontal arm
    g[2:5, 2:13, 8:15] = dome  # its vertical arm
    g[8:12, 8:12, 7:16] = dome  # inside the L's bbox, touching neither arm
    rng = np.random.default_rng(11)
    ext = np.full((H, W), PART_IDS["full_building"], np.uint8)
    ext[1:12, 2:13] = np.where(rng.random((11, 11)) < 0.8, dome, PART_IDS["full_building"])
    return g, ext


def test_component_guided_carve_with_overlapping_bboxes():
    g, ext = _overlapping_components()
    comp, n = scipy.ndimage.label(g == PART_IDS["dome"])
    boxes = scipy.ndimage.find_objects(comp)
    assert n == 2
    assert all(a.start < b.stop and b.start < a.stop for a, b in zip(*boxes))  # bboxes overlap
    ref = np.asarray(jax_stage1.component_guided_carve(jnp.asarray(g), ext, "dome", 30))
    ours = torch_stage1.component_guided_carve(g, ext, "dome", 30, device="cpu")
    assert int((ref != g).sum()) > 0  # the carve erased something
    np.testing.assert_array_equal(ours.numpy(), ref)
    # the guided step of the fused route gives the same grid
    fused = torch_fused.guided_carve_fused(torch.from_numpy(g.copy()), ext, "dome", 30)
    np.testing.assert_array_equal(fused.numpy(), ref)


def test_component_guided_carve_without_the_part_in_the_mask():
    g, ext = _overlapping_components()
    ext[ext == PART_IDS["dome"]] = PART_IDS["full_building"]
    ours = torch_stage1.component_guided_carve(g, ext, "dome", 30, device="cpu")
    np.testing.assert_array_equal(ours.numpy(), g)


def _minaret_in_a_building(seed):
    """A minaret cylinder (with a sliver beside it) inside a partly filled
    building, and an exterior plane whose minaret columns are a little wider
    or narrower than the cylinder; the guided carve's angle is drawn too."""
    rng = np.random.default_rng(seed)
    W, H, D = 24, 10, 24
    fm = PART_IDS["front_minarets"]
    g = np.zeros((W, H, D), np.uint8)
    if rng.random() < 0.7:
        g[2:22, :, 2:22] = (rng.random((20, H, 20)) < rng.uniform(0.3, 0.9)) * PART_IDS["full_building"]
    cx, cz, r = rng.uniform(6, 18), rng.uniform(6, 18), rng.uniform(2, 5)
    xx, zz = np.meshgrid(np.arange(W), np.arange(D), indexing="ij")
    disk = (xx - cx) ** 2 + (zz - cz) ** 2 <= r * r
    y0, y1 = sorted(rng.integers(0, H, 2))
    g[:, y0:y1 + 1, :] = np.where(disk[:, None, :], fm, g[:, y0:y1 + 1, :])
    g[int(np.clip(cx + r + 1, 0, W - 1)), y0:y0 + 2, int(cz - r):int(cz + r)] = fm
    ext = np.full((H, W), PART_IDS["full_building"], np.uint8)
    ext[:, np.abs(np.arange(W) - cx) <= r + rng.uniform(-1.5, 1.5)] = fm
    return g, ext, int(rng.choice([5, 10, 15, 30, 45]))


@pytest.mark.parametrize("seed", [1, 2, 6, 12])
def test_the_two_guided_routes_differ_as_in_jax(seed):
    """The unfused route sweeps the occupancy of every part in a component's
    bbox (``pbr3d.carving.stage1.component_guided_carve``); the fused route
    sweeps the component's own, as the reference does
    (``pbr3d.carving.fused._guided_window_step``).  Where other parts' voxels
    hold up a rotated sample the unfused route keeps minaret voxels the
    fused one erases (48 voxels of golden Itimad's minarets in the study).
    Each port route equals its JAX counterpart."""
    g, ext, angle = _minaret_in_a_building(seed)
    fm = PART_IDS["front_minarets"]
    ref_unfused = np.asarray(jax_stage1.component_guided_carve(jnp.asarray(g), ext, "front_minarets", angle))
    padded = np.zeros((64, 64, 64), np.uint8)  # the JAX fused route reads 32-voxel windows
    padded[:24, :10, :24] = g
    ref_fused = np.asarray(jax_fused.guided_carve_fused(jnp.asarray(padded), ext, "front_minarets", angle))
    ref_fused = ref_fused[:24, :10, :24]
    unfused = torch_stage1.component_guided_carve(g, ext, "front_minarets", angle, device="cpu").numpy()
    fused = torch_fused.guided_carve_fused(torch.from_numpy(g.copy()), ext, "front_minarets", angle).numpy()
    np.testing.assert_array_equal(unfused, ref_unfused)
    np.testing.assert_array_equal(fused, ref_fused)
    differ = unfused != fused
    assert differ.any()
    assert (unfused[differ] == fm).all() and (fused[differ] == 0).all()


@pytest.mark.parametrize("direction", ["+", "-"])
@pytest.mark.parametrize("axis", [0, 2])
def test_extrude_from_surface_bit_equal(axis, direction):
    """Both axes and directions; the plane y = 0 is all empty columns, whose
    start is 0 (+) or size-1 (-); along axis 0 the (H, W) mask is read as
    (H, D) (W == D here)."""
    rng = np.random.default_rng(axis * 2 + (direction == "-"))
    W, H, D = 14, 9, 14
    g = np.zeros((W, H, D), np.uint8)
    g[2:11, 1:8, 3:12] = (rng.random((9, 7, 9)) < 0.6) * PART_IDS["full_building"]
    g[:, 0, :] = 0
    mask = rng.random((H, W)) < 0.5
    mask[0, :] = True
    for fill in (PART_IDS["main_door"], None):
        ref = np.asarray(jax_stage1.extrude_from_surface(jnp.asarray(g), mask, axis, direction, 4, fill))
        ours = torch_stage1.extrude_from_surface(g, mask, axis, direction, 4, fill, device="cpu")
        assert int((ref != g).sum()) > 0
        np.testing.assert_array_equal(ours.numpy(), ref)


def test_extrude_interior_parts_bit_equal():
    masks = _synthetic(40, 40)
    g = np.asarray(jax_stage1.global_carve(masks.binary, masks.exterior_labels, 90))
    depths = (("main_door", 6), ("windows", 3))
    ref = np.asarray(jax_stage1.extrude_interior_parts(jnp.asarray(g), masks.semantic_labels, depths))
    ours = torch_stage1.extrude_interior_parts(g, masks.semantic_labels, depths, device="cpu")
    assert (ref == PART_IDS["main_door"]).any() and (ref == PART_IDS["windows"]).any()
    np.testing.assert_array_equal(ours.numpy(), ref)


def _minaret_grid(extents):
    """front_minarets components, one per ``(x0, x1)`` extent along axis 0,
    each on its own (y, z) row so that none touch; ids follow scipy's raster
    order (first voxel's x, then y)."""
    g = np.zeros((16, 12, 12), np.uint8)
    g[:, 10:, :] = PART_IDS["full_building"]
    for i, (x0, x1) in enumerate(extents):
        g[x0:x1, 2 * i, 2 * i : 2 * i + 2] = PART_IDS["front_minarets"]
    return g


@pytest.mark.parametrize("case,extents", [
    # means along axis 0: 5.5 (id 1), 2.5, 5.5 (a tie with id 1 at the cut
    # of k = 2), 9
    ("tie", [(1, 11), (2, 4), (5, 7), (8, 11)]),
    ("n_at_most_k", [(1, 3), (6, 9)]),
    ("distinct", [(0, 2), (3, 14), (9, 12), (12, 15), (4, 6)]),
])
def test_recolor_backward_components_bit_equal(case, extents):
    g = _minaret_grid(extents)
    ref = np.asarray(jax_stage1.recolor_backward_components(jnp.asarray(g)))
    ours = torch_stage1.recolor_backward_components(g, device="cpu")
    np.testing.assert_array_equal(ours.numpy(), ref)
    recolored = int((ref == PART_IDS["back_minarets"]).sum())
    assert (recolored == 0) == (case == "n_at_most_k")
    if case == "tie":
        # ids 1 (mean 5.5) and 2 (mean 2.5) stay; id 3 (mean 5.5) goes
        labels, _ = scipy.ndimage.label(g == PART_IDS["front_minarets"])
        np.testing.assert_array_equal(ours.numpy() == PART_IDS["back_minarets"], np.isin(labels, [3, 4]))


def test_recolor_other_part_and_axis():
    g = _minaret_grid([(1, 11), (2, 4), (5, 7), (8, 11)])
    g[g == PART_IDS["front_minarets"]] = PART_IDS["small_minarets"]
    kw = dict(part_name="small_minarets", new_part_name="chhatris", k=1, sort_axis=2)
    ref = np.asarray(jax_stage1.recolor_backward_components(jnp.asarray(g), **kw))
    ours = torch_stage1.recolor_backward_components(g, device="cpu", **kw)
    assert (ref == PART_IDS["chhatris"]).any()
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_reorient_and_host_recolor_bit_equal():
    masks = _synthetic(48, 48)
    g = torch_fused._global_and_part_carve([masks], 90, torch_fused._preset_sweeps(
        torch_config.DEFAULT_CARVE_PRESET)[0], "cpu")[0].numpy()
    np.testing.assert_array_equal(torch_stage1.reorient(torch.from_numpy(g)).numpy(),
                                  np.asarray(jax_stage1.reorient(jnp.asarray(g))))
    np.testing.assert_array_equal(torch_fused.reorient_recolor_host(g),
                                  jax_fused.reorient_recolor_host(g))
    assert (torch_fused.reorient_recolor_host(g) == PART_IDS["back_minarets"]).any()


@pytest.mark.parametrize("shape", [(9, 12), (12, 9), (10, 10)])
def test_as_wh(shape):
    m = np.arange(np.prod(shape)).reshape(shape)
    W, H = 12, 9
    if shape in ((H, W), (W, H)):
        np.testing.assert_array_equal(torch_stage1._as_wh(m, W, H), jax_stage1._as_wh(m, W, H))
    else:
        for mod in (torch_stage1, jax_stage1):
            with pytest.raises(ValueError):
                mod._as_wh(m, W, H)


@pytest.mark.parametrize("angle", ANGLES)
def test_rotate_y_binary_u8_bit_exact(angle):
    """W != D, so only 0° and 180° are exact permutations here (90° is the
    LUT route); the 90° square case is below."""
    rng = np.random.default_rng(int(angle))
    g = (rng.random((30, 5, 44)) < 0.5).astype(np.float32)
    ref = np.asarray(jax_rotate.rotate_y_binary_u8(jnp.asarray(g), angle))
    ours = torch_rotate.rotate_y_binary_u8(g, angle, device="cpu")
    assert ours.dtype == torch.float32 and ours.shape == g.shape
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("angle", [90.0, 180.0, 270.0])
def test_rotate_y_binary_u8_permutation_branch(angle):
    rng = np.random.default_rng(3)
    g = (rng.random((26, 4, 26)) < 0.5).astype(np.float32)
    assert torch_rotate._binary_plan(26, 26, angle) is None  # the exact-permutation branch
    ref = np.asarray(jax_rotate.rotate_y_binary_u8(jnp.asarray(g), angle))
    np.testing.assert_array_equal(torch_rotate.rotate_y_binary_u8(g, angle, device="cpu").numpy(), ref)


@pytest.mark.parametrize("angle", ANGLES)
def test_rotate_y_bit_equal(angle):
    """Tolerance 0 ulp on a float32 grid of random values: the number of
    unequal elements is 0."""
    rng = np.random.default_rng(100 + int(angle))
    g = rng.random((30, 5, 44)).astype(np.float32)
    ref = np.asarray(jax_rotate.rotate_y(jnp.asarray(g), angle))
    ours = torch_rotate.rotate_y(g, angle, device="cpu").numpy()
    assert ours.dtype == np.float32
    assert int((ours != ref).sum()) == 0


def test_carve_with_mask_and_mask_parts_from_labels():
    rng = np.random.default_rng(5)
    occ = rng.random((7, 5, 6)).astype(np.float32)
    mask = rng.integers(0, 3, (7, 5)).astype(np.uint8)
    ref = np.asarray(jax_carve.carve_with_mask(jnp.asarray(occ), jnp.asarray(mask)))
    ours = torch_carve.carve_with_mask(torch.from_numpy(occ), torch.from_numpy(mask))
    np.testing.assert_array_equal(ours.numpy(), ref)
    labels = rng.integers(0, 11, (13, 17)).astype(np.uint8)
    for parts in (["dome"], ["front_minarets", "back_minarets"], []):
        np.testing.assert_array_equal(torch_masks.mask_parts_from_labels(labels, parts),
                                      jax_masks.mask_parts_from_labels(labels, parts))
