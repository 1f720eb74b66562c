"""The port's segmentation tooling (``pbr3d_torch.segmentation``) against the
JAX package's on the same inputs: every case of ``tests/test_segmentation.py``.

Tolerance: none.  Crops, symmetry axes, masks, composites and saved PNG
bytes are equal; the gray plane of the symmetry search is bit-equal to
JAX's float32 ``mean(axis=2)``.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from pbr3d import config as jax_config
from pbr3d import segmentation as jseg
from pbr3d_torch import config as torch_config
from pbr3d_torch import segmentation as tseg
from pbr3d_torch.segmentation import crop as tcrop

pytest_plugins = ["torch_threads"]

REPO = Path(__file__).resolve().parents[1]


def test_apply_crop_symmetric():
    img = np.arange(20 * 30 * 3, dtype=np.uint8).reshape(20, 30, 3)
    for args in (((5, 2, 12, 18), True, 10), ((5, 2, 12, 18), False, None), ((-4, -1, 40, 25), True, 22)):
        out, box = tseg.apply_crop(img, *args)
        ref, ref_box = jseg.apply_crop(img, *args)
        assert box == ref_box
        np.testing.assert_array_equal(out, ref)
    assert tseg.apply_crop(img, (5, 2, 12, 18), True, 10)[1] == (5, 2, 15, 18)
    for mod in (tseg, jseg):
        with pytest.raises(ValueError):
            mod.apply_crop(img, (10, 5, 10, 8))
    for args in ((5, 12, 10, 30), (0, 30, 3, 30), (20, 25, 4, 30)):
        assert tseg.expand_box_symmetric(*args) == jseg.expand_box_symmetric(*args)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_gray_plane_bit_equal(rng, dtype):
    """XLA's CPU backend multiplies the channel sum by float32 1/3; numpy's
    ``mean`` divides and differs by one ulp in about a third of the pixels."""
    img = rng.integers(0, 255, (31, 47, 3)).astype(dtype)
    if dtype == np.float32:
        img = img * np.float32(1.37) + rng.random(img.shape).astype(np.float32)
    ours = tcrop._gray(img)
    ref = np.asarray(jnp.asarray(img, jnp.float32).mean(axis=2))
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours.view(np.uint32), ref.view(np.uint32))


def test_find_symmetry_axis_mirrored(rng):
    # an image symmetric about column 24 of 40
    half = rng.integers(0, 255, (16, 16, 3)).astype(np.uint8)
    img = np.zeros((16, 40, 3), np.uint8)
    img[:, 8:24] = half
    img[:, 24:40] = half[:, ::-1]
    axis = tseg.find_symmetry_axis(img)
    assert axis == jseg.find_symmetry_axis(img)
    assert abs(axis - 24) <= 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_find_symmetry_axis_random(seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (23, 57 + seed, 3)).astype(np.uint8)
    assert tseg.find_symmetry_axis(img) == jseg.find_symmetry_axis(img)


def test_find_symmetry_axis_ties_go_to_the_first():
    """A constant image scores every candidate 0: the first one wins."""
    img = np.full((9, 20, 3), 7, np.uint8)
    assert tseg.find_symmetry_axis(img) == jseg.find_symmetry_axis(img) == 20 // 4


def test_cleanup_ops():
    m = np.zeros((40, 40), np.uint8)
    m[5:20, 5:20] = 1
    m[10, 10] = 0  # hole
    m[30, 30] = 1  # speck
    closed = tseg.close_holes(m, 3, device="cpu")
    assert closed[10, 10]
    np.testing.assert_array_equal(closed, jseg.close_holes(m, 3))
    cleaned = tseg.remove_small_regions_2d(m, min_area=10)
    assert not cleaned[30, 30] and cleaned[6, 6]
    np.testing.assert_array_equal(cleaned, jseg.remove_small_regions_2d(m, min_area=10))


@pytest.mark.parametrize("ksize", [2, 3, 4, 5, 7, 9])
def test_close_holes_matches_jax_and_cv2(rng, ksize):
    """Even sizes round up to the next odd one, as in the JAX package; the
    result equals cv2's MORPH_CLOSE with that dense square kernel."""
    import cv2

    m = (rng.random((41, 38)) > 0.6).astype(np.uint8)
    ours = tseg.close_holes(m.astype(bool), ksize, device="cpu")
    assert ours.dtype == bool
    np.testing.assert_array_equal(ours, jseg.close_holes(m.astype(bool), ksize))
    k = max(3, ksize + (ksize % 2 == 0))
    ref = cv2.morphologyEx(m, cv2.MORPH_CLOSE, np.ones((k, k), np.uint8))
    np.testing.assert_array_equal(ours.astype(np.uint8), ref)


@pytest.mark.parametrize("min_area", [1, 4, 12, 50])
def test_remove_small_regions_2d(rng, min_area):
    m = rng.random((33, 29)) > 0.7
    np.testing.assert_array_equal(tseg.remove_small_regions_2d(m, min_area),
                                  jseg.remove_small_regions_2d(m, min_area))


def test_rasterize_polygon():
    for verts, hw in (([(2, 2), (10, 2), (10, 8), (2, 8)], (12, 14)),
                      ([(1.5, 0.5), (12.2, 3.7), (6.1, 11.9)], (13, 15)),
                      ([(0, 0), (3, 3)], (5, 5))):
        np.testing.assert_array_equal(tseg.rasterize_polygon(verts, hw),
                                      jseg.rasterize_polygon(verts, hw))
    sel = tseg.rasterize_polygon([(2, 2), (10, 2), (10, 8), (2, 8)], (12, 14))
    assert sel[5, 5] and not sel[0, 0] and not sel[11, 13]


def _drive_editor(ed, mod_close_kw):
    a = np.zeros((10, 10), bool); a[2:5, 2:5] = True
    b = np.zeros((10, 10), bool); b[3:7, 3:7] = True
    c = np.zeros((10, 10), bool); c[1:9, 6] = True; c[5, 1:9] = True
    states = []
    ed.apply(a, "dome", "replace")
    ed.apply(b, "plinth", "add")  # add: only unowned pixels
    states.append({k: m.copy() for k, m in ed.masks.items()})
    ed.apply(b, "plinth", "replace")  # replace: claims from dome
    ed.apply(a, "plinth", "subtract")
    ed.apply(np.zeros((10, 10), bool), "dome", "replace")  # empty: no-op, no undo entry
    states.append({k: m.copy() for k, m in ed.masks.items()})
    assert ed.undo()  # revert the subtract
    ed.apply(c, "dome", "add")
    ed.clean("dome", **mod_close_kw)
    states.append({k: m.copy() for k, m in ed.masks.items()})
    with pytest.raises(ValueError):
        ed.apply(a, "dome", "paint")
    return states, list(ed.draw_order), ed.render_color_mask(), ed.render_color_mask(False)


def test_mask_editor_modes_and_undo():
    ours = tseg.MaskEditor((10, 10), ["dome", "plinth"], device="cpu")
    ref = jseg.MaskEditor((10, 10), ["dome", "plinth"])
    kw = dict(close_ksize=3, min_area=2)
    s_ours, order_ours, rgb_ours, rgb_nobg_ours = _drive_editor(ours, kw)
    s_ref, order_ref, rgb_ref, rgb_nobg_ref = _drive_editor(ref, kw)
    assert order_ours == order_ref
    for a, b in zip(s_ours, s_ref):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(rgb_ours, rgb_ref)
    np.testing.assert_array_equal(rgb_nobg_ours, rgb_nobg_ref)
    assert tuple(rgb_ours[0, 0]) == torch_config.PART_COLORS["background"]
    assert s_ours[0]["dome"][3, 3] == 1 and s_ours[0]["plinth"][3, 3] == 0
    assert ours.undo() and ours.undo()
    while ours.undo():
        pass
    assert not ours.undo()


def test_mask_editor_default_parts():
    ours = tseg.MaskEditor((4, 5), device="cpu")
    ref = jseg.MaskEditor((4, 5))
    assert list(ours.masks) == list(ref.masks)
    assert "background" not in ours.masks


def test_mask_editor_save(tmp_path):
    import cv2

    img_path = tmp_path / "Bibi_front.png"
    outs = []
    for mod, kw, root in ((tseg, dict(device="cpu"), "port"), (jseg, {}, "jax")):
        ed = mod.MaskEditor((12, 16), ["dome", "windows"], **kw)
        sel = np.zeros((12, 16), bool); sel[2:9, 3:11] = True
        ed.apply(sel, "dome", "replace")
        sel2 = np.zeros((12, 16), bool); sel2[5:7, 1:14] = True
        ed.apply(sel2, "windows", "replace")
        outs.append(ed.save(img_path, (3, 4, 19, 16), out_root=tmp_path / root))
        outs.append(ed.save(img_path, out_root=tmp_path / (root + "_full")))
    assert outs[0].name == outs[2].name == "Bibi_front_mask_3_4_19_16.png"
    assert outs[1].name == outs[3].name == "Bibi_front_mask_0_0_16_12.png"
    assert outs[0].parent == tmp_path / "port" / "masks"
    for a, b in ((outs[0], outs[2]), (outs[1], outs[3])):
        assert a.read_bytes() == b.read_bytes()
    rgb = cv2.cvtColor(cv2.imread(str(outs[0])), cv2.COLOR_BGR2RGB)
    assert tuple(rgb[6, 5]) == torch_config.PART_COLORS["windows"]


def test_sam_wrappers_with_stub():
    class StubPredictor:
        def set_image(self, img):
            self.img = img

        def predict(self, point_coords=None, point_labels=None, box=None,
                    multimask_output=True):
            self.args = (point_coords, point_labels, box, multimask_output)
            H, W = self.img.shape[:2]
            masks = np.zeros((3, H, W), bool)
            masks[2, :5, :5] = True
            masks[0, 5:, 5:] = True
            return masks, np.array([0.1, 0.2, 0.9]), None

    img = np.zeros((8, 8, 3), np.uint8)
    for call in (lambda mod, p: mod.sam_point(p, img, 2, 2),
                 lambda mod, p: mod.sam_point(p, img, 3.5, 1.0, label=0),
                 lambda mod, p: mod.sam_box(p, img, (0, 0, 4, 4))):
        p_ours, p_ref = StubPredictor(), StubPredictor()
        m = call(tseg, p_ours)
        np.testing.assert_array_equal(m, call(jseg, p_ref))
        for a, b in zip(p_ours.args, p_ref.args):
            np.testing.assert_array_equal(a, b)
        assert m[0, 0] and not m[6, 6]


def test_load_sam_predictor_without_segment_anything():
    probe = (
        "import sys; sys.modules['segment_anything'] = None\n"
        "from pbr3d_torch.segmentation import load_sam_predictor\n"
        "try:\n"
        "    load_sam_predictor('missing.pth')\n"
        "except ImportError as e:\n"
        "    print('ImportError', 'segment_anything' in str(e))\n"
    )
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ImportError True"


def test_image_state_load_and_undo(tmp_path):
    import cv2

    img = np.random.default_rng(0).integers(0, 255, (6, 7, 3)).astype(np.uint8)
    p = tmp_path / "x.png"
    cv2.imwrite(str(p), img)
    st = tseg.ImageState().load(p)
    ref = jseg.ImageState().load(p)
    np.testing.assert_array_equal(st.base_np, ref.base_np)
    np.testing.assert_array_equal(st.curr_np, img[:, :, ::-1])
    assert st.path == ref.path == p
    st.push_undo()
    st.curr_np = st.curr_np[:3, :3]
    assert st.pop_undo()
    assert st.curr_np.shape == (6, 7, 3)
    assert not tseg.ImageState().pop_undo()
    st.load(p)
    assert st.undo == []


def test_part_colors_agree():
    assert torch_config.PART_COLORS == jax_config.PART_COLORS
