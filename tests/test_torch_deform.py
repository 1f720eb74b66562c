"""The port's stage-3 modules (``pbr3d_torch.deform.{warp,search,verify}``)
against the JAX package's on the same inputs, on the CPU.

* The warp is bit-equal (approx and exact, random deforms and identity):
  the port takes XLA's FMA contraction through ``cameramath._fma``.
* The fused rebuild equals the sequential one and the JAX package's.
* The candidate objectives, the z-buffers and the neighbour bundles equal
  the JAX package's on Akbar at 128, whose 123x128 front plane has an odd
  height: the port pads planes to even dims, the JAX package to 128.
* The search and verify cases of ``tests/test_deform.py`` that need no
  batcher give the JAX package's decisions.
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbr3d import config
from pbr3d.camera.geometry import params_to_vector
from pbr3d.carving.voxel import bucket_size
from pbr3d.deform import search as jsearch
from pbr3d.deform import verify as jverify
from pbr3d.deform import warp as jwarp
from pbr3d.ops.point_table import build_point_table as jax_table
from pbr3d_torch.deform import search, verify, warp
from pbr3d_torch.ops.point_table import build_point_table

REPO = Path(__file__).resolve().parents[1]
CAMS = REPO / "results_temp_golden/2.Perspective_Camera_Estimation"
PARTS3 = ["dome", "windows", "main_door"]


@pytest.fixture(scope="module")
def akbar():
    """(grid, 123x128 front mask, front camera, JAX table, port table)."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_stage2_fixture", REPO / "scripts" / "make_torch_port_stage2_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    grid, views = mod.akbar_128()
    cam = json.loads((CAMS / "Akbar_camera_params_final.json").read_text())["front"]
    return grid, views["front"], cam, jax_table(grid), build_point_table(grid, device="cpu")


def _deforms(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    d = np.stack([rng.uniform(0.5, 2, n), rng.uniform(-100, 100, n),
                  rng.uniform(0.5, 2, n), rng.uniform(-100, 100, n)], 1).astype(np.float32)
    d[0] = search.IDENTITY_DEFORM
    d[1] = [1.05, -3.0, 0.95, 2.0]
    return d


def _simple_cam(size):
    c = size / 2.0
    return {"cam_pos": np.array([c, c, -2.5 * size]), "target": np.array([c, c, c]),
            "f": 2.0 * size, "cx": c, "cy": c}


# ---------------------------------------------------------------- the warp

@pytest.mark.parametrize("approx", [True, False])
def test_warp_bit_equal(approx):
    rng = np.random.default_rng(0)
    coords = rng.integers(0, 128, (5000, 3)).astype(np.int16)
    center = rng.uniform(20, 100, 3).astype(np.float32)
    deforms = _deforms(1, 24)
    hw, vs = (123, 128), (128, 123, 128)
    ref = jax.jit(jax.vmap(lambda d: jwarp.deform_coords_soa(
        jnp.asarray(coords), jnp.ones(len(coords), bool), jnp.asarray(hw, jnp.int32),
        jnp.asarray(vs, jnp.int32), d, jnp.asarray(center), approx=approx)))(jnp.asarray(deforms))
    ours = warp.deform_coords_soa(torch.as_tensor(coords), None, hw, vs,
                                  torch.as_tensor(deforms), torch.as_tensor(center), approx=approx)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if not approx:  # identity reproduces every point, jittered copies rounded to it
        xs = ours[0][0].reshape(7, -1)
        np.testing.assert_array_equal(xs[0].numpy(), coords[:, 0].astype(np.float32))


def test_fused_rebuild_equals_sequential_and_jax(akbar):
    grid, mask, _, jt, tt = akbar
    parts = [p for p in config.PART_NAMES if p != "background" and tt.count(config.PART_IDS[p])]
    rng = np.random.default_rng(3)
    deforms = {p: np.array([rng.uniform(0.8, 1.3), rng.uniform(-20, 20),
                            rng.uniform(0.8, 1.3), rng.uniform(-20, 20)], np.float32)
               for p in parts}
    centers = {p: tt.center(config.PART_IDS[p]) for p in parts}
    points = {p: tt.part_window(config.PART_IDS[p]) for p in parts}
    fused = warp.build_deformed_grid_fused(points, deforms, centers, mask.shape, grid.shape, parts)
    seq = warp.build_deformed_grid(grid.shape, points, deforms, centers, mask.shape, parts)
    np.testing.assert_array_equal(fused.numpy(), seq.numpy())
    jpts = {}
    for p in parts:
        pid = config.PART_IDS[p]
        c, v = jt.part_window(pid, 1, bucket_size(jt.count(pid)))
        jpts[p] = (c, v)
    ref = np.asarray(jwarp.build_deformed_grid_fused(
        jpts, deforms, centers, mask.shape, grid.shape, parts))
    np.testing.assert_array_equal(fused.numpy(), ref)
    assert (ref > 0).sum() > (grid > 0).sum() // 2


# ---------------------------------------------------------- the objectives

@pytest.fixture(scope="module")
def objective_inputs(akbar):
    """The chhatris on Akbar's 123x128 front plane: shells, the identity
    rest plane of the other parts and a neighbour bundle, in both packages'
    plane layouts (JAX 128x128, port 124x128)."""
    grid, mask, cam, jt, tt = akbar
    H, W = mask.shape
    parts = [p for p in config.PART_NAMES if p != "background" and tt.count(config.PART_IDS[p])]
    part, pid = "chhatris", config.PART_IDS["chhatris"]
    zb = jsearch.all_part_zbuffers(jt.coords, jt.labels, jt.valid, params_to_vector(cam), parts,
                                   np.asarray([H, W], np.int32), 128, 128)
    others = [q for q in parts if q != part]
    rest = np.minimum.reduce([zb[q] for q in others])
    Q = 8
    nb = {"zb": np.full((Q, 64, 64), np.inf, np.float32), "base": np.zeros((Q, 64, 64), bool),
          "gt": np.zeros((Q, 64, 64), bool), "floor": np.zeros(Q, np.float32),
          "valid": np.zeros(Q, bool)}
    for i, q in enumerate(others):
        gq = np.zeros((128, 128), bool)
        gq[:H, :W] = mask == config.PART_IDS[q]
        nb["zb"][i] = jsearch._min_pool2(zb[q])
        nb["base"][i] = nb["zb"][i] < jsearch._min_pool2(rest) + 1.0
        nb["gt"][i] = jsearch._max_pool2(gq)
        nb["floor"][i] = 0.1 * (i + 1)
        nb["valid"][i] = True
    gt = np.zeros((128, 128), bool)
    gt[:H, :W] = mask == pid
    center = np.asarray(tt.center(pid), np.float32)
    c, v = jt.shell_window(pid, 2, bucket_size(-(-jt.shell_count(pid) // 2)))
    return dict(part=part, pid=pid, cam=cam, hw=(H, W), vs=grid.shape, rest=rest, nb=nb, gt=gt,
                center=center, jshell=(c, v), shell=tt.shell_window(pid, 2),
                full=tt.part_window(pid), deforms=_deforms(5, 40), zb=zb, parts=parts)


def _jax_kw(o):
    c, v = o["jshell"]
    return dict(coords=c, valid=v, cam_vec=jnp.asarray(params_to_vector(o["cam"])),
                gt_part=jnp.asarray(o["gt"]), rest_zbuf=jnp.asarray(o["rest"]),
                true_hw=jnp.asarray(o["hw"], jnp.int32), voxel_shape=jnp.asarray(o["vs"], jnp.int32),
                center=jnp.asarray(o["center"]), H=128, W=128)


def _port_kw(o):
    hp = o["hw"][0] + o["hw"][0] % 2
    return dict(coords=o["shell"], cam_vec=torch.as_tensor(params_to_vector(o["cam"])),
                gt_part=torch.as_tensor(o["gt"][:hp]), rest_zbuf=torch.as_tensor(o["rest"][:hp]),
                image_hw=o["hw"], voxel_shape=o["vs"], center=torch.as_tensor(o["center"]))


def _port_nb(o):
    h2 = (o["hw"][0] + 1) // 2
    assert np.isinf(o["nb"]["zb"][:, h2:]).all() and not o["nb"]["gt"][:, h2:].any()
    return {f"nb_{k}": torch.as_tensor(v[:, :h2] if v.ndim == 3 else v) for k, v in o["nb"].items()}


@pytest.mark.parametrize("penalized", [False, True])
@pytest.mark.parametrize("approx", [True, False])
def test_candidate_objectives_equal_jax_on_an_odd_plane(objective_inputs, approx, penalized):
    o = objective_inputs
    d = o["deforms"]
    if penalized:
        jn = {f"nb_{k}": jnp.asarray(v) for k, v in o["nb"].items()}
        ref = jsearch._batch_deform_visible_iou_penalized(jnp.asarray(d), **_jax_kw(o), **jn,
                                                           approx=approx)
        ours = search._batch_deform_visible_iou_penalized(torch.as_tensor(d), **_port_kw(o),
                                                          **_port_nb(o), approx=approx)
        assert ours.shape == (len(d), 3) and (np.asarray(ref)[:, 1] > 0).any()
    else:
        ref = jsearch._batch_deform_visible_iou(jnp.asarray(d), **_jax_kw(o), approx=approx)
        ours = search._batch_deform_visible_iou(torch.as_tensor(d), **_port_kw(o), approx=approx)
    ref = np.asarray(ref)
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert (ref[..., 0] if penalized else ref).max() > 0.2
    # the host combination picks the same candidate
    w = np.float64(1.0)
    comb = (lambda v: v[:, 0] + w * v[:, 1] - search.NEIGHBOR_PENALTY * v[:, 2]) if penalized \
        else (lambda v: v)
    assert np.argmax(comb(ours.numpy())) == np.argmax(comb(ref))


def test_splat_objective_and_part_zbuffers_equal_jax(objective_inputs, akbar):
    o = objective_inputs
    grid, mask, cam, jt, tt = akbar
    H, W = o["hw"]
    gt_p = np.zeros((128, 128), np.uint8)
    gt_p[:H, :W] = mask
    c, v = jt.part_window(o["pid"], 1, bucket_size(jt.count(o["pid"])))
    d = o["deforms"][:8]
    ref = jsearch._batch_deform_iou(
        jnp.asarray(d), c, v, params_to_vector(cam), jnp.asarray(gt_p), jnp.int32(o["pid"]),
        jnp.asarray([H, W], jnp.int32), jnp.asarray(grid.shape, jnp.int32), 128, 128)
    ours = search._batch_deform_iou(torch.as_tensor(d), o["full"], torch.as_tensor(
        params_to_vector(cam)), torch.as_tensor(mask), o["pid"], (H, W), grid.shape)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))

    cv = torch.as_tensor(params_to_vector(cam))
    for dd in d[:4]:
        ref_zb = np.asarray(jsearch.deformed_zbuffer(
            jnp.asarray(dd), c, v, params_to_vector(cam), jnp.asarray([H, W], jnp.int32),
            jnp.asarray(grid.shape, jnp.int32), jnp.asarray(o["center"]), 128, 128))
        ours_zb = search.deformed_zbuffer(torch.as_tensor(dd), o["full"], cv, (H, W), grid.shape,
                                          torch.as_tensor(o["center"])).numpy()
        assert ours_zb.shape == (124, 128)
        np.testing.assert_array_equal(ours_zb, ref_zb[:124])

    # identity z-buffers: from the point table, from the dense grid, and JAX's
    pts = search.all_part_zbuffers(tt.coords, tt.labels, params_to_vector(cam), o["parts"], (H, W))
    dense = verify._part_zbufs_grid(grid, cam, H, W, o["parts"], device="cpu")
    for p in o["parts"]:
        np.testing.assert_array_equal(pts[p], dense[p])
        np.testing.assert_array_equal(pts[p], o["zb"][p][:124])


@pytest.mark.parametrize("dtype", [np.float32, bool])
def test_half_res_pools_equal_jax(dtype):
    """The port's strided 2x2 pools against the JAX package's reshape form."""
    rng = np.random.default_rng(11)
    z = rng.random((124, 128)).astype(np.float32)
    z[rng.random(z.shape) < 0.4] = np.inf
    if dtype is bool:
        z = np.isfinite(z)
        np.testing.assert_array_equal(search._max_pool2(z), jsearch._max_pool2(z))
    np.testing.assert_array_equal(search._min_pool2(z), jsearch._min_pool2(z))


def _record_bundles(module, monkeypatch):
    seen = []
    inner = module.optimize_part_deform

    def rec(*a, **k):
        seen.append(k.get("_nb"))
        return inner(*a, **k)

    monkeypatch.setattr(module, "optimize_part_deform", rec)
    return seen


def test_neighbour_bundles_and_floors_equal_jax_on_an_odd_plane(akbar, monkeypatch):
    grid, mask, cam, jt, tt = akbar
    kw = dict(search_stride=8, chunk=32, scale_range=(0.9, 1.1, 3), shift_range=(-20, 20, 3),
              refine_steps=3, sweeps=2, exact_topk=6)
    ref_nb = _record_bundles(jsearch, monkeypatch)
    ref = jsearch.refine_parts(grid, mask, cam, table=jt, **kw)
    ours_nb = _record_bundles(search, monkeypatch)
    ours = search.refine_parts(grid, mask, cam, table=tt, device="cpu", **kw)
    assert ours == ref
    assert len(ours_nb) == len(ref_nb) > 4
    for a, b in zip(ours_nb, ref_nb):
        assert a["zb"].shape == (8, 62, 64) and b["zb"].shape == (8, 64, 64)
        for k in ("base", "gt"):
            np.testing.assert_array_equal(a[k], b[k][:, :62])
            assert not b[k][:, 62:].any()
        assert np.isinf(b["zb"][:, 62:]).all()
        _assert_zb_within_one_ulp(a["zb"], b["zb"][:, :62])
        for k in ("floor", "valid"):
            np.testing.assert_array_equal(a[k], b[k])


def _assert_zb_within_one_ulp(ours, ref):
    """Equal empty pixels and depths within one float32 ulp.  The JAX
    package's ``deformed_zbuffer`` is one XLA program for warp and
    projection, and XLA contracts its depth sum differently from the
    standalone projection that both packages otherwise share: on a deformed
    part up to one depth in ~30k pixels differs by one ulp from every other
    route (measured on Akbar's main_door).  No decision here moves with it."""
    np.testing.assert_array_equal(np.isinf(ours), np.isinf(ref))
    fin = np.isfinite(ref)
    ulps = np.abs(ours[fin].view(np.int32).astype(np.int64) - ref[fin].view(np.int32).astype(np.int64))
    assert ulps.max(initial=0) <= 1 and (ulps > 0).sum() <= 2


# --------------------------------------------------- the search and verify

def test_optimize_part_deform_recovers_shift():
    grid = np.zeros((48, 48, 48), np.uint8)
    pid = config.PART_IDS["dome"]
    grid[20:28, 8:20, 20:28] = pid
    mask = np.zeros((48, 48), np.uint8)
    mask[18:34, 18:34] = pid  # taller GT than the part projects
    cam = {"cam_pos": np.array([24.0, 24.0, -120.0]), "target": np.array([24.0, 24.0, 24.0]),
           "f": 100.0, "cx": 24.0, "cy": 24.0}
    kw = dict(search_stride=1, chunk=32, scale_range=(0.8, 1.2, 3), shift_range=(-20, 20, 5),
              refine_steps=3)
    best, iou = search.optimize_part_deform(grid, "dome", mask, cam, device="cpu", **kw)
    ref_best, ref_iou = jsearch.optimize_part_deform(grid, "dome", mask, cam, **kw)
    np.testing.assert_array_equal(best, ref_best)
    assert iou == ref_iou
    table = build_point_table(grid, device="cpu")
    iou_id = float(search._batch_deform_iou(
        torch.as_tensor(search.IDENTITY_DEFORM)[None], table.part_window(pid),
        torch.as_tensor(params_to_vector(cam)), torch.as_tensor(mask), pid, (48, 48),
        grid.shape)[0])
    assert iou > iou_id and not np.array_equal(best, search.IDENTITY_DEFORM)


def test_refine_parts_pins_minarets_and_applies_overrides():
    size = 48
    grid = np.zeros((size,) * 3, np.uint8)
    mid, did = config.PART_IDS["front_minarets"], config.PART_IDS["dome"]
    grid[20:28, 8:40, 4:10] = mid
    grid[20:28, 8:20, 20:28] = did
    mask = np.zeros((size, size), np.uint8)
    mask[6:40, 2:12] = mid
    mask[16:34, 18:34] = did
    forced = {"scale_y": 1.05, "shift_y": 2.0, "scale_xz": 0.95, "shift_xz": -1.0}
    kw = dict(part_names=["front_minarets", "dome"], overrides={"dome": forced},
              search_stride=1, chunk=16, scale_range=(0.9, 1.1, 3), shift_range=(-10, 10, 3),
              refine_steps=3)
    out = search.refine_parts(grid, mask, _simple_cam(size), device="cpu", **kw)
    assert out == jsearch.refine_parts(grid, mask, _simple_cam(size), **kw)
    assert [out["front_minarets"]["deform"][k] for k in ("scale_y", "shift_y", "scale_xz",
                                                         "shift_xz")] == [1.0, 0.0, 1.0, 0.0]
    for k, val in forced.items():
        assert out["dome"]["deform"][k] == pytest.approx(val)


def _staggered_scene(with_plinth: bool):
    size = 48
    grid = np.zeros((size,) * 3, np.uint8)
    did, wid, pid = (config.PART_IDS[p] for p in ("dome", "windows", "plinth"))
    grid[10:16, 20:32, 12:24] = wid
    grid[18:30, 8:24, 14:30] = did
    mask = np.zeros((size, size), np.uint8)
    mask[4:24, 12:28] = did
    mask[24:34, 14:26] = wid
    if with_plinth:
        grid[6:12, 34:44, 16:28] = pid
        mask[36:46, 14:30] = pid
    parts = ["dome", "windows"] + (["plinth"] if with_plinth else [])
    return grid, mask, dict(part_names=parts, search_stride=1, chunk=16,
                            scale_range=(0.8, 1.2, 3), shift_range=(-10, 10, 3), refine_steps=3)


def test_dual_dedup_and_pass0_prefix_reuse_match_jax():
    """The dual-scored pass 0 flags divergence as the JAX chain does; when
    it diverges mid-chain, a chain adopting the snapshot's prefix equals the
    chain run from scratch."""
    grid, mask, kw = _staggered_scene(with_plinth=True)
    cam = _simple_cam(48)
    flags, snap, ref_flags = {}, {}, {}
    out_g = search.refine_parts(grid, mask, cam, device="cpu", first_gain_w=0.0, dual_gain_w=1.0,
                                pass0_done=lambda d: flags.update(d=d),
                                pass0_snapshot_out=snap, **kw)
    ref_g = jsearch.refine_parts(grid, mask, cam, first_gain_w=0.0, dual_gain_w=1.0,
                                 pass0_done=lambda d: ref_flags.update(d=d), **kw)
    assert out_g == ref_g and flags == ref_flags
    out_full = search.refine_parts(grid, mask, cam, device="cpu", first_gain_w=1.0, **kw)
    assert out_full == jsearch.refine_parts(grid, mask, cam, first_gain_w=1.0, **kw)
    if not flags["d"]:
        assert out_g == out_full
    elif snap.get("idx"):
        out_pre = search.refine_parts(grid, mask, cam, device="cpu", first_gain_w=1.0,
                                      pass0_prefix=snap, **kw)
        assert out_pre == out_full


def test_resweep_window_matches_jax():
    grid, mask, kw = _staggered_scene(with_plinth=False)
    cam = _simple_cam(48)
    out = search.refine_parts(grid, mask, cam, device="cpu", resweep_window=(1.5, 5), **kw)
    assert out == jsearch.refine_parts(grid, mask, cam, resweep_window=(1.5, 5), **kw)


def test_rigid_consistency_seed_matches_warp_algebra():
    rng = np.random.default_rng(7)
    py = 80 / 97

    def warp_y(y, pivot_y, sy, dy):
        return (y - pivot_y) * sy + pivot_y - dy * py

    for _ in range(20):
        cq = rng.uniform(5, 60, 3).astype(np.float32)
        cp = rng.uniform(5, 60, 3).astype(np.float32)
        dq = np.array([rng.uniform(0.5, 2.0), rng.uniform(-40, 40),
                       rng.uniform(0.5, 2.0), rng.uniform(-20, 20)], np.float32)
        seed = search.rigid_consistency_seed(dq, cp, cq, py)
        np.testing.assert_array_equal(seed, jsearch.rigid_consistency_seed(dq, cp, cq, py))
        np.testing.assert_allclose(warp_y(cp[1], cp[1], seed[0], seed[1]),
                                   warp_y(cp[1], cq[1], dq[0], dq[1]), rtol=0, atol=1e-3)
        assert seed[0] == dq[0] and seed[2] == dq[2] and seed[3] == dq[3]


def test_enforce_no_regression_reverts_offender():
    size = 48
    grid = np.zeros((size,) * 3, np.uint8)
    did, wid = config.PART_IDS["dome"], config.PART_IDS["windows"]
    grid[4:8, 10:30, 10:30] = wid
    grid[9:31, 10:30, 10:30] = did
    mask = np.zeros((size, size), np.uint8)
    mask[10:30, 10:30] = wid
    cam = _simple_cam(size)
    table = build_point_table(grid, device="cpu")
    parts = ["dome", "windows"]
    points = {p: table.part_window(config.PART_IDS[p]) for p in parts}
    centers = {p: table.center(config.PART_IDS[p]) for p in parts}

    def build_fn(vecs):
        return warp.build_deformed_grid_fused(points, vecs, centers, (size, size), grid.shape,
                                              parts)

    def deforms():
        return {"dome": {"deform": {"scale_y": 1.0, "shift_y": 0.0, "scale_xz": 3.0,
                                    "shift_xz": 0.0}, "iou": 0.9},
                "windows": {"deform": {"scale_y": 1.0, "shift_y": 0.0, "scale_xz": 1.0,
                                       "shift_xz": 0.0}, "iou": 0.9}}

    bad = build_fn({"dome": np.array([1, 0, 3.0, 0], np.float32),
                    "windows": search.IDENTITY_DEFORM})
    before = verify.nb4_exact_cells(grid, bad, mask, cam, device="cpu")
    assert before["windows"][1] + 1e-6 < before["windows"][0]
    assert before == jverify.nb4_exact_cells(grid, bad.numpy(), mask, cam)

    out, grid_def = verify.enforce_no_regression(grid, deforms(), mask, cam, build_fn,
                                                 device="cpu")
    assert out["dome"]["deform"]["scale_xz"] == 1.0
    after = verify.nb4_exact_cells(grid, grid_def, mask, cam, device="cpu")
    assert after["windows"][1] + 1e-6 >= after["windows"][0]

    jpoints = {p: (points[p].numpy().astype(np.float32), np.ones(points[p].shape[0], bool))
               for p in parts}
    ref, ref_grid = jverify.enforce_no_regression(
        grid, deforms(), mask, cam,
        lambda v: jwarp.build_deformed_grid_fused(jpoints, v, centers, (size, size), grid.shape,
                                                  parts))
    assert out == ref
    np.testing.assert_array_equal(grid_def.numpy(), np.asarray(ref_grid))
