"""Stage 2's hand-written kernels on the CPU: their plain versions and the
dispatch in front of them, at Akbar@128 (the oracle's grid, the recovered
front mask and a planted drone view; 6 keypoints a view, R = 12 residuals;
the two minaret parts, K = 2).

* ``splat_iou_plain`` in the kernel's layout, and ``camera.align._batch_iou``
  in both of its layouts, are bit-equal to the route the kernel replaces,
  ``splat_labels`` then ``partwise_iou``, with points off the plane, behind
  the camera and on one pixel, and within 1e-6 of the JAX package's
  ``_batch_iou`` (XLA's CPU FMAs, emulated exactly).  The kernel's own way
  (an int32 plane of the winning point ``n + 1``) is held to this route in
  ``tests/test_torch_stage2_emulated.py``.
* ``lm_fit_plain`` of V = 3 fits gives the bits of three single fits, under
  both objectives; ``_lm_fit`` on CPU tensors matches the JAX fit's loss
  within rtol 1e-3 (the objective has a near-flat ridge: see
  ``tests/test_torch_camera.py``).
* CPU tensors reach only the plain versions (the kernels' launch counts stay
  put), and each kernel wrapper rejects a wrong dtype, shape or device before
  it builds or launches anything.  The kernels themselves run on the card:
  ``python3 chip_smoke.py kernels``.
"""


import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from pbr3d.camera import align as jalign
from pbr3d.camera import estimate as jest
from pbr3d_torch.camera import align as talign
from pbr3d_torch.camera import estimate as test_
from pbr3d_torch.ops import cuda_kernels as ck
from pbr3d_torch.ops.projection import partwise_iou, splat_labels

from torch_stage2_cases import (  # noqa: F401  (fixtures: fx, akbar, kp, shell)
    IDS, PARTS, VIEWS, _cams, _fit_rows, _hard_cams, _hard_points, akbar, fx, kp, shell,
)

pytest_plugins = ["torch_threads"]


def _splat_route(cams, pts, labels, valid, gt, H, W, true_hw=None):
    """The route ``splat_iou`` replaces: the int64-key splat, then the IoU."""
    img = splat_labels(pts, labels, valid, cams[..., 0:3], cams[..., 3:6], cams[..., 6], cams[..., 7],
                       cams[..., 8], H, W, true_hw)
    return partwise_iou(img, gt, IDS)[1]


@pytest.mark.parametrize("layout", ["one_view", "views"])
def test_splat_iou_plain_equals_splat_route(akbar, kp, shell, layout):
    grid, views = akbar
    pts, labels = _hard_points(*shell, seed=1)
    if layout == "one_view":
        cams = torch.from_numpy(np.concatenate([_cams(kp, "drone", 24, 2), _hard_cams(kp, "drone", shell[0])]))
        gt = torch.from_numpy(talign.mask_labels_selected(views["drone"], PARTS))
        H, W = gt.shape
        ref = _splat_route(cams, pts, labels, None, gt, H, W)
        ours = ck.splat_iou_plain(cams[None], pts[None], labels[None], None, gt[None], IDS)[0]
        via = talign._batch_iou(cams, pts, labels, gt, IDS, H, W)
    else:
        # three views of one group, _search's layout: points padded with
        # invalid ones to the longest, planes to the largest, true_hw inside
        sets = [(pts, labels), (pts[::2], labels[::2]), (pts[::3], labels[::3])]
        planes = [views["front"], views["drone"], views["front"][::2, ::2]]
        V, N = 3, pts.shape[0]
        H = max(p.shape[0] for p in planes) + 3
        W = max(p.shape[1] for p in planes) + 5
        rng = np.random.default_rng(4)
        pts_b = torch.from_numpy(rng.uniform(0, 128, (V, N, 3)).astype(np.float32))
        lab_b = torch.from_numpy(rng.choice(np.array([5, 6], np.uint8), (V, N)))
        val_b = torch.zeros((V, N), dtype=torch.bool)
        gt_b = torch.zeros((V, H, W), dtype=torch.uint8)
        for i, ((p, l), m) in enumerate(zip(sets, planes)):
            pts_b[i, :p.shape[0]], lab_b[i, :p.shape[0]], val_b[i, :p.shape[0]] = p, l, True
            gt_b[i, :m.shape[0], :m.shape[1]] = torch.from_numpy(talign.mask_labels_selected(m, PARTS))
        hw = torch.tensor([m.shape for m in planes], dtype=torch.int32)
        true_hw = tuple(hw[:, a].view(V, 1, 1) for a in (0, 1))
        cams = torch.from_numpy(np.stack([
            np.concatenate([_cams(kp, v, 13, 3 + i), _hard_cams(kp, v, shell[0])])
            for i, v in enumerate(("front", "drone", "front"))]))
        cams[2, :, 6:9] /= 2  # the half-resolution plane
        ref = _splat_route(cams, pts_b[:, None], lab_b[:, None], val_b[:, None], gt_b[:, None], H, W, true_hw)
        ours = ck.splat_iou_plain(cams, pts_b, lab_b, val_b, gt_b, IDS, hw)
        via = talign._batch_iou(cams[:, 2:9], pts_b, lab_b, gt_b, IDS, H, W, val_b, hw)
        assert torch.equal(via, ours[:, 2:9])
        via = talign._batch_iou(cams, pts_b, lab_b, gt_b, IDS, H, W, val_b, hw)
    assert ref.dtype == ours.dtype == torch.float32 and ref.shape == ours.shape
    assert float(ref.max()) > 0.3 and float(ref.min()) < 0.05  # hits and a camera looking away
    assert torch.equal(ours, ref)
    assert torch.equal(via, ref)


@pytest.mark.parametrize("view", VIEWS)
def test_splat_iou_plain_matches_jax(fx, akbar, kp, shell, view, monkeypatch):
    monkeypatch.setattr(jalign, "_MM_PLANE_MAX", 0)
    grid, views = akbar
    cams = _cams(kp, view, 32, 7)
    ref = fx.jax_shell_ious(grid, views[view], cams)
    gt = torch.from_numpy(talign.mask_labels_selected(views[view], PARTS))
    pts, labels = shell
    ours = ck.splat_iou_plain(torch.from_numpy(cams)[None], pts[None], labels[None], None, gt[None], IDS)[0]
    assert ref.max() > 0.3
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("loss_type", ["L2", "L1"])
def test_lm_fit_plain_batch_equals_single_fits(akbar, kp, loss_type):
    rows = _fit_rows(kp, akbar[1])
    batch = ck.lm_fit_plain(*(torch.from_numpy(np.stack(a)) for a in zip(*rows)), loss_type)
    for i, row in enumerate(rows):
        single = ck.lm_fit_plain(*(torch.from_numpy(a)[None] for a in row), loss_type)
        for b, s in zip(batch, single):
            assert torch.equal(b[i], s[0]), (i, b[i], s[0])
    x, loss, steps = batch
    assert x.shape == (3, 9) and loss.shape == (3,) and steps.dtype == torch.int32
    assert torch.all((steps > 0) & (steps <= 200))
    lo, hi = torch.from_numpy(np.stack([r[4] for r in rows])), torch.from_numpy(np.stack([r[5] for r in rows]))
    assert torch.all((x >= lo) & (x <= hi))


@pytest.mark.parametrize("view", VIEWS)
@pytest.mark.parametrize("loss_type", ["L2", "L1"])
def test_lm_fit_cpu_matches_jax(akbar, kp, view, loss_type):
    vk, ik, init, fit = kp[view]
    ref = fit if loss_type == "L2" else jest.optimize_camera_with_keypoints(
        vk, ik, akbar[1][view].shape, init, loss_type=loss_type)
    args = [torch.from_numpy(a) for a in test_.keypoint_fit_inputs(vk, ik, akbar[1][view].shape, init)]
    before = ck.lm_fit_kernel.launches
    x, loss = test_._lm_fit(*args, loss_type=loss_type)
    assert ck.lm_fit_kernel.launches == before
    assert x.shape == (9,) and loss.shape == ()
    assert abs(float(loss) - ref["loss"]) <= 1e-3 * ref["loss"], (float(loss), ref["loss"])


def _counting(monkeypatch, module, name):
    """Wrap ``module.name`` to record its calls."""
    calls = []
    fn = getattr(module, name)

    def spy(*a, **k):
        calls.append(name)
        return fn(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("what", ["lm_fit", "batch_iou"])
def test_cpu_tensors_reach_only_the_plain_versions(akbar, kp, shell, what, monkeypatch):
    before = (ck.lm_fit_kernel.launches, ck.splat_iou_kernel.launches)
    if what == "lm_fit":
        calls = _counting(monkeypatch, test_, "lm_fit_plain")
        vk, ik, init, _ = kp["front"]
        args = [torch.from_numpy(a) for a in test_.keypoint_fit_inputs(vk, ik, akbar[1]["front"].shape, init)]
        test_._lm_fit(*args, max_iters=3)
        fit = test_.optimize_camera_with_keypoints(vk, ik, akbar[1]["front"].shape, init, device="cpu")
        assert np.isfinite(fit["loss"])
        with pytest.raises(ValueError, match="unsupported device"):
            test_._lm_fit(*(a.to("meta") for a in args))
        assert calls == ["lm_fit_plain"] * 2
    else:
        calls = _counting(monkeypatch, talign, "splat_iou_plain")
        gt = torch.from_numpy(talign.mask_labels_selected(akbar[1]["front"], PARTS))
        cams = torch.from_numpy(_cams(kp, "front", 4, 5))
        ious = talign._batch_iou(cams, *shell, gt, IDS, *gt.shape)
        assert ious.shape == (4,) and float(ious.max()) > 0
        iou = talign.evaluate_camera_iou(akbar[0], akbar[1]["front"], PARTS, kp["front"][3], device="cpu")
        assert 0 <= iou <= 1
        with pytest.raises(ValueError, match="unsupported device"):
            talign._batch_iou(cams.to("meta"), *shell, gt, IDS, *gt.shape)
        assert calls == ["splat_iou_plain"] * 2
    assert (ck.lm_fit_kernel.launches, ck.splat_iou_kernel.launches) == before


def _lm_args(V=2, K=5, **change):
    args = dict(x0=torch.zeros(V, 9), vox=torch.zeros(V, K, 3), img=torch.zeros(V, K, 2), mask=torch.ones(V, K),
                lo=torch.zeros(V, 9), hi=torch.ones(V, 9))
    args.update(change)
    return args


def _splat_args(V=2, P=3, N=7, H=4, W=5, **change):
    args = dict(cams=torch.zeros(V, P, 9), pts=torch.zeros(V, N, 3), labels=torch.zeros(V, N, dtype=torch.uint8),
                valid=None, gt=torch.zeros(V, H, W, dtype=torch.uint8), part_ids=[5, 6], hw=None)
    args.update(change)
    return args


@pytest.mark.parametrize("call, error, match", [
    (lambda: ck.lm_fit_kernel(**_lm_args(x0=torch.zeros(2, 9, dtype=torch.float64))), TypeError, "x0 must be"),
    (lambda: ck.lm_fit_kernel(**_lm_args(x0=torch.zeros(2, 8))), ValueError, r"x0 must have shape \(V, 9\)"),
    (lambda: ck.lm_fit_kernel(**_lm_args(img=torch.zeros(2, 4, 2))), ValueError, r"img must have shape"),
    (lambda: ck.lm_fit_kernel(**_lm_args(mask=torch.ones(2, 5, dtype=torch.bool))), TypeError, "mask must be"),
    (lambda: ck.lm_fit_kernel(**_lm_args(hi=torch.ones(3, 9))), ValueError, "hi must have shape"),
    (lambda: ck.lm_fit_kernel(**_lm_args()), ValueError, "CUDA"),
    (lambda: ck.lm_fit_kernel(**_lm_args(), loss_type="L3"), ValueError, "loss_type"),
    (lambda: ck.lm_fit_kernel(**_lm_args(), max_iters=-1), ValueError, "max_iters"),
    (lambda: ck.splat_iou_kernel(**_splat_args(cams=torch.zeros(3, 9))), ValueError, r"cams must have shape"),
    (lambda: ck.splat_iou_kernel(**_splat_args(pts=torch.zeros(2, 7, 3, dtype=torch.float16))), TypeError,
     "pts must be"),
    (lambda: ck.splat_iou_kernel(**_splat_args(labels=torch.zeros(2, 7, dtype=torch.int64))), TypeError,
     "labels must be"),
    (lambda: ck.splat_iou_kernel(**_splat_args(valid=torch.ones(2, 6, dtype=torch.bool))), ValueError,
     "valid must have shape"),
    (lambda: ck.splat_iou_kernel(**_splat_args(gt=torch.zeros(4, 5, dtype=torch.uint8))), ValueError,
     r"gt must have shape \(V, H, W\)"),
    (lambda: ck.splat_iou_kernel(**_splat_args(hw=torch.ones(2, 2, dtype=torch.int64))), TypeError, "hw must be"),
    (lambda: ck.splat_iou_kernel(**_splat_args()), ValueError, "CUDA"),
])
def test_wrappers_reject_before_launch(call, error, match):
    before = (ck.lm_fit_kernel.launches, ck.splat_iou_kernel.launches)
    with pytest.raises(error, match=match):
        call()
    assert (ck.lm_fit_kernel.launches, ck.splat_iou_kernel.launches) == before
    assert ck.load_extension.cache_info().currsize == 0  # nothing was built


@pytest.mark.parametrize("ids", [[], list(range(1, 34)), [5, 300]])
def test_splat_iou_kernel_rejects_part_lists(ids):
    with pytest.raises(ValueError, match="part_ids"):
        ck.splat_iou_kernel(**_splat_args(part_ids=ids))


def test_threads_build_the_library_once(tmp_path, monkeypatch):
    """Two threads that reach their first kernel together (``run_all``'s
    preparation pool) build the library once: the second waits for the first
    and finds its library.  ``nvcc`` is a stub that logs its calls, takes a
    while, and fails a link whose objects are missing."""
    calls = tmp_path / "calls"
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(f"""#!/bin/sh
echo "$@" >> {calls}
sleep 0.3
out=""; prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"
  else case "$a" in *.o) [ -f "$a" ] || {{ echo "missing $a"; exit 1; }};; esac
  fi
  prev="$a"
done
echo stub > "$out"
""")
    nvcc.chmod(0o755)
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(ck, "BUILD_DIR", tmp_path / "build")
    start = threading.Barrier(2)

    def build(_):
        start.wait()
        return ck.build_library()

    with ThreadPoolExecutor(2) as pool:
        first, second = pool.map(build, range(2))
    lines = calls.read_text().splitlines()
    assert first == second and first.read_text() == "stub\n"
    assert len(lines) == len(ck._SOURCES) + 1 and sum("-shared" in line for line in lines) == 1
    assert sorted(p.name for p in first.parent.iterdir()) == sorted([first.name, first.with_suffix(".log").name])
