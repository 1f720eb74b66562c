"""The CUDA sources of stage 2's kernels, ``pbr3d_torch/csrc/lm_fit.cu`` and
``splat_iou.cu``, compiled for the host by g++ under
``tests/cuda_host_emulation.h`` and run on the CPU against their plain
versions, at Akbar@128 as ``tests/test_torch_stage2_kernels.py``.

The build rewrites each launch ``kernel<<<grid, block, smem, stream>>>(`` to
``emu::launch(grid, block, smem, stream).run(kernel, `` and names each
file's anonymous namespace, then compiles both with ``-ffp-contract=off``
into a shared library under the test's temporary directory, called through
``ctypes`` with the C signatures of ``ops/cuda_kernels.py``.  The emulation
does each ``__*_rn`` operation as IEEE float32 and runs a block's threads
in lockstep at every barrier and warp intrinsic, so it computes the card's
bits; what it cannot show is what only the card has (registers, spills,
timing, the order of atomics).

Tolerances: the LM's losses within rtol 1e-3 of the plain fit's (its
Jacobian and sums round in another order, and the objective's near-flat
ridge moves the end point: ``tests/test_torch_camera.py``), or 1e-6 px²
where a fit solves its keypoints exactly; under L1 (IRLS on a sum of
absolute values, whose kinks rounding decides between) no loss above the
plain fit's times (1 + 1e-3); splat-IoU within
1e-3 of the plain version (a pixel whose float64-emulated FMA rounds
otherwise than one true FMA moves an IoU by ~1/union), the unequal IoUs
counted.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from pbr3d_torch.ops import cuda_kernels as ck
from pbr3d_torch.ops.cameramath import _ISCLOSE_TOL
from torch_stage2_cases import (  # noqa: F401  (fixtures: fx, akbar, kp, shell)
    IDS, PARTS, VIEWS, _cams, _fit_rows, _hard_cams, _hard_points, akbar, fx, kp, shell,
)

REPO = Path(__file__).resolve().parents[1]
_P, _I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """The two sources built for the host, with the wrappers' signatures."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the host emulation")
    out = tmp_path_factory.mktemp("emu")
    sources = []
    for name in ("lm_fit.cu", "splat_iou.cu"):
        text = (REPO / "pbr3d_torch" / "csrc" / name).read_text()
        text = text.replace("#include <cuda_runtime.h>", '#include "cuda_host_emulation.h"')
        text = re.sub(r"(\w+)<<<(.*?)>>>\(", r"emu::launch(\2).run(\1, ", text, flags=re.S)
        ns = name.split(".")[0]
        text = text.replace("namespace {", f"namespace {ns} {{", 1)
        text = text.replace("}  // namespace\n", f"}}  // namespace\nusing namespace {ns};\n", 1)
        (out / f"{ns}.cpp").write_text(text)
        sources.append(str(out / f"{ns}.cpp"))
    lib_path = out / "libstage2_emulated.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
                    f"-I{REPO / 'tests'}", "-o", str(lib_path), *sources], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.pbr3d_lm_fit.argtypes = [_P] * 6 + [_I] * 4 + [ctypes.c_float] + [_P] * 4
    lib.pbr3d_splat_iou.argtypes = [_P] * 6 + [ctypes.POINTER(_I)] + [_I] * 6 + [ctypes.c_float] + [_P] * 3
    assert (lib.pbr3d_lm_fit_threads(), lib.pbr3d_splat_iou_max_parts()) == (ck.LM_THREADS,
                                                                            ck.SPLAT_IOU_MAX_PARTS)
    return lib


def _ptr(a):
    return None if a is None else a.ctypes.data


def lm_fit_emulated(lib, rows, loss_type="L2", max_iters=200):
    """(x (V, 9), loss (V,), steps (V,)) of one emulated launch over fit rows
    of one K."""
    x0, vox, img, mask, lo, hi = (np.ascontiguousarray(np.stack(a), np.float32) for a in zip(*rows))
    V, K = vox.shape[:2]
    x, loss, steps = np.empty((V, 9), np.float32), np.empty(V, np.float32), np.empty(V, np.int32)
    assert lib.pbr3d_lm_fit(*map(_ptr, (x0, vox, img, mask, lo, hi)), V, K, int(loss_type == "L1"), max_iters,
                            _ISCLOSE_TOL, _ptr(x), _ptr(loss), _ptr(steps), None) == 0
    return x, loss, steps


def lm_fit_plain(rows, loss_type="L2", max_iters=200):
    return tuple(t.numpy() for t in ck.lm_fit_plain(*(torch.from_numpy(np.stack(a)) for a in zip(*rows)),
                                                    loss_type, max_iters))


def splat_iou_emulated(lib, cams, pts, labels, valid, gt, hw=None):
    cams, pts, labels, gt = (np.ascontiguousarray(t.numpy()) for t in (cams, pts, labels, gt))
    valid = None if valid is None else np.ascontiguousarray(valid.numpy()).view(np.uint8)
    hw = None if hw is None else np.ascontiguousarray(hw.numpy())
    (V, P), N, (H, W) = cams.shape[:2], pts.shape[1], gt.shape[1:]
    scratch, out = np.empty(V * P * (H * W + 2 * len(IDS)), np.int32), np.empty((V, P), np.float32)
    assert lib.pbr3d_splat_iou(_ptr(cams), _ptr(pts), _ptr(labels), _ptr(valid), _ptr(hw), _ptr(gt),
                               (_I * len(IDS))(*IDS), len(IDS), V, P, N, H, W, _ISCLOSE_TOL, _ptr(scratch),
                               _ptr(out), None) == 0
    return torch.from_numpy(out)


@pytest.mark.parametrize("loss_type", ["L2", "L1"])
def test_emulated_lm_fit_matches_plain(emu, akbar, kp, loss_type):
    rows = _fit_rows(kp, akbar[1])
    x, loss, steps = lm_fit_emulated(emu, rows, loss_type)
    _, ref, ref_steps = lm_fit_plain(rows, loss_type)
    assert np.all((steps > 0) & (steps <= 200)), steps
    if loss_type == "L2":
        np.testing.assert_allclose(loss, ref, rtol=1e-3, atol=1e-6)  # the third fit solves exactly: loss ~0
        assert np.all(np.abs(steps - ref_steps) <= 20), (steps, ref_steps)
    else:  # IRLS on sum |r| is not smooth: rounding sends the fits to other kinks, none worse
        assert np.all(loss <= ref * (1 + 1e-3)), (loss, ref)
    lo, hi = np.stack([r[4] for r in rows]), np.stack([r[5] for r in rows])
    assert np.all((x >= lo) & (x <= hi))
    for i, row in enumerate(rows):  # a block's fit does not depend on the others
        one = lm_fit_emulated(emu, [row], loss_type)
        for a, b in zip((x, loss, steps), one):
            assert np.array_equal(a[i], b[0])


def test_emulated_lm_fit_stops_where_plain_does(emu, akbar, kp):
    """NaN residuals give a NaN step, which ends both loops after one step
    with the start kept; max_iters = 0 takes no step."""
    x0, vox, img, mask, lo, hi = (a.copy() for a in _fit_rows(kp, akbar[1])[0])
    vox[0, 1] = np.nan
    bad = [(x0, vox, img, mask, lo, hi)]
    for fit in (lambda r, n: lm_fit_emulated(emu, r, max_iters=n), lambda r, n: lm_fit_plain(r, max_iters=n)):
        x, loss, steps = fit(bad, 200)
        assert steps[0] == 1 and np.array_equal(x[0], x0) and np.isnan(loss[0])
    good = _fit_rows(kp, akbar[1])[:1]
    x, loss, steps = lm_fit_emulated(emu, good, max_iters=0)
    _, ref, ref_steps = lm_fit_plain(good, max_iters=0)
    assert steps[0] == ref_steps[0] == 0 and np.array_equal(x[0], good[0][0])
    np.testing.assert_allclose(loss, ref, rtol=1e-6)


@pytest.mark.parametrize("layout", ["one_view", "views"])
def test_emulated_splat_iou_matches_plain(emu, akbar, kp, shell, layout):
    views = akbar[1]
    pts, labels = _hard_points(*shell, seed=2)
    if layout == "one_view":
        cams = torch.from_numpy(np.concatenate([_cams(kp, "front", 6, 8), _hard_cams(kp, "front", shell[0])]))[None]
        gt = torch.from_numpy(ck_mask(views["front"]))[None]
        args = (cams, pts[None], labels[None], None, gt)
        hw = None
    else:
        planes = [views["front"], views["drone"][::2, ::2]]
        sets = [(pts, labels), (pts[::2], labels[::2])]
        N, H, W = pts.shape[0], max(p.shape[0] for p in planes), max(p.shape[1] for p in planes)
        pts_b = torch.full((2, N, 3), 60.0)
        lab_b = torch.full((2, N), 5, dtype=torch.uint8)
        val_b = torch.zeros((2, N), dtype=torch.bool)
        gt_b = torch.zeros((2, H, W), dtype=torch.uint8)
        for i, ((p, lab), m) in enumerate(zip(sets, planes)):
            pts_b[i, : p.shape[0]], lab_b[i, : p.shape[0]], val_b[i, : p.shape[0]] = p, lab, True
            gt_b[i, : m.shape[0], : m.shape[1]] = torch.from_numpy(ck_mask(m))
        cams = torch.from_numpy(np.stack([_cams(kp, v, 5, 9 + i) for i, v in enumerate(VIEWS)]))
        cams[1, :, 6:9] /= 2
        hw = torch.tensor([m.shape for m in planes], dtype=torch.int32)
        args = (cams, pts_b, lab_b, val_b, gt_b)
    got = splat_iou_emulated(emu, *args, hw)
    ref = ck.splat_iou_plain(*args, IDS, hw)
    assert float(ref.max()) > 0.2
    err = (got - ref).abs()
    assert float(err.max()) <= 1e-3 and int((err > 0).sum()) <= 2, (got, ref)


def ck_mask(mask):
    """The selected parts' plane, as the search sees it."""
    from pbr3d_torch.camera.align import mask_labels_selected

    return mask_labels_selected(mask, PARTS)
