#!/usr/bin/env python3
"""On-card smoke of the PyTorch port (``pbr3d_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, each of which fails the script loudly (there is no CPU fallback):

1. card and build: the card's name and power limit, and the build of the
   hand-written CUDA kernels from ``pbr3d_torch/csrc`` into ``build/`` by
   nvcc (its seconds, and ``-Xptxas -v``'s registers, shared memory and
   spills; a spill fails the phase);
2. kernel vs plain: ``min_dist2_kernel`` against ``min_dist2_plain`` on the
   card, on seeded inputs at every shape of ``KERNEL_SHAPES`` (small,
   degenerate and ragged shapes and the main path's 20k and 50k), each
   output's sha256 held against the first design's; then at 20k and 50k the
   kernel, the plain version and the ``torch.cdist`` yardstick timed by
   CUDA events in turns, beside the bound, with the SM clock and power; then
   ``knn_kernel`` against ``knn_plain`` at every case of ``KNN_CASES``
   (distances to ``KERNEL_RTOL``, indices equal but for counted near ties,
   k = 1 equal to ``min_dist2``'s bits) and timed the same way beside the
   ``torch.cdist`` + ``topk`` yardstick;
3. stage 1 at 512 (Bibi): ``global_carve`` bit-exact against the reference
   oracle, ``carve_monument_fused`` bit-exact against the JAX package's grid
   in ``tests/fixtures/torch_port_Bibi_512.npz``; cold and warm times, peak
   device memory; the grid saved in the reference layout;
4. notebook-5 metrics on the card: the stage-1 cloud against the committed
   stage-3 model — chamfer, F-score@τ and the F1 curve — held against the
   fixture's float64 cKDTree values and its JAX values; the artifact's
   decode time apart, and the kernel's device time under the profiler.  The
   kernel's launch count over phases 3-4 must be positive;
5. stage 2 at 512 (Bibi): camera estimation on phase 3's grid, for the
   front view and a planted drone view, at ``run_stage2``'s defaults
   (generations 40, population 64, cd_rounds 6, seed 0, with the retry
   family and the quarter-step polish), against the JAX package's numbers
   in ``tests/fixtures/torch_port_Bibi_512_stage2.npz``: a candidate batch's
   IoUs, the keypoint fit's loss, the final IoUs of a run on the JAX draws
   and of one on the port's own generator; the returned IoUs re-scored, the
   camera JSONs saved and read back; cold and warm wall time per view, peak
   device memory, and the profiler's device-busy share and top kernels;
6. stage 3 at 512 (Bibi): part-wise refinement on phase 3's grid under the
   JAX package's stage-2 front camera, against
   ``tests/fixtures/torch_port_Bibi_512_stage3.npz``: the point table, every
   part's identity z-buffer, three candidate batches of the dome search (the
   plain and the penalized coarse-A batch, the exact refine batch), the
   rebuild of the JAX run's final deforms and its nb4 cells; then
   ``run_stage3_body`` at its golden defaults (both profiles, both
   schedules, the exact nb4 verify), whose picked nb4 total, cells, whole
   IoU and mean part IoU are gated and whose artifacts are read back; cold
   and second-run wall, peak device memory, the ``[prof]`` phases, and the
   profiler's device-busy share and top kernels;
7. the study: ``run_all_body(strict=True)`` over the five monuments, on the
   masks of ``tests/fixtures/torch_port_study.npz`` (stage 1's front planes
   recovered from the committed stage-1 grids; a planted front and a
   planted drone view each for stages 2 and 3), (a) at
   golden resolution (512; Akbar 128) with nothing else set, so the deep
   polish and stage 3's golden portfolio run, and (b) at 256 with the study
   bench's knobs (stage 2 at generations 12 and population 192, stage 3 at
   search stride 8).  Each stage-1 grid's sha256 and label counts are held
   against the JAX package's ``carve_monuments_batched`` on the same masks
   and against the port's per-scene route; every final camera's IoU is
   re-scored on the search objective; the three bench gates (stage-1 IoU
   against the committed golden grid, stage-3 whole IoU, mean part IoU), the
   nb4 cells and the artifacts are checked per monument.  It reports each
   call's wall, the ``[prof]`` phases, peak device memory, both carve routes'
   times and peaks, and for (b) a second call under the profiler (the same
   results; its device-busy share).

8. the evaluation path, after the study.  Notebook 4: the three table
   bodies of ``pbr3d_torch.eval.intra`` over all five monuments on the
   committed ``results_temp_golden/`` and ``results_temp/`` artifacts with
   the study fixture's front planes, every cell held against the JAX
   package's in ``tests/fixtures/torch_port_eval.json``; then the same
   bodies on the grids and cameras phase 7 just produced, whose third-table
   cells must be ``verify.nb4_exact_cells``'s.  Notebook 5, on clouds made
   from the committed Taj artifacts (the reference's PLY and OBJ inputs are
   not in the repository): a stand-in for the SfM cloud (the front half of
   the stage-1 shell at unit scale, thinned, moved and jittered from a seed)
   written as a PLY, the stage-1 grid, and a stand-in for the CAD model
   (``meshify_colored_voxel_grid`` at stride 2, written as an OBJ) go
   through ``build_taj_clouds`` (plane fit, alignment, symmetric completion,
   three ICPs, surface sampling); then ``examples/5``'s table over every
   pair of the five clouds, the NN statistics at 50k and the surface
   metrics (marching cubes at 128, k = 20) per cloud.  Every ``knn`` use is
   held against a float64 cKDTree, the first ICP against a cKDTree ICP, the dilation
   and the Gaussian against ``scipy.ndimage``, the values against the JAX
   package's in the fixture.  It reports the wall, peak allocated and
   reserved bytes, both kernels' launches and the profiler's busy share.

9. the stage-1 API, after the study and before phase 8: the unfused
   ``carve_monument`` on Bibi@512 (cold and warm; the steps once more under
   ``StageTimer``; peak allocated bytes; the profiler's busy share), on the
   ten study scenes, and under a test preset whose group angles differ from
   the global angle (five monuments at 256 and Bibi@512; the fused route
   refuses it): every grid's sha256 and label counts equal to the JAX
   unfused route's in ``tests/fixtures/torch_port_presets.npz``, and equal
   to the fused route's grid exactly where the JAX package's two routes
   agree;
   ``rotate_y_binary_u8`` and ``rotate_y`` on the Bibi@512 occupancy at
   ``ROTATE_ANGLES``, the card's bytes equal to CPU tensors'; the hole
   closing and small-region removal of Bibi's front plane, card against
   CPU, and its symmetry axis against JAX's; a ``device_trace`` around one
   warm carve with CUDA kernel events.  ``utils.viz`` is not run (no
   matplotlib on the card).

``python3 chip_smoke.py study`` runs the build and phase 7 alone,
``python3 chip_smoke.py stage1`` the build and phase 9,
``python3 chip_smoke.py kernels`` the build and phase 2, ``python3
chip_smoke.py eval`` the build and phase 8 on the committed artifacts; each
prints no result line.  The last two lines are the kernels' JSON record and the result line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result, when
there is no CUDA device or any check fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib.util
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from pbr3d_torch import config, pipeline
from pbr3d_torch.camera.align import (
    _batch_iou, evaluate_camera_iou, mask_labels_selected, refine_cameras_batched,
)
from pbr3d_torch.camera.estimate import (
    auto_compute_initial_params_matching_bbox,
    optimize_camera_with_keypoints,
)
from pbr3d_torch.camera.geometry import params_to_vector, vector_to_params
from pbr3d_torch.camera.keypoints import extract_minaret_kps_for_view
from pbr3d_torch.carving.fused import _sweep_working_set, carve_monument_fused, carve_monuments_batched
from pbr3d_torch.carving.stage1 import (
    carve_monument, component_guided_carve, extrude_interior_parts, global_carve, part_carve,
    recolor_backward_components, reorient,
)
from pbr3d_torch.carving.voxel import all_points, meshify_colored_voxel_grid, surface_points_by_parts
from pbr3d_torch.config import rgb_to_labels
from pbr3d_torch.deform import search, verify
from pbr3d_torch.deform.warp import build_deformed_grid_fused
from pbr3d_torch.eval import gates, inter, intra, preprocess
from pbr3d_torch.io.artifacts import load_camera_json, load_voxel_grid_labels, save_voxel_grid
from pbr3d_torch.io.masks import MaskSet
from pbr3d_torch.io.pointcloud import load_obj, load_ply, save_ply
from pbr3d_torch.ops import morphology, neighbors
from pbr3d_torch.ops.cuda_kernels import (
    knn_kernel, knn_plain, load_extension, min_dist2_kernel, min_dist2_plain,
)
from pbr3d_torch.ops.point_table import build_point_table
from pbr3d_torch.ops.rotate import rotate_y, rotate_y_binary_u8
from pbr3d_torch.pipeline import ALIGN_PARTS, SceneMasks, run_all_body, run_stage2_views, run_stage3_body
from pbr3d_torch.segmentation import close_holes, find_symmetry_axis, remove_small_regions_2d
from pbr3d_torch.utils import profiling

REPO = Path(__file__).resolve().parent
FIXTURE = REPO / "tests/fixtures/torch_port_Bibi_512.npz"
ORACLE = REPO / "tests/fixtures/oracle_Bibi_512.npz"
STAGE3 = REPO / "results_temp_golden/3.Part-wise_3D_Refinement/Bibi_deformed_voxel_grid.npz"

#: Kernel vs plain version, elementwise relative: both are the float32
#: direct difference; the kernel's FMAs round fewer times, a few ulp.
KERNEL_RTOL = 1e-6
#: Port vs float64 cKDTree on the same points (F-values: points on τ).
KD_CHAMFER_RTOL = 1e-4
KD_F_ATOL = 1e-3
#: Port vs the JAX package: its |a|²+|b|²-2a·b form errs by ~8ε(|a|²+|b|²)
#: per point (tests/test_eval.py:49).
JAX_RTOL = 1e-2
#: (N, M) of the kernel checks: small and degenerate shapes, ragged ones (N
#: not a multiple of a block's queries, M not a multiple of a chunk, N = 1,
#: few queries against many points) and the two main-path shapes.
KERNEL_SHAPES = ((777, 1311), (19, 1000), (100, 1), (100, 0), (1, 5000), (1025, 4097),
                 (5, 100003), (20000, 20000), (50000, 50000))
#: The main path's shapes: chamfer and F-score at 20k (four launches), the
#: F1 curve at 50k (two).
TIMED_SHAPES = ((20000, 20000), (50000, 50000))
#: sha256 of the first design's output (one block per 256 queries, all of
#: B in each block) at each of KERNEL_SHAPES on ``kernel_inputs``: min is
#: exact, so every design of the same arithmetic must give these bytes.
REFERENCE_SHA256 = {
    (777, 1311): "4bb552e71919652abe92830a92fa98d257d2f2a2f6648920be344fac4c849e2f",
    (19, 1000): "833c193f43c00e85d172268ceb62013b7ef82f214651cf441e6f354549b1cd8c",
    (100, 1): "86843f6d424854a4f214e5cdc3c8a3fd2200f3c9197b54e54416359f3f0d7a2d",
    (100, 0): "e338184703a3b370520834d1d2c6bfdeff58c8bf623cd94b6c21466f1ce5dbcb",
    (1, 5000): "e260dceacc5557a0dbf8c8c0acad761e513199d466ffcf5f1dfbc014d04784ce",
    (1025, 4097): "eb81fc040aee011766ab74b6668e799965f162edadff72e890e83abccee71830",
    (5, 100003): "2787ee7835706b07e3faf34a4eee2e82ce09cec17d17c8211bc5b31e8ead817a",
    (20000, 20000): "2f3d703da1137b48f5478bca77969da94ca310decf6ccd4c085c17be77405b8b",
    (50000, 50000): "def4c870399f3879cfdd5fdc0dcac93bb7cd530b6b65c4a514234f3ada61a04c",
}
#: The bound counts FP32 instructions: 3 FSUB, 1 FMUL, 2 FFMA and 1 FMNMX
#: per (a, b) pair, against the H100 SXM's 67 TFLOP/s float32 peak, which
#: counts an FMA as two (33.5e12 instructions a second); bytes at 3.35 TB/s.
PAIR_INSTRUCTIONS = 7
FP32_INSTRUCTIONS_PER_S = 67e12 / 2
HBM_BYTES_PER_S = 3.35e12

#: (cloud kind, N, M, k) of the knn checks: small, degenerate and ragged
#: shapes (N = 1, M < k, M = 0, one block's worth and one more), clouds of
#: duplicated points and an integer lattice (exact ties by the thousand), and
#: the evaluation path's shapes: the NN statistics (50k x 50k, k = 2), ICP
#: (k = 1), the surface metrics' neighbourhoods (k = 20) and the mesh
#: colours (k = 1, many queries against more voxels).  Exact ties come at
#: k = 1 (the lattice lookups rely on the lower index there) and at every
#: other capacity on the path or not (7 and 12: capacities 8 and 16).  Above
#: ``KNN_PLAIN_PAIRS`` pairs the plain version takes a seeded choice of the
#: queries against all of B.
KNN_CASES = (
    ("normal", 777, 1311, 1), ("normal", 19, 1000, 2), ("normal", 100, 1, 3), ("normal", 100, 0, 2),
    ("normal", 1, 5000, 20), ("normal", 1025, 4097, 20), ("normal", 5, 100003, 32), ("normal", 300, 3, 5),
    ("normal", 129, 2048, 7), ("duplicates", 1000, 3000, 20), ("duplicates", 257, 100, 2),
    ("duplicates", 1000, 3000, 1), ("grid", 4096, 4096, 1), ("grid", 20000, 64000, 1),
    ("grid", 4096, 4096, 7), ("grid", 4096, 4096, 12), ("grid", 20000, 64000, 20),
    ("normal", 50000, 50000, 2), ("normal", 100000, 100000, 1), ("normal", 120000, 120000, 20),
    ("normal", 400000, 1400000, 1),
)
KNN_PLAIN_PAIRS = 1 << 33
#: Cloud kinds whose ties are exact, where no index may differ.
KNN_EXACT_KINDS = ("grid", "duplicates")
#: Share of a case's entries whose index may differ from the plain version's
#: at a near tie.
KNN_NEAR_TIE_SHARE = 1e-4
#: (N, M, k) timed: the NN statistics' shape, the surface metrics' one, an
#: ICP's and the mesh colours' (185,750 vertices against 1,450,802 voxels).
#: All are timed whole; above ``KNN_PLAIN_PAIRS`` pairs the yardstick, like
#: the plain version, takes one repetition a turn.
KNN_TIMED = ((50000, 50000, 2), (120000, 120000, 20), (100000, 100000, 1), (185750, 1450802, 1))

FIXTURE2 = REPO / "tests/fixtures/torch_port_Bibi_512_stage2.npz"
VIEWS = ("front", "drone")
#: Candidate IoUs, port vs JAX on the same cameras: equal but for pixels on
#: a rounding tie, each of which moves an IoU by about 1/union.
BATCH_IOU_ATOL = 1e-3
#: The keypoint fit may not end worse than the JAX package's.
LM_LOSS_RTOL = 1e-3
#: Final IoU of a run on the JAX draws vs the JAX run's; of a run on the
#: port's own generator vs the worst of five JAX seeds.  The search is
#: chaotic in its start: JAX itself, started 0.5 off its drone keypoint
#: fit, ends 0.03 below its seed-0 IoU.
FINAL_IOU_ATOL = 0.01

FIXTURE3 = REPO / "tests/fixtures/torch_port_Bibi_512_stage3.npz"
#: Score components of a candidate batch and nb4 cells, port vs JAX on the
#: same deforms: equal but for rounding-tie pixels, each worth ~1/union.
COMP_ATOL = 1e-3
#: The picked exact nb4 total may end at most this far below the JAX run's.
NB4_TOTAL_ATOL = 0.01
#: ``enforce_no_regression``'s own tolerances (parts 1e-6).
NB4_TOL = {"whole": 0.01, "minarets": 0.005}

STUDY = REPO / "tests/fixtures/torch_port_study.npz"
#: Phase 7's two configurations: what ``run_all_body`` is given, and the
#: committed results of the JAX package at that resolution.
STUDY_RUNS = {
    "golden": dict(results=REPO / "results_temp_golden", kw=dict(max_dim=None)),
    "256": dict(results=REPO / "results_temp", kw=dict(
        max_dim=256, stage2_kw=dict(generations=12, population=192, seed=0),
        stage3_kw=dict(search_stride=8))),
}
#: Bibi's final front IoU in the golden study may end this far below the
#: serial stage 2's of phase 5 (another search schedule on the same view).
STUDY_FRONT_IOU_ATOL = 0.01


EVAL = REPO / "tests/fixtures/torch_port_eval.json"
#: Notebook-4 cells, port vs JAX as printed: a pixel on a rounding tie moves
#: an IoU by about 1/union, a reprojection error (2 decimals) not at all.
NB4_IOU_ATOL = 1e-3
NB4_PX_ATOL = 1e-2
#: Every knn use vs a float64 cKDTree on the same float32 points.
KD_KNN_RTOL = 1e-4
#: ICP's 4x4 transform vs a float64 cKDTree ICP and vs the JAX package's, on
#: clouds of unit size with 0.002 of noise: float32 correspondences may pick
#: another of two near-equal neighbours, and thirty iterations carry that on.
ICP_T_ATOL = 1e-3
#: The Gaussian vs scipy's, relative to the grid's largest value.
GAUSS_RTOL = 2e-5
#: The notebook-5 inputs: seed, points of the SfM stand-in, its noise, the
#: stride of the CAD stand-in's mesh and its surface samples, the table's τ,
#: and the surface metrics' grid, neighbours and vertex filter (vertices
#: above it, the ground-most eighth of the wrapped y axis, are dropped).
NB5 = dict(seed=0, sparse_points=100_000, noise=0.002, mesh_stride=2, cad_samples=50_000, tau=0.03,
           grid_size=128, k=20, y_thresh=0.9)
NB5_CLOUDS = ("Sparse", "Completed (ICP Aligned)", "Carved Grid", "Stage-3 Model", "Synthetic")

PRESETS = REPO / "tests/fixtures/torch_port_presets.npz"
#: Phase 9's test preset (not a user configuration): group sweeps whose
#: angles differ from the global 90°, which the fused route refuses and the
#: unfused ``carve_monument`` takes; the reference's part symmetry and
#: extrusion depths.
OTHER_ANGLE_GROUPS = (
    (("full_building",), 90), (("chhatris",), 45), (("plinth",), 90),
    (("front_minarets",), 30), (("small_minarets",), 30), (("dome",), 15),
)
#: Bit-exact rotation angles of phase 9 on the Bibi@512 grid.
ROTATE_ANGLES = (5.0, 45.0, 90.0, 137.0)


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def query_card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def load_wrapper(root: Path):
    """The ``cuda_kernels`` module of another checkout at ``root`` (an A/B
    script's parent); it builds its kernels the way that checkout did."""
    spec = importlib.util.spec_from_file_location(
        "parent_cuda_kernels", root / "pbr3d_torch" / "ops" / "cuda_kernels.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_inputs(n: int, m: int):
    """Seeded (n, 3) and (m, 3) float32 clouds, the same in every run."""
    rng = np.random.default_rng([0, n, m])
    return rng.normal(size=(n, 3)).astype(np.float32), rng.normal(size=(m, 3)).astype(np.float32)


def sha256(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def min_dist2_bound(n: int, m: int):
    """(least ms, "operations" or "bytes") of min_dist2 at n x m on an H100."""
    ops_s = n * m * PAIR_INSTRUCTIONS / FP32_INSTRUCTIONS_PER_S
    bytes_s = (12 * n + 12 * m + 4 * n) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s else "bytes")


def min_dist2_library(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """The yardstick: one PyTorch call for the same function (timed only)."""
    return torch.cdist(A, B).amin(dim=1).square_()


@contextlib.contextmanager
def smi_samples(out: list):
    """Appends (SM clock MHz, power W) samples of the card, every 50 ms,
    while the block runs."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
         "-lms", "50"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        yield
    finally:
        proc.terminate()
        for line in proc.communicate(timeout=10)[0].splitlines():
            with contextlib.suppress(ValueError):
                out.append(tuple(float(v) for v in line.split(",")[:2]))


def smi_summary(samples: list) -> str:
    if not samples:
        return "clock/power not sampled"
    clk, watts = np.array(samples).T
    return (f"sm_clock_mhz min/median/max={clk.min():.0f}/{np.median(clk):.0f}/{clk.max():.0f} "
            f"power_w min/median/max={watts.min():.1f}/{np.median(watts):.1f}/{watts.max():.1f} "
            f"({len(samples)} samples)")


def time_in_turns(fns: dict, reps: dict, order: list) -> dict:
    """CUDA-event ms of each named function, taken in the given order of
    names (e.g. a, b, b, a) after one warm-up call of each."""
    for fn in fns.values():
        fn()
    times: dict = {name: [] for name in fns}
    for name in order:
        times[name].append(cuda_ms(fns[name], reps[name]))
    return times


def phase_kernel() -> dict:
    """The kernel against its plain version and the reference hashes at every
    shape, then timed at the main-path shapes beside the plain version and
    the library call."""
    max_abs = 0.0
    for n, m in KERNEL_SHAPES:
        A, B = (torch.from_numpy(x).cuda() for x in kernel_inputs(n, m))
        k = min_dist2_kernel(A, B)
        p = min_dist2_plain(A, B)
        torch.cuda.synchronize()
        check(k.shape == (n,) and k.dtype == torch.float32, f"kernel output {k.shape} {k.dtype}")
        digest = sha256(k)
        same = digest == REFERENCE_SHA256.get((n, m))
        if m == 0:
            check(bool(torch.isinf(k).all()) and bool((k > 0).all()), "M = 0 must give +inf")
            log(f"kernel_vs_plain {n}x{m}: all +inf sha256_equal={same}")
        else:
            check(bool(torch.isfinite(k).all()), f"non-finite kernel output at {n}x{m}")
            err = (k - p).abs()
            rel = float((err / p.abs().clamp_min(1e-30)).max())
            max_abs = max(max_abs, float(err.max()))
            log(f"kernel_vs_plain {n}x{m}: max_abs_err={float(err.max()):.3e} "
                f"max_rel_err={rel:.3e} tol_rel={KERNEL_RTOL:g} sha256_equal={same}")
            check(rel <= KERNEL_RTOL, f"kernel disagrees with plain at {n}x{m}: rel {rel}")
        check(same, f"kernel output at {n}x{m} hashes {digest}, not the reference design's")

    out = {"max_abs_err": max_abs}
    for n, m in TIMED_SHAPES:
        A, B = (torch.from_numpy(x).cuda() for x in kernel_inputs(n, m))
        samples: list = []
        with smi_samples(samples):
            t = time_in_turns(
                {"plain": lambda: min_dist2_plain(A, B), "kernel": lambda: min_dist2_kernel(A, B),
                 "library": lambda: min_dist2_library(A, B)},
                {"plain": 3, "kernel": 20 if n * m > 1e9 else 50, "library": 3},
                ["plain", "kernel", "library", "library", "kernel", "plain"])
        torch.cuda.empty_cache()
        bound, bound_by = min_dist2_bound(n, m)
        ms, plain_ms, library_ms = (float(np.mean(t[k])) for k in ("kernel", "plain", "library"))
        log(f"min_dist2 {n}x{m}: kernel_ms={t['kernel']} plain_ms={t['plain']} "
            f"library_ms={t['library']} bound_ms={bound:.4f} ({bound_by}) "
            f"share_of_bound={bound / ms:.3f}; {smi_summary(samples)}")
        tag = "" if (n, m) == TIMED_SHAPES[-1] else f"_{n // 1000}k"
        out.update({f"ms{tag}": ms, f"plain_ms{tag}": plain_ms, f"bound_ms{tag}": bound,
                    f"library_ms{tag}": library_ms, "bound_by": bound_by})
    return out


def knn_bound(n: int, m: int, k: int):
    """(least ms, "operations" or "bytes") of knn at n x m, k on an H100: the
    distance and the compare against the list's last entry, 7 FP32
    instructions a pair as for min_dist2 (3 FSUB, 1 FMUL, 2 FFMA, 1 FSETP);
    the list upkeep, which depends on the order of the data, is left out, so
    the bound errs low."""
    ops_s = n * m * PAIR_INSTRUCTIONS / FP32_INSTRUCTIONS_PER_S
    bytes_s = (12 * n + 12 * m + 12 * n * k) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s else "bytes")


def knn_library(A: torch.Tensor, B: torch.Tensor, k: int):
    """The yardstick: ``torch.cdist`` + ``topk``, over row tiles of A so that
    the distance matrix fits (timed only)."""
    rows = max(1, (1 << 28) // max(1, B.shape[0]))
    parts = [torch.cdist(A[i : i + rows], B).topk(k, dim=1, largest=False) for i in range(0, A.shape[0], rows)]
    return torch.cat([p.values for p in parts]).square_(), torch.cat([p.indices for p in parts])


def knn_inputs(kind: str, n: int, m: int):
    """Seeded float32 clouds on the card: "normal" as ``kernel_inputs``;
    "duplicates" draws both from 64 distinct points, so distances tie exactly
    and by the hundred; "grid" is an integer lattice queried by itself."""
    if kind == "grid":
        side = round(m ** (1 / 3))
        G = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3).astype(np.float32)
        A, B = G[:n], G
    else:
        A, B = kernel_inputs(n, m)
        if kind == "duplicates":
            rng = np.random.default_rng([1, n, m])
            pool = rng.normal(size=(64, 3)).astype(np.float32)
            A, B = pool[rng.integers(0, 64, n)], pool[rng.integers(0, 64, m)]
    return torch.from_numpy(np.ascontiguousarray(A)).cuda(), torch.from_numpy(np.ascontiguousarray(B)).cuda()


def knn_agrees(A, B, k, got, ref, what: str, exact: bool = False) -> float:
    """Holds a (distances², indices) pair against the plain version's:
    distances to ``KERNEL_RTOL``; indices equal, except that where the
    kernel's neighbour lies within that tolerance of the plain one's distance
    (a near tie, decided the other way by the kernel's fused multiply-adds)
    the entry is counted; the count is bounded by ``KNN_NEAR_TIE_SHARE``.
    ``exact`` (coordinates on which both are exact) allows none.  Returns the
    largest absolute error of a finite distance."""
    (d, i), (pd, pi) = got, ref
    n = A.shape[0]
    check(d.shape == (n, k) and d.dtype == torch.float32 and i.shape == (n, k) and i.dtype == torch.int64,
          f"knn {what}: output {tuple(d.shape)} {d.dtype} {tuple(i.shape)} {i.dtype}")
    if d.numel() == 0:
        return 0.0
    finite = torch.isfinite(pd)
    check(bool((torch.isfinite(d) == finite).all()), f"knn {what}: other entries are infinite")
    check(B.shape[0] == 0 or bool(((i >= 0) & (i < B.shape[0])).all()), f"knn {what}: index out of range")
    check(bool((d[:, 1:] >= d[:, :-1]).all()), f"knn {what}: distances not ascending")
    err = torch.where(finite, (d - pd).abs(), torch.zeros_like(d))
    rel = float((err / pd.abs().clamp_min(1e-30)).max()) if bool(finite.any()) else 0.0
    unequal = i != pi
    count = int(unequal.sum())
    if count:
        at = torch.where(unequal, i, pi)  # the kernel's neighbour, by the plain arithmetic
        diff = A[:, None, :] - B[at]
        again = diff[..., 0].square() + diff[..., 1].square() + diff[..., 2].square()
        near = (again - pd).abs() <= KERNEL_RTOL * pd.abs() + 1e-30
        check(bool((near | ~unequal).all()), f"knn {what}: an index differs that is no near tie")
    log(f"knn_vs_plain {what}: max_abs_err={float(err.max()):.3e} max_rel_err={rel:.3e} tol_rel={KERNEL_RTOL:g} "
        f"indices_unequal={count} of {i.numel()} (near ties; at most "
        f"{0 if exact else int(KNN_NEAR_TIE_SHARE * i.numel()) + 1})")
    check(rel <= KERNEL_RTOL, f"knn {what}: distances disagree with plain: rel {rel}")
    check(count <= (0 if exact else int(KNN_NEAR_TIE_SHARE * i.numel()) + 1),
          f"knn {what}: {count} indices differ from the plain version's")
    return float(err.max())


def phase_knn_kernel() -> dict:
    """``knn_kernel`` against ``knn_plain`` at every case of ``KNN_CASES``,
    then timed at ``KNN_TIMED`` beside the plain version and the library
    yardstick."""
    max_abs = 0.0
    for kind, n, m, k in KNN_CASES:
        A, B = knn_inputs(kind, n, m)
        q = A if n * m <= KNN_PLAIN_PAIRS else A[torch.from_numpy(
            np.random.default_rng(0).choice(n, KNN_PLAIN_PAIRS // m, replace=False)).cuda()].contiguous()
        got, ref = knn_kernel(q, B, k), knn_plain(q, B, k)
        torch.cuda.synchronize()
        what = f"{kind} {q.shape[0]}x{B.shape[0]} k={k}"
        max_abs = max(max_abs, knn_agrees(q, B, k, got, ref, what, exact=kind in KNN_EXACT_KINDS))
        if k == 1 and m:
            check(torch.equal(got[0][:, 0], min_dist2_kernel(q, B)), f"knn {what}: k = 1 is not min_dist2's bits")
    out = {"max_abs_err": max_abs}
    for n, m, k in KNN_TIMED:
        A, B = knn_inputs("normal", n, m)
        samples: list = []
        with smi_samples(samples):
            t = time_in_turns(
                {"plain": lambda: knn_plain(A, B, k), "kernel": lambda: knn_kernel(A, B, k),
                 "library": lambda: knn_library(A, B, k)},
                {"plain": 1, "kernel": 10, "library": 1 if n * m > KNN_PLAIN_PAIRS else 2},
                ["plain", "kernel", "library", "library", "kernel", "plain"])
        torch.cuda.empty_cache()
        bound, bound_by = knn_bound(n, m, k)
        ms, plain_ms, library_ms = (float(np.mean(t[key])) for key in ("kernel", "plain", "library"))
        log(f"knn {n}x{m} k={k}: kernel_ms={t['kernel']} plain_ms={t['plain']} "
            f"library_ms={t['library']} bound_ms={bound:.4f} ({bound_by}) "
            f"share_of_bound={bound / ms:.3f}; {smi_summary(samples)}")
        tag = "" if (n, m, k) == KNN_TIMED[0] else f"_{n // 1000}k_k{k}"
        out.update({f"ms{tag}": ms, f"plain_ms{tag}": plain_ms, f"bound_ms{tag}": bound,
                    f"library_ms{tag}": library_ms, "bound_by": bound_by})
    return out


def phase_stage1(fx):
    """Returns the fused route's grid and its (cold, warm) seconds."""
    colored = rgb_to_labels(np.load(ORACLE)["colored"])
    g = global_carve(fx["binary"], fx["exterior_labels"], 90, device="cuda").cpu().numpy()
    check(np.array_equal(g, colored),
          f"global_carve vs reference oracle: {int((g != colored).sum())} voxels differ")
    log(f"stage1 global_carve 512: bit-exact vs reference oracle {g.shape}")

    masks = MaskSet.from_labels(fx["binary"], fx["exterior_labels"], fx["semantic_labels"])
    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):  # cold, warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid = carve_monument_fused(masks, device="cuda")
        times.append(time.perf_counter() - t0)
        diff = int((grid != fx["grid"]).sum()) if grid.shape == fx["grid"].shape else -1
        check(diff == 0, f"carve_monument_fused vs JAX fixture: {diff} voxels differ")
    peak = torch.cuda.max_memory_allocated()
    log(f"stage1 carve_monument_fused 512: bit-exact vs JAX grid {grid.shape}, "
        f"occupied={int((grid > 0).sum())} cold_s={times[0]:.3f} warm_s={times[1]:.3f} "
        f"peak_mem_bytes={peak}")

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "1.Orthographic_Voxel_Carving" / "Bibi_voxel_grid.npz"
        save_voxel_grid(path, grid)
        check(np.array_equal(load_voxel_grid_labels(path), grid), "saved grid does not round-trip")
    log("stage1 artifact: saved and reloaded in the reference layout")
    return grid, times


def phase_metrics(fx, grid: np.ndarray) -> int:
    """The notebook-5 metrics of the stage-1 cloud against the committed
    stage-3 model, held against cKDTree and JAX; then the metrics once more
    under the profiler for the kernel's device time.  Returns the kernel's
    launches up to the end of the first run."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = load_voxel_grid_labels(STAGE3)
    decode = time.perf_counter() - t0
    A = inter.normalize_preserve_aspect(all_points(grid, device="cuda")[0], device="cuda")
    B = inter.normalize_preserve_aspect(all_points(model, device="cuda")[0], device="cuda")

    def metrics():
        return (inter.chamfer_distance(A, B, device="cuda"),
                np.asarray(inter.fscore_with_threshold(A, B, float(fx["tau"]), device="cuda")),
                np.stack(inter.compute_f1_curve(A, B, fx["thresholds"], device="cuda")))

    chamfer, fscore, curve = metrics()
    secs = time.perf_counter() - t0
    launches = min_dist2_kernel.launches
    log(f"metrics: clouds {tuple(A.shape)} vs {tuple(B.shape)}, {secs:.3f} s "
        f"(of it {decode:.3f} s decoding the stage-3 artifact)")
    log(f"metrics: chamfer={chamfer!r} kd={float(fx['kd_chamfer'])!r} jax={float(fx['jax_chamfer'])!r}")
    log(f"metrics: fscore(f1,p,r)={fscore.tolist()} kd={fx['kd_fscore'].tolist()} "
        f"jax={fx['jax_fscore'].tolist()}")
    log(f"metrics: f1_curve max |port-kd|={float(np.abs(curve - fx['kd_f1_curve']).max()):.3e} "
        f"max |port-jax|={float(np.abs(curve - fx['jax_f1_curve']).max()):.3e}")
    check(abs(chamfer - float(fx["kd_chamfer"])) <= KD_CHAMFER_RTOL * float(fx["kd_chamfer"]),
          "chamfer vs cKDTree")
    check(np.allclose(fscore, fx["kd_fscore"], rtol=0, atol=KD_F_ATOL), "F-score vs cKDTree")
    check(np.allclose(curve, fx["kd_f1_curve"], rtol=0, atol=KD_F_ATOL), "F1 curve vs cKDTree")
    check(abs(chamfer - float(fx["jax_chamfer"])) <= JAX_RTOL * float(fx["jax_chamfer"]),
          "chamfer vs JAX")
    check(np.allclose(fscore, fx["jax_fscore"], rtol=JAX_RTOL, atol=0), "F-score vs JAX")
    check(np.allclose(curve, fx["jax_f1_curve"], rtol=JAX_RTOL, atol=0), "F1 curve vs JAX")

    wall, busy, top, _ = _device_profile(metrics)
    mine = [(ms, k) for name, ms, k in top if "min_dist2" in name]
    log(f"metrics profiled (decode and points excluded): wall_s={wall:.4f} device_busy_s={busy:.4f} "
        f"min_dist2 device_ms={sum(ms for ms, _ in mine):.4f} over {sum(k for _, k in mine)} launches")
    return launches


def _device_profile(fn):
    """(wall s, device-busy s, top kernels [(name, ms, launches)], every
    kernel's (ms, launches) by name) of ``fn()`` under ``torch.profiler``:
    busy is the union of the kernels' intervals.  Only the device is traced
    (a long multi-threaded run's host events are many and are not read
    here)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the trace's own records, not ``prof.events()``: building the event tree
    # of a study's ~1.5 M launches takes minutes, and only the device
    # intervals are read here
    kernels = [(e.start_ns(), e.end_ns(), e.name()) for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
    busy, end = 0, -1
    for a, b, _ in sorted(kernels):
        busy += max(0, b - max(a, end))
        end = max(end, b)
    by_name: dict = {}
    for a, b, name in kernels:
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (b - a) / 1e6, n + 1)
    top = sorted(((k, *v) for k, v in by_name.items()), key=lambda r: -r[1])[:8]
    return wall, busy / 1e9, top, by_name


def phase_stage2(fx2, grid: np.ndarray, device: str = "cuda") -> dict:
    """Returns the final IoU per view of the body as a user runs it."""
    views = {v: fx2[f"{v}_mask"] for v in VIEWS}
    draws = {s: fx2[f"draws_{s}"] for s in (0, 1, 3)}
    ids = config.part_ids(ALIGN_PARTS)
    grid_dev = torch.as_tensor(grid, device=device)
    shell = surface_points_by_parts(grid_dev, ALIGN_PARTS, device=device)
    log(f"stage2 shell: {shell[0].shape[0]} points of {list(ALIGN_PARTS)}")
    for v in VIEWS:
        gt = torch.as_tensor(mask_labels_selected(views[v], ALIGN_PARTS), device=device)
        cams = torch.as_tensor(fx2[f"{v}_batch"], device=device)
        ious = _batch_iou(cams, *shell, gt, ids, *views[v].shape).cpu().numpy()
        err = np.abs(ious - fx2[f"{v}_batch_iou"])
        ms = cuda_ms(lambda: _batch_iou(cams, *shell, gt, ids, *views[v].shape), 10)
        log(f"stage2 {v} candidate batch {cams.shape[0]} cams on {views[v].shape}: "
            f"max_abs_err={err.max():.3e} unequal={int((err > 0).sum())} "
            f"tol={BATCH_IOU_ATOL:g} best={ious.max():.6f} batch_ms={ms:.3f}")
        check(err.max() <= BATCH_IOU_ATOL, f"{v}: candidate IoUs vs JAX off by {err.max()}")

        vk, ik = extract_minaret_kps_for_view(grid, views[v])
        init = auto_compute_initial_params_matching_bbox(grid_dev, views[v], ALIGN_PARTS, device=device)
        check(np.array_equal(params_to_vector(init), fx2[f"{v}_init"]), f"{v}: bbox init vs JAX")
        t0 = time.perf_counter()
        kp = optimize_camera_with_keypoints(vk, ik, views[v].shape, init, device=device)
        secs = time.perf_counter() - t0
        ref = float(fx2[f"{v}_kp_loss"])
        log(f"stage2 {v} keypoints={len(ik)} lm_loss={kp['loss']!r} jax={ref!r} "
            f"|dx|={np.linalg.norm(params_to_vector(kp) - fx2[f'{v}_kp']):.4f} lm_s={secs:.3f} "
            f"kp={params_to_vector(kp).tolist()}")
        check(kp["loss"] <= ref * (1 + LM_LOSS_RTOL), f"{v}: LM loss {kp['loss']} vs JAX {ref}")

    def report(tag, cams, ious):
        """Log each view's final IoU against the JAX run's; the returned IoU
        must be the final camera's score on the search objective."""
        for v in cams["final"]:
            final = cams["final"][v]
            gt = torch.as_tensor(mask_labels_selected(views[v], ALIGN_PARTS), device=device)
            rescored = float(_batch_iou(torch.as_tensor(params_to_vector(final), device=device)[None],
                                        *shell, gt, ids, *views[v].shape)[0])
            solid = evaluate_camera_iou(grid_dev, views[v], ALIGN_PARTS, final, device=device)
            log(f"stage2 {v} {tag}: final_iou={ious[v]!r} jax={float(fx2[f'{v}_final_iou'])!r} "
                f"rescored={rescored!r} solid_iou={solid!r} "
                f"jax_solid={float(fx2[f'{v}_final_solid_iou'])!r} "
                f"cameras_identical={np.array_equal(params_to_vector(final), fx2[f'{v}_final'])}")
            check(rescored == ious[v], f"{v}: returned IoU {ious[v]} re-scores as {rescored}")

    def above_seed_floor(ious):
        for v in VIEWS:
            floor = float(fx2[f"{v}_seed_ious"].min())
            log(f"stage2 {v}: final_iou={ious[v]!r} vs jax_seeds={fx2[f'{v}_seed_ious'].tolist()}")
            check(ious[v] >= floor - FINAL_IOU_ATOL, f"{v}: own-generator IoU {ious[v]} < {floor}")

    torch.cuda.reset_peak_memory_stats()
    for v in VIEWS:  # the body on the JAX draws, one view at a time: cold, warm
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cams, ious = run_stage2_views("Bibi", grid, {v: views[v]}, draws=draws, device=device)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        log(f"stage2 {v} body cold_s={times[0]:.3f} warm_s={times[1]:.3f}")
        report("jax-draws", cams, ious)
    log(f"stage2 peak_mem_bytes={torch.cuda.max_memory_allocated()}")

    # The keypoint fit's objective has a near-flat ridge, and float32 steps
    # taken in another order end elsewhere on it (the JAX fit itself moves
    # by ~0.02 for a 1e-6 change of its init), which sends the searches down
    # other paths.  Given the JAX fit, the body must follow the JAX run.
    def jax_kp(vox_kps, img_kps, hw, init, device):
        v = next(v for v in VIEWS if views[v].shape[:2] == tuple(hw))
        return {**vector_to_params(fx2[f"{v}_kp"].astype(np.float64)), "loss": float(fx2[f"{v}_kp_loss"])}

    with mock.patch.object(pipeline, "optimize_camera_with_keypoints", jax_kp):
        cams, ious = run_stage2_views("Bibi", grid, views, draws=draws, device=device)
        report("jax-draws+jax-kp", cams, ious)
        for v in VIEWS:
            check(abs(ious[v] - float(fx2[f"{v}_final_iou"])) <= FINAL_IOU_ATOL,
                  f"{v}: final IoU {ious[v]} vs JAX {float(fx2[f'{v}_final_iou'])} from the same kp fit")
        cams, ious = run_stage2_views("Bibi", grid, views, device=device)  # the port's own generator
        report("own-generator+jax-kp", cams, ious)
        above_seed_floor(ious)

    # The main path as a user runs it: the port's own generator and fit,
    # both views, the artifacts, under the profiler.
    with tempfile.TemporaryDirectory() as tmp:
        out: dict = {}
        wall, busy, top, _ = _device_profile(lambda: out.update(zip(
            ("cams", "ious"), run_stage2_views("Bibi", grid, views, tmp, device=device))))
        log(f"stage2 profiled body (both views, own generator): wall_s={wall:.3f} "
            f"device_busy_s={busy:.4f} busy_share={busy / wall:.4f}")
        for name, ms, n in top:
            log(f"stage2   kernel {ms:9.2f} ms  x{n:<6d} {name[:90]}")
        report("own-generator", out["cams"], out["ious"])
        above_seed_floor(out["ious"])
        for tag, params in out["cams"].items():
            path = Path(tmp) / "2.Perspective_Camera_Estimation" / f"Bibi_camera_params_{tag}.json"
            raw = json.loads(path.read_text())
            check(sorted(raw) == sorted(VIEWS), f"{tag} JSON views {sorted(raw)}")
            for v in VIEWS:
                back = load_camera_json(path, v)
                check(np.allclose(params_to_vector(back), params_to_vector(params[v]), rtol=1e-6),
                      f"{tag}/{v} JSON does not read back")
                keys = ["cam_pos", "target", "f", "cx", "cy"] + (["H", "W"] if tag == "final" else [])
                check(list(raw[v]) == keys, f"{tag}/{v} JSON keys {list(raw[v])}")
        log("stage2 artifacts: init/kp/final camera JSONs saved and read back in the reference layout")
    return out["ious"]


def _unequal(ours: np.ndarray, ref: np.ndarray):
    """(unequal pixels, of them finite depths one float32 ulp apart)."""
    diff = ours != ref
    both = diff & np.isfinite(ours) & np.isfinite(ref)
    ulps = np.abs(ours[both].view(np.int32).astype(np.int64) - ref[both].view(np.int32).astype(np.int64))
    return int(diff.sum()), int((ulps <= 1).sum())


def _prof_totals(text: str) -> dict:
    """Seconds and count per ``[prof]`` phase, per-part names folded."""
    out: dict = {}
    for name, secs in re.findall(r"\[prof\] (\S+): ([\d.]+)s", text):
        name = re.sub(r"^opd\.[^.]+\.", "opd.", name)
        name = re.sub(r"^(refine_parts\.(search|resweep\d+))\..*", r"\1", name)
        s, n = out.get(name, (0.0, 0))
        out[name] = (s + float(secs), n + 1)
    return out


def phase_stage3(fx3, fx2, grid: np.ndarray, device: str = "cuda") -> None:
    mask = fx2["front_mask"]
    cam = vector_to_params(fx2["front_final"].astype(np.float64))
    H, W = mask.shape
    padded = np.pad(grid, ((0, 0), (0, config.STAGE3_PAD["Bibi"]), (0, 0)))
    cam_vec = torch.as_tensor(params_to_vector(cam), device=device)

    # 1. the point table
    table = build_point_table(padded, device=device)
    for k in ("counts", "shell_counts", "sums"):
        check(np.array_equal(getattr(table, k), fx3[f"table_{k}"]), f"point table {k} vs JAX")
    dome = config.PART_IDS["dome"]
    n_shell = table.shell_count(dome)
    coarse = table.shell_window(dome, max(4, -(-n_shell // 24576)))
    fine = table.shell_window(dome, max(2, -(-n_shell // 65536)))
    check(np.array_equal(coarse.cpu().numpy(), fx3["dome_coarse_shell"]), "dome coarse shell vs JAX")
    check(fine.shape[0] == int(fx3["dome_r_n"]), f"dome fine shell {fine.shape[0]} points")
    log(f"stage3 table: {table.n} points, counts/shell counts/sums equal to JAX; "
        f"dome shells coarse {coarse.shape[0]} fine {fine.shape[0]}")

    # 2. identity z-buffers of every present part
    parts = [str(p) for p in fx3["zb_parts"]]
    zb = search.all_part_zbuffers(table.coords, table.labels, params_to_vector(cam), parts, (H, W))
    ms = cuda_ms(lambda: search.all_part_zbuffers(table.coords, table.labels,
                                                  params_to_vector(cam), parts, (H, W)), 3)
    total, ties = 0, 0
    for i, p in enumerate(parts):
        n, t = _unequal(zb[p][:H, :W], fx3["zb_identity"][i])
        total, ties = total + n, ties + t
    log(f"stage3 identity z-buffers of {len(parts)} parts: unequal_px={total} "
        f"of_them_one_ulp_ties={ties} ms={ms:.3f}")
    check(total == ties, f"identity z-buffers: {total - ties} pixels differ beyond a rounding tie")

    # 3. three candidate batches of the JAX run's dome search
    center = torch.as_tensor(np.asarray(table.center(dome), np.float32), device=device)
    common = dict(cam_vec=cam_vec, image_hw=(H, W), voxel_shape=padded.shape, center=center,
                  gt_part=torch.as_tensor(mask == dome, device=device),
                  rest_zbuf=torch.as_tensor(fx3["dome_rest"], device=device))
    nb = {f"nb_{k}": torch.as_tensor(fx3[f"dome_nb_{k}"], device=device)
          for k in ("zb", "base", "gt", "floor", "valid")}
    da = torch.as_tensor(fx3["dome_a_deforms"], device=device)
    dr = torch.as_tensor(fx3["dome_r_deforms"], device=device)
    batches = (
        ("coarse-A plain", lambda: search._batch_deform_visible_iou(
            da, coarse, approx=True, **common), fx3["dome_a_comps"][:, 0]),
        ("coarse-A penalized", lambda: search._batch_deform_visible_iou_penalized(
            da, coarse, approx=True, **common, **nb), fx3["dome_a_comps"]),
        ("exact refine penalized", lambda: search._batch_deform_visible_iou_penalized(
            dr, fine, approx=False, **common, **nb), fx3["dome_r_comps"]),
    )
    for name, fn, ref in batches:
        err = np.abs(fn().cpu().numpy() - ref)
        ms = cuda_ms(fn, 5)
        log(f"stage3 dome {name} batch {ref.shape[0]} deforms: max_abs_err={err.max():.3e} "
            f"unequal={int((err > 0).sum())} of {err.size} tol={COMP_ATOL:g} batch_ms={ms:.3f}")
        check(err.max() <= COMP_ATOL, f"dome {name}: components vs JAX off by {err.max()}")

    # 4. the JAX run's final deforms, rebuilt
    final = dict(zip((str(p) for p in fx3["final_parts"]), fx3["final_deforms"]))
    points = {p: table.part_window(config.PART_IDS[p]) for p in final}
    centers = {p: table.center(config.PART_IDS[p]) for p in final}
    order = [p for p in config.PART_NAMES if p in final]

    def rebuild():
        return build_deformed_grid_fused(points, final, centers, (H, W), padded.shape, order)

    built = rebuild().cpu().numpy()
    ms = cuda_ms(rebuild, 3)
    diff = int((built != fx3["deformed"]).sum())
    log(f"stage3 rebuild of the JAX deforms: {int((built > 0).sum())} voxels, "
        f"{diff} differ from the JAX grid, ms={ms:.3f}")
    check(diff == 0, f"rebuild vs JAX deformed grid: {diff} voxels differ")
    present = [p for p in config.PART_NAMES if p != "background" and table.count(config.PART_IDS[p])]
    cells = verify._nb4_state(padded, built, mask, cam, parts=present, device=device)[0]
    ref_cells = {str(k): (a, b) for k, a, b in zip(fx3["nb4_cells"], fx3["nb4_init"], fx3["nb4_def"])}
    check(list(cells) == list(ref_cells), f"nb4 rows {list(cells)}")
    err = max(abs(cells[k][j] - ref_cells[k][j]) for k in cells for j in (0, 1))
    log(f"stage3 nb4 cells of the rebuilt grid: max_abs_err={err:.3e} tol={COMP_ATOL:g}")
    check(err <= COMP_ATOL, f"nb4 cells vs JAX off by {err}")

    # 5. the whole body at its golden defaults
    totals: list = []
    nb4_state = verify._nb4_state

    def nb4_recorded(*a, **k):
        res = nb4_state(*a, **k)
        totals.append(sum(d for _, d in res[0].values()))
        return res

    def body(out_dir=None):
        return run_stage3_body("Bibi", grid, mask, mask, cam, out_dir, device=device)

    err_text = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        with mock.patch.object(verify, "_nb4_state", nb4_recorded), \
                mock.patch.object(profiling, "PROFILE", True), contextlib.redirect_stderr(err_text):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            deforms, deformed = body(tmp)
            torch.cuda.synchronize()
            cold = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        base = Path(tmp) / "3.Part-wise_3D_Refinement"
        check(np.array_equal(load_voxel_grid_labels(base / "Bibi_deformed_voxel_grid.npz"), deformed),
              "deformed grid artifact does not read back")
        saved = json.loads((base / "Bibi_deform_params.json").read_text())
        check(sorted(saved) == sorted(final), f"deform-params parts {sorted(saved)}")
        check(all(list(d) == ["deform", "iou", "gt_px"]
                  and list(d["deform"]) == ["scale_y", "shift_y", "scale_xz", "shift_xz"]
                  for d in saved.values()), "deform-params JSON keys")
        check(saved == json.loads(json.dumps(deforms)), "deform-params JSON does not read back")
    log("stage3 artifacts: deformed grid and deform-params JSON saved and read back "
        "in the JAX package's layout")
    text = err_text.getvalue()
    line = re.search(r"portfolio \[(.*)\] -> (\S+)", text)
    labels = re.findall(r"'(\w+)=", line.group(1)) if line else []
    log(f"stage3 portfolio: {dict(zip(labels, totals[:len(labels)]))} "
        f"pick={line.group(2) if line else None} jax={dict(zip(fx3['portfolio_labels'].tolist(), fx3['portfolio_totals'].tolist()))} "
        f"jax_pick={fx3['portfolio_pick']}")
    for msg in re.findall(r"^\[stage3.*$", text, re.M):
        log(f"stage3 log: {msg}")
    for name, (secs, n) in sorted(_prof_totals(text).items(), key=lambda kv: -kv[1][0]):
        log(f"stage3 [prof] {secs:9.2f} s  x{n:<5d} {name}")

    # the second run of the body, under the profiler
    second: dict = {}
    wall, busy, top, _ = _device_profile(lambda: second.update(zip(("deforms", "grid"), body())))
    log(f"stage3 body cold_s={cold:.3f} peak_mem_bytes={peak}; second run, profiled: "
        f"wall_s={wall:.3f} device_busy_s={busy:.4f} busy_share={busy / wall:.4f}")
    for name, ms, n in top:
        log(f"stage3   kernel {ms:9.2f} ms  x{n:<6d} {name[:90]}")
    check(second["deforms"] == deforms and np.array_equal(second["grid"], deformed),
          "a second run of the body gave other deforms")

    moved = [p for p in final if not np.array_equal(search._deform_vec(deforms[p]["deform"]), final[p])]
    log(f"stage3 final deforms vs JAX: {'identical' if not moved else f'differ in {moved}'}")
    for p in final:
        log(f"stage3   {p:15s} port={search._deform_vec(deforms[p]['deform']).tolist()} iou={deforms[p]['iou']:.4f} "
            f"jax={final[p].tolist()}")
    cells = nb4_state(padded, deformed, mask, cam, parts=present, device=device)[0]
    total = sum(d for _, d in cells.values())
    log(f"stage3 nb4 cells (init, deformed): "
        f"{ {k: (round(a, 4), round(b, 4)) for k, (a, b) in cells.items()} } "
        f"total={total!r} jax_total={float(fx3['nb4_total'])!r}")
    check(total >= float(fx3["nb4_total"]) - NB4_TOTAL_ATOL,
          f"picked nb4 total {total} < JAX {float(fx3['nb4_total'])} - {NB4_TOTAL_ATOL}")
    regressed = [k for k, (a, b) in cells.items() if b + NB4_TOL.get(k, 1e-6) < a]
    check(not regressed, f"nb4 cells regressed: {regressed}")

    whole = gates.stage3_whole_iou(deformed, cam, mask, grid, device=device)
    mean_part = gates.mean_part_iou(deforms)
    log(f"stage3 whole_iou={whole!r} jax={float(fx3['whole_iou'])!r} min={gates.STAGE3_WHOLE_IOU_MIN} "
        f"mean_part_iou={mean_part!r} jax={float(fx3['mean_part_iou'])!r} "
        f"min={gates.STAGE3_MEAN_PART_IOU_MIN}")
    check(whole >= gates.STAGE3_WHOLE_IOU_MIN, f"stage-3 whole IoU {whole}")
    check(mean_part >= gates.STAGE3_MEAN_PART_IOU_MIN, f"stage-3 mean part IoU {mean_part}")


def _refusal(fn) -> str:
    """The message of the ``NotImplementedError`` that ``fn()`` raises, or
    "" when it returns."""
    try:
        fn()
    except NotImplementedError as e:
        return str(e)
    return ""


def phase_stage1_api(fx, fxs, card: str, fused=None, device: str = "cuda") -> None:
    """Phase 9: the unfused stage-1 route and the tooling beside it on the
    card.  ``fused`` is phase 3's (grid, (cold s, warm s)); without it (the
    ``stage1`` mode) the fused route runs here first."""
    fxp = np.load(PRESETS)
    where = f"[{card}]"
    t9 = time.perf_counter()
    masks = MaskSet.from_labels(fx["binary"], fx["exterior_labels"], fx["semantic_labels"])
    if fused is None:
        fused_times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fused_grid = carve_monument_fused(masks, device=device)
            fused_times.append(time.perf_counter() - t0)
        fused = (fused_grid, fused_times)
    fused_grid, fused_times = fused

    def anchored(grid, key, fused_sha256, what):
        """The grid is the JAX unfused route's; it is the fused route's
        exactly when the JAX package's two routes agree (they differ where
        other parts' voxels sit in a guided window, see
        ``pbr3d_torch.carving.stage1.component_guided_carve``)."""
        digest, counts = _sha256_counts(grid)
        check(digest == str(fxp[f"{key}_sha256"]) and np.array_equal(counts, fxp[f"{key}_counts"]),
              f"stage1 api: {what} {digest[:12]} is not the JAX unfused route's {str(fxp[f'{key}_sha256'])[:12]}")
        jax_routes_agree = str(fxp[f"{key}_sha256"]) == fused_sha256
        check((digest == fused_sha256) == jax_routes_agree,
              f"stage1 api: {what}: equal to the fused route's grid {digest == fused_sha256}, the JAX "
              f"package's two routes agree {jax_routes_agree}")
        return digest, jax_routes_agree

    # 1. Bibi@512: cold and warm, against the JAX grids and the fused route
    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid = carve_monument(masks, device=device)
        times.append(time.perf_counter() - t0)
        anchored(grid, "default_bibi512", _sha256_counts(fx["grid"])[0], "carve_monument Bibi@512")
    check(np.array_equal(fx["grid"], fused_grid), "phase 3's fused grid is not the JAX grid")
    diff = int((grid != fused_grid).sum())
    peak = torch.cuda.max_memory_allocated()
    log(f"stage1 api {where}: carve_monument (unfused) Bibi@512 {grid.shape} = the JAX unfused route's; "
        f"{diff} voxels differ from the JAX and the fused grid; cold_s={times[0]:.3f} warm_s={times[1]:.3f} "
        f"(fused route cold_s={fused_times[0]:.3f} warm_s={fused_times[1]:.3f}) peak_mem_bytes={peak}")

    # the steps under StageTimer (device-fenced at both edges of each)
    preset = config.DEFAULT_CARVE_PRESET
    timer = profiling.StageTimer()
    with timer.stage("global"):
        g = global_carve(masks.binary, masks.exterior_labels, preset.global_angle_interval, device=device)
    with timer.stage("part"):
        g = part_carve(g, masks.exterior_labels, preset.group_jobs, device=device)
    with timer.stage("guided"):
        for part, angle in preset.part_symmetry:
            g = component_guided_carve(g, masks.exterior_labels, part, angle, device=device)
    with timer.stage("extrude"):
        g = extrude_interior_parts(g, masks.semantic_labels, preset.extrusion_depths, device=device)
    with timer.stage("recolor"):
        g = recolor_backward_components(reorient(g), device=device).cpu().numpy()
    check(np.array_equal(g, grid), "the stage-1 steps one by one do not give carve_monument's grid")
    for ln in timer.report().splitlines():
        log(f"stage1 api StageTimer {ln}")
    wall, busy, top, _ = _device_profile(lambda: carve_monument(masks, device=device))
    log(f"stage1 api profiled: wall_s={wall:.3f} device_busy_s={busy:.4f} busy_share={busy / wall:.4f}")
    for name, ms, n in top[:5]:
        log(f"stage1 api   kernel {ms:9.2f} ms  x{n:<6d} {name[:90]}")

    # 2. the ten study grids, default preset
    for tag in STUDY_RUNS:
        for m in config.MONUMENTS:
            ms = MaskSet.from_labels(*(fxs[f"{tag}_{m}_{k}"] for k in ("binary", "exterior", "semantic")))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            grid_m = carve_monument(ms, device=device)
            secs = time.perf_counter() - t0
            digest, agree = anchored(grid_m, f"default_{tag}_{m}", str(fxs[f"{tag}_{m}_sha256"]),
                                     f"carve_monument {tag} {m}")
            log(f"stage1 api: carve_monument {tag} {m}: sha256 {digest[:12]} = the JAX unfused route's, "
                f"{'=' if agree else 'not'} the fused route's (as in JAX), {secs:.3f} s")

    # 3. the test preset, group angles other than the global one
    other = dataclasses.replace(config.DEFAULT_CARVE_PRESET, group_jobs=OTHER_ANGLE_GROUPS)
    runs = [(f"other_256_{m}", MaskSet.from_labels(*(fxs[f"256_{m}_{k}"] for k in ("binary", "exterior", "semantic"))))
            for m in config.MONUMENTS] + [("other_bibi512", masks)]
    for key, ms in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        digest, counts = _sha256_counts(carve_monument(ms, other, device=device))
        secs = time.perf_counter() - t0
        check(digest == str(fxp[f"{key}_sha256"]) and np.array_equal(counts, fxp[f"{key}_counts"]),
              f"stage1 api: the test preset's {key} grid {digest[:12]} is not the JAX unfused route's "
              f"{str(fxp[f'{key}_sha256'])[:12]}")
        log(f"stage1 api: test preset {key}: sha256 {digest[:12]} = JAX, {secs:.3f} s "
            f"(the JAX package's CPU run: {float(fxp[f'seconds_{key}']):.1f} s)")
    refused = _refusal(lambda: carve_monument_fused(masks, other, device=device))
    check("pbr3d_torch.carving.stage1.carve_monument" in refused,
          f"carve_monument_fused does not refuse the test preset with the new message: {refused!r}")
    log(f"stage1 api: carve_monument_fused refuses the test preset: {refused}")

    # 4. rotation: the card against CPU tensors
    occ = torch.from_numpy((fx["grid"] > 0).astype(np.float32))
    occ_card = occ.to(device)
    for angle in ROTATE_ANGLES:
        b_card = rotate_y_binary_u8(occ_card, angle, device=device).cpu()
        b_cpu = rotate_y_binary_u8(occ, angle, device="cpu")
        check(torch.equal(b_card, b_cpu), f"rotate_y_binary_u8 {angle}°: card and CPU bytes differ")
        f_card = rotate_y(occ_card, angle, device=device).cpu()
        f_cpu = rotate_y(occ, angle, device="cpu")
        unequal = int((f_card != f_cpu).sum())
        check(unequal == 0, f"rotate_y {angle}°: {unequal} elements differ between the card and the CPU")
        log(f"stage1 api: rotate_y_binary_u8 {angle}° on {tuple(occ.shape)}: card = CPU bytes "
            f"({int(b_card.sum())} set); rotate_y: 0 of {f_card.numel()} elements differ")
    del occ_card

    # 5. segmentation on Bibi's front plane
    binary = fx["binary"]
    closed = close_holes(binary, 5, device=device)
    check(np.array_equal(closed, close_holes(binary, 5, device="cpu")), "close_holes: card vs CPU")
    kept = remove_small_regions_2d(torch.from_numpy(binary).to(device), 50)
    check(np.array_equal(kept, remove_small_regions_2d(binary, 50)), "remove_small_regions_2d: card vs CPU")
    axis = find_symmetry_axis(config.labels_to_rgb(fx["exterior_labels"]))
    check(axis == int(fxp["symmetry_axis_bibi512"]),
          f"find_symmetry_axis {axis} vs JAX {int(fxp['symmetry_axis_bibi512'])}")
    log(f"stage1 api: segmentation on the {binary.shape} plane: close_holes(5) card = CPU "
        f"({int(closed.sum())} px), remove_small_regions_2d(50) card = CPU ({int(kept.sum())} px), "
        f"symmetry axis x={axis} = JAX")

    # 6. a trace around one warm carve
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.device_trace(tmp) as log_dir:
            carve_monument(masks, device=device)
        trace, = Path(log_dir).glob("trace_*.json")
        events = json.loads(trace.read_text())["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    check(kernels > 0, "device_trace: no CUDA kernel events in the trace")
    log(f"stage1 api: device_trace around a warm carve_monument: {len(events)} events, {kernels} CUDA kernel events")
    log("stage1 api: utils.viz is not run on the card (matplotlib is not installed there); "
        "tests/test_torch_viz.py holds it against the JAX package on the CPU")
    log(f"phase 9: {time.perf_counter() - t9:.1f} s")


def _sha256_counts(grid: np.ndarray):
    g = np.ascontiguousarray(grid, np.uint8)
    return hashlib.sha256(g.tobytes()).hexdigest(), np.bincount(g.reshape(-1), minlength=11)


def _study_prof(text: str) -> dict:
    """Seconds and count per ``[prof]`` phase of a study run: the stage-1 and
    stage-2 phases by name, the preparation's with monument and view folded,
    each monument's stage 3 as the sum of its chains."""
    out: dict = {}
    for name, secs in re.findall(r"\[prof\] (\S+): ([\d.]+)s", text):
        if name.startswith("prep."):
            name = "stage2.prep." + name.split(".")[-1]
        elif re.match(r"stage3\.\w+\.refine_parts", name):
            name = ".".join(name.split(".")[:2]) + ".refine_parts"
        elif not name.startswith(("stage1.", "stage2.", "stage3.")):
            continue
        s, n = out.get(name, (0.0, 0))
        out[name] = (s + float(secs), n + 1)
    return out


def phase_study(fxs, tag: str, card: str, bibi_front_floor=None, device: str = "cuda"):
    """Phase 7 at one of ``STUDY_RUNS``; ``fxs`` is the study fixture.
    Returns (results by monument, the scenes' masks)."""
    run = STUDY_RUNS[tag]
    monuments = list(config.MONUMENTS)
    scenes = {}
    for m in monuments:
        planes = (fxs[f"{tag}_{m}_{k}"] for k in ("binary", "exterior", "semantic"))
        # the planted front view serves stages 2 and 3 and, no monument's
        # padded grid outgrowing its mask's larger side, as the notebook-4
        # mask too
        front = fxs[f"{tag}_{m}_front"]
        scenes[m] = SceneMasks(MaskSet.from_labels(*planes), {"front": front, "drone": fxs[f"{tag}_{m}_drone"]}, front)
    ids = config.part_ids(ALIGN_PARTS)
    where = f"[{card}]"

    def anchored(grids, what):
        for m in monuments:
            digest, counts = _sha256_counts(grids[m])
            check(digest == str(fxs[f"{tag}_{m}_sha256"]) and np.array_equal(counts, fxs[f"{tag}_{m}_counts"]),
                  f"study {tag} {m}: the {what} grid {grids[m].shape} {digest[:12]} is not the JAX package's "
                  f"{tuple(fxs[f'{tag}_{m}_shape'])} {str(fxs[f'{tag}_{m}_sha256'])[:12]}")

    clock = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        log(f"study {tag}: {what} took {now - clock[0]:.1f} s")
        clock[0] = now

    recorded: list = []

    def recording_search(jobs, **kw):
        res = refine_cameras_batched(jobs, **kw)
        if kw.get("polish", True):
            recorded.extend((k if isinstance(k[0], str) else k[0], params_to_vector(p), iou)
                            for k, (p, iou) in res.items())
        return res

    def study(out_dir=None):
        return run_all_body(scenes, strict=True, out_dir=out_dir, device=device, **run["kw"])

    # 1. the study, first call: [prof] on, artifacts written
    err_text = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    launches0 = min_dist2_kernel.launches
    with tempfile.TemporaryDirectory() as tmp:
        with mock.patch.object(pipeline, "refine_cameras_batched", recording_search), \
                mock.patch.object(profiling, "PROFILE", True), contextlib.redirect_stderr(err_text):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = study(tmp)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
        peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
        text = err_text.getvalue()
        check(list(results) == monuments, f"study {tag}: results for {list(results)}")
        log(f"study {tag} {where}: run_all first call wall_s={first:.3f} (with [prof] fences and artifacts) "
            f"peak_mem_bytes={peak} peak_reserved_bytes={reserved} "
            f"min_dist2 launches={min_dist2_kernel.launches - launches0}")
        for msg in re.findall(r"^\[(?:run_all|stage2|stage3|(?!prof)\w+\] stage\d).*$", text, re.M):
            log(f"study {tag} log: {msg}")
        for name, (secs, n) in sorted(_study_prof(text).items()):
            log(f"study {tag} [prof] {secs:9.2f} s  x{n:<4d} {name}")
        log(f"study {tag} {where}: timings " + json.dumps(
            {m: {k: round(v, 3) for k, v in r.timings.items()} for m, r in results.items()}))

        # 2. artifacts in the reference layout, with the JAX package's keys
        for m, r in results.items():
            base = Path(tmp)
            check(np.array_equal(load_voxel_grid_labels(
                base / "1.Orthographic_Voxel_Carving" / f"{m}_voxel_grid.npz"), r.grid_stage1),
                f"study {tag} {m}: stage-1 artifact does not read back")
            check(np.array_equal(load_voxel_grid_labels(
                base / "3.Part-wise_3D_Refinement" / f"{m}_deformed_voxel_grid.npz"), r.grid_stage3),
                f"study {tag} {m}: deformed grid artifact does not read back")
            saved = json.loads((base / "3.Part-wise_3D_Refinement" / f"{m}_deform_params.json").read_text())
            check(saved == json.loads(json.dumps(r.deform_params))
                  and all(list(d) == ["deform", "iou", "gt_px"]
                          and list(d["deform"]) == ["scale_y", "shift_y", "scale_xz", "shift_xz"]
                          for d in saved.values()), f"study {tag} {m}: deform-params JSON")
            for t, params in r.cameras.items():
                path = base / "2.Perspective_Camera_Estimation" / f"{m}_camera_params_{t}.json"
                raw = json.loads(path.read_text())
                check(list(raw) == list(params) == list(VIEWS), f"study {tag} {m}: {t} JSON views {list(raw)}")
                keys = ["cam_pos", "target", "f", "cx", "cy"] + (["H", "W"] if t == "final" else [])
                for v in raw:
                    check(list(raw[v]) == keys, f"study {tag} {m}: {t}/{v} JSON keys {list(raw[v])}")
                    check(np.allclose(params_to_vector(load_camera_json(path, v)),
                                      params_to_vector(params[v]), rtol=1e-6),
                          f"study {tag} {m}: {t}/{v} JSON does not read back")
    log(f"study {tag}: 5 x (stage-1 npz, 3 camera JSONs, deformed npz, deform-params JSON) read back "
        f"in the reference layout")

    lap("the first call and its artifacts")

    # 3. stage 1: every grid is the JAX package's
    anchored({m: r.grid_stage1 for m, r in results.items()}, "run_all stage-1")

    # 4. stage 2: the returned IoU of every final camera re-scores exactly
    final_ious = {}
    for m, r in results.items():
        shell = surface_points_by_parts(torch.as_tensor(r.grid_stage1, device=device), ALIGN_PARTS, device=device)
        for v, cam in r.cameras["final"].items():
            vec = params_to_vector(cam)
            got = [iou for k, x, iou in recorded if k == (m, v) and np.array_equal(x, vec)]
            check(bool(got), f"study {tag} {m}/{v}: the final camera is no search's result")
            mask = scenes[m].views[v]
            gt = torch.as_tensor(mask_labels_selected(mask, ALIGN_PARTS), device=device)
            rescored = float(_batch_iou(torch.as_tensor(vec, device=device)[None], *shell, gt, ids, *mask.shape)[0])
            check(all(g == rescored for g in got),
                  f"study {tag} {m}/{v}: returned IoU {got} re-scores as {rescored}")
            final_ious[f"{m}/{v}"] = rescored
    log(f"study {tag} {where}: final IoUs (each equal to its re-score) " + json.dumps(final_ious))
    if bibi_front_floor is not None:
        check(final_ious["Bibi/front"] >= bibi_front_floor - STUDY_FRONT_IOU_ATOL,
              f"study {tag}: Bibi front IoU {final_ious['Bibi/front']} < the serial stage 2's "
              f"{bibi_front_floor} - {STUDY_FRONT_IOU_ATOL}")

    lap("anchors and re-scoring")

    # 5. the three gates and the nb4 cells, per monument
    failures: list = []
    for m, r in results.items():
        cam = r.cameras["final"]["front"]
        gold = load_voxel_grid_labels(STUDY_RUNS["golden"]["results"] / "1.Orthographic_Voxel_Carving"
                                      / f"{m}_voxel_grid.npz")
        iou1 = gates.stage1_iou_vs_golden(r.grid_stage1, gold)
        same_res = iou1 if tag == "golden" else gates.stage1_iou_vs_golden(
            r.grid_stage1, load_voxel_grid_labels(run["results"] / "1.Orthographic_Voxel_Carving"
                                                  / f"{m}_voxel_grid.npz"))
        whole = gates.stage3_whole_iou(r.grid_stage3, cam, scenes[m].views["front"], r.grid_stage1, device=device)
        mean_part = gates.mean_part_iou(r.deform_params)
        padded = np.pad(r.grid_stage1, ((0, 0), (0, config.STAGE3_PAD[m]), (0, 0)))
        present = [p for p in config.PART_NAMES if p != "background" and (padded == config.PART_IDS[p]).any()]
        cells = verify._nb4_state(padded, r.grid_stage3, scenes[m].nb4, cam, parts=present, device=device)[0]
        total = sum(d for _, d in cells.values())
        ref = json.loads((run["results"] / "3.Part-wise_3D_Refinement" / f"{m}_deform_params.json").read_text())
        log(f"study {tag} {m} {where}: stage1_iou_vs_golden={iou1!r} (min {gates.STAGE1_IOU_MIN}) "
            f"vs_committed_{tag}={same_res!r} stage3_whole_iou={whole!r} (min {gates.STAGE3_WHOLE_IOU_MIN}) "
            f"mean_part_iou={mean_part!r} (min {gates.STAGE3_MEAN_PART_IOU_MIN}; the committed JAX run on "
            f"the PNG masks: {gates.mean_part_iou(ref)!r}) nb4_total={total!r} stage3_s={r.timings['stage3']:.2f}")
        log(f"study {tag} {m}: nb4 cells (init, deformed) "
            f"{ {k: (round(a, 4), round(b, 4)) for k, (a, b) in cells.items()} }; part IoUs "
            f"{ {p: round(d['iou'], 4) for p, d in r.deform_params.items()} }; committed "
            f"{ {p: round(d['iou'], 4) for p, d in ref.items()} }")
        regressed = [k for k, (a, b) in cells.items() if b + NB4_TOL.get(k, 1e-6) < a]
        missed = [what for ok, what in (
            (iou1 is not None and iou1 >= gates.STAGE1_IOU_MIN, f"stage-1 IoU {iou1}"),
            (whole >= gates.STAGE3_WHOLE_IOU_MIN, f"stage-3 whole IoU {whole}"),
            (mean_part >= gates.STAGE3_MEAN_PART_IOU_MIN, f"mean part IoU {mean_part}"),
            (not regressed, f"nb4 cells regressed: {regressed}")) if not ok]
        failures += [f"{m}: {what}" for what in missed]
    check(not failures, f"study {tag}: gates missed: {failures}")
    lap("gates and nb4 cells")

    # 6. the two carve routes, second runs of each: all scenes' sweeps side
    # by side, and one scene after the other (``carve_monument_fused`` on two
    # worker threads, each on its own stream)
    sets = {m: scenes[m].front for m in monuments}
    need = _sweep_working_set(list(sets.values()))
    free = torch.cuda.mem_get_info()[0]
    check(need <= free // 2, f"study {tag}: the stacked carve needs {need} B of {free // 2} B budgeted")
    check("batched stage1 x5" in text, f"study {tag}: run_all did not take the multi-scene carve")
    turns = ("per_scene", "stacked", "stacked", "per_scene") if tag == "256" else ("per_scene", "stacked")
    for route in turns:
        budget = need - 1 if route == "per_scene" else None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        grids = carve_monuments_batched(sets, mem_budget_bytes=budget, device=device)
        secs = time.perf_counter() - t0
        anchored(grids, f"{route} route's")
        log(f"study {tag} {where}: carve route {route} wall_s={secs:.3f} "
            f"peak_mem_bytes={torch.cuda.max_memory_allocated()} (run_all took the stacked route; "
            f"working-set estimate {need} B, budget {free // 2} B)")
    del grids
    lap("carve routes")

    # 7. the second call, at 256 only (the golden one would add a minute to
    # the smoke): the same results, whatever ran beside what
    if tag != "256":
        return results, scenes
    second: dict = {}
    wall, busy, top, _ = _device_profile(lambda: second.update(study()))
    log(f"study {tag} {where}: run_all second call, profiled: wall_s={wall:.3f} "
        f"device_busy_s={busy:.4f} busy_share={busy / wall:.4f}")
    for name, ms, n in top:
        log(f"study {tag}   kernel {ms:9.2f} ms  x{n:<6d} {name[:90]}")
    for m, r in results.items():
        same = (second[m].deform_params == r.deform_params
                and np.array_equal(second[m].grid_stage3, r.grid_stage3)
                and all(np.array_equal(params_to_vector(second[m].cameras["final"][v]), params_to_vector(c))
                        for v, c in r.cameras["final"].items()))
        check(same, f"study {tag} {m}: a second run_all gave other cameras or deforms")
    log(f"study {tag}: the second call's cameras, deforms and grids are the first call's")
    lap("the second call")
    return results, scenes


def nb5_sparse_cloud(shell_xyz: np.ndarray) -> np.ndarray:
    """The stand-in for the SfM cloud: the front half (along z) of a shell's
    (x, y, z) points at unit scale, thinned to ``NB5['sparse_points']``,
    under a rigid motion, with Gaussian noise; all from ``NB5['seed']``.
    (N, 3) float64."""
    rng = np.random.default_rng(NB5["seed"])
    p = np.asarray(shell_xyz, np.float64)
    p = p[p[:, 2] <= (p[:, 2].min() + p[:, 2].max()) / 2]
    p = p / (p.max(0) - p.min(0)).max()
    p = p[rng.choice(len(p), min(NB5["sparse_points"], len(p)), replace=False)]
    R = preprocess.rodrigues_rotation(rng.normal(size=3), 0.35)
    return p @ R.T + rng.normal(scale=0.2, size=3) + rng.normal(scale=NB5["noise"], size=p.shape)


def write_obj(path, verts: np.ndarray, faces: np.ndarray) -> None:
    """A triangle mesh as a Wavefront OBJ (1-based faces)."""
    with open(path, "w") as f:
        np.savetxt(f, np.asarray(verts, np.float64), fmt="v %.6f %.6f %.6f")
        np.savetxt(f, np.asarray(faces, np.int64) + 1, fmt="f %d %d %d")


def compact_faces(vertices, faces, y_thresh: float):
    """``filter_mesh`` keeps the kept faces' indices into the unfiltered
    vertices; this renumbers them into the kept vertices."""
    keep = vertices[:, 1] <= y_thresh
    v, f = inter.filter_mesh(vertices, faces, y_thresh)
    return v, (torch.cumsum(keep.to(torch.int64), 0) - 1)[f.to(torch.int64)]


def icp_reference(source: np.ndarray, target: np.ndarray, max_dist: float = 0.05,
                  max_iterations: int = 30, tol: float = 1e-7):
    """Point-to-point ICP in float64 numpy over a cKDTree: the independent
    version ``preprocess.icp_point_to_point`` is held against."""
    from scipy.spatial import cKDTree

    src, tree, T, prev = source.copy(), cKDTree(target), np.eye(4), np.inf
    for _ in range(max_iterations):
        # bounded: a side that starts a quarter turn away has most of its
        # points far from the target, where an unbounded query walks the
        # whole tree; beyond the bound the tree answers (inf, n)
        d, idx = tree.query(src, distance_upper_bound=max_dist)
        keep = d < max_dist
        if keep.sum() < 3:
            break
        P, Q = src[keep], target[idx[keep]]
        cp, cq = P.mean(0), Q.mean(0)
        U, _, Vt = np.linalg.svd((P - cp).T @ (Q - cq))
        if np.linalg.det(Vt.T @ U.T) < 0:
            Vt[-1] *= -1
        R = Vt.T @ U.T
        t = cq - R @ cp
        src = src @ R.T + t
        Ti = np.eye(4)
        Ti[:3, :3], Ti[:3, 3] = R, t
        T = Ti @ T
        err = float(np.mean(d[keep] ** 2))
        if abs(prev - err) < tol:
            break
        prev = err
    return src, T


def knn_vs_kdtree(A, B, k: int, what: str, device: str) -> None:
    """``neighbors.knn`` on ``device`` against a float64 cKDTree on the same
    float32 points: distances to ``KD_KNN_RTOL``."""
    from scipy.spatial import cKDTree

    A, B = neighbors._points(A, device), neighbors._points(B, device)
    d = neighbors.knn(A, B, k, device=device)[0].cpu().numpy()
    ref = cKDTree(B.cpu().numpy().astype(np.float64)).query(A.cpu().numpy().astype(np.float64), k=k)[0]
    ref = ref.reshape(d.shape)
    rel = float(np.max(np.abs(d - ref) / np.maximum(ref, 1e-30) * (ref > 0)))
    zero = bool(np.all(d[ref == 0] <= 1e-6))
    log(f"nb5 knn vs cKDTree, {what}: {A.shape[0]} x {B.shape[0]} k={k} max_rel_err={rel:.3e} tol={KD_KNN_RTOL:g}")
    check(rel <= KD_KNN_RTOL and zero, f"knn vs cKDTree, {what}: rel {rel}")


def _cell_numbers(cell: str):
    return None if cell == "--" else [float(x) for x in cell.split("→")]


def cells_agree(cells: dict, ref: dict, atol: float, what: str) -> None:
    """Table cells (row -> monument -> string) against reference cells: the
    unequal strings counted, every number within ``atol``."""
    check({r: sorted(c) for r, c in cells.items()} == {r: sorted(c) for r, c in ref.items()},
          f"{what}: rows or monuments differ")
    unequal, worst = [], 0.0
    for row, by_monument in cells.items():
        for m, cell in by_monument.items():
            if cell == ref[row][m]:
                continue
            unequal.append(f"{row}/{m}: {cell} vs {ref[row][m]}")
            a, b = _cell_numbers(cell), _cell_numbers(ref[row][m])
            check(a is not None and b is not None and len(a) == len(b), f"{what} {row}/{m}: {cell} vs {ref[row][m]}")
            worst = max(worst, max(abs(x - y) for x, y in zip(a, b)))
    n = sum(len(c) for c in cells.values())
    log(f"{what}: {n - len(unequal)} of {n} cells equal as printed; unequal {unequal or 'none'}; "
        f"max_abs_diff={worst:.4f} tol={atol:g}")
    check(worst <= atol, f"{what}: a cell differs by {worst}")


def nb4_tables(scenes: dict, device: str) -> dict:
    return {"kp": intra.minaret_kp_cells(scenes, device=device),
            "iou": intra.minaret_iou_cells(scenes, device=device),
            "part": intra.part_minaret_binary_cells(scenes, device=device)}


def phase_eval_nb4(fxs, ev: dict, card: str, produced: dict, device: str = "cuda") -> dict:
    """Notebook 4.  ``produced``: {tag: (results, scenes)} of phase 7 (may be
    empty).  Returns the committed golden Taj grids for notebook 5."""
    monuments = list(config.MONUMENTS)
    keep = {}
    for tag, run in STUDY_RUNS.items():
        t0 = time.perf_counter()
        scenes = {}
        for m in monuments:
            grid = load_voxel_grid_labels(run["results"] / "1.Orthographic_Voxel_Carving" / f"{m}_voxel_grid.npz")
            deformed = load_voxel_grid_labels(
                run["results"] / "3.Part-wise_3D_Refinement" / f"{m}_deformed_voxel_grid.npz")
            cams = {t: load_camera_json(run["results"] / "2.Perspective_Camera_Estimation"
                                        / f"{m}_camera_params_{t}.json", "front") for t in ("init", "kp", "final")}
            scenes[m] = intra.Scene(grid, deformed, fxs[f"{tag}_{m}_front"], cams)
        if tag == "golden":
            keep = {"grid": scenes["Taj"].grid, "model": scenes["Taj"].deformed}
        load_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tables = nb4_tables(scenes, device)
        torch.cuda.synchronize()
        log(f"nb4 {tag} [{card}]: three tables over {len(monuments)} monuments on the committed artifacts "
            f"wall_s={time.perf_counter() - t0:.3f} (loading them {load_s:.3f} s)")
        for name, atol in (("kp", NB4_PX_ATOL), ("iou", NB4_IOU_ATOL), ("part", NB4_IOU_ATOL)):
            cells_agree(tables[name], ev["nb4"][tag][name], atol, f"nb4 {tag} {name} table vs the JAX package's")
        for name, header in (("kp", intra.KP_HEADER), ("iou", intra.IOU_HEADER), ("part", intra.PART_HEADER)):
            log(header.strip().replace("\n", " | ") + " " + json.dumps(tables[name], ensure_ascii=False))
        del scenes

    for tag, (results, masks) in produced.items():
        scenes = {}
        for m, r in results.items():
            padded = np.pad(r.grid_stage1, ((0, 0), (0, config.STAGE3_PAD[m]), (0, 0)))
            scenes[m] = intra.Scene(padded, r.grid_stage3, masks[m].nb4,
                                    {t: r.cameras[t]["front"] for t in ("init", "kp", "final")})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tables = nb4_tables(scenes, device)
        torch.cuda.synchronize()
        log(f"nb4 {tag} [{card}]: three tables on the study's own grids and cameras wall_s={time.perf_counter() - t0:.3f}")
        exact = {row: {} for row in tables["part"]}
        for m, sc in scenes.items():
            cells = verify.nb4_exact_cells(sc.grid, sc.deformed, sc.mask, sc.cams["final"], device=device)
            for row in exact:
                exact[row][m] = "→".join(f"{x:.3f}" for x in cells[row]) if row in cells else "--"
        cells_agree(tables["part"], exact, NB4_IOU_ATOL, f"nb4 {tag} part table of the study's grids vs nb4_exact_cells")
        log(f"nb4 {tag} study tables: " + json.dumps(tables, ensure_ascii=False))
    return keep


def nb5_values(clouds: dict, device: str) -> dict:
    """``examples/5``'s pair table and NN statistics, and the surface metrics
    per cloud, of already normalized clouds."""
    import itertools

    out = {"pairs": {}, "nn": {}, "surface": {}, "mesh": {}}
    for a, b in itertools.combinations(clouds, 2):
        f1, prec, rec = inter.fscore_with_threshold(clouds[a], clouds[b], tau=NB5["tau"], device=device)
        out["pairs"][f"{a} vs {b}"] = {
            "chamfer2": inter.chamfer_distance(clouds[a], clouds[b], device=device), "f1": f1,
            "voxel_iou": inter.voxel_iou(clouds[a], clouds[b], device=device),
            "pca": inter.pca_shape_similarity(clouds[a], clouds[b], device=device)}
    for name, cloud in clouds.items():
        out["nn"][name] = inter.compute_nn_stats(cloud, device=device)
        verts, faces = inter.get_marching_cubes_mesh(cloud, NB5["grid_size"], device=device)
        v, f = compact_faces(verts, faces, NB5["y_thresh"])
        out["surface"][name] = inter.compute_surface_metrics(v, f, NB5["k"], device=device)
        out["mesh"][name] = [int(verts.shape[0]), int(faces.shape[0]), int(v.shape[0]), int(f.shape[0])]
    return out


def values_agree(ours, ref, rtol: float, what: str) -> float:
    """Nested dicts of numbers, leaf by leaf, to ``rtol``; returns the worst."""
    worst = 0.0
    for k, v in ref.items():
        check(k in ours, f"{what}: no {k}")
        if isinstance(v, dict):
            worst = max(worst, values_agree(ours[k], v, rtol, f"{what}/{k}"))
        elif isinstance(v, list):
            continue
        else:
            rel = abs(ours[k] - v) / max(abs(v), 1e-12)
            worst = max(worst, rel)
            check(np.isfinite(ours[k]) and rel <= rtol, f"{what}/{k}: {ours[k]!r} vs {v!r}")
    return worst


def knn_profile_by_capacity(by_name: dict) -> dict:
    """Profiler (ms, scan kernels) of the knn kernels by list capacity (the
    first template argument of the scan, merge and finish kernels; the k = 1
    kernels are capacity 1), and of the pack kernel as "pack".  A wrapper
    call launches one scan kernel, so the scans count the calls."""
    out: dict = {}
    for name, (ms, n) in by_name.items():
        if "knn" not in name:
            continue
        hit = re.search(r"knn_(?:scan|merge)_kernel<(\d+)", name)
        cap = "pack" if "knn_pack" in name else 1 if "knn1_" in name else int(hit.group(1)) if hit else name
        a, b = out.get(cap, (0.0, 0))
        out[cap] = (a + ms, b + (n if "scan" in name else 0))
    return out


def phase_eval_nb5(ev: dict, card: str, grid: np.ndarray, model: np.ndarray, device: str = "cuda") -> dict:
    """Notebook 5 on clouds made from the committed golden Taj artifacts.
    Returns both kernels' launches on its main path."""
    import scipy.ndimage
    from scipy.spatial import cKDTree

    ref = ev["nb5"]
    names = [p for p in config.PART_NAMES if p != "background"]
    triples = np.asarray(ref["ransac_triples"], np.int64)
    clock = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        log(f"nb5: {what} took {now - clock[0]:.1f} s")
        clock[0] = now

    def path(root: Path) -> dict:
        """The main path as a user runs it: the input files, the clouds, the
        tables."""
        g = torch.as_tensor(grid, device=device)
        shell = surface_points_by_parts(g, names, device=device)[0].cpu().numpy()
        save_ply(root / "segmented_point_cloud_final.ply", nb5_sparse_cloud(shell))
        (root / "Taj_voxel_grid.npz").symlink_to(
            STUDY_RUNS["golden"]["results"] / "1.Orthographic_Voxel_Carving" / "Taj_voxel_grid.npz")
        mesh = meshify_colored_voxel_grid(g, NB5["mesh_stride"], device=device)
        write_obj(root / "synthetic_taj.obj", mesh[0].cpu().numpy(), mesh[1].cpu().numpy())
        raw = preprocess.build_taj_clouds(root, cad_samples=NB5["cad_samples"], seed=NB5["seed"],
                                          triples=triples, device=device)
        raw["Stage-3 Model"] = all_points(model, device=device)[0].to(torch.float64)
        clouds = {k: inter.normalize_preserve_aspect(raw[k], device=device) for k in NB5_CLOUDS}
        return {"mesh": mesh, "raw": raw, "clouds": clouds, "values": nb5_values(clouds, device)}

    # 1. the main path, counted and timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    knn_kernel.launches = min_dist2_kernel.launches = 0
    knn_kernel.pairs.clear()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        got = path(Path(tmp))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"knn": knn_kernel.launches, "min_dist2": min_dist2_kernel.launches}
        pairs = dict(sorted(knn_kernel.pairs.items()))
        peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
        log(f"nb5 [{card}]: main path wall_s={wall:.3f} peak_mem_bytes={peak} peak_reserved_bytes={reserved} "
            f"launches={json.dumps(launches)}")
        check(launches["knn"] > 0 and launches["min_dist2"] > 0, f"nb5: kernel launches {launches}")

        # 2. the files read back
        sparse_back = load_ply(Path(tmp) / "segmented_point_cloud_final.ply")["points"]
        ov, of = load_obj(Path(tmp) / "synthetic_taj.obj")
        verts, faces, colors, normals = got["mesh"]
        check(np.array_equal(ov, verts.cpu().numpy().astype(np.float64)) and np.array_equal(of, faces.cpu().numpy()),
              "nb5: the OBJ does not read back as the mesh")
        log(f"nb5 inputs: PLY {sparse_back.shape} and OBJ {ov.shape} {of.shape} written and read back; clouds "
            + json.dumps({k: int(v.shape[0]) for k, v in got["raw"].items()}))
    check(list(got["raw"]) == ["Sparse", "Completed (ICP Aligned)", "Carved Grid", "Synthetic", "Stage-3 Model"],
          f"nb5: clouds {list(got['raw'])}")

    lap("the main path and its files read back")

    # 3. the mesh colours: nearest occupied voxel, against a cKDTree
    g = torch.as_tensor(grid, device=device)[::NB5["mesh_stride"], ::NB5["mesh_stride"], ::NB5["mesh_stride"]]
    filled = torch.nonzero(g > 0).to(torch.float32)
    query = verts[:, [2, 1, 0]] / NB5["mesh_stride"]  # as the mesh's colour lookup forms it
    knn_vs_kdtree(query, filled, 1, "mesh colours (vertices vs occupied voxels)", device)
    q64, f64 = query.cpu().numpy().astype(np.float64), filled.cpu().numpy().astype(np.float64)
    near_d, near = cKDTree(f64).query(q64)
    mine = neighbors.knn(query, filled, 1, device=device)[1][:, 0].cpu().numpy()
    # a vertex midway between two occupied voxels takes the lower index; the
    # tree may take the other: an index may differ only at an exact tie
    other = mine != near
    check(np.array_equal(np.linalg.norm(q64[other] - f64[mine[other]], axis=1), near_d[other]),
          "nb5: a mesh vertex's neighbour is not a nearest voxel")
    want = config.PALETTE[g[g > 0].cpu().numpy()][mine] / 255.0
    check(np.array_equal(colors.cpu().numpy(), want), "nb5: vertex colours are not the nearest voxels'")
    check(bool(torch.isfinite(normals).all()) and normals.shape == (faces.shape[0], 3), "nb5: face normals")
    log(f"nb5 mesh at stride {NB5['mesh_stride']}: {verts.shape[0]} vertices, {faces.shape[0]} faces, colours "
        f"those of the nearest voxels; {int(other.sum())} vertices lie midway between two voxels and take the "
        f"lower index where the cKDTree took the other")

    lap("the mesh colours against a cKDTree")

    # 4. the plane, the ICPs: against the JAX package's and a cKDTree ICP
    raw_sparse = sparse_back
    plane, inliers = preprocess.segment_plane(raw_sparse, 0.01, 1000, NB5["seed"], triples, device=device)
    own_plane, own_inliers = preprocess.segment_plane(raw_sparse, 0.01, 1000, NB5["seed"], device=device)
    cos = abs(float(np.dot(plane[:3], own_plane[:3])))
    log(f"nb5 plane on the JAX triples {plane.tolist()} inliers={len(inliers)} jax={ref['plane']} "
        f"jax_inliers={ref['plane_inliers']}; on the port's generator {own_plane.tolist()} "
        f"inliers={len(own_inliers)} |cos|={cos:.6f}")
    check(np.allclose(plane, ref["plane"], rtol=0, atol=1e-5) and abs(len(inliers) - ref["plane_inliers"]) <= 2,
          "nb5: the plane on the JAX triples is not the JAX package's")
    check(cos >= 0.999 and len(own_inliers) >= 0.9 * len(inliers), "nb5: the port's own draws find another plane")
    sides = preprocess.symmetric_completion(got["raw"]["Sparse"], device=device)
    host = {k: v.cpu().numpy() for k, v in sides.items()}
    left = None
    for src, tgt in (("left", "front"), ("right", "front"), ("back", "left")):
        target = sides[tgt] if tgt == "front" else left
        moved, T = preprocess.icp_point_to_point(sides[src], target, 0.05, device=device)
        err_jax = np.abs(T - np.asarray(ref["icp"][src])).max()
        log(f"nb5 ICP {src}->{tgt}: max |T - T_jax|={err_jax:.3e} tol={ICP_T_ATOL:g}")
        check(err_jax <= ICP_T_ATOL, f"nb5: ICP {src}->{tgt} transform vs the JAX package's")
        if src == "left":  # the first ICP also against the independent one
            left = moved
            knn_vs_kdtree(sides[src], target, 1, "ICP's first correspondences", device)
            err_kd = np.abs(T - icp_reference(host[src], host[tgt])[1]).max()
            log(f"nb5 ICP {src}->{tgt}: max |T - T_cKDTree|={err_kd:.3e} tol={ICP_T_ATOL:g}")
            check(err_kd <= ICP_T_ATOL, f"nb5: ICP {src}->{tgt} transform vs the cKDTree ICP's")
    lap("the plane and the three ICPs against their references")

    # 5. the other knn uses, the dilation and the Gaussian, against scipy
    clouds = got["clouds"]
    for name in ("Sparse", "Carved Grid"):
        cloud = inter._cloud(clouds[name], 50000, 0, device)
        knn_vs_kdtree(cloud, cloud, 2, f"NN statistics of {name}", device)
        verts_s, faces_s = inter.get_marching_cubes_mesh(clouds[name], NB5["grid_size"], device=device)
        v, _ = compact_faces(verts_s, faces_s, NB5["y_thresh"])
        knn_vs_kdtree(v, v, NB5["k"], f"surface neighbourhoods of {name}", device)
        dens = torch.zeros((NB5["grid_size"],) * 3, dtype=torch.float32, device=device)
        vox = torch.remainder((clouds[name] * (NB5["grid_size"] - 1)).to(torch.int64), NB5["grid_size"])
        dens.index_put_((vox[:, 0], vox[:, 1], vox[:, 2]), torch.ones((), device=device), accumulate=True)
        blur = morphology.gaussian_filter(dens, 1.0, device=device).cpu().numpy()
        want = scipy.ndimage.gaussian_filter(dens.cpu().numpy(), 1.0)
        err = float(np.abs(blur - want).max() / want.max())
        occ = dens > 0
        dil = morphology.binary_dilation(occ, 2, device=device).cpu().numpy()
        same = np.array_equal(dil, scipy.ndimage.binary_dilation(occ.cpu().numpy(), iterations=2))
        log(f"nb5 {name}: Gaussian vs scipy max_err/max={err:.3e} tol={GAUSS_RTOL:g}; dilation equal to scipy's: {same}")
        check(err <= GAUSS_RTOL and same, f"nb5 {name}: Gaussian or dilation vs scipy")

    lap("the other knn uses, the Gaussian and the dilation against scipy")

    # 6. the values against the JAX package's
    log("nb5 values: " + json.dumps(got["values"], ensure_ascii=False))
    worst = values_agree(got["values"], {k: ref[k] for k in ("pairs", "nn", "surface")}, JAX_RTOL, "nb5")
    log(f"nb5 values vs the JAX package's: max_rel_diff={worst:.3e} tol={JAX_RTOL:g}; meshes "
        f"(vertices, faces, kept vertices, kept faces) {got['values']['mesh']} jax {ref['mesh']}")

    # 7. the main path once more, under the profiler
    with tempfile.TemporaryDirectory() as tmp:
        wall2, busy, top, by_name = _device_profile(lambda: path(Path(tmp)))
    log(f"nb5 [{card}]: main path profiled: wall_s={wall2:.3f} device_busy_s={busy:.4f} busy_share={busy / wall2:.4f}")
    for name, ms, n in top:
        log(f"nb5   kernel {ms:9.2f} ms  x{n:<6d} {name[:90]}")
    knn_ms = knn_profile_by_capacity(by_name)
    check(sum(n for cap, (_, n) in knn_ms.items() if cap != "pack") == launches["knn"],
          f"nb5: the profiled path's knn scans {knn_ms} are not the counted run's {launches['knn']} launches")
    for cap, cap_pairs in pairs.items():
        bound = cap_pairs * PAIR_INSTRUCTIONS / FP32_INSTRUCTIONS_PER_S * 1e3
        ms, n = knn_ms.get(cap, (0.0, 0))
        log(f"nb5 knn capacity {cap}: launches={n} pairs={cap_pairs} summed_bound_ms={bound:.4f} "
            f"profiler_ms={ms:.4f} (scan and merge or finish) share_of_bound="
            f"{bound / ms if ms else float('nan'):.3f}")
    log(f"nb5 knn pack kernel (all capacities): profiler_ms={knn_ms.get('pack', (0.0, 0))[0]:.4f}")
    lap("the profiled main path")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the card", file=sys.stderr)
        return 2

    card = query_card()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib = load_extension()
    log(f"kernel build+load: {time.perf_counter() - t0:.2f} s")
    for ln in lib.build_log.splitlines():
        log(f"  {ln.strip()}")
    # a spill in any kernel fails the phase
    entry, spilled = "", {}
    for ln in lib.build_log.splitlines():
        entry = ln.split("'")[1] if "Compiling entry function" in ln else entry
        if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln:
            spilled[entry] = ln.strip()
    log(f"kernels that spill registers: {spilled or 'none'}")
    check(not spilled, f"kernels spill registers: {spilled}")

    fxs = np.load(STUDY)
    if sys.argv[1:] == ["study"]:
        for tag in STUDY_RUNS:
            phase_study(fxs, tag, card)
        log(f"study alone: {time.perf_counter() - t0:.1f} s; a partial run prints no result line")
        return 0

    if sys.argv[1:] == ["stage1"]:
        phase_stage1_api(np.load(FIXTURE), fxs, card)
        log(f"stage-1 API alone: {time.perf_counter() - t0:.1f} s; a partial run prints no result line")
        return 0

    ev = json.loads(EVAL.read_text())
    if sys.argv[1:] == ["eval"]:
        taj = phase_eval_nb4(fxs, ev, card, {})
        phase_eval_nb5(ev, card, taj["grid"], taj["model"])
        log(f"evaluation alone: {time.perf_counter() - t0:.1f} s; a partial run prints no result line")
        return 0

    kernel = phase_kernel()
    knn = phase_knn_kernel()
    if sys.argv[1:] == ["kernels"]:
        log(f"kernels alone: {time.perf_counter() - t0:.1f} s; a partial run prints no result line")
        return 0

    fx = np.load(FIXTURE)
    min_dist2_kernel.launches = 0  # count the main path only
    grid, fused_times = phase_stage1(fx)
    launches = phase_metrics(fx, grid)
    check(launches > 0, "the metrics never launched the min-dist kernel")
    fx2 = np.load(FIXTURE2)
    ious2 = phase_stage2(fx2, grid)
    phase_stage3(np.load(FIXTURE3), fx2, grid)
    log(f"phases 1-6: {time.perf_counter() - t0:.1f} s")
    produced = {"golden": phase_study(fxs, "golden", card, bibi_front_floor=ious2["front"]),
                "256": phase_study(fxs, "256", card)}
    phase_stage1_api(fx, fxs, card, fused=(grid, fused_times))
    t8 = time.perf_counter()
    taj = phase_eval_nb4(fxs, ev, card, produced)
    del produced
    launches8 = phase_eval_nb5(ev, card, taj["grid"], taj["model"])
    log(f"phase 8: {time.perf_counter() - t8:.1f} s")
    log(f"whole smoke: {time.perf_counter() - t0:.1f} s")

    log(card)
    log(json.dumps({"kernels": [{
        "name": "min_dist2", "route": "cuda", "source": "pbr3d_torch/csrc/min_dist2.cu",
        "replaces": "pbr3d/ops/pallas_kernels.py:30", "launches": launches + launches8["min_dist2"],
        "launches_metrics_path": launches, "launches_evaluation_path": launches8["min_dist2"], **kernel,
    }, {
        "name": "knn", "route": "cuda", "source": "pbr3d_torch/csrc/knn.cu",
        "replaces": "pbr3d/ops/neighbors.py:122", "launches": launches8["knn"], **knn,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
