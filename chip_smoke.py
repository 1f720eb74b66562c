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
   CUDA events in turns, beside the bound, with the SM clock and power;
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
   times and peaks, and for (b) the profiler's device-busy share.

``python3 chip_smoke.py study`` runs the build and phase 7 alone and prints
no result line.  The last two lines are the kernels' JSON record and the result line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result, when
there is no CUDA device or any check fails.
"""

from __future__ import annotations

import contextlib
import hashlib
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
from pbr3d_torch.carving.stage1 import global_carve
from pbr3d_torch.carving.voxel import all_points, surface_points_by_parts
from pbr3d_torch.config import rgb_to_labels
from pbr3d_torch.deform import search, verify
from pbr3d_torch.deform.warp import build_deformed_grid_fused
from pbr3d_torch.eval import gates, inter
from pbr3d_torch.io.artifacts import load_camera_json, load_voxel_grid_labels, save_voxel_grid
from pbr3d_torch.io.masks import MaskSet
from pbr3d_torch.ops.cuda_kernels import load_extension, min_dist2_kernel, min_dist2_plain
from pbr3d_torch.ops.point_table import build_point_table
from pbr3d_torch.pipeline import ALIGN_PARTS, SceneMasks, run_all_body, run_stage2_views, run_stage3_body
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


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


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


def phase_stage1(fx) -> np.ndarray:
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
    return grid


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

    wall, busy, top = _device_profile(metrics)
    mine = [(ms, k) for name, ms, k in top if "min_dist2" in name]
    log(f"metrics profiled (decode and points excluded): wall_s={wall:.4f} device_busy_s={busy:.4f} "
        f"min_dist2 device_ms={sum(ms for ms, _ in mine):.4f} over {sum(k for _, k in mine)} launches")
    return launches


def _device_profile(fn):
    """(wall s, device-busy s, top kernels [(name, ms, launches)]) of ``fn()``
    under ``torch.profiler``: busy is the union of the kernels' intervals.
    Only the device is traced (a long multi-threaded run's host events are
    many and are not read here)."""
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
    return wall, busy / 1e9, top


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
        wall, busy, top = _device_profile(lambda: out.update(zip(
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
    wall, busy, top = _device_profile(lambda: second.update(zip(("deforms", "grid"), body())))
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


def phase_study(fxs, tag: str, card: str, bibi_front_floor=None, device: str = "cuda") -> None:
    """Phase 7 at one of ``STUDY_RUNS``; ``fxs`` is the study fixture."""
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

    # 7. the second call: the same results, whatever ran beside what
    second: dict = {}
    if tag == "256":
        wall, busy, top = _device_profile(lambda: second.update(study()))
        log(f"study {tag} {where}: run_all second call, profiled: wall_s={wall:.3f} "
            f"device_busy_s={busy:.4f} busy_share={busy / wall:.4f}")
        for name, ms, n in top:
            log(f"study {tag}   kernel {ms:9.2f} ms  x{n:<6d} {name[:90]}")
    else:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        second.update(study())
        torch.cuda.synchronize()
        log(f"study {tag} {where}: run_all second call wall_s={time.perf_counter() - t0:.3f}")
    for m, r in results.items():
        same = (second[m].deform_params == r.deform_params
                and np.array_equal(second[m].grid_stage3, r.grid_stage3)
                and all(np.array_equal(params_to_vector(second[m].cameras["final"][v]), params_to_vector(c))
                        for v, c in r.cameras["final"].items()))
        check(same, f"study {tag} {m}: a second run_all gave other cameras or deforms")
    log(f"study {tag}: the second call's cameras, deforms and grids are the first call's")
    lap("the second call")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the card", file=sys.stderr)
        return 2

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib = load_extension()
    log(f"kernel build+load: {time.perf_counter() - t0:.2f} s")
    for ln in lib.build_log.splitlines():
        log(f"  {ln.strip()}")
    spills = [ln for ln in lib.build_log.splitlines() if "spill" in ln]
    check(all("0 bytes spill stores, 0 bytes spill loads" in ln for ln in spills),
          f"the kernel spills registers: {spills}")

    fxs = np.load(STUDY)
    if sys.argv[1:] == ["study"]:
        for tag in STUDY_RUNS:
            phase_study(fxs, tag, card)
        log(f"study alone: {time.perf_counter() - t0:.1f} s; a partial run prints no result line")
        return 0

    kernel = phase_kernel()

    fx = np.load(FIXTURE)
    min_dist2_kernel.launches = 0  # count the main path only
    grid = phase_stage1(fx)
    launches = phase_metrics(fx, grid)
    check(launches > 0, "the metrics never launched the min-dist kernel")
    fx2 = np.load(FIXTURE2)
    ious2 = phase_stage2(fx2, grid)
    phase_stage3(np.load(FIXTURE3), fx2, grid)
    log(f"phases 1-6: {time.perf_counter() - t0:.1f} s")
    phase_study(fxs, "golden", card, bibi_front_floor=ious2["front"])
    phase_study(fxs, "256", card)
    log(f"whole smoke: {time.perf_counter() - t0:.1f} s")

    log(card)
    log(json.dumps({"kernels": [{
        "name": "min_dist2", "route": "cuda", "source": "pbr3d_torch/csrc/min_dist2.cu",
        "replaces": "pbr3d/ops/pallas_kernels.py:30", "launches": launches, **kernel,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
