#!/usr/bin/env python3
"""On-card smoke of the PyTorch port (``pbr3d_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, each of which fails the script loudly (there is no CPU fallback):

1. card and build: the card's name and power limit, and the build of the
   hand-written CUDA kernels from ``pbr3d_torch/csrc`` into ``build/``;
2. kernel vs plain: ``min_dist2_kernel`` against ``min_dist2_plain`` on the
   card, on seeded inputs at 777x1311, N < 32, M = 1, M = 0 and
   50,000 x 50,000, with both times from CUDA events;
3. stage 1 at 512 (Bibi): ``global_carve`` bit-exact against the reference
   oracle, ``carve_monument_fused`` bit-exact against the JAX package's grid
   in ``tests/fixtures/torch_port_Bibi_512.npz``; cold and warm times, peak
   device memory; the grid saved in the reference layout;
4. notebook-5 metrics on the card: the stage-1 cloud against the committed
   stage-3 model — chamfer, F-score@τ and the F1 curve — held against the
   fixture's float64 cKDTree values and its JAX values.  The kernel's launch
   count over phases 3-4 must be positive.

The last two lines are the kernels' JSON record and the result line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result, when
there is no CUDA device or any check fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from pbr3d_torch.carving.fused import carve_monument_fused
from pbr3d_torch.carving.stage1 import global_carve
from pbr3d_torch.carving.voxel import all_points
from pbr3d_torch.config import rgb_to_labels
from pbr3d_torch.eval import inter
from pbr3d_torch.io.artifacts import load_voxel_grid_labels, save_voxel_grid
from pbr3d_torch.io.masks import MaskSet
from pbr3d_torch.ops.cuda_kernels import load_extension, min_dist2_kernel, min_dist2_plain

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
KERNEL_SHAPES = ((777, 1311), (19, 1000), (100, 1), (100, 0), (50000, 50000))


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


def phase_kernel() -> dict:
    rng = np.random.default_rng(0)
    max_abs = 0.0
    for n, m in KERNEL_SHAPES:
        A = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).cuda()
        B = torch.from_numpy(rng.normal(size=(m, 3)).astype(np.float32)).cuda()
        k = min_dist2_kernel(A, B)
        p = min_dist2_plain(A, B)
        torch.cuda.synchronize()
        check(k.shape == (n,) and k.dtype == torch.float32, f"kernel output {k.shape} {k.dtype}")
        if m == 0:
            check(bool(torch.isinf(k).all()) and bool((k > 0).all()), "M = 0 must give +inf")
            log(f"kernel_vs_plain {n}x{m}: all +inf")
            continue
        check(bool(torch.isfinite(k).all()), f"non-finite kernel output at {n}x{m}")
        err = (k - p).abs()
        rel = float((err / p.abs().clamp_min(1e-30)).max())
        max_abs = max(max_abs, float(err.max()))
        log(f"kernel_vs_plain {n}x{m}: max_abs_err={float(err.max()):.3e} "
            f"max_rel_err={rel:.3e} tol_rel={KERNEL_RTOL:g}")
        check(rel <= KERNEL_RTOL, f"kernel disagrees with plain at {n}x{m}: rel {rel}")

    A = torch.from_numpy(rng.normal(size=(50000, 3)).astype(np.float32)).cuda()
    B = torch.from_numpy(rng.normal(size=(50000, 3)).astype(np.float32)).cuda()
    for _ in range(2):  # warm-up
        min_dist2_kernel(A, B)
        min_dist2_plain(A, B)
    plain = [cuda_ms(lambda: min_dist2_plain(A, B), 3)]
    kern = [cuda_ms(lambda: min_dist2_kernel(A, B), 20) for _ in range(2)]
    plain.append(cuda_ms(lambda: min_dist2_plain(A, B), 3))
    log(f"min_dist2 50000x50000: kernel_ms={kern} plain_ms={plain}")
    return {"max_abs_err": max_abs, "ms": float(np.mean(kern)), "plain_ms": float(np.mean(plain))}


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


def phase_metrics(fx, grid: np.ndarray) -> None:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    A = inter.normalize_preserve_aspect(all_points(grid, device="cuda")[0], device="cuda")
    B = inter.normalize_preserve_aspect(
        all_points(load_voxel_grid_labels(STAGE3), device="cuda")[0], device="cuda")
    chamfer = inter.chamfer_distance(A, B, device="cuda")
    fscore = np.asarray(inter.fscore_with_threshold(A, B, float(fx["tau"]), device="cuda"))
    curve = np.stack(inter.compute_f1_curve(A, B, fx["thresholds"], device="cuda"))
    secs = time.perf_counter() - t0
    log(f"metrics: clouds {tuple(A.shape)} vs {tuple(B.shape)}, {secs:.3f} s")
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
    load_extension()
    log(f"kernel build+load: {time.perf_counter() - t0:.1f} s")

    kernel = phase_kernel()

    fx = np.load(FIXTURE)
    min_dist2_kernel.launches = 0  # count the main path only
    grid = phase_stage1(fx)
    phase_metrics(fx, grid)
    launches = min_dist2_kernel.launches
    check(launches > 0, "the metrics never launched the min-dist kernel")

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
