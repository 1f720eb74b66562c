#!/usr/bin/env python3
"""The study bench of the PyTorch port (``pbr3d_torch``) on one NVIDIA GPU:
``bench.py``'s five-monument study, timing protocol, quality gates and
one-line JSON.

    python3 bench_torch.py                              # 256, 5 passes
    PBR3D_BENCH_MAX_DIM=golden python3 bench_torch.py   # golden, 3 passes
    python3 bench_torch.py --trace                      # + one profiled pass

What it runs: ``pipeline.run_all_body`` over the five monuments of
``tests/fixtures/torch_port_study.npz``, at one of ``CONFIGS``:

* ``"256"``: ``bench.py``'s own knobs (stage 2 at generations 12 and
  population 192, seed 0; stage 3 at search stride 8);
* ``"golden"``: each monument at its golden resolution (512; Akbar 128), with
  nothing else set.

The PNG dataset is not in the repository, so the masks are the fixture's:
stage 1's front planes recovered from the committed stage-1 grids, and a front
and a drone view planted through the committed cameras
(``scripts/make_torch_port_study_fixture.py``).  ``strict=False`` as in
``bench.py``: a lost monument shows as ``quality_ok: false``; a device fault
raises.  No artifact is written.

Protocol (``bench.py:157-169``): pass 1 is ``cold_s``; ``value`` is the median
of the other passes, each clock stopped after ``torch.cuda.synchronize()``.
``PBR3D_BENCH_PASSES`` sets the number of passes (default 5 at 256, 3 at
golden).  With ``--trace`` one more pass runs under ``torch.profiler``,
apart from the median: its kernels' busy seconds over the steady median are
the device-busy share.

Gates (``bench.py:177-204``, :mod:`pbr3d_torch.eval.gates`), from the last
timed pass: stage-1 occupancy IoU against the JAX package's committed grids
in ``results_temp_golden/1.Orthographic_Voxel_Carving``, stage-3 whole IoU
(against the scene's front plane, which must have the unpadded stage-1 grid's
notebook-4 shape, ``io.masks.voxel_grid_mask_shape``), stage-3 mean part IoU.
``quality_ok`` needs every monument and every gate.

The last line of standard output is the JSON: ``bench.py``'s keys under the
same names, then ``KEYS``' added ones.  It runs on the card: with no CUDA
device it exits non-zero and prints no result (``--device cpu`` is for the
tests).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from pbr3d_torch import config, pipeline
from pbr3d_torch.eval import gates
from pbr3d_torch.io.artifacts import load_voxel_grid_labels
from pbr3d_torch.io.masks import MaskSet, voxel_grid_mask_shape
from pbr3d_torch.pipeline import SceneMasks

REPO = Path(__file__).resolve().parent
STUDY = REPO / "tests/fixtures/torch_port_study.npz"
#: The JAX package's committed stage-1 grids, in place of the reference's
#: ``results/`` (absent here and on the card's machine).
GOLDEN_DIR = REPO / "results_temp_golden/1.Orthographic_Voxel_Carving"
STUDY_MASKS = ("tests/fixtures/torch_port_study.npz: stage-1 front planes recovered from the committed "
               "stage-1 grids, front and drone views planted through the committed cameras "
               "(scripts/make_torch_port_study_fixture.py); not the PNG dataset")

#: The two configurations: what ``run_all_body`` is given.
CONFIGS = {
    "256": dict(max_dim=256, stage2_kw=dict(generations=12, population=192, seed=0),
                stage3_kw=dict(search_stride=8)),
    "golden": dict(max_dim=None),
}
#: ``bench.py``'s baseline: the reference's stage 1 alone on one CPU core for
#: the five monuments (BASELINE.md), not a device number.
BASELINE_S_BY_MODE = {"256": 148.5, "golden": 1050.0}
BASELINE_SCOPE = ("reference stage-1 only (its stages 2-3 are human-interactive; ours are automated "
                  "and included in value)")

#: ``bench.py``'s keys, then the ones this bench adds; ``TRACE_KEYS`` with a
#: profiled pass: its kernels' busy seconds (the union of their intervals),
#: those over ``value`` (the profiler stretches the host's wall, not the
#: kernels), and its own wall.
KEYS = ("metric", "value", "unit", "vs_baseline", "baseline_scope", "cold_s", "stage1_s",
        "vs_stage1_baseline", "stage1_iou_min", "stage3_whole_iou_min", "stage3_mean_part_iou_min",
        "quality_ok",
        "value_min", "value_max", "passes", "device", "card", "peak_allocated_bytes",
        "peak_reserved_bytes", "stage_s", "quality", "masks", "stage1_golden_dir")
TRACE_KEYS = ("device_busy_s", "device_busy_share", "traced_wall_s")


def query_card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def device_profile(fn):
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


def study_scenes(fxs, tag: str) -> dict:
    """``{monument: SceneMasks}`` of the study fixture ``fxs`` at one of
    ``CONFIGS``."""
    scenes = {}
    for m in config.MONUMENTS:
        planes = (fxs[f"{tag}_{m}_{k}"] for k in ("binary", "exterior", "semantic"))
        # the planted front view serves stages 2 and 3 and, no monument's
        # padded grid outgrowing its mask's larger side, as the notebook-4
        # mask too
        front = fxs[f"{tag}_{m}_front"]
        scenes[m] = SceneMasks(MaskSet.from_labels(*planes), {"front": front, "drone": fxs[f"{tag}_{m}_drone"]},
                               front)
    return scenes


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _gates(scenes, results, golden_dir: Path, device) -> tuple:
    """(stage-1 IoUs, stage-3 whole IoUs, mean part IoUs) by monument, rounded
    as ``bench.py`` rounds them."""
    s1, s3, s3p = {}, {}, {}
    for m, r in results.items():
        path = golden_dir / f"{m}_voxel_grid.npz"
        if path.exists():
            iou1 = gates.stage1_iou_vs_golden(r.grid_stage1, load_voxel_grid_labels(path))
            if iou1 is None:
                print(f"[bench] {m}: golden shape incomparable to {r.grid_stage1.shape}, "
                      f"skipping stage-1 gate", file=sys.stderr)
            else:
                s1[m] = round(float(iou1), 4)
        cam = r.cameras["final"].get("front") or next(iter(r.cameras["final"].values()))
        # bench.py resizes the front PNG to the unpadded stage-1 grid; the
        # study's front planes have that shape already, in all ten scenes
        front = scenes[m].views["front"]
        hw = voxel_grid_mask_shape(front.shape, r.grid_stage1.shape)
        if front.shape[:2] != hw:
            raise ValueError(f"{m}: front plane {front.shape[:2]} is not the notebook-4 shape {hw} "
                             f"of its stage-1 grid {r.grid_stage1.shape}")
        s3[m] = round(float(gates.stage3_whole_iou(r.grid_stage3, cam, front, r.grid_stage1, device=device)), 4)
        s3p[m] = round(gates.mean_part_iou(r.deform_params), 4)
    return s1, s3, s3p


def bench(scenes, kw, passes: int, *, device, golden_dir, trace: bool = False) -> dict:
    """The study bench over ``{monument: SceneMasks}`` (the study fixture's,
    ``study_scenes``): ``passes`` calls of ``run_all_body(scenes, **kw)``, the
    gates on the last against the stage-1 goldens in ``golden_dir``, and the
    JSON record (``KEYS``, plus ``TRACE_KEYS`` with ``trace``)."""
    if passes < 1:
        raise ValueError(f"passes={passes}: the bench needs at least one pass")
    cuda = torch.device(device).type == "cuda"
    if trace and not cuda:
        raise ValueError("the trace reads the card's kernels; it needs a CUDA device")
    golden_dir = Path(golden_dir)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    times, results = [], {}
    for p in range(passes):
        _sync(device)
        t0 = time.perf_counter()
        results = pipeline.run_all_body(scenes, out_dir=None, device=device, **kw)
        _sync(device)
        times.append(time.perf_counter() - t0)
        print(f"[bench] pass {p + 1}/{passes}: {times[-1]:.1f}s", file=sys.stderr, flush=True)
    peak = (torch.cuda.max_memory_allocated(device), torch.cuda.max_memory_reserved(device)) if cuda \
        else (None, None)
    steady = times[1:] or times
    value = statistics.median(steady)
    print("[bench] per-monument stage timings: " + json.dumps(
        {m: {k: round(v, 3) for k, v in r.timings.items()} for m, r in results.items()}),
        file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    s1, s3, s3p = _gates(scenes, results, golden_dir, device)
    print(f"[bench] gates: {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    quality = {m: {"stage1_iou_vs_golden": s1.get(m), "stage3_whole_iou": s3[m],
                   "stage3_mean_part_iou": s3p[m], "views": sorted(r.cameras["final"])}
               for m, r in results.items()}
    print(f"[bench] quality: {quality}", file=sys.stderr)
    quality_ok = (len(results) == len(scenes)
                  and all(v >= gates.STAGE1_IOU_MIN for v in s1.values())
                  and all(v >= gates.STAGE3_WHOLE_IOU_MIN for v in s3.values())
                  and all(v >= gates.STAGE3_MEAN_PART_IOU_MIN for v in s3p.values()))
    if not quality_ok:
        print(f"[bench] QUALITY GATE FAILED: {len(results)}/{len(scenes)} monuments, stage1 {s1}, "
              f"stage3_whole {s3}, stage3_mean_part {s3p}", file=sys.stderr)

    tag = "golden" if kw.get("max_dim") is None else str(kw["max_dim"])
    baseline_s = BASELINE_S_BY_MODE.get(tag, 148.5)
    # the stage sums of the last pass; the batched stages 1 and 2 give each
    # monument an equal share of their wall
    stage_s = {k: sum(r.timings.get(k, 0.0) for r in results.values()) for k in ("stage1", "stage2", "stage3")}
    out = {
        "metric": f"full_3stage_pipeline_{len(scenes)}monuments_maxdim{tag}",
        "value": round(value, 3),
        "unit": "s",
        "vs_baseline": round(baseline_s / value, 3),
        "baseline_scope": BASELINE_SCOPE,
        "cold_s": round(times[0], 3),
        "stage1_s": round(stage_s["stage1"], 3),
        "vs_stage1_baseline": round(baseline_s / stage_s["stage1"], 3) if stage_s["stage1"] else None,
        "stage1_iou_min": min(s1.values()) if s1 else None,
        "stage3_whole_iou_min": min(s3.values()) if s3 else None,
        "stage3_mean_part_iou_min": min(s3p.values()) if s3p else None,
        "quality_ok": quality_ok,
        "value_min": round(min(steady), 3),
        "value_max": round(max(steady), 3),
        "passes": passes,
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "card": query_card() if cuda else None,
        "peak_allocated_bytes": peak[0],
        "peak_reserved_bytes": peak[1],
        "stage_s": {k: round(v, 3) for k, v in stage_s.items()},
        "quality": quality,
        "masks": STUDY_MASKS,
        "stage1_golden_dir": os.path.relpath(golden_dir, REPO),
    }
    if trace:
        t0 = time.perf_counter()
        wall, busy, top, _ = device_profile(lambda: pipeline.run_all_body(scenes, out_dir=None, device=device, **kw))
        print(f"[bench] profiled pass: wall {wall:.1f}s, {time.perf_counter() - t0:.1f}s with the trace's "
              f"collection and read", file=sys.stderr)
        for name, ms, n in top:
            print(f"[bench] traced kernel {ms:9.2f} ms  x{n:<6d} {name[:90]}", file=sys.stderr)
        out.update(device_busy_s=round(busy, 3), device_busy_share=round(busy / value, 4),
                   traced_wall_s=round(wall, 3))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", action="store_true", help="one more pass under torch.profiler (busy share)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help="cpu: for the tests only")
    args = ap.parse_args(argv)
    tag = os.environ.get("PBR3D_BENCH_MAX_DIM", "256")
    if tag not in CONFIGS:
        print(f"bench_torch: PBR3D_BENCH_MAX_DIM={tag!r}; expected one of {sorted(CONFIGS)}", file=sys.stderr)
        return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_torch: no CUDA device; this bench runs only on the card (--device cpu is for the tests)",
              file=sys.stderr)
        return 2
    passes = int(os.environ.get("PBR3D_BENCH_PASSES", "5" if tag == "256" else "3"))
    with np.load(STUDY) as fxs:
        scenes = study_scenes(fxs, tag)
    out = bench(scenes, CONFIGS[tag], passes, device=args.device, golden_dir=GOLDEN_DIR,
                trace=args.trace)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
