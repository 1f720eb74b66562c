#!/usr/bin/env python3
"""Sweep of the min-dist kernel's tile constants on one card.

    python3 scripts/min_dist2_variants.py [--out PATH]

Builds copies of ``pbr3d_torch/csrc/min_dist2.cu`` with other threads per
block, queries per thread, B unroll, tile length and resident-block hint
(all started together, one nvcc each, into ``build/min_dist2_variants/``),
then for each: its registers and spills, resident blocks per SM, the launch
plan at the main-path shapes, the time of its C call (the pack kernel and
the min-dist kernel) at 20k x 20k and 50k x 50k by CUDA events, taken in
turns, and the device time of each of the two kernels alone under
``torch.profiler``, each with its share of the bound.  Each output is held
to ``chip_smoke.REFERENCE_SHA256``.  The wrapper of the committed design is
timed beside them, so the cost of its host side shows.  Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from pbr3d_torch.ops import cuda_kernels as ck  # noqa: E402

#: name -> (threads, queries per thread, unroll, tile, min blocks per SM).
VARIANTS = {
    "t128_q8_u8": (128, 8, 8, 512, 4),
    "t128_q8_u4": (128, 8, 4, 512, 4),
    "t128_q8_u16": (128, 8, 16, 512, 4),
    "t128_q8_u8_b6": (128, 8, 8, 512, 6),
    "t256_q4_u8": (256, 4, 8, 512, 4),
    "t64_q16_u4": (64, 16, 4, 512, 4),
    "t128_q12_u4": (128, 12, 4, 512, 3),
    "t128_q8_u8_tile1024": (128, 8, 8, 1024, 4),
}


def variant_source(threads, queries, unroll, tile, min_blocks) -> str:
    src = (REPO / "pbr3d_torch/csrc/min_dist2.cu").read_text()
    for name, value in (("kThreads", threads), ("kQueries", queries), ("kUnroll", unroll),
                        ("kTile", tile)):
        src, k = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        assert k == 1, name
    src, k = re.subn(r"__launch_bounds__\(kThreads, \d+\)",
                     f"__launch_bounds__(kThreads, {min_blocks})", src)
    assert k == 1
    return src


def build_all(out_dir: Path) -> dict:
    from torch.utils.cpp_extension import CUDA_HOME

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, cfg in VARIANTS.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(variant_source(*cfg))
        procs[name] = subprocess.Popen(
            [str(Path(CUDA_HOME) / "bin" / "nvcc"), *ck.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log}", flush=True)
            continue
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        lib.pbr3d_min_dist2.argtypes = ck.load_extension().pbr3d_min_dist2.argtypes
        lib.pbr3d_min_dist2_blocks_per_sm.argtypes = [ctypes.POINTER(ctypes.c_int)]
        regs = re.search(r"Used (\d+) registers", log)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
        lib.info = {"registers": int(regs.group(1)) if regs else None,
                    "spill_bytes": [int(spills.group(1)), int(spills.group(2))] if spills else None}
        libs[name] = lib
    return libs


def plan_for(lib, n, m):
    blocks = ctypes.c_int(0)
    assert lib.pbr3d_min_dist2_blocks_per_sm(ctypes.byref(blocks)) == 0
    plan = ck._launch_plan(n, m, torch.cuda.get_device_properties(0).multi_processor_count, blocks.value,
                           lib.pbr3d_min_dist2_queries_per_block(), lib.pbr3d_min_dist2_b_step())
    return blocks.value, plan


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, help="write the report there as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("min_dist2_variants: no CUDA device", file=sys.stderr)
        return 2
    card = cs.query_card()
    print(card, flush=True)
    libs = build_all(REPO / "build" / "min_dist2_variants")
    stream = torch.cuda.current_stream().cuda_stream
    report: dict = {"card": card, "variants": {}}
    for n, m in cs.TIMED_SHAPES:
        A, B = (torch.from_numpy(x).cuda() for x in cs.kernel_inputs(n, m))
        bound, _ = cs.min_dist2_bound(n, m)
        fns, rows = {}, {}
        for name, lib in libs.items():
            per_sm, plan = plan_for(lib, n, m)
            B4 = torch.empty((plan.m_pad, 4), device="cuda")
            out = torch.empty((n,), device="cuda")

            def launch(lib=lib, plan=plan, B4=B4, out=out):
                assert lib.pbr3d_min_dist2(A.data_ptr(), n, B.data_ptr(), m, B4.data_ptr(),
                                           plan.m_pad, plan.chunk_len, out.data_ptr(), stream) == 0

            launch()
            torch.cuda.synchronize()
            _, _, top, _ = cs.device_profile(lambda launch=launch: [launch() for _ in range(10)])
            alone = {("pack" if "pack" in k else "main"): ms / count for k, ms, count in top}
            rows[name] = {
                **dict(zip(("threads", "queries", "unroll", "tile", "min_blocks"), VARIANTS[name])),
                **lib.info, "blocks_per_sm": per_sm, "plan": plan._asdict(),
                "sha256_equal": cs.sha256(out) == cs.REFERENCE_SHA256[(n, m)],
                "profiled_main_ms": alone.get("main"), "profiled_pack_ms": alone.get("pack"),
                "main_share_of_bound": bound / alone["main"] if alone.get("main") else None}
            fns[name] = launch
        fns["wrapper"] = lambda: ck.min_dist2_kernel(A, B)
        reps = {name: 20 if n * m > 1e9 else 50 for name in fns}
        order = list(fns) + list(fns)[::-1]
        t = cs.time_in_turns(fns, reps, order)
        for name in fns:
            ms = float(np.mean(t[name]))
            rows.setdefault(name, {}).update(ms=t[name], mean_ms=ms, share_of_bound=bound / ms)
            print(f"{n}x{m} {name}: {ms:.4f} ms share={bound / ms:.3f} "
                  f"{ {k: v for k, v in rows[name].items() if k not in ('ms', 'mean_ms', 'share_of_bound')} }",
                  flush=True)
        report["variants"][f"{n}x{m}"] = rows
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
