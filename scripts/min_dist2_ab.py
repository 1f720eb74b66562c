#!/usr/bin/env python3
"""The min-dist kernel of an earlier checkout against this checkout's, on
one card, in one call.

    mkdir -p build/parent && git archive <commit> pbr3d_torch | tar -x -C build/parent
    python3 scripts/min_dist2_ab.py --parent build/parent [--skip-current] [--out PATH]

``--parent`` names a directory that holds an earlier checkout's
``pbr3d_torch/ops/cuda_kernels.py`` and ``pbr3d_torch/csrc``; its wrapper is
loaded from there and builds its kernel the way that checkout built it.
Both wrappers run on ``chip_smoke.py``'s seeded inputs.  For each: the build
seconds, the sha256 of the output at every shape of ``chip_smoke.KERNEL_SHAPES``
and whether it equals ``chip_smoke.REFERENCE_SHA256``, and the time at the two
main-path shapes, taken in turns (parent, current, current, parent) beside
the plain version and ``torch.cdist``, with the bound, the share of it, and
the card's SM clock and power.  The main path's six launches (four at 20k,
two at 50k) are summed from those times.  ``--out`` writes the whole report
as JSON.  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from pbr3d_torch.ops.cuda_kernels import min_dist2_plain  # noqa: E402

#: Launches of each main-path shape in one metrics run.
MAIN_PATH_LAUNCHES = {(20000, 20000): 4, (50000, 50000): 2}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--skip-current", action="store_true",
                    help="time the parent's kernel only")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("min_dist2_ab: no CUDA device", file=sys.stderr)
        return 2
    card = cs.query_card()
    print(card, flush=True)
    from pbr3d_torch.ops import cuda_kernels as current

    wrappers = {"parent": cs.load_wrapper(args.parent.resolve())}
    if not args.skip_current:
        wrappers["current"] = current
    report: dict = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                    "variants": {}}
    for name, mod in wrappers.items():
        t0 = time.perf_counter()
        mod.load_extension()
        build_s = time.perf_counter() - t0
        hashes = {}
        for n, m in cs.KERNEL_SHAPES:
            A, B = (torch.from_numpy(x).cuda() for x in cs.kernel_inputs(n, m))
            out = mod.min_dist2_kernel(A, B)
            torch.cuda.synchronize()
            hashes[f"{n}x{m}"] = cs.sha256(out)
        equal = {k: v == cs.REFERENCE_SHA256.get(tuple(map(int, k.split("x"))))
                 for k, v in hashes.items()}
        report["variants"][name] = {"build_s": build_s, "sha256": hashes, "sha256_equal": equal}
        print(f"{name}: build_s={build_s:.2f} sha256_equal_to_reference={equal}", flush=True)
        print(f"{name}: sha256={json.dumps(hashes)}", flush=True)

    names = list(wrappers)
    order = names + names[::-1]
    report["shapes"] = {}
    for n, m in cs.TIMED_SHAPES:
        A, B = (torch.from_numpy(x).cuda() for x in cs.kernel_inputs(n, m))
        fns = {name: (lambda mod=mod: mod.min_dist2_kernel(A, B)) for name, mod in wrappers.items()}
        fns["plain"] = lambda: min_dist2_plain(A, B)
        fns["library"] = lambda: cs.min_dist2_library(A, B)
        reps = {name: 20 if n * m > 1e9 else 50 for name in names}
        reps.update(plain=3, library=3)
        samples: list = []
        with cs.smi_samples(samples):
            t = cs.time_in_turns(fns, reps, ["plain", "library"] + order + ["library", "plain"])
        torch.cuda.empty_cache()
        bound, bound_by = cs.min_dist2_bound(n, m)
        row = {k: {"ms": v, "mean_ms": float(np.mean(v))} for k, v in t.items()}
        for name in names:
            row[name]["share_of_bound"] = bound / row[name]["mean_ms"]
        row.update(bound_ms=bound, bound_by=bound_by, smi=cs.smi_summary(samples))
        report["shapes"][f"{n}x{m}"] = row
        print(f"{n}x{m}: " + " ".join(f"{k}={row[k]['mean_ms']:.4f}ms{t[k]}" for k in t)
              + f" bound_ms={bound:.4f} ({bound_by}) "
              + " ".join(f"{k}_share={row[k]['share_of_bound']:.3f}" for k in names)
              + f"; {row['smi']}", flush=True)
    report["main_path_ms"] = {
        name: sum(k * report["shapes"][f"{n}x{m}"][name]["mean_ms"]
                  for (n, m), k in MAIN_PATH_LAUNCHES.items())
        for name in names}
    print(f"six main-path launches (4 x 20k + 2 x 50k): {report['main_path_ms']}", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
