#!/usr/bin/env python3
"""The knn kernel of an earlier checkout against this checkout's, on one
card, in one call.

    mkdir -p build/parent && git archive <commit> pbr3d_torch | tar -x -C build/parent
    python3 scripts/knn_ab.py --parent build/parent [--out PATH]

``--parent`` names a directory that holds an earlier checkout's
``pbr3d_torch/ops/cuda_kernels.py`` and ``pbr3d_torch/csrc``; its wrapper is
loaded from there and builds its kernels the way that checkout built them.
Both wrappers run on ``chip_smoke.py``'s seeded inputs.  First, at every
case of ``chip_smoke.KNN_CASES``, the two outputs must be equal: the same
distance bits and the same indices.  Then each of ``chip_smoke.KNN_TIMED`` is
timed by CUDA events in turns (parent, current, current, parent) beside the
bound and the share of it, with the card's SM clock and power.  Prints each
build's seconds and ``-Xptxas -v`` lines for knn, and each knn instantiation's
resident blocks per SM in this checkout.  ``--out`` writes the report as
JSON.  Exits non-zero when an output differs.  Needs one card.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("knn_ab: no CUDA device", file=sys.stderr)
        return 2
    card = cs.query_card()
    print(card, flush=True)
    from pbr3d_torch.ops import cuda_kernels as current

    wrappers = {"parent": cs.load_wrapper(args.parent.resolve()), "current": current}
    report: dict = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda, "build_s": {}}
    for name, mod in wrappers.items():
        t0 = time.perf_counter()
        lib = mod.load_extension()
        report["build_s"][name] = time.perf_counter() - t0
        entry = ""
        for ln in lib.build_log.splitlines():
            entry = ln.split("'")[1] if "Compiling entry function" in ln else entry
            if "knn" in entry and ("registers" in ln or "spill" in ln):
                print(f"{name}: {entry[:60]}: {ln.strip()}", flush=True)
        print(f"{name}: build_s={report['build_s'][name]:.2f}", flush=True)
    blocks = {cap: current._knn_card_slots(0, cap)[1] for cap in current.KNN_CAPACITIES}
    report["blocks_per_sm"] = blocks
    print(f"current: resident blocks per SM by capacity {blocks}", flush=True)

    report["cases"] = {}
    unequal = 0
    for kind, n, m, k in cs.KNN_CASES:
        A, B = cs.knn_inputs(kind, n, m)
        (pd, pi), (d, i) = (mod.knn_kernel(A, B, k) for mod in wrappers.values())
        torch.cuda.synchronize()
        same_d = torch.equal(pd.view(torch.int32), d.view(torch.int32))
        same_i = torch.equal(pi, i)
        unequal += not (same_d and same_i)
        what = f"{kind} {n}x{m} k={k}"
        report["cases"][what] = {"distance_bits_equal": same_d, "indices_equal": same_i,
                                 "indices_unequal": int((pi != i).sum())}
        print(f"{what}: distance bits equal={same_d} indices equal={same_i}", flush=True)

    names = list(wrappers)
    order = names + names[::-1]
    report["shapes"] = {}
    for n, m, k in cs.KNN_TIMED:
        A, B = cs.knn_inputs("normal", n, m)
        fns = {name: (lambda mod=mod: mod.knn_kernel(A, B, k)) for name, mod in wrappers.items()}
        samples: list = []
        with cs.smi_samples(samples):
            t = cs.time_in_turns(fns, {name: 10 for name in names}, order)
        torch.cuda.empty_cache()
        bound, bound_by = cs.knn_bound(n, m, k)
        row = {name: {"ms": t[name], "mean_ms": float(np.mean(t[name])),
                      "share_of_bound": bound / float(np.mean(t[name]))} for name in names}
        row.update(bound_ms=bound, bound_by=bound_by, smi=cs.smi_summary(samples))
        report["shapes"][f"{n}x{m} k={k}"] = row
        print(f"{n}x{m} k={k}: " + " ".join(f"{x}={row[x]['mean_ms']:.4f}ms{t[x]}" for x in names)
              + f" bound_ms={bound:.4f} ({bound_by}) "
              + " ".join(f"{x}_share={row[x]['share_of_bound']:.3f}" for x in names)
              + f" speedup={row['parent']['mean_ms'] / row['current']['mean_ms']:.3f}; {row['smi']}",
              flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    print(f"cases with unequal outputs: {unequal} of {len(cs.KNN_CASES)}")
    print(card)
    return 1 if unequal else 0


if __name__ == "__main__":
    sys.exit(main())
