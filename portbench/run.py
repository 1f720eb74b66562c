#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the card, from the root of a
checkout:

    python3 portbench/run.py --workload study-256.study --seed 7 --seconds 30 --trace 0

The last line of standard output is the result's JSON object; the numbers
compared for ``correct``, each beside its limit, are the last lines of
standard error.  With no CUDA device, or fewer than the cell asks for, it
exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# the kernel library's build is the program's own, at a fixed path inside
# the checkout (build/torch_kernels); any other compiler cache goes there too
os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "portbench_cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(REPO / "build" / "portbench_cache" / "torch_extensions")
sys.path.insert(0, str(REPO))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    with open(REPO / "BENCHMARK.json") as fh:
        bench = json.load(fh)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"portbench: no cell {args.workload!r}; BENCHMARK.json has {sorted(cells)}", file=sys.stderr)
        return 2

    from portbench.harness import device

    device.cards_or_exit(cells[args.workload]["chips"])
    from portbench.harness.bench import execute

    line = execute(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
