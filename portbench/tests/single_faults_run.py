#!/usr/bin/env python3
"""A fault of ``test_single.py`` planted in the timed path of the per-monument
cell, at the cell's own size on the card, over a few seeds in one process:

    python3 portbench/tests/single_faults_run.py --fault warp_off_by_one --seconds 3 --seeds 1 2

One JSON line a seed (the numbers compared and ``correct``) on standard
output and in ``chiprun_out/faults/study-golden.single-bibi.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
sys.path[:0] = [str(REPO), str(HERE)]


def main(argv=None) -> int:
    from test_single import CELL, SINGLE_FAULTS, planted

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fault", required=True, choices=sorted(SINGLE_FAULTS))
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    from portbench.harness import device
    from portbench.harness.bench import execute

    device.cards_or_exit(1)
    with open(REPO / "BENCHMARK.json") as fh:
        bench = json.load(fh)
    out_dir = REPO / "chiprun_out" / "faults"
    out_dir.mkdir(parents=True, exist_ok=True)
    for seed in args.seeds:
        with planted(args.fault):
            line = execute(bench, CELL, seed, args.seconds, False)
        rec = {"seed": seed, "fault": args.fault, "correct": line["correct"],
               "numbers": {k: v["value"] for k, v in line["compared"].items()}}
        print(json.dumps(rec), flush=True)
        with open(out_dir / f"{CELL}.jsonl", "a") as fh:
            fh.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
