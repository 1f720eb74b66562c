#!/usr/bin/env python3
"""The program's readings and the control's, over many seeds of one cell, in
one process on the card:

    python3 portbench/tests/control_run.py --workload study-256.study --seconds 5 --seeds 1 2 3 [--control 3]

For each seed: one run of the cell (set-up, a window of ``--seconds``, the
check), whose numbers compared are the program's readings, then, for the
first ``--control`` seeds (all by default), the control's readings on the
same run: the plain reference computed in bfloat16, one precision below the
program's float32, in the program's place.  One JSON line a seed on standard output and in
``chiprun_out/control/<cell>.jsonl``.  The benchmark's own runs do not run
the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=None, help="seeds that also read the control (default: all)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from portbench.harness import device
    from portbench.harness.bench import execute

    if args.device == "cuda":
        device.cards_or_exit(1)
    with open(REPO / "BENCHMARK.json") as fh:
        bench = json.load(fh)
    out_dir = REPO / "chiprun_out" / "control"
    out_dir.mkdir(parents=True, exist_ok=True)
    n_control = len(args.seeds) if args.control is None else args.control
    for i, seed in enumerate(args.seeds):
        got = {}
        after = (lambda run, driver: got.update(driver.control(run))) if i < n_control else None
        line = execute(bench, args.workload, seed, args.seconds, False, device=args.device, after=after)
        rec = {"seed": seed, "correct": line["correct"], "attempted": line["attempted"], "failed": line["failed"],
               "program": {k: v["value"] for k, v in line["compared"].items()}, "control": got,
               "metrics": {k: v["value"] for k, v in line["metrics"].items()}}
        print(json.dumps(rec), flush=True)
        with open(out_dir / f"{args.workload}.jsonl", "a") as fh:
            fh.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
