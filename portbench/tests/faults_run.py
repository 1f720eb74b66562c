#!/usr/bin/env python3
"""A fault of ``test_checks.py`` planted in the timed path of one cell, at
the cell's own size on the card, over a few seeds in one process:

    python3 portbench/tests/faults_run.py --workload study-golden.nb5 --fault icp_state_unchanged --seconds 3 --seeds 1 2 3

One JSON line a seed (the numbers compared and ``correct``) on standard
output and in ``chiprun_out/faults/<cell>.jsonl``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path
from unittest import mock

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
sys.path[:0] = [str(REPO), str(HERE)]


def main(argv=None) -> int:
    import test_checks

    faults = {**test_checks.STUDY_FAULTS, **test_checks.NB5_FAULTS}
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=sorted(faults))
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
    target, make = faults[args.fault]
    mod_name, attr = target.rsplit(".", 1)
    mod = importlib.import_module(mod_name)
    for seed in args.seeds:
        with mock.patch.object(mod, attr, make(getattr(mod, attr))):
            line = execute(bench, args.workload, seed, args.seconds, False)
        rec = {"seed": seed, "fault": args.fault, "correct": line["correct"],
               "numbers": {k: v["value"] for k, v in line["compared"].items()}}
        print(json.dumps(rec), flush=True)
        with open(out_dir / f"{args.workload}.jsonl", "a") as fh:
            fh.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
