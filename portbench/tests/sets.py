#!/usr/bin/env python3
"""Two sets of runs of one cell, the same seeds in both, each run its own
process as a check makes them, and each end-to-end metric's spread:

    python3 portbench/tests/sets.py --workload study-256.study --seeds 1 2 3 4 5 6 [--traced 7 8 9]

A spread is the distance between the first and the third quartile
(``statistics.quantiles(values, n=4)``) as a share of the median; the bound
to set is about five times the wider of the two sets' spreads, and never
under 1 %.  ``--traced`` seeds add runs with ``--trace 1``.  Every result
line goes to ``chiprun_out/sets/<cell>.jsonl``; the summary to standard
output and ``chiprun_out/sets/<cell>.summary.json``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def one_run(cell: str, seed: int, seconds: int, trace: int, log_dir: Path) -> dict:
    t0 = time.perf_counter()
    tag = f"{cell}.s{seed}.t{trace}.{int(time.time() * 1000) % 10**8}"
    with open(log_dir / f"{tag}.err", "w") as err:
        proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed", str(seed),
                               "--seconds", str(seconds), "--trace", str(trace)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=err, text=True, timeout=1200)
    lines = proc.stdout.strip().splitlines()
    rec = json.loads(lines[-1]) if proc.returncode == 0 and lines else {"error": proc.returncode}
    rec["_seed"], rec["_trace"], rec["_wall_s"] = seed, trace, time.perf_counter() - t0
    return rec


def spread(values: list) -> float:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--traced", type=int, nargs="*", default=[])
    ap.add_argument("--sets", type=int, default=2)
    args = ap.parse_args(argv)
    with open(REPO / "BENCHMARK.json") as fh:
        seconds = json.load(fh)["run_seconds"]
    out_dir = REPO / "chiprun_out" / "sets"
    log_dir = out_dir / "logs"
    log_dir.mkdir(parents=True, exist_ok=True)
    sets = []
    with open(out_dir / f"{args.workload}.jsonl", "a") as fh:
        for s in range(args.sets):
            runs = []
            for seed in args.seeds:
                rec = one_run(args.workload, seed, seconds, 0, log_dir)
                rec["_set"] = s
                fh.write(json.dumps(rec) + "\n")
                fh.flush()
                runs.append(rec)
                print(json.dumps({k: rec.get(k) for k in ("_set", "_seed", "_wall_s", "correct", "failed")}
                                 | {m: v["value"] for m, v in rec.get("metrics", {}).items()}), flush=True)
            sets.append(runs)
        for seed in args.traced:
            rec = one_run(args.workload, seed, seconds, 1, log_dir)
            fh.write(json.dumps(rec) + "\n")
            print(json.dumps({k: rec.get(k) for k in ("_seed", "_wall_s", "correct", "failed")}
                             | {m: v["value"] for m, v in rec.get("metrics", {}).items()}
                             | {"busy_s": rec.get("device", {}).get("busy_s"),
                                "window_s": rec.get("device", {}).get("window_s")}), flush=True)
    summary = {"cell": args.workload, "seconds": seconds, "metrics": {}}
    names = sorted({m for runs in sets for r in runs for m in r.get("metrics", {})})
    for m in names:
        per = []
        for runs in sets:
            vals = [r["metrics"][m]["value"] for r in runs if m in r.get("metrics", {})]
            # the first run of a set in a fresh checkout builds the library
            steady = vals[1:] if m == "setup_s" else vals
            per.append({"median": statistics.median(steady), "spread": spread(steady) if len(steady) >= 2 else None,
                        "values": vals})
        widest = max(p["spread"] for p in per if p["spread"] is not None)
        summary["metrics"][m] = {"sets": per, "widest_spread": widest, "bound_5x": max(0.01, 5 * widest)}
    summary["correct"] = [r.get("correct") for runs in sets for r in runs]
    with open(out_dir / f"{args.workload}.summary.json", "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
