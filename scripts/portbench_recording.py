#!/usr/bin/env python3
"""One run of a benchmark cell with the program's span recorder on
(``pbr3d_torch.utils.profiling.recording()``) for the whole process, to
weigh what recording costs against the same run with it off:

    python3 scripts/portbench_recording.py --workload study-256.study --seed 7 --seconds 30 --trace 0

The arguments are ``portbench/run.py``'s and its result line is printed as
it prints it; the spans and the ``stage3.round_trips`` counts of each study
or notebook-5 pass go to standard error as one JSON line (``[recording]``).
Run it untraced: a traced run's metrics enter the recorder themselves.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def per_trace(spans) -> dict:
    """``{root name: [{"spans": n, "round_trips": n, "seconds": s}, ...]}``,
    one entry a trace, in the order the traces began."""
    by_trace = defaultdict(list)
    for s in spans:
        if s.trace is not None:
            by_trace[s.trace].append(s)
    out = defaultdict(list)
    for t in sorted(by_trace):
        roots = [s for s in by_trace[t] if s.parent is None]
        if not roots:
            continue
        root = roots[0]
        out[root.name].append({"spans": len(by_trace[t]), "seconds": root.seconds,
                               "round_trips": sum(s.counts.get("stage3.round_trips", 0) for s in by_trace[t])})
    return dict(out)


def main() -> int:
    spec = importlib.util.spec_from_file_location("portbench_run", REPO / "portbench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    from pbr3d_torch.utils import profiling

    with profiling.recording() as spans:
        rc = run.main(sys.argv[1:])
    print("[recording] " + json.dumps({"spans": len(spans), "traces": per_trace(spans)}),
          file=sys.stderr, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
