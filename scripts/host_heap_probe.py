#!/usr/bin/env python3
"""Host-bound stage 1 with glibc's default malloc thresholds against big
blocks kept on the heap, on one card.

    python3 scripts/host_heap_probe.py [--out PATH]   # runs the four processes below
    python3 scripts/host_heap_probe.py --child {default,kept}

The JAX package raises glibc's mmap and trim thresholds to 1 GiB when it is
imported (``pbr3d/utils/hostmem.py``), so large numpy temporaries are not
returned to the kernel and re-faulted.  The port imports nothing of it.
This script measures what that costs the port: Bibi@512 stage 1
(``carve_monument_fused``, host scipy labelling and numpy statistics
around the device sweeps) and the decode of the stage-3 artifact, each
three times warm, in processes taken in turns (default, kept, kept,
default), each process fresh.  Prints one JSON line per process; with
``--out PATH`` also writes them there as one JSON document.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def child(mode: str) -> dict:
    if mode == "kept":  # the JAX package's setting: M_MMAP_THRESHOLD, M_TRIM_THRESHOLD
        libc = ctypes.CDLL("libc.so.6")
        assert libc.mallopt(-3, 1 << 30) and libc.mallopt(-1, 1 << 30)
    import numpy as np
    import torch

    import chip_smoke as cs
    from pbr3d_torch.carving.fused import carve_monument_fused
    from pbr3d_torch.io.artifacts import load_voxel_grid_labels
    from pbr3d_torch.io.masks import MaskSet

    fx = np.load(cs.FIXTURE)
    masks = MaskSet.from_labels(fx["binary"], fx["exterior_labels"], fx["semantic_labels"])
    carve_monument_fused(masks, device="cuda")  # cold
    stage1, decode = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid = carve_monument_fused(masks, device="cuda")
        stage1.append(time.perf_counter() - t0)
        assert np.array_equal(grid, fx["grid"])
        t0 = time.perf_counter()
        load_voxel_grid_labels(cs.STAGE3)
        decode.append(time.perf_counter() - t0)
    return {"mode": mode, "stage1_warm_s": stage1, "decode_s": decode}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", choices=("default", "kept"))
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    rows = []
    for mode in ("default", "kept", "kept", "default"):
        out = subprocess.run([sys.executable, __file__, "--child", mode], check=True,
                             capture_output=True, text=True).stdout.strip().splitlines()[-1]
        print(out, flush=True)
        rows.append(json.loads(out))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "runs": rows}, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
