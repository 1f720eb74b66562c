#!/usr/bin/env python3
"""The components kernels of an earlier checkout against this checkout's, on
one card, in one call.

    mkdir -p build/parent && git archive <commit> pbr3d_torch | tar -x -C build/parent
    python3 scripts/components_ab.py --parent build/parent [--out PATH]

``--parent`` names a directory that holds an earlier checkout's
``pbr3d_torch/ops/cuda_kernels.py`` and ``pbr3d_torch/csrc``; its wrapper is
loaded from there and builds its kernels the way that checkout did.  Both
wrappers label the same masks: every case of ``chip_smoke.COMPONENT_CASES``
under face and full connectivity, the Bibi@512 part masks and occupancy of
``tests/fixtures/torch_port_Bibi_512.npz`` (the occupancy under both), and
the largest mask that the unfused ``carve_monument`` labels on Bibi@512 and
on the study scenes of ``tests/fixtures/torch_port_study.npz`` (the path's
largest crop).  Labels and n must be equal byte for byte, and both builds'
statistics of those labels equal.  Then both kernels of both builds are
timed by CUDA events in turns (parent, current, current, parent) on the
path's part mask (``chip_smoke.COMPONENT_TIMED_PART``), the occupancy and
the path's largest crop, beside the byte bounds and the share of them, with
the card's SM clock and power.  Prints the card's name and power limit,
each build's seconds and ``-Xptxas -v`` lines of the components kernels.
``--out`` writes the report as JSON.  Exits non-zero when an output
differs.  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from pbr3d_torch import config  # noqa: E402
from pbr3d_torch.carving.stage1 import carve_monument  # noqa: E402
from pbr3d_torch.io.masks import MaskSet  # noqa: E402
from pbr3d_torch.ops import components  # noqa: E402


def path_largest_crop(fx, fxs) -> np.ndarray:
    """The largest mask the unfused carves of Bibi@512 and the ten study
    scenes label (the default preset), as a host array."""
    largest: dict = {}
    real = components.components_kernel

    def recording(vol, full):
        if vol.numel() > largest.get("numel", -1):
            largest.update(numel=vol.numel(), mask=vol.bool().cpu().numpy())
        return real(vol, full)

    scenes = [MaskSet.from_labels(fx["binary"], fx["exterior_labels"], fx["semantic_labels"])]
    scenes += [MaskSet.from_labels(*(fxs[f"{tag}_{m}_{k}"] for k in ("binary", "exterior", "semantic")))
               for tag in cs.STUDY_RUNS for m in config.MONUMENTS]
    with mock.patch.object(components, "components_kernel", recording):
        for masks in scenes:
            carve_monument(masks, device="cuda")
    return largest["mask"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("components_ab: no CUDA device", file=sys.stderr)
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
            if "components_cu" in entry and ("registers" in ln or "spill" in ln):
                print(f"{name}: {entry[40:100]}: {ln.strip()}", flush=True)
        print(f"{name}: build_s={report['build_s'][name]:.2f}", flush=True)

    fx = np.load(cs.FIXTURE)
    grid = np.ascontiguousarray(fx["grid"])
    masks = [(f"{kind} {shape}", cs.component_case_mask(kind, shape), conn)
             for kind, shape in cs.COMPONENT_CASES for conn in ("face", "full")]
    parts = {name: grid == config.PART_IDS[name] for name in cs.COMPONENT_PARTS}
    parts["occupancy"] = grid > 0
    masks += [(f"Bibi@512 {name}", mask, "face") for name, mask in parts.items()]
    masks.append(("Bibi@512 occupancy", parts["occupancy"], "full"))
    crop = path_largest_crop(fx, np.load(cs.STUDY))
    masks.append((f"path's largest crop {crop.shape}", crop, "face"))

    report["cases"] = {}
    unequal = 0
    for what, mask, conn in masks:
        vol = torch.from_numpy(np.ascontiguousarray(mask).view(np.uint8)).cuda()
        (plab, pn), (lab, n) = (mod.components_kernel(vol, conn == "full") for mod in wrappers.values())
        same = pn == n and torch.equal(plab, lab)
        stats = [mod.component_stats_kernel(lab, n) for mod in wrappers.values()]
        same_stats = all(torch.equal(a, b) for a, b in zip(*stats))
        torch.cuda.synchronize()
        unequal += not (same and same_stats)
        report["cases"][f"{what} {conn}"] = {"n": n, "labels_equal": same, "stats_equal": same_stats}
        print(f"{what} {conn}: n={n} labels equal={same} stats equal={same_stats}", flush=True)
        del plab, lab, stats

    names = list(wrappers)
    order = names + names[::-1]
    report["shapes"] = {}
    for what, mask in ((cs.COMPONENT_TIMED_PART, parts[cs.COMPONENT_TIMED_PART]), ("occupancy", parts["occupancy"]),
                       ("path_crop", crop)):
        vol = torch.from_numpy(np.ascontiguousarray(mask).view(np.uint8)).cuda()
        labels, n = current.components_kernel(vol, False)
        bound, stats_bound = cs.components_bound(mask.size)
        row = {"shape": list(mask.shape), "n": n}
        for kernel, fn, b in (("components", lambda mod: mod.components_kernel(vol, False), bound),
                              ("component_stats", lambda mod: mod.component_stats_kernel(labels, n), stats_bound)):
            samples: list = []
            with cs.smi_samples(samples):
                t = cs.time_in_turns({x: (lambda mod=mod: fn(mod)) for x, mod in wrappers.items()},
                                     {x: 20 for x in names}, order)
            cell = {x: {"ms": t[x], "mean_ms": float(np.mean(t[x])), "share_of_bound": b / float(np.mean(t[x]))}
                    for x in names}
            cell.update(bound_ms=b, bound_by="bytes", smi=cs.smi_summary(samples))
            row[kernel] = cell
            print(f"{kernel} {what} {mask.shape}: " + " ".join(f"{x}={cell[x]['mean_ms']:.4f}ms{t[x]}" for x in names)
                  + f" bound_ms={b:.4f} (bytes) " + " ".join(f"{x}_share={cell[x]['share_of_bound']:.3f}" for x in names)
                  + f" speedup={cell['parent']['mean_ms'] / cell['current']['mean_ms']:.3f}; {cell['smi']}", flush=True)
        row["current_device_ms_by_pass"] = cs.components_pass_ms(vol, False)
        print(f"current labelling {what}: device ms by pass {row['current_device_ms_by_pass']}", flush=True)
        report["shapes"][what] = row
        del labels
        torch.cuda.empty_cache()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    print(f"cases with unequal outputs: {unequal} of {len(masks)}")
    print(card)
    return 1 if unequal else 0


if __name__ == "__main__":
    sys.exit(main())
