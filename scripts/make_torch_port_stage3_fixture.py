"""Write ``tests/fixtures/torch_port_Bibi_512_stage3.npz``: the JAX package's
stage 3 (part-wise refinement) on Bibi at 512, for holding ``pbr3d_torch``
against it on the card.

Runs on the CPU with JAX, in about 2-3 minutes (the whole ``run_stage3`` at
its golden defaults dominates)::

    JAX_PLATFORMS=cpu python scripts/make_torch_port_stage3_fixture.py

Inputs, reused from the earlier fixtures rather than copied:

* the stage-1 ``grid`` of ``tests/fixtures/torch_port_Bibi_512.npz``;
* ``front_mask`` (318x512) and the JAX stage-2 front camera ``front_final``
  of ``tests/fixtures/torch_port_Bibi_512_stage2.npz``.

The mask is written as a PNG in the reference layout and
``pbr3d.pipeline.run_stage3`` runs on it as a user would (both profiles,
both schedules, the exact nb4 verify); the script records inside the run.

Contents:

* ``table_counts``, ``table_shell_counts`` (11,) and ``table_sums`` (11, 3):
  the point table of the padded grid; ``dome_coarse_shell`` (M, 3) int16:
  dome's coarse search shell window, coordinate for coordinate;
* ``zb_parts`` (names) and ``zb_identity`` (K, 318, 512) float32: the
  identity z-buffer of every present part;
* the first chain's pass-0 search of the dome: ``dome_rest`` (318, 512),
  the neighbour bundle ``dome_nb_{zb,base,gt,floor,valid}`` (cropped to
  159x256), the coarse-A batch ``dome_a_deforms`` (approx warp, coarse
  shell) and the exact refine batch ``dome_r_deforms`` (7-jitter, fine
  shell), each with the JAX score components ``dome_{a,r}_comps`` (P, 3);
* ``portfolio_labels`` / ``portfolio_totals`` (exact nb4 totals of the
  chains) and ``portfolio_pick``;
* ``final_parts``, ``final_deforms`` (K, 4) and ``final_ious``; the
  ``nb4_cells`` names with ``nb4_init`` / ``nb4_def`` and ``nb4_total``;
* ``whole_iou`` (``bench.py:107-136``) and ``mean_part_iou``
  (``bench.py:183-187``);
* ``deformed`` (512, 378, 512) uint8: the JAX deformed grid;
* ``jax_cpu_wall_s``: the JAX run's wall on the CPU that made the file.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import os
import re
import sys
import tempfile
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np


def _stage2_helpers():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_stage2_fixture", REPO / "scripts" / "make_torch_port_stage2_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage1", default=REPO / "tests/fixtures/torch_port_Bibi_512.npz")
    ap.add_argument("--stage2", default=REPO / "tests/fixtures/torch_port_Bibi_512_stage2.npz")
    ap.add_argument("--out", default=REPO / "tests/fixtures/torch_port_Bibi_512_stage3.npz")
    args = ap.parse_args()

    helpers = _stage2_helpers()
    helpers._jax()
    from pbr3d import config
    from pbr3d.camera.geometry import vector_to_params
    from pbr3d.deform import search, verify
    from pbr3d.eval.intra import compute_binary_gt
    from pbr3d.ops.point_table import build_point_table
    from pbr3d.ops.projection import binary_iou
    from pbr3d.pipeline import run_stage3

    grid = np.load(args.stage1)["grid"]
    fx2 = np.load(args.stage2)
    mask = fx2["front_mask"]
    cam = vector_to_params(fx2["front_final"].astype(np.float64))
    H, W = mask.shape
    padded = np.pad(grid, ((0, 0), (0, config.STAGE3_PAD["Bibi"]), (0, 0)))
    dome = config.PART_IDS["dome"]
    out = {}

    table = build_point_table(padded)
    out["table_counts"] = table.counts
    out["table_shell_counts"] = table.shell_counts
    out["table_sums"] = table.sums
    n_shell = max(table.shell_count(dome), 1)
    s_c = max(4, -(-n_shell // 24576))  # optimize_part_deform's coarse stride at defaults
    c, v = table.shell_window(dome, s_c, search._shell_bucket(-(-n_shell // s_c)))
    out["dome_coarse_shell"] = np.asarray(c)[np.asarray(v)]
    dome_center = np.asarray(table.center(dome), np.float32)

    rec = {"nb4": [], "dome": []}
    prep, ev, nb4 = search.prepare_shared_state, search._eval_chunked, verify._nb4_state

    def prep_rec(*a, **k):
        res = prep(*a, **k)
        rec["zb_identity"] = res[2]
        return res

    def ev_rec(deforms, chunk_cap, fn=None, approx=False, **kw):
        res = ev(deforms, chunk_cap, fn=fn, approx=approx, **kw)
        if fn is not None and np.array_equal(np.asarray(kw["center"]), dome_center):
            rec["dome"].append(dict(deforms=np.asarray(deforms, np.float32), approx=approx,
                                    n=int(np.asarray(kw["valid"]).sum()), comps=res,
                                    rest=np.asarray(kw["rest_zbuf"]),
                                    nb={k: np.asarray(kw[f"nb_{k}"]) for k in
                                        ("zb", "base", "gt", "floor", "valid")}))
        return res

    def nb4_rec(*a, **k):
        res = nb4(*a, **k)
        rec["nb4"].append(res[0])
        return res

    err = io.StringIO()
    with tempfile.TemporaryDirectory() as root:
        helpers.write_mask_pngs(root, "Bibi", {"front": mask})
        search.prepare_shared_state, search._eval_chunked, verify._nb4_state = (
            prep_rec, ev_rec, nb4_rec)
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err):
                deforms, deformed = run_stage3("Bibi", grid, cam, root)
            wall = time.perf_counter() - t0
        finally:
            search.prepare_shared_state, search._eval_chunked, verify._nb4_state = prep, ev, nb4
    log = err.getvalue()
    sys.stderr.write(log)
    print(f"JAX run_stage3: {wall:.1f} s", flush=True)
    out["jax_cpu_wall_s"] = np.float64(wall)

    parts = list(rec["zb_identity"])
    out["zb_parts"] = np.array(parts)
    out["zb_identity"] = np.stack([rec["zb_identity"][p][:H, :W] for p in parts])

    # the first chain's pass-0 dome search: its coarse-A and exact refine calls
    calls = rec["dome"]
    a = calls[0]
    r = next(c for c in calls if not c["approx"])
    assert a["approx"] and a["n"] == len(out["dome_coarse_shell"]), (a["approx"], a["n"])
    out["dome_rest"] = a["rest"][:H, :W]
    for k, val in a["nb"].items():
        out[f"dome_nb_{k}"] = val[:, : (H + 1) // 2, : (W + 1) // 2] if val.ndim == 3 else val
    for tag, call in (("a", a), ("r", r)):
        out[f"dome_{tag}_deforms"] = call["deforms"]
        out[f"dome_{tag}_comps"] = np.asarray(call["comps"], np.float32)
        out[f"dome_{tag}_n"] = np.int64(call["n"])
        assert np.array_equal(call["rest"], a["rest"]), "dome's rest plane moved within pass 0"

    line = re.search(r"portfolio \[(.*)\] -> (\S+)", log)
    pairs = re.findall(r"'(\w+)=([-\d.]+)'", line.group(1)) if line else []
    n_var = len(pairs)
    out["portfolio_labels"] = np.array([p[0] for p in pairs])
    out["portfolio_totals"] = np.array([sum(d for _, d in cells.values())
                                        for cells in rec["nb4"][:n_var]], np.float64)
    out["portfolio_pick"] = np.array(line.group(2) if line else "")

    names = list(deforms)
    out["final_parts"] = np.array(names)
    out["final_deforms"] = np.stack([search._deform_vec(deforms[p]["deform"]) for p in names])
    out["final_ious"] = np.array([deforms[p]["iou"] for p in names], np.float64)
    present = [p for p in config.PART_NAMES
               if p != "background" and table.count(config.PART_IDS[p]) > 0]
    cells = verify._nb4_state(padded, deformed, mask, cam, parts=present)[0]
    out["nb4_cells"] = np.array(list(cells))
    out["nb4_init"] = np.array([cells[k][0] for k in cells], np.float64)
    out["nb4_def"] = np.array([cells[k][1] for k in cells], np.float64)
    out["nb4_total"] = np.float64(sum(d for _, d in cells.values()))

    ids = [int(v) for v in np.unique(deformed) if 0 < v < 10]
    zbs = verify._part_zbufs_grid(deformed, cam, H, W,
                                  [p for p, i in config.PART_IDS.items() if i in ids])
    pr = np.isfinite(np.minimum.reduce(list(zbs.values())))[:H, :W]
    out["whole_iou"] = np.float32(binary_iou(compute_binary_gt(mask, grid), pr))
    scored = [d["iou"] for d in deforms.values() if d.get("gt_px", 1) > 0]
    out["mean_part_iou"] = np.float64(sum(scored) / max(len(scored), 1))
    out["deformed"] = np.asarray(deformed, np.uint8)

    print("portfolio", dict(zip(out["portfolio_labels"], out["portfolio_totals"])),
          "pick", out["portfolio_pick"], "nb4 total", out["nb4_total"],
          "whole", out["whole_iou"], "mean part", out["mean_part_iou"],
          "deformed voxels", int((out["deformed"] > 0).sum()), flush=True)
    np.savez_compressed(args.out, **out)
    print("wrote", args.out, os.path.getsize(args.out), "bytes")


if __name__ == "__main__":
    main()
