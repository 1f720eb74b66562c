"""Driver of the mixes of kind "pipeline": one unit is notebooks 1-3 for one
monument, ``passes_per_unit`` times back to back, through
``pbr3d_torch.pipeline.run_pipeline_body`` (``run_pipeline``'s body on
in-memory masks): the fused carve, the serial per-view camera search and
stage 3 at the configuration's keywords (``run_pipeline``: ``stage2_kw``,
``stage3_kw``), with ``--seed`` as the keyword ``seed_key`` (dotted).
Nothing is written to disk.

The scene is the study fixture's, at the configuration's ``scenes`` tag,
for the mix's ``monument`` (``drivers/study.py``); where the configuration
names a ``front_mask`` (``file``, from the root of the repository, and
``key``), that label plane takes the place of the planted front view, as
stage 2's front view, stage 3's mask and the notebook-4 mask.  The probes (a reservoir of ``splat_sample`` splat-IoU
calls and every keypoint fit) and the study's numbers come from
``drivers/study.py``.  A unit keeps its passes as the study keeps its
monuments, ``results: {name: pass}`` (the monument, then ``<monument>#2``
...), so that the study's readers of ``PipelineResult.timings`` read it.

The check (``check``) compares with the plain reference
(``harness/study_reference.py``, ``harness/stage3_reference.py``), after
the window, over every pass:

* ``stage1_grids_differ``, ``splat_iou_gap``, ``lm_loss_gap``,
  ``lm_loss_ratio``, ``part_iou_gap``: as the study's;
* ``deformed_voxels_differ``: the widest pass's count of voxels where the
  stage-3 grid differs from the reference's rebuild of the deform
  parameters returned with it;
* ``nb4_parts_regressed``: notebook-4 parts whose float64 visible IoU in
  the stage-3 grid lies more than ``NB4_TOL`` below the one in the padded
  stage-1 grid, under the final front camera, summed over the passes;
* ``stage3_units_unchanged``: passes whose stage-3 grid is the padded
  stage-1 grid (on the dataset's front mask of Bibi stage 3 moves parts in
  every pass);
* failed: a pass that raises, a view with no final camera, or a miss of one
  of the three gates of ``bench.py:72-74``.
"""

from __future__ import annotations

import copy
import sys
import traceback
from types import SimpleNamespace

import numpy as np
import torch

from portbench.drivers import study
from portbench.drivers.stage12 import _device_fault
from portbench.harness import stage3_reference as ref3
from portbench.harness import study_reference as ref
from portbench.harness.bench import REPO, Number, Verdict

#: How far below the stage-1 grid's a part's visible IoU in the stage-3 grid
#: may read and not count as regressed: above the program's own allowance
#: (1e-6 on its float32 z-buffers, ``deform/verify.py``) and the float64
#: recount's rounding, under one pixel of every notebook-4 part (a pixel is
#: 1/union; the largest of Bibi's front mask, the plinth, holds 17,062
#: pixels, so its union stays well under 10^5), so a lost pixel counts.
NB4_TOL = 1e-5


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def setup(run) -> None:
    from pbr3d_torch import pipeline

    cfg, mix = run.config, run.mix
    tag, m = cfg["scenes"], mix["monument"]
    with np.load(study.STUDY) as fxs:
        scene = study.study_scenes(fxs, tag, [m])[m]
        expected = str(fxs[f"{tag}_{m}_sha256"])
    if cfg.get("front_mask"):
        with np.load(REPO / cfg["front_mask"]["file"]) as fx:
            front = fx[cfg["front_mask"]["key"]]
        scene = pipeline.SceneMasks(scene.front, {**scene.views, "front": front}, front)
    kw = copy.deepcopy(cfg["run_pipeline"])
    study._set_dotted(kw, mix["seed_key"], int(run.seed))
    # the body, looked up now: a program without it fails here
    run.state.update(body=pipeline.run_pipeline_body, monument=m, scene=scene, kw=kw, expected_sha=expected)


def unit(run) -> dict:
    st = run.state
    m = st["monument"]
    results, lost = {}, []
    for i in range(int(run.mix["passes_per_unit"])):
        name = m if i == 0 else f"{m}#{i + 1}"
        try:
            r = st["body"](m, st["scene"], out_dir=None, device=run.device, **st["kw"])
        except Exception as e:
            if _device_fault(e):
                raise
            log(f"[pipeline] {name} FAILED:")
            traceback.print_exc()
            lost.append(name)
            continue
        results[name] = dict(grid1=r.grid_stage1, grid3=r.grid_stage3, deform=r.deform_params, cams=r.cameras,
                             timings=dict(r.timings))
    return {"results": results, "lost": lost}


install_probes = study.install_probes


def _padded(r: dict) -> np.ndarray:
    pad = r["grid3"].shape[1] - r["grid1"].shape[1]
    return np.pad(r["grid1"], ((0, 0), (0, pad), (0, 0))) if pad > 0 else r["grid1"]


def _front(r: dict) -> dict:
    cams = r["cams"]["final"]
    return cams.get("front") or next(iter(cams.values()))


def stage3_numbers(r: dict, scene, device, grid3=None) -> dict:
    """The reference's readings of one pass's stage 3 (``grid3``: its
    stage-3 grid, or what stands in its place): voxels where it differs from
    the float64 rebuild of the pass's deform parameters, and each notebook-4
    part's float64 visible IoU in it against the one in the padded stage-1
    grid."""
    padded = _padded(r)
    grid3 = r["grid3"] if grid3 is None else grid3
    rebuilt = ref3.rebuild(padded, r["deform"], scene.views["front"].shape, device=device)
    cam = _front(r)
    init = ref.visible_part_ious(padded, padded, cam, scene.nb4, device=device)
    final = ref.visible_part_ious(padded, grid3, cam, scene.nb4, device=device)
    margins = {p: final[p] - v for p, v in init.items() if p in ref.NB4_PARTS}
    return {"voxels_differ": int(np.count_nonzero(rebuilt != grid3)),
            "margins": margins, "regressed": sum(d < -NB4_TOL for d in margins.values())}


def _readings(run, r: dict, gold) -> tuple:
    """(the study's readings, :func:`stage3_numbers`) of a pass, computed
    once for each distinct answer: the passes of a run repeat theirs."""
    st = run.state
    key = (ref.grid_sha256(r["grid1"]), ref.grid_sha256(r["grid3"]), tuple(ref.cam_vector(_front(r))),
           repr(sorted((p, sorted(d["deform"].items()), d.get("iou")) for p, d in r["deform"].items())))
    cache = st.setdefault("readings", {})
    if key not in cache:
        cache[key] = (study.monument_numbers(r, st["scene"], gold, st["expected_sha"], run.device),
                      stage3_numbers(r, st["scene"], run.device))
    return cache[key]


def _passes(run):
    return [r for u in run.units for r in u["results"].values()]


def check(run) -> Verdict:
    st, lim = run.state, run.limits
    dev, m, scene = run.device, st["monument"], st["scene"]
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    gold = study._golden_occupancy(m)
    attempted = failed = differ = regressed = voxels = unchanged = 0
    part_gap, means = 0.0, []
    for k, u in enumerate(run.units):
        attempted += len(u["results"]) + len(u["lost"])
        failed += len(u["lost"])
        for r in u["results"].values():
            got, s3 = _readings(run, r, gold)
            differ += not got["sha_ok"]
            unchanged += got["unchanged"]
            regressed += s3["regressed"]
            voxels = max(voxels, s3["voxels_differ"])
            part_gap = max(part_gap, got["part_iou_gap"])
            means.append(got["mean_part_iou"])
            skipped = [v for v in scene.views if v not in r["cams"]["final"]]
            s1 = got["stage1_iou"]
            ok = (not skipped and (s1 is None or s1 >= ref.STAGE1_IOU_MIN)
                  and got["whole_iou"] >= ref.STAGE3_WHOLE_IOU_MIN
                  and got["mean_part_iou"] >= ref.STAGE3_MEAN_PART_IOU_MIN)
            failed += not ok
            if k == 0 or not ok or s3["regressed"] or s3["voxels_differ"] or got["unchanged"]:
                log(f"[pipeline] unit {k} {m}: stage1_iou {s1!r} whole_iou {got['whole_iou']!r} mean_part_iou "
                    f"{got['mean_part_iou']!r} part_iou_gap {got['part_iou_gap']!r} sha_ok {got['sha_ok']} "
                    f"skipped {skipped} stage-3 grid unchanged {got['unchanged']} voxels differing from the "
                    f"rebuild {s3['voxels_differ']} notebook-4 IoU stage 3 - stage 1 {s3['margins']} "
                    f"deform {[(p, d['deform']) for p, d in r['deform'].items()]} timings {r['timings']}"
                    f"{'' if ok else ' FAILED'}")
    run.values["part_iou"] = float(np.mean(means)) if means else None
    samples, fits = st["splat"].items, st["lm"].items
    # a window with no splat-IoU call or no fit fails their numbers (finite: the line is JSON)
    s_gap = study.splat_gap(samples) if samples else 1e9
    l_gap, l_ratio = study.lm_gaps(fits) if fits else (1e9, 1e9)
    log(f"[pipeline] check: {len(samples)} splat-IoU calls sampled of {st['splat'].seen}, {len(fits)} keypoint "
        f"fits, {len(means)} passes")
    numbers = [
        Number("stage1_grids_differ", differ, 0),
        Number("splat_iou_gap", s_gap, lim["splat_iou_gap"]),
        Number("lm_loss_gap", l_gap, lim["lm_loss_gap"]),
        Number("lm_loss_ratio", l_ratio, lim["lm_loss_ratio"]),
        Number("part_iou_gap", part_gap, lim["part_iou_gap"]),
        Number("deformed_voxels_differ", voxels, lim["deformed_voxels_differ"]),
        Number("nb4_parts_regressed", regressed, 0),
        Number("stage3_units_unchanged", unchanged, 0),
    ]
    return Verdict(attempted, failed, numbers)


def control(run) -> dict:
    """The control's readings: the reference computed in bfloat16, one
    precision below the program's float32, in the program's place, against
    the float64 reference, on this run's own answers and samples: the
    study's three, then the bfloat16 rebuild of each pass's parameters as
    its stage-3 grid."""
    st = run.state
    scenes = {name: st["scene"] for u in run.units for name in u["results"]}
    out = study.control(SimpleNamespace(state={**st, "scenes": scenes}, device=run.device, units=run.units))
    low = [stage3_numbers(r, st["scene"], run.device,
                          grid3=ref3.rebuild(_padded(r), r["deform"], st["scene"].views["front"].shape,
                                             device=run.device, dtype=torch.bfloat16))
           for r in _passes(run)]
    out["deformed_voxels_differ"] = max(n["voxels_differ"] for n in low)
    out["nb4_parts_regressed"] = sum(n["regressed"] for n in low)
    return out
