"""Driver of the mixes of kind "stage12": one unit is notebooks 1 and 2 run one
monument at a time, through the bodies of the notebook entries.  For each
monument of the configuration, in its order: ``pipeline.run_stage1_body`` on
the scene's front masks, then ``pipeline.run_stage2_views`` on that grid and
the scene's front and drone views, at the mix's ``generations`` and
``population``, with ``--seed`` as the keyword ``seed_key``.  Nothing is
written to disk.

The scenes (the study fixture's, at the configuration's ``scenes`` tag), the
probes (a reservoir of ``splat_sample`` splat-IoU calls and every keypoint
fit) and their numbers are the study driver's (``drivers/study.py``).

The check (``check``) compares with the plain reference
(``harness/study_reference.py``, ``harness/stage12_reference.py``), after the
window:

* ``stage1_grids_differ``: stage-1 grids whose sha256 is not that of the JAX
  package's carve of the same masks (recorded in the fixture);
* ``splat_iou_gap``, ``lm_loss_gap``, ``lm_loss_ratio``: as the study's;
* ``camera_iou_gap``: the widest gap, over every view of every unit, between
  the IoU that ``run_stage2_views`` returned and the float64 search
  objective recounted at the final camera it returned;
* ``camera_iou_shortfall``: the drop of a view's float64 objective at its
  final camera below the objective at the camera the fixture planted the
  view through (0 where the final camera scores higher), averaged over a
  pass's views, the widest pass.  Not the widest view: on this route the
  drone views of Akbar, Bibi and Taj end 0.4-0.7 below their planted
  cameras in sound runs, and a search that returned its keypoint start
  would read barely more there; the mean over the ten views separates it;
* failed: a monument that raises, a view that is skipped, a stage-1
  occupancy IoU under ``bench.py``'s 0.92 against the committed grid.
"""

from __future__ import annotations

import sys
import traceback

import numpy as np
import torch

from portbench.drivers import study
from portbench.harness import stage12_reference as ref12
from portbench.harness import study_reference as ref
from portbench.harness.bench import Number, Verdict


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def setup(run) -> None:
    from pbr3d_torch import pipeline

    cfg, mix = run.config, run.mix
    tag, monuments = cfg["scenes"], list(cfg["monuments"])
    with np.load(study.STUDY) as fxs:
        scenes = study.study_scenes(fxs, tag, monuments)
        expected = {m: str(fxs[f"{tag}_{m}_sha256"]) for m in monuments}
        planted = {m: {v: fxs[f"{tag}_{m}_{v}_cam"] for v in scenes[m].views} for m in monuments}
    kw = {"generations": int(mix["generations"]), "population": int(mix["population"]),
          mix["seed_key"]: int(run.seed)}
    # the notebook bodies, looked up now: a program without them fails here
    run.state.update(stage1=pipeline.run_stage1_body, stage2=pipeline.run_stage2_views, scenes=scenes, kw=kw,
                     expected_sha=expected, planted=planted)


def _device_fault(exc: BaseException) -> bool:
    return isinstance(exc, torch.OutOfMemoryError) or "CUDA" in str(exc)


def unit(run) -> dict:
    st = run.state
    results, lost = {}, []
    for m, scene in st["scenes"].items():
        try:
            grid = st["stage1"](m, scene.front, device=run.device)
            cams, ious = st["stage2"](m, grid, scene.views, device=run.device, **st["kw"])
        except Exception as e:
            if _device_fault(e):
                raise
            log(f"[stage12] {m} FAILED:")
            traceback.print_exc()
            lost.append(m)
            continue
        results[m] = dict(grid=grid, cams=cams, ious=ious)
    return {"results": results, "lost": lost}


install_probes = study.install_probes


def _reference(run, m: str, grid: np.ndarray) -> dict:
    """What the reference reads once a grid: its sha256, and by monument and
    sha256 (a carve repeats its grid) the shell, the stage-1 IoU against the
    committed grid and the readings at the planted cameras."""
    st = run.state
    shas, cache = st.setdefault("sha", {}), st.setdefault("ref_cache", {})
    if id(grid) not in shas:  # the window's grids stay alive in run.units
        shas[id(grid)] = ref.grid_sha256(grid)
    sha = shas[id(grid)]
    if (m, sha) not in cache:
        gold = study._golden_occupancy(m)
        cache[(m, sha)] = {"sha": sha, "shell": ref12.shell(grid, device=run.device), "planted": {},
                           "stage1_iou": None if gold is None else ref.stage1_iou(grid, gold)}
    return cache[(m, sha)]


def _camera_readings(run, dtype=torch.float64) -> list:
    """``[(unit, monument, view, returned IoU, reference IoU at the final
    camera in dtype, float64 reference IoU at the planted camera)]`` of every
    view answered in the window."""
    st = run.state
    out = []
    for k, u in enumerate(run.units):
        for m, r in u["results"].items():
            scene = st["scenes"][m]
            c = _reference(run, m, r["grid"])
            for v, cam in r["cams"]["final"].items():
                if v not in c["planted"]:
                    c["planted"][v] = ref12.camera_iou(st["planted"][m][v], c["shell"], scene.views[v])
                got = ref12.camera_iou(cam, c["shell"], scene.views[v], dtype=dtype)
                out.append((k, m, v, float(r["ious"][v]), got, c["planted"][v]))
    return out


def _shortfall(readings) -> float:
    """The widest pass's mean drop below the planted cameras (1e9 when no
    view was answered: a finite number, since the line is JSON)."""
    drops = {}
    for k, *_, want, planted in readings:
        drops.setdefault(k, []).append(max(0.0, planted - want))
    return max((sum(d) / len(d) for d in drops.values()), default=1e9)


def check(run) -> Verdict:
    st, lim = run.state, run.limits
    if torch.device(run.device).type == "cuda":
        torch.cuda.synchronize()
    attempted = failed = differ = 0
    for k, u in enumerate(run.units):
        for m in u["lost"]:
            attempted += 1
            failed += 1
            log(f"[stage12] unit {k} {m}: lost")
        for m, r in u["results"].items():
            attempted += 1
            c = _reference(run, m, r["grid"])
            sha_ok = c["sha"] == st["expected_sha"][m]
            differ += not sha_ok
            s1 = c["stage1_iou"]
            skipped = [v for v in st["scenes"][m].views if v not in r["cams"]["final"] or v not in r["ious"]]
            ok = not skipped and (s1 is None or s1 >= ref.STAGE1_IOU_MIN)
            failed += not ok
            if k == 0 or not ok:
                log(f"[stage12] unit {k} {m}: stage1_iou {s1!r} sha_ok {sha_ok} skipped {skipped} "
                    f"ious {r['ious']}{'' if ok else ' FAILED'}")
    readings = _camera_readings(run)
    cam_gap = max((abs(got - want) for _, _, _, got, want, _ in readings), default=1e9)
    shortfall = _shortfall(readings)
    for k, m, v, got, want, planted in readings:
        if k == 0:
            r = run.units[0]["results"][m]
            kp = ref12.camera_iou(r["cams"]["kp"][v], _reference(run, m, r["grid"])["shell"], st["scenes"][m].views[v])
            log(f"[stage12] unit 0 {m}/{v}: returned IoU {got!r}, reference {want!r}, at the planted camera "
                f"{planted!r}, at the keypoint camera {kp!r}")
    samples, fits = st["splat"].items, st["lm"].items
    # a window with no splat-IoU call, fit or view fails their numbers (finite: the line is JSON)
    s_gap = study.splat_gap(samples) if samples else 1e9
    l_gap, l_ratio = study.lm_gaps(fits) if fits else (1e9, 1e9)
    log(f"[stage12] check: {len(samples)} splat-IoU calls sampled of {st['splat'].seen}, {len(fits)} keypoint "
        f"fits, {len(readings)} views")
    numbers = [
        Number("stage1_grids_differ", differ, 0),
        Number("splat_iou_gap", s_gap, lim["splat_iou_gap"]),
        Number("lm_loss_gap", l_gap, lim["lm_loss_gap"]),
        Number("lm_loss_ratio", l_ratio, lim["lm_loss_ratio"]),
        Number("camera_iou_gap", cam_gap, lim["camera_iou_gap"]),
        Number("camera_iou_shortfall", shortfall, lim["camera_iou_shortfall"]),
    ]
    return Verdict(attempted, failed, numbers)


def control(run) -> dict:
    """The control's readings: the reference computed in bfloat16, one
    precision below the program's float32, in the program's place, against
    the float64 reference, on this run's own answers and samples."""
    st, low = run.state, torch.bfloat16
    out = {"splat_iou_gap": 0.0, "lm_loss_gap": 0.0}
    for cams, pts, labels, valid, gt, part_ids, hw, _ in st["splat"].items:
        a = ref.splat_mean_iou(cams, pts, labels, valid, gt, part_ids, hw)
        b = ref.splat_mean_iou(cams, pts, labels, valid, gt, part_ids, hw, dtype=low)
        out["splat_iou_gap"] = max(out["splat_iou_gap"], float((a - b).abs().max()))
    for (x0, vox, img, mask, lo, hi), loss_type, (x, loss, _steps) in st["lm"].items:
        a = ref.keypoint_loss(x, vox, img, mask, loss_type)
        b = ref.keypoint_loss(x, vox, img, mask, loss_type, dtype=low).double()
        out["lm_loss_gap"] = max(out["lm_loss_gap"], float(((a - b).abs() / a.clamp_min(1e-9)).max()))
    exact = _camera_readings(run)
    lowered = _camera_readings(run, dtype=low)
    out["camera_iou_gap"] = max(abs(a[4] - b[4]) for a, b in zip(exact, lowered))
    out["camera_iou_shortfall"] = _shortfall(lowered)
    return out
