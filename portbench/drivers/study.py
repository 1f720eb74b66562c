"""Driver of the mixes of kind "study": one unit is one
``pbr3d_torch.pipeline.run_all_body`` call over the monuments of a scene
set, as a user runs the five-monument study.

The configuration gives the scene set (``scenes``: the tag of the study
fixture's scenes) and the keywords of ``run_all_body`` (``run_all``); the
mix gives which keyword ``--seed`` sets (``seed_key``, dotted) and how many
of the window's splat-IoU calls the check samples; the cell's limits are
``portbench/limits/<cell>.json``.  The scenes are a copy of
``bench_torch.py::study_scenes`` over a copy of
``tests/fixtures/torch_port_study.npz``.

The check (``check``) compares with the plain reference
(``harness/study_reference.py``), after the window:

* ``stage1_grids_differ``: stage-1 grids whose sha256 is not that of the JAX
  package's carve of the same masks (recorded in the fixture);
* ``splat_iou_gap``: the widest gap between a sampled splat-IoU call's mean
  part IoUs and the reference's, over every camera of the sample;
* ``lm_loss_gap``: the widest relative gap between a keypoint fit's loss and
  the reference's loss at the fit's camera, over every fit of the window;
* ``lm_loss_ratio``: the largest ratio of the reference's loss at a fit's
  camera to its loss at the fit's start;
* ``part_iou_gap``: the widest gap between a notebook-4 part's IoU in the
  deform parameters and the reference's, from the stage-3 grid;
* ``stage3_studies_unchanged``: studies in which every monument's stage-3
  grid equals its padded stage-1 grid (stage 3 may keep a monument's grid
  where its stage-1 grid already fits the mask, not all five);
* the three gates of ``bench.py:72-74``, by monument: a monument that misses
  one, or is lost, counts as failed.
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import numpy as np
import torch

from portbench.harness import study_reference as ref
from portbench.harness.bench import Number, Verdict
from portbench.harness.probes import CallLog, Probe, Reservoir

DATA = Path(__file__).resolve().parents[1] / "data"
STUDY = DATA / "torch_port_study.npz"
STAGE1_GOLDEN = DATA / "stage1_golden"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def study_scenes(fxs, tag: str, monuments) -> dict:
    """``{monument: SceneMasks}`` of the study fixture at the scene tag
    (copy of ``bench_torch.py::study_scenes``): the planted front view serves
    stages 2 and 3 and the notebook-4 mask."""
    from pbr3d_torch.io.masks import MaskSet
    from pbr3d_torch.pipeline import SceneMasks

    scenes = {}
    for m in monuments:
        planes = (fxs[f"{tag}_{m}_{k}"] for k in ("binary", "exterior", "semantic"))
        front = fxs[f"{tag}_{m}_front"]
        scenes[m] = SceneMasks(MaskSet.from_labels(*planes), {"front": front, "drone": fxs[f"{tag}_{m}_drone"]},
                               front)
    return scenes


def _set_dotted(d: dict, key: str, value) -> None:
    *path, last = key.split(".")
    for k in path:
        d = d.setdefault(k, {})
    d[last] = value


def setup(run) -> None:
    from pbr3d_torch import pipeline

    cfg, mix = run.config, run.mix
    tag, monuments = cfg["scenes"], list(cfg["monuments"])
    with np.load(STUDY) as fxs:
        scenes = study_scenes(fxs, tag, monuments)
        expected = {m: str(fxs[f"{tag}_{m}_sha256"]) for m in monuments}
    kw = copy.deepcopy(cfg["run_all"])
    _set_dotted(kw, mix["seed_key"], int(run.seed))
    run.state.update(pipeline=pipeline, scenes=scenes, kw=kw, expected_sha=expected)


def unit(run) -> dict:
    st = run.state
    res = st["pipeline"].run_all_body(st["scenes"], out_dir=None, device=run.device, **st["kw"])
    return {"results": {m: dict(grid1=r.grid_stage1, grid3=r.grid_stage3, deform=r.deform_params,
                                cams=r.cameras, timings=dict(r.timings)) for m, r in res.items()},
            "lost": [m for m in st["scenes"] if m not in res]}


def _clone(x):
    return x.detach().clone() if isinstance(x, torch.Tensor) else copy.deepcopy(x)


def install_probes(run) -> list:
    """Samples of the window's splat-IoU calls and every keypoint fit, with
    their inputs, for the check."""
    st = run.state
    st["splat"] = Reservoir(int(run.mix["splat_sample"]), run.seed)
    st["lm"] = CallLog()

    def splat(args, kwargs, out):
        # (cams, pts, labels, valid, gt, part_ids, hw), then the IoUs
        full = list(args) + [kwargs.get("hw")] * (7 - len(args))
        st["splat"].offer(lambda: tuple(_clone(a) for a in full) + (out.detach().clone(),))

    def lm(args, kwargs, out):
        st["lm"].add((tuple(_clone(a) for a in args[:6]), kwargs.get("loss_type", "L2"),
                      tuple(t.detach().clone() for t in out)))

    # the card's calls go to the kernels; the plain versions serve CPU tensors
    return [Probe([("pbr3d_torch.camera.align", "splat_iou_kernel"),
                   ("pbr3d_torch.camera.align", "splat_iou_plain")], splat),
            Probe([("pbr3d_torch.camera.estimate", "lm_fit_kernel"),
                   ("pbr3d_torch.camera.estimate", "lm_fit_plain")], lm)]


def _golden_occupancy(m: str):
    path = STAGE1_GOLDEN / f"{m}_voxel_grid.npz"
    if not path.exists():
        return None
    with np.load(path) as f:
        g = f["voxel_grid"]
    return np.any(g > 0, axis=-1) if g.ndim == 4 else g > 0


def splat_gap(samples, *, dtype=torch.float64) -> float:
    """Widest |program − reference| over the sampled calls' IoUs; the widest
    camera's case is logged."""
    gap, worst = 0.0, None
    for k, (cams, pts, labels, valid, gt, part_ids, hw, out) in enumerate(samples):
        mine = ref.splat_mean_iou(cams, pts, labels, valid, gt, part_ids, hw, dtype=dtype)
        diff = (out.double() - mine).abs()
        if float(diff.max()) > gap:
            gap = float(diff.max())
            v, c = divmod(int(diff.argmax()), diff.shape[1])
            worst = (k, v, c, float(out[v, c]), float(mine[v, c]))
    if worst is not None:
        k, v, c, got, want = worst
        cams, pts = samples[k][0], samples[k][1]
        _, _, Z = ref.project(pts[v].double(), cams[v, c].double())
        log(f"[study] widest splat-IoU gap {gap!r}: sample {k} of {len(samples)}, view {v} camera {c} "
            f"{[round(float(x), 3) for x in cams[v, c]]}: program {got!r} reference {want!r}; "
            f"{tuple(pts.shape)} points, least camera Z {float(Z.min())!r}, {int((Z < 1).sum())} with Z < 1")
    return gap


def lm_gaps(fits, *, dtype=torch.float64):
    """(widest relative loss gap, largest loss ratio end / start) over the
    fits."""
    gap, ratio = 0.0, 0.0
    for (x0, vox, img, mask, lo, hi), loss_type, (x, loss, _steps) in fits:
        end = ref.keypoint_loss(x, vox, img, mask, loss_type, dtype=dtype)
        start = ref.keypoint_loss(x0, vox, img, mask, loss_type, dtype=torch.float64)
        gap = max(gap, float(((loss.double() - end.double()).abs() / end.double().clamp_min(1e-9)).max()))
        ratio = max(ratio, float((end.double() / start.clamp_min(1e-30)).max()))
    return gap, ratio


def monument_numbers(r: dict, scene, gold, expected_sha: str, device, *, dtype=torch.float64) -> dict:
    """The reference's readings of one monument's answers."""
    grid1, grid3 = r["grid1"], r["grid3"]
    cams = r["cams"]["final"]
    cam = cams.get("front") or next(iter(cams.values()))
    mask = scene.nb4
    pad = grid3.shape[1] - grid1.shape[1]
    padded = np.pad(grid1, ((0, 0), (0, pad), (0, 0))) if pad > 0 else grid1
    ious = ref.visible_part_ious(padded, grid3, cam, mask, device=device, dtype=dtype)
    nb4 = [abs(float(r["deform"][p]["iou"]) - v) for p, v in ious.items()
           if p in ref.NB4_PARTS and p in r["deform"]]
    return {
        "sha_ok": ref.grid_sha256(grid1) == expected_sha,
        "unchanged": padded.shape == grid3.shape and bool(np.array_equal(padded, grid3)),
        "part_ious": ious,
        "mean_part_iou": float(np.mean(list(ious.values()))) if ious else 0.0,
        "part_iou_gap": max(nb4, default=0.0),
        "whole_iou": ref.whole_iou(grid3, cam, mask, grid1, device=device, dtype=dtype),
        "stage1_iou": None if gold is None else ref.stage1_iou(grid1, gold),
    }


def check(run) -> Verdict:
    st, lim = run.state, run.limits
    dev = run.device
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    golds = {m: _golden_occupancy(m) for m in st["scenes"]}
    attempted = failed = differ = unchanged = 0
    moved = []
    part_gap, part_means = 0.0, []
    for k, u in enumerate(run.units):
        for m in u["lost"]:
            attempted += 1
            failed += 1
            log(f"[study] unit {k} {m}: lost")
        moved.append([])
        for m, r in u["results"].items():
            attempted += 1
            got = monument_numbers(r, st["scenes"][m], golds[m], st["expected_sha"][m], dev)
            differ += not got["sha_ok"]
            if not got["unchanged"]:
                moved[-1].append(m)
            part_gap = max(part_gap, got["part_iou_gap"])
            part_means.append(got["mean_part_iou"])
            s1 = got["stage1_iou"]
            gates_ok = ((s1 is None or s1 >= ref.STAGE1_IOU_MIN) and got["whole_iou"] >= ref.STAGE3_WHOLE_IOU_MIN
                        and got["mean_part_iou"] >= ref.STAGE3_MEAN_PART_IOU_MIN)
            failed += not gates_ok
            if k == 0 or not gates_ok:
                log(f"[study] unit {k} {m}: stage1_iou {s1!r} whole_iou {got['whole_iou']!r} mean_part_iou "
                    f"{got['mean_part_iou']!r} part_iou_gap {got['part_iou_gap']!r} sha_ok {got['sha_ok']} "
                    f"stage-3 grid unchanged {got['unchanged']} timings {r['timings']}"
                    f"{'' if gates_ok else ' GATE MISSED'}")
    unchanged = sum(not mv for mv in moved)
    log(f"[study] monuments whose stage-3 grid moved, by study: {moved}")
    run.values["part_iou"] = float(np.mean(part_means)) if part_means else None
    samples, fits = st["splat"].items, st["lm"].items
    # a window with no splat-IoU call or no fit fails their numbers (finite
    # values: the line is JSON)
    s_gap = splat_gap(samples) if samples else 1e9
    l_gap, l_ratio = lm_gaps(fits) if fits else (1e9, 1e9)
    log(f"[study] check: {len(samples)} splat-IoU calls sampled of {st['splat'].seen}, {len(fits)} keypoint fits")
    numbers = [
        Number("stage1_grids_differ", differ, 0),
        Number("splat_iou_gap", s_gap, lim["splat_iou_gap"]),
        Number("lm_loss_gap", l_gap, lim["lm_loss_gap"]),
        Number("lm_loss_ratio", l_ratio, lim["lm_loss_ratio"]),
        Number("part_iou_gap", part_gap, lim["part_iou_gap"]),
        Number("stage3_studies_unchanged", unchanged, 0),
    ]
    return Verdict(attempted, failed, numbers)


def control(run) -> dict:
    """The control's readings: the reference computed in bfloat16, one
    precision below the program's float32, in the program's place, against
    the float64 reference, on this run's own answers and samples."""
    st, low = run.state, torch.bfloat16
    out = {"splat_iou_gap": 0.0, "lm_loss_gap": 0.0, "part_iou_gap": 0.0}
    for cams, pts, labels, valid, gt, part_ids, hw, _ in st["splat"].items:
        a = ref.splat_mean_iou(cams, pts, labels, valid, gt, part_ids, hw)
        b = ref.splat_mean_iou(cams, pts, labels, valid, gt, part_ids, hw, dtype=low)
        out["splat_iou_gap"] = max(out["splat_iou_gap"], float((a - b).abs().max()))
    for (x0, vox, img, mask, lo, hi), loss_type, (x, loss, _steps) in st["lm"].items:
        a = ref.keypoint_loss(x, vox, img, mask, loss_type)
        b = ref.keypoint_loss(x, vox, img, mask, loss_type, dtype=low).double()
        out["lm_loss_gap"] = max(out["lm_loss_gap"], float(((a - b).abs() / a.clamp_min(1e-9)).max()))
    for u in run.units:
        for m, r in u["results"].items():
            grid1, grid3 = r["grid1"], r["grid3"]
            cams = r["cams"]["final"]
            cam = cams.get("front") or next(iter(cams.values()))
            pad = grid3.shape[1] - grid1.shape[1]
            padded = np.pad(grid1, ((0, 0), (0, pad), (0, 0))) if pad > 0 else grid1
            mask = st["scenes"][m].nb4
            a = ref.visible_part_ious(padded, grid3, cam, mask, device=run.device)
            b = ref.visible_part_ious(padded, grid3, cam, mask, device=run.device, dtype=low)
            gaps = [abs(a[p] - b.get(p, 0.0)) for p in a if p in ref.NB4_PARTS]
            out["part_iou_gap"] = max(out["part_iou_gap"], max(gaps, default=0.0))
    return out
