"""Driver of the mixes of kind "nb5": one unit is one pass of notebook 5's
path (``examples/torch/5_inter_method_analysis.py``) on one monument's
committed artifacts, as a user runs it after a study.

Set-up writes the notebook's input files into a temporary directory: the
SfM stand-in (a PLY: the front half of the stage-1 grid's shell, thinned,
moved and jittered from ``--seed``), the stage-1 grid, and the CAD stand-in
(an OBJ: the grid's mesh at a stride).  These makers are copies of
``chip_smoke.py``'s ``nb5_sparse_cloud``, ``write_obj`` and
``compact_faces`` with its ``NB5`` constants, which the mix file holds.

A pass: ``eval.preprocess.build_taj_clouds`` (the plane fit, the alignment,
the symmetric completion, the three ICPs, the CAD surface samples), the
stage-3 model's points, the clouds normalised; the pair table (squared
chamfer, F-score at τ, voxel IoU, PCA similarity) over every pair; the NN
statistics and the surface metrics (marching cubes, k-neighbourhoods) of
every cloud.

The check compares with the plain reference (``harness/nb5_reference.py``)
after the window:

* ``pair_gap``: the widest relative gap of a squared chamfer distance, and
  absolute gap of an F-score, over every pair of every pass;
* ``nn_gap``: the widest relative gap of an NN mean or standard deviation,
  over every cloud of every pass;
* ``surface_gap``: the widest relative gap of a surface metric, over every
  cloud of one pass drawn from the seed;
* ``icp_sides_unmoved``: sides of the completed cloud that ICP aligns (back,
  left, right) and that still lie where the symmetric completion of the
  pass's aligned SfM cloud puts them, over every pass.  ICP's float32
  correspondences are chaotic (two sound ICPs stop at poses some 0.02
  apart), so the aligned poses are not compared with a float64 ICP's;
* ``icp_gain_shortfall``: 1 - (how much the program's three ICPs lowered
  the sides' truncated mean squared distance to their targets) / (how much
  the reference's float64 ICPs from the same completion did), in the pass
  drawn from the seed;
* ``plane_shortfall``: 1 - (the most points of the aligned SfM cloud in one
  slab of z, 2 x 0.01 thick) / (the most points within 0.01 of a plane of
  the reference's RANSAC), over every pass;
* ``sparse_rigid_gap``: how far the best rotation of the SfM stand-in onto
  the aligned cloud leaves a point, over every pass;
* ``cloud_points_gap``: the largest coordinate gap of a normalised cloud:
  the grids' against the reference's normalised occupied voxels, the other
  three against the reference's normalisation of the program's cloud, over
  every pass;
* ``cad_ground_gap``: |least y of the CAD samples - least y of the completed
  cloud|, over every pass;
* ``cad_off_mesh``: the largest distance of a CAD sample to the OBJ's
  triangles, once the ground shift is undone, in the pass drawn from the
  seed;
* ``cad_coverage_gap``: the largest relative gap between the CAD samples'
  count in a slice of the mesh (eight of equal area along each axis) and
  an area-weighted draw's, in the same pass.
"""

from __future__ import annotations

import itertools
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench.harness import nb5_reference as ref
from portbench.harness.bench import Number, Verdict

DATA = Path(__file__).resolve().parents[1] / "data"
CLOUDS = ("Sparse", "Completed (ICP Aligned)", "Carved Grid", "Stage-3 Model", "Synthetic")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sparse_cloud(shell_xyz: np.ndarray, points: int, noise: float, seed: int) -> np.ndarray:
    """The SfM stand-in (copy of ``chip_smoke.nb5_sparse_cloud``): the front
    half (along z) of a shell's (x, y, z) points at unit scale, thinned to
    ``points``, under a rigid motion, with Gaussian noise; all from ``seed``.
    (N, 3) float64."""
    rng = np.random.default_rng(seed)
    p = np.asarray(shell_xyz, np.float64)
    p = p[p[:, 2] <= (p[:, 2].min() + p[:, 2].max()) / 2]
    p = p / (p.max(0) - p.min(0)).max()
    p = p[rng.choice(len(p), min(points, len(p)), replace=False)]
    R = ref.rodrigues_rotation(rng.normal(size=3), 0.35)
    return p @ R.T + rng.normal(scale=0.2, size=3) + rng.normal(scale=noise, size=p.shape)


def write_obj(path, verts: np.ndarray, faces: np.ndarray) -> None:
    """A triangle mesh as a Wavefront OBJ (1-based faces; copy of
    ``chip_smoke.write_obj``)."""
    with open(path, "w") as f:
        np.savetxt(f, np.asarray(verts, np.float64), fmt="v %.6f %.6f %.6f")
        np.savetxt(f, np.asarray(faces, np.int64) + 1, fmt="f %d %d %d")


def compact_faces(inter, vertices, faces, y_thresh: float):
    """``filter_mesh`` keeps the kept faces' indices into the unfiltered
    vertices; this renumbers them into the kept vertices (copy of
    ``chip_smoke.compact_faces``)."""
    keep = vertices[:, 1] <= y_thresh
    v, f = inter.filter_mesh(vertices, faces, y_thresh)
    return v, (torch.cumsum(keep.to(torch.int64), 0) - 1)[f.to(torch.int64)]


def setup(run) -> None:
    from pbr3d_torch import config
    from pbr3d_torch.carving.voxel import all_points, meshify_colored_voxel_grid, surface_points_by_parts
    from pbr3d_torch.eval import inter, preprocess
    from pbr3d_torch.io.artifacts import load_voxel_grid_labels
    from pbr3d_torch.io.pointcloud import save_ply

    mix, dev = run.mix, run.device
    tmp = Path(tempfile.mkdtemp(prefix="portbench_nb5_"))
    grid = load_voxel_grid_labels(DATA / mix["grid"])
    model = load_voxel_grid_labels(DATA / mix["model"])
    g = torch.as_tensor(grid, device=dev)
    names = [p for p in config.PART_NAMES if p != "background"]
    shell = surface_points_by_parts(g, names, device=dev)[0].cpu().numpy()
    sparse_in = sparse_cloud(shell, mix["sparse_points"], mix["noise"], run.seed)
    save_ply(tmp / "segmented_point_cloud_final.ply", sparse_in)
    shutil.copyfile(DATA / mix["grid"], tmp / "Taj_voxel_grid.npz")
    mesh = meshify_colored_voxel_grid(g, mix["mesh_stride"], device=dev)
    write_obj(tmp / "synthetic_taj.obj", mesh[0].cpu().numpy(), mesh[1].cpu().numpy())
    run.state.update(tmp=tmp, model=model, inter=inter, preprocess=preprocess, all_points=all_points,
                     sparse_in=sparse_in)


def unit(run) -> dict:
    st, mix, dev = run.state, run.mix, run.device
    inter = st["inter"]
    with run.spans.span("nb5.clouds"):
        t0 = time.perf_counter()
        raw = st["preprocess"].build_taj_clouds(st["tmp"], cad_samples=mix["cad_samples"],
                                                seed=mix["clouds_seed"], device=dev)
        raw["Stage-3 Model"] = st["all_points"](st["model"], device=dev)[0].to(torch.float64)
        clouds = {k: inter.normalize_preserve_aspect(raw[k], device=dev) for k in CLOUDS}
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        clouds_s = time.perf_counter() - t0
    out = {"clouds_s": clouds_s, "pairs": {}, "nn": {}, "surface": {}, "mesh": {}}
    with run.spans.span("nb5.pairs"):
        for a, b in itertools.combinations(CLOUDS, 2):
            f1, prec, rec = inter.fscore_with_threshold(clouds[a], clouds[b], tau=mix["tau"],
                                                        max_points=mix["pair_points"], device=dev)
            out["pairs"][(a, b)] = {
                "chamfer2": inter.chamfer_distance(clouds[a], clouds[b], max_points=mix["pair_points"], device=dev),
                "f1": f1, "voxel_iou": inter.voxel_iou(clouds[a], clouds[b], device=dev),
                "pca": inter.pca_shape_similarity(clouds[a], clouds[b], device=dev)}
    with run.spans.span("nb5.nn"):
        for name in CLOUDS:
            out["nn"][name] = inter.compute_nn_stats(clouds[name], max_points=mix["nn_points"], device=dev)
    with run.spans.span("nb5.surface"):
        for name in CLOUDS:
            verts, faces = inter.get_marching_cubes_mesh(clouds[name], mix["grid_size"], device=dev)
            v, f = compact_faces(inter, verts, faces, mix["y_thresh"])
            out["surface"][name] = inter.compute_surface_metrics(v, f, mix["k"], device=dev)
            out["mesh"][name] = (v, f)
    # the clouds stay on the card for the check, after the window
    out["clouds"] = clouds
    out["sides"] = raw["Sparse"], raw["Completed (ICP Aligned)"]
    out["cad"] = raw["Synthetic"]
    return out


def install_probes(run) -> list:
    return []


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def references(run) -> dict:
    """What the reference makes once a run from the pass's inputs: the
    RANSAC's best count, the grids' normalised occupied voxels, the CAD
    mesh in the notebook's frame."""
    mix, tmp = run.mix, run.state["tmp"]
    _, best = ref.plane_fit(run.state["sparse_in"], seed=mix["clouds_seed"])
    verts, faces = ref.read_obj(tmp / "synthetic_taj.obj")
    return {"plane_best": best,
            "Carved Grid": ref.normalize(ref.occupied_points(DATA / mix["grid"])),
            "Stage-3 Model": ref.normalize(ref.occupied_points(DATA / mix["model"])),
            "mesh": ref.Mesh(ref.cad_frame(verts), faces)}


def cad_numbers(cad, mesh, n: int) -> dict:
    """The CAD samples' distance to the mesh and their coverage of it."""
    cad = np.asarray(cad, np.float64)
    shift = ref.ground_shift(cad, mesh)
    if not np.isfinite(shift):
        return {"cad_off_mesh": float("inf"), "cad_coverage_gap": float("inf")}
    dist, which = mesh.distance(cad - [0.0, shift, 0.0])
    return {"cad_off_mesh": float(dist.max()), "cad_coverage_gap": ref.coverage_gap(which, mesh, n)}


def pass_gaps(u: dict, mix: dict, surface: bool, refs: dict, sparse_in, *, dtype=torch.float64) -> dict:
    """The reference's gaps to one pass's answers; the surface metrics and
    the CAD samples' mesh numbers only with ``surface`` (the pass drawn from
    the seed)."""
    clouds = {k: _host(v) for k, v in u["clouds"].items()}
    pair = 0.0
    for (a, b), got in u["pairs"].items():
        ch, f1 = ref.chamfer_f1(clouds[a], clouds[b], mix["tau"], mix["pair_points"], 0, dtype=dtype)
        pair = max(pair, _rel(got["chamfer2"], ch), abs(got["f1"] - f1))
    nn = 0.0
    for name, got in u["nn"].items():
        mean, std = ref.nn_stats(clouds[name], mix["nn_points"], 0, dtype=dtype)
        vals = list(got.values())
        nn = max(nn, _rel(vals[0], mean), _rel(vals[1], std))
    surf = None
    if surface:
        surf = 0.0
        for name, (v, f) in u["mesh"].items():
            want = ref.surface_stats(_host(v), _host(f), mix["k"], dtype=dtype)
            surf = max(surf, *(_rel(g, w) for g, w in zip(u["surface"][name].values(), want)))
    sparse, done = (_host(t) for t in u["sides"])
    cad = _host(u["cad"])
    unmoved, least = ref.sides_unmoved(sparse, done)
    raw = {"Sparse": sparse, "Completed (ICP Aligned)": done, "Synthetic": cad}
    points = max(ref.points_gap(clouds[k], refs[k] if k in refs else ref.normalize(raw[k])) for k in CLOUDS)
    out = {"pair_gap": pair, "nn_gap": nn, "surface_gap": surf, "icp_sides_unmoved": unmoved,
           "icp_least_move": least, "icp_gain_shortfall": None,
           "plane_shortfall": 1.0 - ref.slab_inliers(sparse) / refs["plane_best"],
           "sparse_rigid_gap": ref.rigid_gap(sparse_in, sparse), "cloud_points_gap": points,
           "cad_ground_gap": abs(float(cad[:, 1].min()) - float(done[:, 1].min())),
           "cad_off_mesh": None, "cad_coverage_gap": None}
    if surface:
        out.update(cad_numbers(cad, refs["mesh"], mix["cad_samples"]),
                   icp_gain_shortfall=ref.icp_gain_shortfall(sparse, done))
    return out


#: The numbers compared whose limit is in the cell's limits file, worst over
#: the passes; ``icp_sides_unmoved`` is a count with the limit 0.
GAPS = ("pair_gap", "nn_gap", "surface_gap", "icp_gain_shortfall", "plane_shortfall", "sparse_rigid_gap",
        "cloud_points_gap", "cad_ground_gap", "cad_off_mesh", "cad_coverage_gap")


def check(run) -> Verdict:
    mix, lim = run.mix, run.limits
    if torch.device(run.device).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    refs = references(run)
    log(f"[nb5] the reference's inputs: {time.perf_counter() - t0:.3f} s")
    pick = int(np.random.default_rng(run.seed).integers(0, max(len(run.units), 1)))
    worst = {key: 0.0 for key in GAPS}
    unmoved = 0
    failed = 0
    for k, u in enumerate(run.units):
        t0 = time.perf_counter()
        got = pass_gaps(u, mix, k == pick, refs, run.state["sparse_in"])
        log(f"[nb5] pass {k}: clouds {u['clouds_s']:.3f} s; checked in {time.perf_counter() - t0:.3f} s; gaps {got}")
        unmoved += got["icp_sides_unmoved"]
        for key in worst:
            # a NaN stays, and fails its limit
            if got[key] is not None and (np.isnan(got[key]) or got[key] > worst[key]):
                worst[key] = got[key]
        bad = [name for name, s in u["nn"].items() if not all(np.isfinite(list(s.values())))]
        failed += bool(bad)
    run.state["refs"] = refs
    shutil.rmtree(run.state["tmp"], ignore_errors=True)
    numbers = [Number(key, worst[key], lim[key]) for key in worst] + [Number("icp_sides_unmoved", unmoved, 0)]
    return Verdict(len(run.units), failed, numbers)


def control(run) -> dict:
    """The control's readings: the reference computed in bfloat16, one
    precision below the program's float32, in the program's place, against
    the float64 reference, on one pass of this run.  The ICP's numbers have
    no control (their upper readings are the planted faults')."""
    u = run.units[0]
    mix, refs = run.mix, run.state["refs"]
    lo = torch.bfloat16
    clouds = {k: _host(v) for k, v in u["clouds"].items()}
    out = {"pair_gap": 0.0, "nn_gap": 0.0, "surface_gap": 0.0}
    for a, b in u["pairs"]:
        hi = ref.chamfer_f1(clouds[a], clouds[b], mix["tau"], mix["pair_points"], 0)
        low = ref.chamfer_f1(clouds[a], clouds[b], mix["tau"], mix["pair_points"], 0, dtype=lo)
        out["pair_gap"] = max(out["pair_gap"], _rel(low[0], hi[0]), abs(low[1] - hi[1]))
    for name in u["nn"]:
        hi = ref.nn_stats(clouds[name], mix["nn_points"], 0)
        low = ref.nn_stats(clouds[name], mix["nn_points"], 0, dtype=lo)
        out["nn_gap"] = max(out["nn_gap"], _rel(low[0], hi[0]), _rel(low[1], hi[1]))
    for name, (v, f) in u["mesh"].items():
        hi = ref.surface_stats(_host(v), _host(f), mix["k"])
        low = ref.surface_stats(_host(v), _host(f), mix["k"], dtype=lo)
        out["surface_gap"] = max(out["surface_gap"], *(_rel(x, y) for x, y in zip(low, hi)))
    # the clouds' making in bfloat16
    sparse_in = run.state["sparse_in"]
    normal, _ = ref.plane_fit(sparse_in, seed=mix["clouds_seed"], dtype=lo)
    aligned = ref.align_to_z(sparse_in, normal, dtype=lo)
    out["plane_shortfall"] = 1.0 - ref.slab_inliers(aligned) / refs["plane_best"]
    out["sparse_rigid_gap"] = ref.rigid_gap(sparse_in, aligned)
    out["cloud_points_gap"] = max(
        ref.points_gap(ref.normalize(ref.occupied_points(DATA / mix[key]), dtype=lo), refs[name])
        for key, name in (("grid", "Carved Grid"), ("model", "Stage-3 Model")))
    mesh = refs["mesh"]
    cad = ref.sample_surface(mesh.verts, mesh.faces, mix["cad_samples"], mix["clouds_seed"], dtype=lo)
    ground = float(_host(u["sides"][1])[:, 1].min())
    cad = torch.as_tensor(cad).to(lo)
    cad[:, 1] += torch.as_tensor(ground).to(lo) - cad[:, 1].amin()
    cad = cad.double().numpy()
    out["cad_ground_gap"] = abs(float(cad[:, 1].min()) - ground)
    out.update(cad_numbers(cad, mesh, mix["cad_samples"]))
    return out
