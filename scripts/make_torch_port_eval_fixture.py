"""Write ``tests/fixtures/torch_port_eval.json``: the JAX package's
notebook-4 cells and notebook-5 values that phase 8 of ``chip_smoke.py``
holds the PyTorch port against on the card.

Runs on the CPU with JAX in about a quarter of an hour::

    JAX_PLATFORMS=cpu python scripts/make_torch_port_eval_fixture.py

Notebook 4.  The three table functions of ``pbr3d.eval.intra`` over all
five monuments on the committed ``results_temp_golden/`` and ``results_temp/`` artifacts.  The
PNG masks are not in the repository, so
``pbr3d.eval.intra._load_mask_labels_for_grid`` is patched, in this process,
to return the planted front plane of ``tests/fixtures/torch_port_study.npz``
(``{resolution}_{monument}_front``).  Stored: ``nb4[resolution][table]``,
row -> monument -> the printed cell.

Notebook 5.  The reference's PLY and OBJ inputs are not in the repository
either; the inputs are made from the committed golden Taj artifacts by the
recipe ``chip_smoke.py`` shares (``nb5_sparse_cloud``, ``write_obj``, the
``NB5`` constants): a stand-in for the SfM cloud written as a PLY, the
stage-1 grid, and ``meshify_colored_voxel_grid`` at stride 2 written as an
OBJ.  ``pbr3d.eval.preprocess.build_taj_clouds`` makes the clouds from those
files, and ``pbr3d.eval.inter`` the pair table, the NN statistics and the
surface metrics.  Two of the JAX package's nearest-neighbour calls are
replaced, in this process, by an exact float64 cKDTree query, because on a
CPU they would take an hour: ICP's correspondences (about ninety products of
10^10 pairs) and the mesh colours (4 x 10^5 vertices against 1.4 x 10^6
voxels); everything else, the metrics' and the statistics' neighbour
searches included, is the JAX package's own.  Stored: the RANSAC triples
``jax.random`` drew, the plane and its inlier count, the three ICP
transforms, ``pairs``, ``nn``, ``surface`` and the meshes' sizes.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np
from scipy.spatial import cKDTree


def kdtree_knn(A, B, k, tile=None):
    """``pbr3d.ops.neighbors.knn``'s contract over a float64 cKDTree."""
    d, idx = cKDTree(np.asarray(B, np.float64)).query(np.asarray(A, np.float64), k=k)
    return (np.asarray(d, np.float32).reshape(len(A), k), np.asarray(idx, np.int32).reshape(len(A), k))


def compact_faces(inter, vertices, faces, y_thresh):
    """``filter_mesh`` with the kept faces renumbered into the kept vertices."""
    keep = vertices[:, 1] <= y_thresh
    v, f = inter.filter_mesh(vertices, faces, y_thresh)
    return v, (np.cumsum(keep) - 1)[f]


def notebook4(fxs, smoke) -> dict:
    import pbr3d.eval.intra as intra

    short = {v: k for k, v in intra.MONUMENT_SHORT.items()}
    monuments = list(smoke.config.MONUMENTS)
    out = {}
    for tag, run in smoke.STUDY_RUNS.items():
        res = run["results"]
        kw = dict(monuments=monuments, view="front", root_voxels=str(res / "1.Orthographic_Voxel_Carving"),
                  root_masks="", cam_dir=str(res / "2.Perspective_Camera_Estimation"))
        with mock.patch.object(intra, "_load_mask_labels_for_grid",
                               lambda root, monument, view, shape: fxs[f"{tag}_{monument}_front"]):
            t0 = time.perf_counter()
            frames = {
                "kp": intra.run_minaret_kp_evaluation(**kw),
                "iou": intra.run_minaret_iou_evaluation(**kw),
                "part": intra.run_part_minaret_binary_iou(
                    deformed_voxels=str(res / "3.Part-wise_3D_Refinement"), **kw),
            }
        print(f"nb4 {tag}: {time.perf_counter() - t0:.0f} s", flush=True)
        out[tag] = {name: {row: {short[c]: df.loc[row, c] for c in df.columns} for row in df.index}
                    for name, df in frames.items()}
    return out


def notebook5(smoke) -> dict:
    import jax

    import pbr3d.ops.neighbors as jax_neighbors
    from pbr3d.carving.voxel import all_points, meshify_colored_voxel_grid, surface_points_by_parts
    from pbr3d.eval import inter, preprocess
    from pbr3d.io.artifacts import load_voxel_grid_labels
    from pbr3d.io.pointcloud import load_ply, save_ply

    nb5 = smoke.NB5
    res = smoke.STUDY_RUNS["golden"]["results"]
    grid_path = res / "1.Orthographic_Voxel_Carving" / "Taj_voxel_grid.npz"
    grid = load_voxel_grid_labels(grid_path)
    model = load_voxel_grid_labels(res / "3.Part-wise_3D_Refinement" / "Taj_deformed_voxel_grid.npz")
    names = [p for p in smoke.config.PART_NAMES if p != "background"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp, mock.patch.object(preprocess, "knn", kdtree_knn):
        root = Path(tmp)
        save_ply(root / "segmented_point_cloud_final.ply",
                 smoke.nb5_sparse_cloud(surface_points_by_parts(grid, names)[0]))
        (root / "Taj_voxel_grid.npz").symlink_to(grid_path)
        with mock.patch.object(jax_neighbors, "knn", kdtree_knn):
            verts, faces, _, _ = meshify_colored_voxel_grid(grid, nb5["mesh_stride"])
        smoke.write_obj(root / "synthetic_taj.obj", verts, faces)
        print(f"nb5 mesh: {verts.shape} {faces.shape}", flush=True)

        sparse = load_ply(root / "segmented_point_cloud_final.ply")["points"]
        out["ransac_triples"] = np.asarray(jax.random.randint(
            jax.random.PRNGKey(nb5["seed"]), (1000, 3), 0, len(sparse))).tolist()
        plane, inliers = preprocess.segment_plane(sparse, 0.01, 1000, nb5["seed"])
        out["plane"], out["plane_inliers"] = plane.tolist(), int(len(inliers))

        raw = preprocess.build_taj_clouds(root, cad_samples=nb5["cad_samples"], seed=nb5["seed"])
        raw["Stage-3 Model"] = all_points(model)[0].astype(np.float64)
        print("nb5 clouds: " + json.dumps({k: len(v) for k, v in raw.items()}), flush=True)

        sides = preprocess.symmetric_completion(raw["Sparse"])
        left, t_left = preprocess.icp_point_to_point(sides["left"], sides["front"], 0.05)
        _, t_right = preprocess.icp_point_to_point(sides["right"], sides["front"], 0.05)
        _, t_back = preprocess.icp_point_to_point(sides["back"], left, 0.05)
        out["icp"] = {"left": t_left.tolist(), "right": t_right.tolist(), "back": t_back.tolist()}

    clouds = {k: inter.normalize_preserve_aspect(raw[k]) for k in smoke.NB5_CLOUDS}
    out.update(pairs={}, nn={}, surface={}, mesh={})
    for a, b in itertools.combinations(clouds, 2):
        f1, _, _ = inter.fscore_with_threshold(clouds[a], clouds[b], tau=nb5["tau"])
        out["pairs"][f"{a} vs {b}"] = {
            "chamfer2": inter.chamfer_distance(clouds[a], clouds[b]), "f1": f1,
            "voxel_iou": inter.voxel_iou(clouds[a], clouds[b]),
            "pca": inter.pca_shape_similarity(clouds[a], clouds[b])}
    print("nb5 pairs done", flush=True)
    for name, cloud in clouds.items():
        t0 = time.perf_counter()
        out["nn"][name] = inter.compute_nn_stats(cloud)
        verts, faces = inter.get_marching_cubes_mesh(cloud, nb5["grid_size"])
        v, f = compact_faces(inter, verts, faces, nb5["y_thresh"])
        out["surface"][name] = inter.compute_surface_metrics(v, f, nb5["k"])
        out["mesh"][name] = [len(verts), len(faces), len(v), len(f)]
        print(f"nb5 {name}: {out['nn'][name]} {out['surface'][name]} {out['mesh'][name]} "
              f"{time.perf_counter() - t0:.0f} s", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=REPO / "tests/fixtures/torch_port_eval.json")
    ap.add_argument("--only", choices=("nb4", "nb5"), help="remake one half, keep the other from --out")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke as smoke

    out = json.loads(Path(args.out).read_text()) if args.only else {}
    if args.only != "nb5":
        out["nb4"] = notebook4(np.load(smoke.STUDY), smoke)
    if args.only != "nb4":
        out["nb5"] = notebook5(smoke)
    out["seconds"] = time.perf_counter() - t_start
    Path(args.out).write_text(json.dumps(out, ensure_ascii=False) + "\n")
    print(f"wrote {args.out} {os.path.getsize(args.out)} bytes in {out['seconds']:.0f} s")


if __name__ == "__main__":
    main()
