"""Write ``tests/fixtures/torch_port_Bibi_512_stage2.npz``: the JAX package's
stage 2 (camera estimation) on Bibi at 512, for holding ``pbr3d_torch``
against it on the card.

Runs on the CPU with JAX, in about 5 minutes (five full ``run_stage2`` runs
at the defaults, ~50 s each, dominate)::

    JAX_PLATFORMS=cpu python scripts/make_torch_port_stage2_fixture.py

Views.  The reference's PNG masks are not in the repo, so both views are
made from files that are:

* front: the recovered ``semantic_labels`` of
  ``tests/fixtures/torch_port_Bibi_512.npz`` (see
  ``scripts/make_torch_port_fixture.py``);
* drone: a planted view — every occupied voxel of that fixture's stage-1
  ``grid`` splatted (``pbr3d.ops.projection.splat_labels``) through the
  committed Bibi drone camera
  (``results_temp_golden/2.Perspective_Camera_Estimation/
  Bibi_camera_params_final.json``, 337x491 px).

Both are written as PNGs in the reference layout and run through
``pbr3d.pipeline.run_stage2``, as a user would.

Contents, per view ``v`` in (front, drone):

* ``{v}_mask``: the label plane; ``drone_cam``: the planted camera (9-vector);
* ``{v}_init``, ``{v}_kp`` (9-vectors) and ``{v}_kp_loss``: the bbox init,
  the keypoint LM fit and its loss;
* ``{v}_batch`` (64, 9): cameras around ``kp`` (numpy seed 0) and
  ``{v}_batch_iou`` (64,): the JAX ``_batch_iou`` of each on the shell, the
  search's objective;
* ``{v}_final`` (9-vector) and ``{v}_final_iou``: ``run_stage2``'s final
  camera at seed 0 and its shell IoU; ``{v}_final_solid_iou``: the same
  camera scored by ``evaluate_camera_iou`` (the solid);
* ``{v}_seed_ious`` (5,): the final shell IoUs of ``run_stage2`` at seeds
  0-4 — their minimum bounds a run on another generator;
* ``draws_{s}`` (40, 64, 9) for s in (0, 1, 3): the JAX uniform draws of
  the searches at seed s (``run_stage2`` searches at seed, seed + 1 and
  seed + 3).

The helpers below also build the small Akbar@128 scene the CPU tests use.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np

from pbr3d.config import labels_to_rgb, rgb_to_labels

CAMERAS = REPO / "results_temp_golden/2.Perspective_Camera_Estimation"
VIEWS = ("front", "drone")
ALIGN_PARTS = ["front_minarets", "back_minarets"]
DRAW_SEEDS = (0, 1, 3)
N_SEEDS = 5
GENERATIONS, POPULATION = 40, 64


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def jax_draws(seed: int, generations: int, population: int) -> np.ndarray:
    """(generations, population, 9) float32: the uniform [-1, 1) proposals
    ``pbr3d.camera.align._search_impl`` draws at ``seed``."""
    jax = _jax()
    import jax.numpy as jnp

    keys = jax.random.split(jax.random.PRNGKey(seed), generations)
    return np.stack([
        np.asarray(jax.random.uniform(k, (population, 9), jnp.float32, -1.0, 1.0)) for k in keys
    ])


def planted_view(grid: np.ndarray, cam: dict, H: int, W: int) -> np.ndarray:
    """(H, W) uint8 label plane: every occupied voxel of ``grid`` splatted
    through ``cam`` by the JAX package."""
    _jax()
    import jax.numpy as jnp

    from pbr3d.carving.voxel import all_points
    from pbr3d.ops.projection import splat_labels

    pts, labels = all_points(grid)
    return np.asarray(splat_labels(
        jnp.asarray(pts), jnp.asarray(labels), jnp.ones(len(pts), bool),
        np.asarray(cam["cam_pos"], np.float32), np.asarray(cam["target"], np.float32),
        cam["f"], cam["cx"], cam["cy"], H, W,
    ))


def write_mask_pngs(root: Path, monument: str, views: dict) -> None:
    """``{root}/{monument}/masks/{monument}_{view}_mask.png`` per view."""
    import cv2

    d = Path(root) / monument / "masks"
    d.mkdir(parents=True, exist_ok=True)
    for view, labels in views.items():
        cv2.imwrite(str(d / f"{monument}_{view}_mask.png"), labels_to_rgb(labels)[:, :, ::-1])


def akbar_128():
    """(grid, {front, drone}) for Akbar at 128: the oracle's ``final`` grid,
    the front mask recovered as in ``make_torch_port_fixture.py``, and a
    drone view planted through the committed Akbar drone camera, its image
    scaled from 526 to 128 px."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_fixture", REPO / "scripts" / "make_torch_port_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    oracle = np.load(REPO / "tests/fixtures/oracle_Akbar_128.npz")
    grid = rgb_to_labels(oracle["final"])
    front = mod.recover_labels(oracle["colored"], oracle["final"])[2]
    cam = dict(json.loads((CAMERAS / "Akbar_camera_params_final.json").read_text())["drone"])
    s = 128 / cam["H"]
    for k in ("f", "cx", "cy"):
        cam[k] = cam[k] * s
    return grid, {"front": front, "drone": planted_view(grid, cam, 128, 128)}


def jax_shell_ious(grid: np.ndarray, mask: np.ndarray, cams: np.ndarray) -> np.ndarray:
    """JAX ``_batch_iou`` of (P, 9) cameras on the alignment parts' shell —
    the objective the mask-IoU search maximises."""
    _jax()
    import jax.numpy as jnp

    from pbr3d import config
    from pbr3d.camera.align import _batch_iou, _pad_plane, mask_labels_selected
    from pbr3d.carving.voxel import bucket_size, pad_points, surface_points_by_parts

    H, W = mask.shape
    pts, labels = surface_points_by_parts(grid, ALIGN_PARTS)
    p, l, v = pad_points(pts, labels, bucket_size(len(pts)))
    gt, (Hp, Wp) = _pad_plane(mask_labels_selected(mask, ALIGN_PARTS))
    return np.asarray(_batch_iou(
        jnp.asarray(np.asarray(cams, np.float32)), jnp.asarray(p), jnp.asarray(l),
        jnp.asarray(v), jnp.asarray(gt), jnp.asarray(config.part_ids(ALIGN_PARTS)),
        jnp.asarray([H, W], jnp.int32), Hp, Wp,
    ))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage1", default=REPO / "tests/fixtures/torch_port_Bibi_512.npz")
    ap.add_argument("--out", default=REPO / "tests/fixtures/torch_port_Bibi_512_stage2.npz")
    args = ap.parse_args()

    _jax()
    from pbr3d.camera.align import evaluate_camera_iou
    from pbr3d.camera.estimate import (
        auto_compute_initial_params_matching_bbox, optimize_camera_with_keypoints,
    )
    from pbr3d.camera.geometry import params_to_vector
    from pbr3d.camera.keypoints import extract_minaret_kps_for_view
    from pbr3d.pipeline import run_stage2

    stage1 = np.load(args.stage1)
    grid = stage1["grid"]
    cam = json.loads((CAMERAS / "Bibi_camera_params_final.json").read_text())["drone"]
    views = {"front": stage1["semantic_labels"],
             "drone": planted_view(grid, cam, cam["H"], cam["W"])}
    out = {"drone_cam": params_to_vector(cam)}
    rng = np.random.default_rng(0)
    for view, mask in views.items():
        out[f"{view}_mask"] = mask
        vox_kps, img_kps = extract_minaret_kps_for_view(grid, mask)
        init = auto_compute_initial_params_matching_bbox(grid, mask, ALIGN_PARTS)
        kp = optimize_camera_with_keypoints(vox_kps, img_kps, mask.shape, init)
        out[f"{view}_init"] = params_to_vector(init)
        out[f"{view}_kp"] = params_to_vector(kp)
        out[f"{view}_kp_loss"] = np.float32(kp["loss"])
        batch = out[f"{view}_kp"] + rng.uniform(-1, 1, (64, 9)).astype(np.float32) * np.array(
            [50, 50, 100, 50, 50, 100, 50, 20, 20], np.float32) * 0.25
        out[f"{view}_batch"] = batch.astype(np.float32)
        out[f"{view}_batch_iou"] = jax_shell_ious(grid, mask, out[f"{view}_batch"])
        print(view, "keypoints", len(img_kps), "kp loss", kp["loss"],
              "batch IoU max", float(out[f"{view}_batch_iou"].max()), flush=True)
    for s in DRAW_SEEDS:
        out[f"draws_{s}"] = jax_draws(s, GENERATIONS, POPULATION)

    with tempfile.TemporaryDirectory() as root:
        write_mask_pngs(root, "Bibi", views)
        seed_ious = {v: [] for v in VIEWS}
        for seed in range(N_SEEDS):
            t0 = time.perf_counter()
            final = run_stage2("Bibi", grid, root, seed=seed)["final"]
            for view in VIEWS:
                vec = params_to_vector(final[view])
                iou = float(jax_shell_ious(grid, views[view], vec[None])[0])
                seed_ious[view].append(iou)
                if seed == 0:
                    out[f"{view}_final"] = vec
                    out[f"{view}_final_iou"] = np.float32(iou)
                    out[f"{view}_final_solid_iou"] = np.float32(
                        evaluate_camera_iou(grid, views[view], ALIGN_PARTS, final[view]))
            print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
                  {v: seed_ious[v][-1] for v in VIEWS}, flush=True)
    for view in VIEWS:
        out[f"{view}_seed_ious"] = np.asarray(seed_ious[view], np.float32)

    np.savez_compressed(args.out, **out)
    print("wrote", args.out, os.path.getsize(args.out), "bytes")


if __name__ == "__main__":
    main()
