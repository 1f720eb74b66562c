"""Write ``tests/fixtures/torch_port_Bibi_512.npz``: the JAX package's stage-1
output and notebook-5 metrics on Bibi at 512, for holding ``pbr3d_torch``
against it on the card.

Runs on the CPU with JAX::

    JAX_PLATFORMS=cpu python scripts/make_torch_port_fixture.py

Mask recovery.  The reference's PNG masks are not in the repo, so the three
label planes are recovered from the reference-code oracle
``tests/fixtures/oracle_Bibi_512.npz``:

* exterior labels: ``ext = rgb_to_labels(colored).max(axis=2).T`` — each
  (x, y) column's label in the global-carve output; background columns are 0.
  ``binary = ext > 0``.  ``pbr3d.carving.stage1.global_carve(binary, ext, 90)``
  reproduces ``colored`` with 0 differing voxels.
* semantic labels: ``final`` is un-reoriented (flip axis 1, transpose back
  to (W, H, D)); where the front-most occupied voxel of a column along depth
  (smallest z) carries an interior label (main_door, windows), that label
  replaces ``ext`` at the column's pixel.  This is an approximation of the
  reference's semantic mask (stage 1 on it lands a few thousand voxels off
  ``final`` at 512), which is why the fixture stores the JAX package's own
  ``carve_monument_fused`` grid on the recovered masks as the exact anchor.

Metrics.  Stage-1 cloud (``all_points`` of the grid) against the committed
stage-3 model ``results_temp_golden/3.Part-wise_3D_Refinement/
Bibi_deformed_voxel_grid.npz``, both through ``normalize_preserve_aspect``:
chamfer (20k points), F-score@``TAU`` (20k) and the F1 curve over
``THRESHOLDS`` (50k), from ``pbr3d.eval.inter`` and again from a float64
scipy ``cKDTree`` on the same downsampled points.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np
from scipy.spatial import cKDTree

from pbr3d import config
from pbr3d.config import PART_IDS, rgb_to_labels

TAU = 0.03
THRESHOLDS = np.linspace(0.005, 0.1, 20)


def recover_labels(colored: np.ndarray, final: np.ndarray):
    """(binary, exterior_labels, semantic_labels), each (H, W) uint8, from an
    oracle's RGB ``colored`` (global carve) and ``final`` (stage 1) grids."""
    ext = rgb_to_labels(colored).max(axis=2).T.copy()
    binary = (ext > 0).astype(np.uint8)
    g = np.transpose(np.flip(rgb_to_labels(final), axis=1), (2, 1, 0))  # (W, H, D)
    occ = g > 0
    front = np.take_along_axis(g, occ.argmax(axis=2)[:, :, None], axis=2)[:, :, 0].T
    interior = np.isin(front, [PART_IDS[p] for p in config.INTERIOR_PARTS])
    sem = ext.copy()
    sem[interior] = front[interior]
    return binary, ext, sem


def _kd_dist(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    return cKDTree(B.astype(np.float64)).query(A.astype(np.float64), k=1)[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--oracle", default=REPO / "tests/fixtures/oracle_Bibi_512.npz")
    ap.add_argument(
        "--stage3",
        default=REPO / "results_temp_golden/3.Part-wise_3D_Refinement/Bibi_deformed_voxel_grid.npz",
    )
    ap.add_argument("--out", default=REPO / "tests/fixtures/torch_port_Bibi_512.npz")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from pbr3d.carving.fused import carve_monument_fused
    from pbr3d.carving.voxel import all_points
    from pbr3d.eval import inter
    from pbr3d.io.artifacts import load_voxel_grid_labels
    from pbr3d_torch.io.masks import MaskSet

    oracle = np.load(args.oracle)
    binary, ext, sem = recover_labels(oracle["colored"], oracle["final"])
    grid = carve_monument_fused(MaskSet.from_labels(binary, ext, sem))
    print("stage-1 grid", grid.shape, "occupied", int((grid > 0).sum()))

    A = inter.normalize_preserve_aspect(all_points(grid)[0])
    B = inter.normalize_preserve_aspect(all_points(load_voxel_grid_labels(args.stage3))[0])
    print("clouds", A.shape, B.shape)

    chamfer = inter.chamfer_distance(A, B)
    fscore = inter.fscore_with_threshold(A, B, TAU)
    curve = inter.compute_f1_curve(A, B, THRESHOLDS)

    A32, B32 = np.asarray(A, np.float32), np.asarray(B, np.float32)
    a, b = inter._downsample(A32, 20000, 0), inter._downsample(B32, 20000, 1)
    dA, dB = _kd_dist(a, b), _kd_dist(b, a)
    kd_chamfer = float(np.mean(dA**2) + np.mean(dB**2))
    p, r = float(np.mean(dA < TAU)), float(np.mean(dB < TAU))
    kd_fscore = (2 * p * r / (p + r), p, r)
    a, b = inter._downsample(A32, 50000, 0), inter._downsample(B32, 50000, 0)
    kd_curve = inter.f1_curve_from_distances(_kd_dist(a, b), _kd_dist(b, a), THRESHOLDS)
    print("chamfer jax", chamfer, "kd", kd_chamfer)
    print("fscore jax", fscore, "kd", kd_fscore)

    np.savez_compressed(
        args.out,
        binary=binary, exterior_labels=ext, semantic_labels=sem, grid=grid,
        tau=TAU, thresholds=THRESHOLDS,
        jax_chamfer=chamfer, jax_fscore=np.asarray(fscore),
        jax_f1_curve=np.stack(curve),
        kd_chamfer=kd_chamfer, kd_fscore=np.asarray(kd_fscore),
        kd_f1_curve=np.stack(kd_curve),
    )
    print("wrote", args.out, os.path.getsize(args.out), "bytes")


if __name__ == "__main__":
    main()
