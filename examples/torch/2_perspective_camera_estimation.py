#!/usr/bin/env python
"""Stage 2 — perspective camera estimation, on the PyTorch port.

Twin of ``examples/2_perspective_camera_estimation.py`` (notebook
``2.Perspective_camera_estimation.ipynb``): for each view (front, drone)
extract minaret anchors, initialize the camera from bounding boxes, fit by
keypoint reprojection, then refine by mask IoU.  Saves the {init,kp,final}
camera JSONs.  Reading the PNG masks needs OpenCV.

    python examples/torch/2_perspective_camera_estimation.py --monument Bibi --device cuda
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from pbr3d_torch import config  # noqa: E402
from pbr3d_torch.io.artifacts import load_voxel_grid_labels  # noqa: E402
from pbr3d_torch.pipeline import run_stage2  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--monument", default="Bibi", choices=config.MONUMENTS)
    ap.add_argument("--data-root", default="data")
    ap.add_argument("--grids", default="results_temp",
                    help="root holding 1.Orthographic_Voxel_Carving/")
    ap.add_argument("--out", default="results_temp")
    ap.add_argument("--generations", type=int, default=40)
    ap.add_argument("--population", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="torch device (cuda, or cpu)")
    args = ap.parse_args()

    grid = load_voxel_grid_labels(
        Path(args.grids) / "1.Orthographic_Voxel_Carving" / f"{args.monument}_voxel_grid.npz"
    )
    cameras = run_stage2(
        args.monument, grid, args.data_root, args.out,
        generations=args.generations, population=args.population, device=args.device,
    )
    for tag, views in cameras.items():
        for view, cam in views.items():
            print(f"{tag:>6}/{view}: f={cam['f']:.1f} cam_pos={cam['cam_pos']}")


if __name__ == "__main__":
    main()
