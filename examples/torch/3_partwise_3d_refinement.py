#!/usr/bin/env python
"""Stage 3 — part-wise symmetry-preserving refinement, on the PyTorch port.

Twin of ``examples/3_partwise_3d_refinement.py`` (notebook
``3.Part-wise_3D_refinement.ipynb``): under the fixed stage-2 "final" front
camera, optimize the 4-DoF deformation of every part to maximize its
projected IoU, rebuild the deformed grid, and save the npz.  Reading the PNG
masks needs OpenCV.

    python examples/torch/3_partwise_3d_refinement.py --monument Bibi --device cuda
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from pbr3d_torch import config  # noqa: E402
from pbr3d_torch.io.artifacts import load_camera_json, load_voxel_grid_labels  # noqa: E402
from pbr3d_torch.pipeline import run_stage3  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--monument", default="Bibi", choices=config.MONUMENTS)
    ap.add_argument("--data-root", default="data")
    ap.add_argument("--grids", default="results_temp")
    ap.add_argument("--cams", default="results_temp")
    ap.add_argument("--out", default="results_temp")
    ap.add_argument("--search-stride", type=int, default=8)
    ap.add_argument(
        "--overrides",
        default=None,
        help="JSON file of {part: {scale_y, shift_y, scale_xz, shift_xz}} "
        "deforms taken verbatim (skips the search for those parts) — the "
        "escape hatch replacing the reference's human slider session; a "
        "previously saved stage-3 params JSON also works.",
    )
    ap.add_argument("--device", default="cuda", help="torch device (cuda, or cpu)")
    args = ap.parse_args()

    grid = load_voxel_grid_labels(
        Path(args.grids) / "1.Orthographic_Voxel_Carving" / f"{args.monument}_voxel_grid.npz"
    )
    cam = load_camera_json(
        Path(args.cams) / "2.Perspective_Camera_Estimation"
        / f"{args.monument}_camera_params_final.json",
        "front",
    )
    deforms, deformed = run_stage3(
        args.monument, grid, cam, args.data_root, args.out,
        search_stride=args.search_stride, overrides=args.overrides, device=args.device,
    )
    for part, d in deforms.items():
        print(f"{part:>16}: IoU {d['iou']:.4f}  {d['deform']}")
    print(f"deformed grid: {deformed.shape}, occupied {(deformed > 0).sum():,}")


if __name__ == "__main__":
    main()
