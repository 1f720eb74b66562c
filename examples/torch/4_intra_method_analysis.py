#!/usr/bin/env python
"""Notebook 4 — intra-method consistency tables over saved artifacts, on the
PyTorch port.

Twin of ``examples/4_intra_method_analysis.py``.  Reading the PNG masks
needs OpenCV; printing the tables needs pandas and tabulate.

    python examples/torch/4_intra_method_analysis.py --results results --device cuda
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from pbr3d_torch.eval.intra import (  # noqa: E402
    run_minaret_iou_evaluation,
    run_minaret_kp_evaluation,
    run_part_minaret_binary_iou,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="results",
                    help="artifact root (results or results_temp)")
    ap.add_argument("--data-root", default="data")
    ap.add_argument("--monuments", nargs="+",
                    default=["Taj", "Bibi", "Itimad", "Akbar", "Charminar"])
    ap.add_argument("--device", default="cuda", help="torch device (cuda, or cpu)")
    args = ap.parse_args()

    kw = dict(
        monuments=args.monuments,
        view="front",
        root_voxels=f"{args.results}/1.Orthographic_Voxel_Carving",
        root_masks=args.data_root,
        cam_dir=f"{args.results}/2.Perspective_Camera_Estimation",
        device=args.device,
    )
    run_minaret_kp_evaluation(**kw)
    run_minaret_iou_evaluation(**kw)
    run_part_minaret_binary_iou(
        deformed_voxels=f"{args.results}/3.Part-wise_3D_Refinement", **kw
    )


if __name__ == "__main__":
    main()
