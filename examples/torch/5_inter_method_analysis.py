#!/usr/bin/env python
"""Notebook 5 — inter-method comparison vs SfM/MVS and CAD references, on the
PyTorch port.

Twin of ``examples/5_inter_method_analysis.py``: builds the comparison
clouds (symmetric completion + ICP; inputs missing from the snapshot are
skipped) and prints the pairwise metric table: chamfer, F-score@τ, voxel
IoU, PCA similarity, and the NN regularity.  It needs the reference's PLY
and OBJ inputs under ``--root``; printing the tables needs pandas and
tabulate.

    python examples/torch/5_inter_method_analysis.py --root results/4.Inter-method_3D --device cuda
"""

import argparse
import itertools
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from pbr3d_torch.eval.inter import (  # noqa: E402
    chamfer_distance,
    compute_nn_stats,
    fscore_with_threshold,
    normalize_preserve_aspect,
    pca_shape_similarity,
    voxel_iou,
)
from pbr3d_torch.eval.preprocess import build_taj_clouds  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="results/4.Inter-method_3D")
    ap.add_argument("--tau", type=float, default=0.03)
    ap.add_argument("--device", default="cuda", help="torch device (cuda, or cpu)")
    args = ap.parse_args()
    import pandas as pd
    from tabulate import tabulate

    dev = args.device
    clouds = {k: normalize_preserve_aspect(v, device=dev)
              for k, v in build_taj_clouds(args.root, device=dev).items()}
    print("clouds:", {k: len(v) for k, v in clouds.items()})

    rows = []
    for a, b in itertools.combinations(clouds, 2):
        f1, prec, rec = fscore_with_threshold(clouds[a], clouds[b], tau=args.tau, device=dev)
        rows.append({
            "pair": f"{a} vs {b}",
            "chamfer²": chamfer_distance(clouds[a], clouds[b], device=dev),
            f"F1@{args.tau}": f1,
            "voxel IoU@96": voxel_iou(clouds[a], clouds[b], device=dev),
            "PCA sim": pca_shape_similarity(clouds[a], clouds[b], device=dev),
        })
    print(tabulate(pd.DataFrame(rows), headers="keys", tablefmt="grid", showindex=False))

    reg = {k: compute_nn_stats(v, device=dev) for k, v in clouds.items()}
    print(tabulate(pd.DataFrame(reg).T, headers="keys", tablefmt="grid", showindex=True))


if __name__ == "__main__":
    main()
