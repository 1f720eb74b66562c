#!/usr/bin/env python
"""Stage 1 — orthographic semantic voxel carving, on the PyTorch port.

Twin of ``examples/1_orthographic_semantic_voxel_carving.py`` (notebook
``1.Orthographic_semantic_voxel_carving.ipynb``): load + prepare the front
mask, globally carve, part-wise refine (the unfused ``carve_monument``, which
takes any carve preset), save the npz artifact, and render a mesh preview.
Reading the PNG masks needs OpenCV; the preview needs matplotlib.

    python examples/torch/1_orthographic_semantic_voxel_carving.py \
        --monument Taj --data-root data --device cuda
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from pbr3d_torch import config  # noqa: E402
from pbr3d_torch.carving.stage1 import carve_monument  # noqa: E402
from pbr3d_torch.carving.voxel import meshify_colored_voxel_grid  # noqa: E402
from pbr3d_torch.io.artifacts import save_voxel_grid  # noqa: E402
from pbr3d_torch.io.masks import prepare_masks  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--monument", default="Taj", choices=config.MONUMENTS)
    ap.add_argument("--data-root", default="data")
    ap.add_argument("--max-dim", type=int, default=256,
                    help="mask resize cap (goldens used 512; 128 for Akbar)")
    ap.add_argument("--out", default="results_temp")
    ap.add_argument("--mesh-preview", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (cuda, or cpu)")
    args = ap.parse_args()

    masks = prepare_masks(args.data_root, args.monument, "front", args.max_dim)
    print(f"masks: semantic {masks.semantic.shape}, binary {masks.binary.shape}")

    grid = carve_monument(masks, device=args.device)
    print(f"carved grid: {grid.shape}, occupied voxels: {(grid > 0).sum():,}")

    out = Path(args.out) / "1.Orthographic_Voxel_Carving" / f"{args.monument}_voxel_grid.npz"
    save_voxel_grid(out, grid)
    print(f"saved {out}")

    if args.mesh_preview:
        verts, faces, colors, _ = (t.cpu().numpy() for t in
                                   meshify_colored_voxel_grid(grid, stride=4, device=args.device))
        from pbr3d_torch.utils.viz import visualize_mesh_matplotlib

        fig = visualize_mesh_matplotlib(verts, faces, colors, args.monument)
        fig.savefig(out.with_suffix(".preview.png"), dpi=120)
        print(f"mesh preview: {out.with_suffix('.preview.png')}")


if __name__ == "__main__":
    main()
