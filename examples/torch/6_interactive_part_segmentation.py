#!/usr/bin/env python
"""Notebook 6 — mask authoring, headless, on the PyTorch port.

Twin of ``examples/6_interactive_part_segmentation.py``: symmetric crop,
polygon part selection, cleanup (the hole closing runs on ``--device``),
composite, save.  SAM prompting needs the external ``segment_anything``
package and a checkpoint (``pbr3d_torch.segmentation.load_sam_predictor``);
without it, polygon selections still work.  Reading and writing the PNGs
needs OpenCV.

    python examples/torch/6_interactive_part_segmentation.py image.png \
        --crop 10 0 300 240 --polygon 20 20 200 20 200 200 20 200 --close 5 --device cuda
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from pbr3d_torch.segmentation import (  # noqa: E402
    ImageState,
    MaskEditor,
    apply_crop,
    find_symmetry_axis,
    rasterize_polygon,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("image")
    ap.add_argument("--crop", nargs=4, type=int, metavar=("L", "T", "R", "B"))
    ap.add_argument("--part", default="full_building")
    ap.add_argument("--polygon", nargs="+", type=float,
                    help="x0 y0 x1 y1 ... polygon selection in pixels")
    ap.add_argument("--close", type=int, default=0, help="closing kernel size")
    ap.add_argument("--min-area", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (cuda, or cpu)")
    args = ap.parse_args()

    st = ImageState().load(args.image)
    st.sym_x = find_symmetry_axis(st.curr_np)
    print(f"symmetry axis: x={st.sym_x}")

    if args.crop:
        st.push_undo()
        st.curr_np, eff = apply_crop(st.curr_np, tuple(args.crop), True, st.sym_x)
        print(f"cropped to {eff}; new shape {st.curr_np.shape}")

    editor = MaskEditor(st.curr_np.shape[:2], device=args.device)
    if args.polygon:
        verts = list(zip(args.polygon[0::2], args.polygon[1::2]))
        sel = rasterize_polygon(verts, st.curr_np.shape[:2])
        editor.apply(sel, args.part, "replace")
        if args.close or args.min_area:
            editor.clean(args.part, args.close or None, args.min_area or None)
        out = editor.save(st.path)
        print(f"saved mask: {out}")


if __name__ == "__main__":
    main()
