"""Mask cleaning & compositing — headless core of the reference's
two-pane editor (segmentation_utils/interactive_part_segmentation.py), as in
``pbr3d.segmentation.cleanup``.

* close_holes: odd-kernel morphological close (reference :370-378);
* remove_small_regions_2d: drop 8-connected regions under min_area
  (reference :380-386, cv2.connectedComponentsWithStats), labelled on the
  host as everywhere in the port;
* MaskEditor: per-part binary masks composited by add / replace / subtract
  with last-action-wins draw order (reference :389-425, sam_ui.py:181-205),
  undo stack, color-mask render & save in the reference's filename scheme
  (reference :743-773);
* rasterize_polygon: the lasso selection as a pure point-in-polygon test
  (reference :706-739 uses matplotlib Path.contains_points).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pbr3d_torch import config
from pbr3d_torch.ops.morphology import binary_closing_square, remove_small_regions


def close_holes(mask, ksize: int = 5, *, device) -> np.ndarray:
    """Morphological close with an odd square kernel of size >= 3 — exact
    ``cv2.morphologyEx(..., MORPH_CLOSE, np.ones((k, k)))`` semantics
    (reference: interactive_part_segmentation.py:375-378), including cv2's
    border rule (dilation pads 0, erosion pads 1).  Runs on ``device``;
    returns a host bool array."""
    k = max(3, int(ksize))
    if k % 2 == 0:
        k += 1
    return binary_closing_square(mask, k, device=device).cpu().numpy()


def remove_small_regions_2d(mask, min_area: int) -> np.ndarray:
    """Keep 8-connected regions with area >= min_area (host labelling; a
    host bool array)."""
    return remove_small_regions(mask, int(min_area), "full")


def rasterize_polygon(verts: Sequence[Tuple[float, float]], hw: Tuple[int, int]) -> np.ndarray:
    """(H, W) bool mask of pixels inside the polygon (even-odd crossing rule,
    vectorized — replaces matplotlib Path.contains_points)."""
    H, W = hw
    v = np.asarray(verts, np.float64)
    if len(v) < 3:
        return np.zeros((H, W), bool)
    yy, xx = np.meshgrid(np.arange(H) + 0.0, np.arange(W) + 0.0, indexing="ij")
    px = xx.ravel()
    py = yy.ravel()
    inside = np.zeros(px.shape, bool)
    x0, y0 = v[:, 0], v[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    for ax, ay, bx, by in zip(x0, y0, x1, y1):
        crosses = ((ay > py) != (by > py)) & (
            px < (bx - ax) * (py - ay) / (by - ay + 1e-30) + ax
        )
        inside ^= crosses
    return inside.reshape(H, W)


class MaskEditor:
    """Per-part binary masks with add/replace/subtract compositing; the
    masks live on the host, :meth:`clean` closes holes on ``device``."""

    def __init__(self, image_hw: Tuple[int, int], part_names: Optional[Sequence[str]] = None, *, device):
        self.hw = tuple(image_hw)
        self.device = device  # where clean() closes holes
        names = list(part_names or [p for p in config.PART_NAMES if p != "background"])
        self.masks: Dict[str, np.ndarray] = {
            n: np.zeros(self.hw, np.uint8) for n in names
        }
        self.draw_order: List[str] = []
        self._undo: List[Tuple[Dict[str, np.ndarray], List[str]]] = []

    def push_undo(self) -> None:
        self._undo.append(({k: m.copy() for k, m in self.masks.items()}, list(self.draw_order)))

    def undo(self) -> bool:
        if not self._undo:
            return False
        self.masks, self.draw_order = self._undo.pop()
        return True

    def apply(self, mask: np.ndarray, part: str, mode: str = "replace") -> None:
        """Composite a binary selection into one part's mask.

        * add: claim only unowned pixels;
        * replace: claim pixels, clearing them from other parts;
        * subtract: remove pixels from this part.
        (reference: interactive_part_segmentation.py:389-425)
        """
        fm = np.asarray(mask, bool)
        if not fm.any():
            return
        self.push_undo()
        if mode == "subtract":
            self.masks[part][fm] = 0
        elif mode == "add":
            occupied = np.zeros(self.hw, bool)
            for m in self.masks.values():
                occupied |= m.astype(bool)
            self.masks[part] |= (fm & ~occupied).astype(np.uint8)
        elif mode == "replace":
            for k in self.masks:
                if k != part:
                    self.masks[k][fm] = 0
            self.masks[part] |= fm.astype(np.uint8)
        else:
            raise ValueError(f"unknown mode {mode!r}")
        if part in self.draw_order:
            self.draw_order.remove(part)
        self.draw_order.append(part)

    def clean(self, part: str, close_ksize: Optional[int] = None,
              min_area: Optional[int] = None) -> None:
        m = self.masks[part].astype(bool)
        self.push_undo()
        if close_ksize:
            m = close_holes(m, close_ksize, device=self.device)
        if min_area:
            m = remove_small_regions_2d(m, min_area)
        self.masks[part] = m.astype(np.uint8)

    def render_color_mask(self, background: bool = True) -> np.ndarray:
        """Composite to an RGB part mask, later draw actions on top
        (reference sam_ui.py:188-205)."""
        out = np.zeros((*self.hw, 3), np.uint8)
        if background:
            out[:] = config.PART_COLORS_NP["background"]
        for part in self.draw_order:
            m = self.masks[part].astype(bool)
            out[m] = config.PART_COLORS_NP[part]
        return out

    def save(self, image_path: str | Path, bbox: Optional[Tuple[int, int, int, int]] = None,
             out_root: Optional[str | Path] = None) -> Path:
        """Save the color mask as
        ``<stem>_mask_<L>_<T>_<R>_<B>.png`` next to the image
        (reference: interactive_part_segmentation.py:743-773)."""
        import cv2

        image_path = Path(image_path)
        masks_dir = (Path(out_root) if out_root else image_path.parent) / "masks"
        masks_dir.mkdir(parents=True, exist_ok=True)
        L, T, R, B = bbox if bbox else (0, 0, self.hw[1], self.hw[0])
        out = masks_dir / f"{image_path.stem}_mask_{L}_{T}_{R}_{B}.png"
        cv2.imwrite(str(out), cv2.cvtColor(self.render_color_mask(), cv2.COLOR_RGB2BGR))
        return out
