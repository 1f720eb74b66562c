"""Semantic part-mask preparation (host side), as in ``pbr3d.io.masks``.

``cv2`` is imported inside the functions that read PNGs only: the PNG
dataset is dataset IO, not the compute path, and the machines that run the
port on the card need not have OpenCV.  See ``pbr3d.io.masks`` for the replicated
reference behaviours (full-resolution interior folding, the INTER_LINEAR
resize quirk, the Charminar window override, the binary silhouette rule).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np

from pbr3d_torch import config
from pbr3d_torch.config import BACKGROUND_ID, PART_IDS, labels_to_rgb, rgb_to_labels


@dataclasses.dataclass
class MaskSet:
    """Prepared per-view masks for stage-1 carving.

    RGB fields keep artifact-exact colors; ``*_labels`` fields are the uint8
    label planes the carving consumes (part ids 1..10, OTHER_ID for blend
    pixels, BACKGROUND_ID for background).
    """

    semantic: np.ndarray  # (H, W, 3) uint8 — full mask (doors/windows kept)
    exterior: np.ndarray  # (H, W, 3) uint8 — interior folded into full_building
    binary: np.ndarray  # (H, W) uint8 {0,1} — carving silhouette
    semantic_labels: np.ndarray  # (H, W) uint8
    exterior_labels: np.ndarray  # (H, W) uint8

    @property
    def hw(self) -> tuple[int, int]:
        return self.binary.shape[:2]

    @classmethod
    def from_labels(
        cls, binary: np.ndarray, exterior_labels: np.ndarray,
        semantic_labels: np.ndarray,
    ) -> "MaskSet":
        """A mask set from its three label planes (RGB fields by palette)."""
        return cls(
            semantic=labels_to_rgb(semantic_labels),
            exterior=labels_to_rgb(exterior_labels),
            binary=np.asarray(binary, np.uint8),
            semantic_labels=np.asarray(semantic_labels, np.uint8),
            exterior_labels=np.asarray(exterior_labels, np.uint8),
        )


def _read_rgb(path) -> np.ndarray:
    import cv2

    img = cv2.imread(str(path))
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _resize_to_max(img: np.ndarray, max_dim: int, linear: bool) -> np.ndarray:
    """Aspect-preserving resize: scale = max_dim / max(h, w), truncating dims."""
    import cv2

    h, w = img.shape[:2]
    s = max_dim / max(h, w)
    interp = cv2.INTER_LINEAR if linear else cv2.INTER_NEAREST
    return cv2.resize(img, (int(w * s), int(h * s)), interpolation=interp)


def load_mask_rgb(
    root_path: str | Path,
    monument_name: str,
    view_name: str,
    max_dim: Optional[int] = None,
) -> np.ndarray:
    """RGB uint8 (H, W, 3) part mask; nearest-resized if max_dim is given."""
    path = Path(root_path) / monument_name / "masks" / f"{monument_name}_{view_name}_mask.png"
    mask = _read_rgb(path)
    if max_dim is not None:
        mask = _resize_to_max(mask, max_dim, linear=False)
    return mask


def load_mask_labels(
    root_path: str | Path,
    monument_name: str,
    view_name: str,
    max_dim: Optional[int] = None,
) -> np.ndarray:
    """uint8 (H, W) label plane version of :func:`load_mask_rgb`."""
    return rgb_to_labels(load_mask_rgb(root_path, monument_name, view_name, max_dim))


def voxel_grid_mask_shape(mask_hw, grid_shape) -> tuple[int, int]:
    """(h, w) that :func:`resize_mask_to_voxel_grid` gives a mask of
    ``mask_hw``: max(mask dims) == max(grid dims), ROUNDED dims."""
    H, W = mask_hw[:2]
    scale = max(grid_shape[:3]) / max(H, W)
    return int(round(H * scale)), int(round(W * scale))


def resize_mask_to_voxel_grid(mask_rgb: np.ndarray, grid_shape) -> np.ndarray:
    """Resize to :func:`voxel_grid_mask_shape`; nearest (the notebook-4
    loader, eval_helpers_intra.py:31-54; stage 1 truncates)."""
    import cv2

    h, w = voxel_grid_mask_shape(mask_rgb.shape, grid_shape)
    return cv2.resize(mask_rgb, (w, h), interpolation=cv2.INTER_NEAREST)


def load_mask_labels_for_grid(
    root_path: str | Path, monument_name: str, view_name: str, grid_shape,
) -> np.ndarray:
    """uint8 (H, W) label plane of a view, resized to a voxel grid as the
    notebook-4 evaluation resizes it (the exact-verify mask of stage 3)."""
    path = Path(root_path) / monument_name / "masks" / f"{monument_name}_{view_name}_mask.png"
    return rgb_to_labels(resize_mask_to_voxel_grid(_read_rgb(path), grid_shape))


def compute_binary_gt(mask_labels: np.ndarray, grid_labels: np.ndarray) -> np.ndarray:
    """GT silhouette: the mask pixels whose label is present in the grid
    (eval_helpers_intra.py:274-285)."""
    present = np.unique(grid_labels)
    return np.isin(mask_labels, present[present > 0])


def prepare_masks(
    root_path: str | Path,
    monument_name: str,
    view_name: str = "front",
    max_dim: int = config.MAX_DIM,
    quirk_linear_resize: bool = True,
) -> MaskSet:
    """Load + fold + resize the semantic masks for one monument view
    (reference: utils/mask_utils.py:35-87)."""
    mask_dir = Path(root_path) / monument_name / "masks"
    semantic_full = _read_rgb(mask_dir / f"{monument_name}_{view_name}_mask.png")

    # Interior -> exterior folding at full resolution.
    labels_full = rgb_to_labels(semantic_full)
    interior = np.isin(
        labels_full, [PART_IDS[p] for p in config.INTERIOR_PARTS]
    )
    exterior_full = semantic_full.copy()
    exterior_full[interior] = config.PART_COLORS_NP["full_building"]

    semantic = _resize_to_max(semantic_full, max_dim, linear=quirk_linear_resize)
    exterior = _resize_to_max(exterior_full, max_dim, linear=quirk_linear_resize)

    # Charminar window-variant override of the *semantic* (full) mask only.
    if monument_name == "Charminar":
        win_path = mask_dir / f"{monument_name}_{view_name}_mask_win.png"
        if win_path.exists():
            semantic = _resize_to_max(
                _read_rgb(win_path), max_dim, linear=quirk_linear_resize
            )

    semantic_labels = rgb_to_labels(semantic)
    exterior_labels = rgb_to_labels(exterior)
    binary = (exterior_labels != BACKGROUND_ID).astype(np.uint8)

    return MaskSet(
        semantic=semantic,
        exterior=exterior,
        binary=binary,
        semantic_labels=semantic_labels,
        exterior_labels=exterior_labels,
    )


def mask_parts_from_labels(labels: np.ndarray, part_names) -> np.ndarray:
    """Keep only the selected parts of a label plane (others -> 0).

    Label-domain analogue of ``mask_parts_from_image``
    (reference: utils/mask_utils.py:89-97).
    """
    ids = config.part_ids(part_names)
    keep = np.isin(labels, ids)
    return np.where(keep, labels, 0).astype(labels.dtype)
