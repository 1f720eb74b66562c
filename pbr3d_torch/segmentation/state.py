"""Mutable editing-session state (reference: segmentation_utils/state.py),
as in ``pbr3d.segmentation.state``."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class ImageState:
    """Holds the image being edited, its symmetry axis, and the undo stack."""

    path: Optional[Path] = None
    base_np: Optional[np.ndarray] = None
    curr_np: Optional[np.ndarray] = None
    sym_on: bool = False
    sym_x: Optional[int] = None
    undo: List[np.ndarray] = dataclasses.field(default_factory=list)

    def load(self, path: str | Path) -> "ImageState":
        import cv2

        self.path = Path(path)
        img = cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)
        self.base_np = img
        self.curr_np = img.copy()
        self.undo.clear()
        return self

    def push_undo(self) -> None:
        if self.curr_np is not None:
            self.undo.append(self.curr_np.copy())

    def pop_undo(self) -> bool:
        if not self.undo:
            return False
        self.curr_np = self.undo.pop()
        return True
