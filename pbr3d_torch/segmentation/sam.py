"""SAM prompt wrappers — gated on the external ``segment_anything`` package
(the reference's only deep-learning dependency; notebook 6 cell 3,
segmentation_utils/sam_ops.py:3-18), as in ``pbr3d.segmentation.sam``.

SAM is itself a PyTorch model, so the predictor is built on ``device``
(default ``"cuda"``).  Neither the package nor a checkpoint is part of this
repository: the loader raises an informative ``ImportError`` without the
package, and the prompt functions accept any object with the SamPredictor
interface (``set_image`` / ``predict``), which keeps them testable with a
stub predictor.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def load_sam_predictor(checkpoint: str, model_type: str = "vit_h", device: str = "cuda"):
    """Build a SamPredictor from a local checkpoint, on ``device``."""
    try:
        from segment_anything import SamPredictor, sam_model_registry
    except ImportError as e:
        raise ImportError(
            "segment_anything is not installed. Interactive SAM mask "
            "authoring needs the `segment-anything` package and a local "
            "checkpoint; every other part of pbr3d_torch works without it."
        ) from e
    sam = sam_model_registry[model_type](checkpoint=checkpoint)
    sam.to(device)
    return SamPredictor(sam)


def sam_point(predictor, image: np.ndarray, x: float, y: float, label: int = 1) -> np.ndarray:
    """Best-of-multimask point prompt (reference sam_ops.py:3-10)."""
    predictor.set_image(image)
    masks, scores, _ = predictor.predict(
        point_coords=np.array([[x, y]]),
        point_labels=np.array([label]),
        multimask_output=True,
    )
    return masks[int(np.argmax(scores))]


def sam_box(predictor, image: np.ndarray, box: Sequence[float]) -> np.ndarray:
    """Best-of-multimask box prompt (reference sam_ops.py:12-18)."""
    predictor.set_image(image)
    masks, scores, _ = predictor.predict(
        box=np.array(box)[None, :],
        multimask_output=True,
    )
    return masks[int(np.argmax(scores))]
