"""Interactive mask authoring — headless core, as in ``pbr3d.segmentation``.

The reference wraps these operations in ipywidgets/matplotlib UIs
(segmentation_utils/crop_ui.py, sam_ui.py, interactive_part_segmentation.py);
here every operation is a pure function so it works headlessly, in scripts,
and under tests.  SAM prompting is gated on the external ``segment_anything``
package exactly like the reference's notebook 6.  OpenCV is imported only
inside the two functions that read or write a PNG.
"""

from pbr3d_torch.segmentation.state import ImageState
from pbr3d_torch.segmentation.crop import apply_crop, find_symmetry_axis, expand_box_symmetric
from pbr3d_torch.segmentation.cleanup import (
    MaskEditor,
    close_holes,
    remove_small_regions_2d,
    rasterize_polygon,
)
from pbr3d_torch.segmentation.sam import sam_point, sam_box, load_sam_predictor

__all__ = [
    "ImageState",
    "apply_crop",
    "find_symmetry_axis",
    "expand_box_symmetric",
    "MaskEditor",
    "close_holes",
    "remove_small_regions_2d",
    "rasterize_polygon",
    "sam_point",
    "sam_box",
    "load_sam_predictor",
]
