"""``part_iou``: the mean over the window's studies and their monuments of
stage 3's mean part IoU, as the plain reference recomputes it from the
stage-3 grid, the final front camera and the front plane (the study
driver's check leaves it in ``run.values``)."""


def read(run):
    return run.values.get("part_iou")
