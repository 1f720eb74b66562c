"""``stage12.searches``: the mask-IoU searches of a pass of notebooks 1-2
(the program's ``stage2.searches`` counter, one a ``refine_camera_mask_iou``
call: the keypoint start, the retry starts, the polish of each view) in the
``stage2`` traces, summed over the traced window and divided by its passes."""

from portbench.harness import program_trace as pt


def probe(run):
    return pt.probe(run)


def read(run):
    traces = pt.traces(run, "stage2")
    if not traces or not run.units:
        return None
    return sum(s.counts.get("stage2.searches", 0) for spans in traces for s in spans) / len(run.units)
