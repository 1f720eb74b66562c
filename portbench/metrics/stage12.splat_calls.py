"""``stage12.splat_calls``: the splat-IoU calls of a pass of notebooks 1-2
(the program's ``stage2.splat_calls`` counter, one a ``camera.align._batch_iou``
call, each a launch of the splat-IoU kernel) in the ``stage2`` traces, summed
over the traced window and divided by its passes."""

from portbench.harness import program_trace as pt


def probe(run):
    return pt.probe(run)


def read(run):
    traces = pt.traces(run, "stage2")
    if not traces or not run.units:
        return None
    return sum(s.counts.get("stage2.splat_calls", 0) for spans in traces for s in spans) / len(run.units)
