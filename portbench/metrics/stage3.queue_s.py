"""``stage3.queue_s``: the seconds the study's monuments wait for a worker of
the stage-3 pool, the ``stage3.queued`` spans (from the submit to the task's
start) summed per study, averaged over the traced window's studies.
Program spans (``pbr3d_torch.utils.profiling``)."""

from portbench.harness import program_trace as pt


def probe(run):
    return pt.probe(run)


def read(run):
    return pt.mean(pt.seconds(spans, "stage3.queued") for spans in pt.traces(run, "study")
                   if any(s.name == "stage3.queued" for s in spans))
