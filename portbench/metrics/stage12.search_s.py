"""``stage12.search_s``: the seconds of notebook 2's mask-IoU searches in a
pass of notebooks 1-2: the ``stage2.search`` and ``stage2.polish`` spans of
the ``stage2`` traces (``pipeline.run_stage2_views`` called on its own, one a
monument) summed over the traced window and divided by its passes.  Program
spans (``pbr3d_torch.utils.profiling``)."""

from portbench.harness import program_trace as pt


def probe(run):
    return pt.probe(run)


def read(run):
    traces = pt.traces(run, "stage2")
    if not traces or not run.units:
        return None
    return sum(pt.seconds(spans, "stage2.search") + pt.seconds(spans, "stage2.polish")
               for spans in traces) / len(run.units)
