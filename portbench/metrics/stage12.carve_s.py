"""``stage12.carve_s``: the seconds of notebook 1's carve in a pass of
notebooks 1-2: the ``stage1`` traces (``pipeline.run_stage1_body`` called on
its own, one a monument) summed over the traced window and divided by its
passes.  Program spans (``pbr3d_torch.utils.profiling``)."""

from portbench.harness import program_trace as pt


def probe(run):
    return pt.probe(run)


def read(run):
    traces = pt.traces(run, "stage1")
    if not traces or not run.units:
        return None
    return sum(pt.seconds(spans, "stage1") for spans in traces) / len(run.units)
