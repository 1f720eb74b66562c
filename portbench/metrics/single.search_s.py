"""``single.search_s``: the seconds of stage 3's part search in a unit of the
per-monument route: the ``stage3.refine_parts`` spans (one a chain, every
profile and schedule of the portfolio) of the ``study`` traces summed over
the traced window and divided by its units.  Program spans
(``pbr3d_torch.utils.profiling``)."""

from portbench.harness import program_trace as pt


def probe(run):
    return pt.probe(run)


def read(run):
    traces = pt.traces(run, "study")
    if not traces or not run.units:
        return None
    return sum(pt.seconds(spans, "stage3.refine_parts") for spans in traces) / len(run.units)
