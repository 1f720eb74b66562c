"""``single.verify_s``: the seconds of stage 3's exact notebook-4 scoring in a
unit of the per-monument route: the ``stage3.portfolio_pick`` (every chain's
rebuild scored) and ``stage3.exact_verify`` (``enforce_no_regression`` and
the post-verify arbitration) spans of the ``study`` traces summed over the
traced window and divided by its units.  Program spans
(``pbr3d_torch.utils.profiling``)."""

from portbench.harness import program_trace as pt


def probe(run):
    return pt.probe(run)


def read(run):
    traces = pt.traces(run, "study")
    if not traces or not run.units:
        return None
    return sum(pt.seconds(spans, "stage3.portfolio_pick") + pt.seconds(spans, "stage3.exact_verify")
               for spans in traces) / len(run.units)
