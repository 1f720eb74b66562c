"""``single.chains``: the ``refine_parts`` chains stage 3 runs in a unit of
the per-monument route (the program's ``stage3.chains`` counter, one a
chain of a profile's schedule: at least one for the production profile and
one for the heavy profile ``w``) in the ``study`` traces, summed over the
traced window and divided by its units; left out where the program counts
none."""

from portbench.harness import program_trace as pt


def probe(run):
    return pt.probe(run)


def read(run):
    traces = pt.traces(run, "study")
    n = sum(s.counts.get("stage3.chains", 0) for spans in traces for s in spans)
    return n / len(run.units) if n and run.units else None
