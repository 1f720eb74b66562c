"""``single.candidates``: the deform candidates stage 3 scores in a unit of
the per-monument route (the program's ``stage3.candidates`` counter, P of
each ``deform.search._eval_chunked`` call) in the ``study`` traces, summed
over the traced window and divided by its units; left out where the program
counts none."""

from portbench.harness import program_trace as pt


def probe(run):
    return pt.probe(run)


def read(run):
    traces = pt.traces(run, "study")
    n = sum(s.counts.get("stage3.candidates", 0) for spans in traces for s in spans)
    return n / len(run.units) if n and run.units else None
