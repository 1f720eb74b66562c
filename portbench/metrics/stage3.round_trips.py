"""``stage3.round_trips``: the device-to-host downloads that the stage-3
search and check wait on (the program's ``stage3.round_trips`` counter, kept
on the span open where each happens), summed per study and averaged over the
traced window's studies."""

from portbench.harness import program_trace as pt


def probe(run):
    return pt.probe(run)


def read(run):
    return pt.mean(sum(s.counts.get("stage3.round_trips", 0) for s in spans)
                   for spans in pt.traces(run, "study") if any(s.name == "stage3.body" for s in spans))
