"""``stage3.tail_s``: the part of a study that stage 3 holds alone, its
critical path: the end of the last ``stage3.body`` span less the end of the
``stage2`` span (at least 0), per study, averaged over the traced window's
studies.  Program spans (``pbr3d_torch.utils.profiling``)."""

from portbench.harness import program_trace as pt


def probe(run):
    return pt.probe(run)


def read(run):
    tails = []
    for spans in pt.traces(run, "study"):
        s2 = [s.end_ns for s in spans if s.name == "stage2"]
        body = [s.end_ns for s in spans if s.name == "stage3.body"]
        if s2 and body:
            tails.append(max(0, max(body) - max(s2)) / 1e9)
    return pt.mean(tails)
