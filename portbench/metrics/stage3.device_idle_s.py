"""``stage3.device_idle_s``: the traced study's device-idle seconds that are
put down to a program span at or under a ``stage3.body`` span, by the rule
of ``harness/program_trace.py`` (the innermost span open at the gap's
midpoint on the thread that launched the record ending it)."""

from portbench.harness import program_trace as pt


def probe(run):
    return pt.probe(run)


def read(run):
    b = pt.bridge(run)
    if b is None or b.gaps is None:
        return None
    return sum(e - a for a, e, s in b.gaps if s is not None and b.index.under(s, "stage3.body")) / 1e9
