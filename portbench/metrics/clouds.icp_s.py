"""``clouds.icp_s``: the seconds of a notebook-5 pass's three ICPs (left,
right and back onto the front), the ``clouds.icp`` spans summed per pass,
averaged over the traced window's passes.  Program spans
(``pbr3d_torch.utils.profiling``)."""

from portbench.harness import program_trace as pt


def probe(run):
    return pt.probe(run)


def read(run):
    return pt.mean(pt.seconds(spans, "clouds.icp") for spans in pt.traces(run, "clouds")
                   if any(s.name == "clouds.icp" for s in spans))
