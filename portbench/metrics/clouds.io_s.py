"""``clouds.io_s``: the seconds a notebook-5 pass spends reading its files,
the ``io.*`` spans (PLY, OBJ, voxel grid) under the pass's ``clouds`` span
summed per pass, averaged over the traced window's passes.  Program spans
(``pbr3d_torch.utils.profiling``)."""

from portbench.harness import program_trace as pt


def probe(run):
    return pt.probe(run)


def read(run):
    return pt.mean(sum(s.end_ns - s.start_ns for s in spans if s.name.startswith("io.")) / 1e9
                   for spans in pt.traces(run, "clouds"))
