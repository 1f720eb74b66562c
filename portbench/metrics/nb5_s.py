"""``nb5_s``: the window's wall, from the first notebook-5 pass's start to
the last pass's end after ``torch.cuda.synchronize()``, over the passes
completed."""


def read(run):
    return run.window_s / len(run.units) if run.units else None
