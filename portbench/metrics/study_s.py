"""``study_s``: the window's wall, from the first study's start to the last
study's end after ``torch.cuda.synchronize()``, over the studies completed."""


def read(run):
    return run.window_s / len(run.units) if run.units else None
