"""``nb5.clouds_s``: seconds of ``eval.preprocess.build_taj_clouds`` and the
clouds' normalisation in a notebook-5 pass, by the benchmark's host clock
fenced by ``torch.cuda.synchronize()``, averaged over the window's passes."""


def read(run):
    t = [u["clouds_s"] for u in run.units if "clouds_s" in u]
    return sum(t) / len(t) if t else None
