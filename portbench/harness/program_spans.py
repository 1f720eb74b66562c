"""Readers of the program's own timings of a study (``PipelineResult.timings``,
one dict a monument, kept by the study driver in each unit)."""


def stage_seconds(run, key: str):
    """The stage's seconds summed over a study's monuments, averaged over
    the window's studies; None when no study carries them."""
    sums = [sum(t[key] for t in (r["timings"] for r in u["results"].values()) if key in t)
            for u in run.units if u.get("results")]
    return sum(sums) / len(sums) if sums else None
