"""``stage3_body_s``: ``PipelineResult.timings["stage3"]`` summed over a
study's monuments and averaged over the window's studies.  Each is a
monument's stage-3 body wall inside the pool of three threads, so the sum is
body time, not the study's critical path."""

from portbench.harness.program_spans import stage_seconds


def read(run):
    return stage_seconds(run, "stage3")
