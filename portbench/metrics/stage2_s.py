"""``stage2_s``: ``PipelineResult.timings["stage2"]`` summed over a study's
monuments and averaged over the window's studies.  The batched stage's wall
is shared out evenly between the monuments, so the sum is the stage's
wall."""

from portbench.harness.program_spans import stage_seconds


def read(run):
    return stage_seconds(run, "stage2")
