"""``device_idle_share.stage12``: the card's idle share of the traced pass of
notebooks 1-2, from the profiler's CUDA records against the pass's own
wall."""

from portbench.harness.idle import idle_share_pct


def read(run):
    return idle_share_pct(run)
