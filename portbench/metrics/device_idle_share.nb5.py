"""``device_idle_share.nb5``: the card's idle share of the traced nb5 unit,
from the profiler's CUDA records against the unit's own wall."""

from portbench.harness.idle import idle_share_pct


def read(run):
    return idle_share_pct(run)
