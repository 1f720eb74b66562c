"""``device_idle_share.study``: the card's idle share of the traced study unit,
from the profiler's CUDA records against the unit's own wall."""

from portbench.harness.idle import idle_share_pct


def read(run):
    return idle_share_pct(run)
