"""The device's idle share of the traced window."""


def idle_share_pct(run):
    """100 (1 - busy / window) of the traced unit: busy is the union of the
    CUDA records' intervals, the window the unit's own wall."""
    ts = run.trace_summary
    if ts is None or ts.window_s <= 0:
        return None
    return 100.0 * (1.0 - ts.busy_s / ts.window_s)
