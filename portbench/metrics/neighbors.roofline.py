"""``neighbors.roofline``: the share of its least time that the
evaluation's nearest-neighbour kernels take on the card, in the traced unit.

Each call of ``min_dist2`` (where ``eval.inter`` and ``ops.neighbors`` bind
it) and of ``knn2`` (where ``ops.neighbors.knn`` looks it up), made in the
traced unit, adds ``roofline.min_dist2_least_s`` or ``roofline.knn_least_s``
of its own inputs.  The time is the device time of the kernels of
``csrc/min_dist2.cu`` and ``csrc/knn.cu`` in the profiler's records of that
unit, taken by name."""

from portbench.harness import roofline
from portbench.harness.probes import CallLog, Probe

TARGETS = [("pbr3d_torch.eval.inter", "min_dist2"), ("pbr3d_torch.ops.neighbors", "min_dist2"),
           ("pbr3d_torch.ops.neighbors", "knn2")]
KERNELS = tuple(f"(anonymous namespace)::{k}" for k in (
    "pack_kernel", "min_dist2_kernel",  # csrc/min_dist2.cu
    "knn_pack_kernel", "knn1_scan_kernel", "knn1_finish_kernel", "knn_scan_kernel", "knn_merge_kernel"))  # knn.cu


def probe(run):
    calls = run.metric_state.setdefault("neighbors.roofline", CallLog())

    def record(args, kwargs, out):
        if run.units:  # only the traced unit, the window's first
            return
        A, B = args[0], args[1]
        k = args[2] if len(args) > 2 else kwargs.get("k")
        n, m = A.shape[0], B.shape[0]
        calls.add(roofline.min_dist2_least_s(n, m) if k is None else roofline.knn_least_s(n, m, int(k)))

    return Probe(TARGETS, record)


def read(run):
    calls = run.metric_state.get("neighbors.roofline")
    if calls is None or not calls.items:
        return None
    return roofline.share_pct(sum(calls.items), run.trace_summary, KERNELS)
