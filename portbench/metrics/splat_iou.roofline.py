"""``splat_iou.roofline``: the share of its least time that the mask-IoU
search's splat-IoU kernels take on the card, in the traced unit.

Each call of ``splat_iou_kernel`` where ``camera.align`` binds it, made in
the traced unit, adds ``roofline.splat_iou_least_s`` of its own inputs.  The
time is the device time of the kernels of ``csrc/splat_iou.cu`` in the
profiler's records of that unit, taken by name; the memset of the design's
own plane is no kernel of that file and is not counted."""

import torch

from portbench.harness import roofline
from portbench.harness.probes import CallLog, Probe

TARGETS = [("pbr3d_torch.camera.align", "splat_iou_kernel")]
KERNELS = ("(anonymous namespace)::splat_kernel", "(anonymous namespace)::count_kernel",
           "(anonymous namespace)::mean_kernel")


def probe(run):
    calls = run.metric_state.setdefault("splat_iou.roofline", CallLog())

    def record(args, kwargs, out):
        if run.units:  # only the traced unit, the window's first
            return
        cams, pts, labels, valid, gt, part_ids = args[:6]
        V, P = cams.shape[:2]
        N = pts.shape[1]
        H, W = gt.shape[1:]
        K = len(list(part_ids))
        # the valid points, counted on the card without a wait
        n_valid = valid.sum(dtype=torch.int64) if valid is not None else V * N
        calls.add(((V, P, N, H, W, K, valid is not None), n_valid))

    return Probe(TARGETS, record)


def read(run):
    calls = run.metric_state.get("splat_iou.roofline")
    if calls is None or not calls.items:
        return None
    least = sum(roofline.splat_iou_least_s(V, P, int(n_valid), N, H, W, K, has_valid)
                for (V, P, N, H, W, K, has_valid), n_valid in calls.items)
    return roofline.share_pct(least, run.trace_summary, KERNELS)
