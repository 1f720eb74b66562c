"""The least time an H100 needs for a call, from the call's own inputs.

Peaks: NVIDIA's H100 SXM data sheet, float32 outside the tensor cores and
HBM3, at the full 700 W power limit.  A call's least time is the larger of
its float32 operations over the float32 peak and its bytes over the memory
peak, each input read once and each output written once, so the share reads
the same work whatever implements the call and cannot pass 100 %.

Work counts (copied from ``chip_smoke.py``, with one change of basis for the
neighbour searches):

* ``min_dist2`` and ``knn``: 8 float32 operations a pair (3 subtracts, 3
  multiplies, 2 adds), where ``chip_smoke.py`` counts 7 issue slots at
  33.5e12 a second;
* ``splat_iou``: ``chip_smoke.py::splat_iou_bound``'s operations and bytes,
  without the design's own plane.
"""

from __future__ import annotations

FP32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
PAIR_FLOPS = 8
SPLAT_OPS_PER_POINT = 30
COUNT_OPS_PER_PIXEL_PART = 4


def least_s(flops: float, nbytes: float) -> float:
    return max(flops / FP32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)


def min_dist2_least_s(n: int, m: int) -> float:
    """(n, 3) and (m, 3) float32 in, (n,) float32 out."""
    return least_s(PAIR_FLOPS * n * m, 12 * n + 12 * m + 4 * n)


def knn_least_s(n: int, m: int, k: int) -> float:
    """(n, 3) and (m, 3) float32 in; (n, k) float32 distances and (n, k)
    int64 indices out."""
    return least_s(PAIR_FLOPS * n * m, 12 * n + 12 * m + 12 * n * k)


def splat_iou_least_s(V: int, P: int, n_valid: int, N: int, H: int, W: int, K: int, has_valid: bool) -> float:
    """P cameras (9 float32) for each of V views of N points (12 B, a label
    byte and a valid byte), a (H, W) uint8 ground truth a view, (V, P)
    float32 IoUs out; ``n_valid`` valid points over all views, each projected
    by the view's P cameras, and 4K + 2 operations a pixel and camera to
    count the parts."""
    flops = P * (n_valid * SPLAT_OPS_PER_POINT + V * H * W * (COUNT_OPS_PER_PIXEL_PART * K + 2))
    nbytes = V * P * 36 + V * N * (12 + 1 + int(has_valid)) + V * H * W + 4 * V * P
    return least_s(flops, nbytes)


def share_pct(least: float, trace_summary, kernels) -> float | None:
    """100 ``least`` / the device seconds that the kernels named ``kernels``
    (``device.kernel_base`` names) took in the traced unit; None where the
    trace holds none of them, or no call was counted."""
    if trace_summary is None or least <= 0:
        return None
    took = sum(trace_summary.kernel_s.get(k, 0.0) for k in kernels)
    return 100.0 * least / took if took > 0 else None
