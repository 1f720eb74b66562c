"""The knn kernel's launch plan, merge keys and list upkeep, on the CPU.

The kernel runs only on the card (``chip_smoke.py`` holds it to
``knn_plain``); here its plan is checked to cover every (query, B point) pair
exactly once and to fill the card where the min-dist kernel's plan does, and
torch models of its two protocols are held to ``knn_plain``: at k = 1 the
per-chunk nearest point (running minimum, the group of its last strict fall,
the first point of that group at the minimum) merged by the minimum of the
64-bit keys ``distance bits << 32 | index`` in any chunk order; at larger k
the per-query queue of groups with candidates below a stale threshold,
drained into the list when a queue is full and at the end of every tile,
then the chunk lists merged on the full (distance, index) order.  The clouds
are tie-heavy (an integer lattice, duplicated points), where only the exact
order gives the plain version's indices."""

import numpy as np
import pytest
import torch

from pbr3d_torch.ops import cuda_kernels as ck
from pbr3d_torch.ops.cuda_kernels import _launch_plan, knn_kernel, knn_launch_plan, knn_plain

pytest_plugins = ["torch_threads"]

#: (n, m, k) of the four timed shapes, one query, and fewer points than k.
SHAPES = [(50000, 50000, 2), (120000, 120000, 20), (100000, 100000, 1), (185750, 1450802, 1),
          (1, 5000, 20), (300, 3, 5), (7, 1, 1)]
#: (SMs, resident blocks per SM): an H100 at several occupancies, a small card.
CARDS = [(132, 3), (132, 4), (132, 5), (16, 2)]


@pytest.mark.parametrize("sms,per_sm", CARDS)
@pytest.mark.parametrize("n,m,k", SHAPES)
def test_plan_covers_every_pair_once(n, m, k, sms, per_sm):
    cap = ck.knn_capacity(k)
    plan = knn_launch_plan(n, m, cap, sms, per_sm)
    Q, L = ck.knn_queries_per_block(cap), plan.chunk_len
    assert plan.m_pad % ck.KNN_B_STEP == 0 and m <= plan.m_pad < m + ck.KNN_B_STEP
    assert L % ck.KNN_B_STEP == 0 and 1 <= plan.chunks <= ck.MAX_CHUNKS
    assert plan.chunks == -(-plan.m_pad // L) and plan.query_tiles == -(-n // Q)
    # block (x, y) takes queries [x Q, (x + 1) Q) and points [y L, min((y + 1) L, m_pad))
    starts = np.arange(plan.chunks, dtype=np.int64) * L
    ends = np.minimum(starts + L, plan.m_pad)
    assert np.all(ends > starts), "an empty chunk"
    points = np.zeros(plan.m_pad + 1, np.int64)
    np.add.at(points, starts, 1)
    np.add.at(points, ends, -1)
    assert np.all(np.cumsum(points)[:-1] == 1)  # every B point in exactly one chunk
    lo = np.arange(plan.query_tiles, dtype=np.int64) * Q
    per_query = np.zeros(n + 1, np.int64)
    np.add.at(per_query, np.minimum(lo, n), 1)
    np.add.at(per_query, np.minimum(lo + Q, n), -1)
    assert np.all(np.cumsum(per_query)[:-1] == 1)  # every query in exactly one tile
    assert plan.query_tiles * Q >= n > (plan.query_tiles - 1) * Q


def _fill(plan, sms, per_sm):
    slots = sms * per_sm
    waves = -(-plan.query_tiles * plan.chunks // slots)
    return plan.query_tiles * plan.m_pad / (waves * slots * plan.chunk_len)


@pytest.mark.parametrize("sms,per_sm", CARDS + [(132, 2), (132, 6), (132, 8)])
def test_plan_fills_the_card_where_min_dist_does(sms, per_sm):
    for n, m, k in SHAPES[:4]:
        knn = knn_launch_plan(n, m, ck.knn_capacity(k), sms, per_sm)
        if _fill(_launch_plan(n, m, sms, per_sm), sms, per_sm) >= ck.WAVE_FILL:
            assert _fill(knn, sms, per_sm) >= ck.WAVE_FILL, (n, m, k)


def test_keys_sort_as_distance_then_index():
    rng = np.random.default_rng(7)
    special = np.array([0.0, np.inf, np.finfo(np.float32).smallest_subnormal, np.finfo(np.float32).tiny,
                        np.finfo(np.float32).max, 1.0], np.float32)
    d = np.concatenate([special, (rng.integers(1, 1 << 23, 200).astype(np.int32)).view(np.float32),
                        np.abs(rng.normal(size=300)).astype(np.float32)])
    d = d[rng.integers(0, len(d), 3000)]  # many exact ties
    j = rng.integers(0, 1 << 31, len(d)).astype(np.uint64)
    key = (d.view(np.uint32).astype(np.uint64) << np.uint64(32)) | j
    assert np.array_equal(np.argsort(key, kind="stable"), np.lexsort((j, d)))
    assert key.max() < np.uint64(~np.uint64(0))  # the all-ones fill is no key of a point


def _dist(A, B):
    """The plain version's arithmetic, (n, m) float32."""
    d = (A[:, None, 0] - B[None, :, 0]).square()
    d += (A[:, None, 1] - B[None, :, 1]).square()
    d += (A[:, None, 2] - B[None, :, 2]).square()
    return d


def _tie_clouds():
    G = np.stack(np.meshgrid(*[np.arange(6)] * 3, indexing="ij"), -1).reshape(-1, 3).astype(np.float32)
    rng = np.random.default_rng(3)
    pool = rng.integers(-3, 4, size=(30, 3)).astype(np.float32)
    return {"lattice": (G, G), "duplicates": (pool[rng.integers(0, 30, 150)], pool[rng.integers(0, 30, 400)])}


def _chunks(m, cap):
    """The plan's chunks of B on a small card, so that B splits."""
    plan = knn_launch_plan(1, m, cap, 4, 2)
    assert plan.chunks > 1
    return [(y * plan.chunk_len, min((y + 1) * plan.chunk_len, plan.m_pad)) for y in range(plan.chunks)], plan.m_pad


def _padded(B, m_pad):
    return torch.cat([B, torch.full((m_pad - len(B), 3), float("inf"))])


@pytest.mark.parametrize("cloud", ["lattice", "duplicates"])
def test_k1_chunk_merge_model_equals_plain(cloud):
    A, B = (torch.from_numpy(x) for x in _tie_clouds()[cloud])
    chunks, m_pad = _chunks(len(B), 1)
    Bp, G = _padded(B, m_pad), ck.KNN_B_STEP
    keys = torch.full((len(A),), -1, dtype=torch.int64)  # all ones; compared as unsigned below
    order = np.random.default_rng(0).permutation(len(chunks))  # chunks land in any order
    for y in order:
        j0, j1 = chunks[y]
        d = _dist(A, Bp[j0:j1])
        best = torch.full((len(A),), float("inf"))
        group = torch.zeros(len(A), dtype=torch.int64)
        for g in range(0, j1 - j0, G):
            was = best
            best = torch.minimum(best, d[:, g : g + G].amin(1))
            group = torch.where(best < was, j0 + g, group)
        found = torch.isfinite(best)
        at = group[:, None] + torch.arange(G)
        first = (_dist(A, Bp)[torch.arange(len(A))[:, None], at] == best[:, None]).int().argmax(1)
        key = (best.view(torch.int32).to(torch.int64) << 32) | (group + first)
        take = found & ((keys == -1) | (key < keys))  # both non-negative as int64 when found
        keys = torch.where(take, key, keys)
    d2, idx = knn_plain(A, B, 1)
    assert torch.equal((keys >> 32).to(torch.int32).view(torch.float32), d2[:, 0])
    assert torch.equal(keys & 0xFFFFFFFF, idx[:, 0])


def _push(ld, li, d, j, mask):
    """The kernel's select chain: (d, j), whose index is above every listed
    one, after the entries at its distance; rows where ``mask``."""
    d = torch.where(mask, d, torch.full_like(d, float("inf")))
    for s in range(ld.shape[1] - 1, 0, -1):
        shift, here = d < ld[:, s - 1], d < ld[:, s]
        ld[:, s] = torch.where(shift, ld[:, s - 1], torch.where(here, d, ld[:, s]))
        li[:, s] = torch.where(shift, li[:, s - 1], torch.where(here, j, li[:, s]))
    first = d < ld[:, 0]
    ld[:, 0] = torch.where(first, d, ld[:, 0])
    li[:, 0] = torch.where(first, j, li[:, 0])


def _insert(ld, li, d, j):
    """The merge kernel's compare-and-swap on the full (distance, index) order."""
    d, j = d.clone(), j.clone()
    for s in range(ld.shape[1]):
        swap = (d < ld[:, s]) | ((d == ld[:, s]) & (j < li[:, s]))
        td, tj = ld[:, s].clone(), li[:, s].clone()
        ld[:, s] = torch.where(swap, d, ld[:, s])
        li[:, s] = torch.where(swap, j, li[:, s])
        d, j = torch.where(swap, td, d), torch.where(swap, tj, j)


@pytest.mark.parametrize("k", [2, 7, 20])
@pytest.mark.parametrize("cloud", ["lattice", "duplicates"])
def test_queue_and_drain_model_equals_plain(cloud, k):
    """Per group of ``KNN_B_STEP`` points a query queues the mask of its
    candidates below its threshold; the queues (2 entries here) are drained
    when one is full before a group and at the end of every tile of 64
    points here; the threshold is the list's tail at the last drain."""
    A, B = (torch.from_numpy(x) for x in _tie_clouds()[cloud])
    cap, size, tile, none, G = ck.knn_capacity(k), 2, 64, 0x7FFFFFFF, ck.KNN_B_STEP
    chunks, m_pad = _chunks(len(B), cap)
    Bp, n = _padded(B, m_pad), len(A)
    lists = []
    for j0, j1 in chunks:
        d = _dist(A, Bp[j0:j1])
        ld, li = torch.full((n, cap), float("inf")), torch.full((n, cap), none, dtype=torch.int64)
        thr, queue, count = torch.full((n,), float("inf")), [], torch.zeros(n, dtype=torch.int64)

        def drain():
            for g, mask in queue:  # entries in arrival order, bits ascending
                for u in range(G):
                    du = d[:, g + u]
                    _push(ld, li, du, torch.full((n,), j0 + g + u), mask[:, u] & (du < ld[:, -1]))
            queue.clear()
            count.zero_()
            thr.copy_(ld[:, -1])

        for g in range(0, j1 - j0, G):
            if bool((count >= size).any()):
                drain()
            mask = d[:, g : g + G] < thr[:, None]
            queue.append((g, mask))
            count.add_(mask.any(1).long())
            if (g + G) % tile == 0:
                drain()
        drain()
        lists.append((ld, li))
    ld, li = lists[0]
    for y in np.random.default_rng(1).permutation(len(lists) - 1) + 1:  # merge order is free
        for s in range(cap):
            _insert(ld, li, lists[y][0][:, s], lists[y][1][:, s])
    pd, pi = knn_plain(A, B, k)
    assert torch.equal(ld[:, :k], pd)
    assert torch.equal(torch.where(torch.isfinite(ld[:, :k]), li[:, :k], li[:, :1]), pi)


@pytest.mark.parametrize("k", [1, 2, 20])
def test_wrapper_refuses_cpu_tensors(k):
    before = knn_kernel.launches, dict(knn_kernel.pairs)
    A = torch.zeros((5, 3))
    with pytest.raises(ValueError, match="CUDA"):
        knn_kernel(A, A, k)
    assert (knn_kernel.launches, knn_kernel.pairs) == before
