"""The min-dist kernel's launch plan and its merge of chunk minima, on the
CPU: the plan covers every (query, B point) pair exactly once, the plain
version run chunk by chunk over the plan's chunks and merged by min (as
float32 and as the kernel's ``atomicMin`` on int bits) equals the unsplit
plain version bit for bit, and the int view of non-negative float32 sorts
as the floats do.  The kernel itself runs only on the card
(``chip_smoke.py`` holds it to these same outputs)."""

import numpy as np
import pytest
import torch

from pbr3d_torch.ops import cuda_kernels as ck
from pbr3d_torch.ops.cuda_kernels import _launch_plan, min_dist2_plain

#: (n, m, SMs, resident blocks per SM): N below one block, M = 1, M below a
#: chunk, ragged N and M, one query against many points, the main path's
#: 20k and 50k on an H100's 132 SMs, and cards of other sizes.
CASES = [
    (1, 1, 132, 6), (7, 1, 132, 6), (1023, 5, 132, 6), (1024, 64, 132, 6), (1025, 65, 132, 6),
    (777, 1311, 132, 6), (19, 1000, 132, 4), (1, 100003, 132, 6), (5000, 333, 16, 2),
    (20000, 20000, 132, 4), (20000, 20000, 132, 6), (20000, 20000, 132, 8),
    (50000, 50000, 132, 4), (50000, 50000, 132, 6), (50000, 50000, 132, 8),
    (3, 70001, 1, 1), (2048, 8, 132, 6),
]


def _blocks(plan):
    """(query range, B range) of every block of the grid, as the kernel
    reads them: block (x, y) takes queries [x Q, (x + 1) Q) and B points
    [y L, min((y + 1) L, m_pad))."""
    Q, L = ck.QUERIES_PER_BLOCK, plan.chunk_len
    for y in range(plan.chunks):
        for x in range(plan.query_tiles):
            yield (x * Q, (x + 1) * Q), (y * L, min((y + 1) * L, plan.m_pad))


@pytest.mark.parametrize("n,m,sms,per_sm", CASES)
def test_plan_covers_every_pair_once(n, m, sms, per_sm):
    plan = _launch_plan(n, m, sms, per_sm)
    assert plan.m_pad % ck.B_STEP == 0 and m <= plan.m_pad < m + ck.B_STEP
    assert plan.chunk_len % ck.B_STEP == 0 and plan.chunk_len > 0
    assert 1 <= plan.chunks <= ck.MAX_CHUNKS
    # the kernel derives the chunk count from m_pad and chunk_len
    assert plan.chunks == -(-plan.m_pad // plan.chunk_len)
    queries, points = np.zeros(n + ck.QUERIES_PER_BLOCK, np.int64), np.zeros(plan.m_pad, np.int64)
    pairs = 0
    for (q0, q1), (j0, j1) in _blocks(plan):
        assert j1 > j0, "an empty chunk"
        queries[q0:q1] += j1 - j0
        pairs += (min(q1, n) - min(q0, n)) * (j1 - j0)
        if q0 == 0:
            points[j0:j1] += 1
    assert np.all(points == 1)  # every B point in exactly one chunk
    assert np.all(queries[:n] == plan.m_pad)  # every query against all of them, once
    assert pairs == n * plan.m_pad


@pytest.mark.parametrize("per_sm", [4, 6, 8])
@pytest.mark.parametrize("n", [20000, 50000])
def test_plan_fills_the_card_at_the_main_path_shapes(n, per_sm):
    """Several blocks per SM and a nearly full last wave on 132 SMs."""
    plan = _launch_plan(n, n, 132, per_sm)
    slots = 132 * per_sm
    blocks = plan.query_tiles * plan.chunks
    waves = -(-blocks // slots)
    assert blocks >= 0.9 * slots
    assert plan.query_tiles * plan.m_pad / (waves * slots * plan.chunk_len) >= ck.WAVE_FILL
    assert plan.chunk_len >= ck.MIN_CHUNK


def _chunked_plain(A, B, plan):
    """The plain version over the plan's chunks of B (B padded with +inf
    points, as the wrapper packs it), merged by float32 min and by int min
    of the bits into +inf, as the kernel merges them."""
    B_pad = torch.cat([B, torch.full((plan.m_pad - len(B), 3), float("inf"))])
    by_float = torch.full((len(A),), float("inf"))
    by_bits = by_float.clone().view(torch.int32)
    for y in range(plan.chunks):
        part = min_dist2_plain(A, B_pad[y * plan.chunk_len : (y + 1) * plan.chunk_len])
        by_float = torch.minimum(by_float, part)
        by_bits = torch.minimum(by_bits, part.view(torch.int32))
    return by_float, by_bits.view(torch.float32)


@pytest.mark.parametrize("n,m,sms,per_sm", [c for c in CASES if c[0] * c[1] <= 5e7])
def test_chunked_plain_merges_to_the_unsplit_plain(n, m, sms, per_sm):
    rng = np.random.default_rng([n, m])
    A = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    B = torch.from_numpy(rng.normal(size=(m, 3)).astype(np.float32))
    plan = _launch_plan(n, m, sms, per_sm)
    whole = min_dist2_plain(A, B)
    by_float, by_bits = _chunked_plain(A, B, plan)
    assert torch.equal(by_float.view(torch.int32), whole.view(torch.int32))
    assert torch.equal(by_bits.view(torch.int32), whole.view(torch.int32))


def test_padding_points_never_win():
    """+inf points, as the wrapper pads B, leave every minimum as it was,
    also for queries far out and at the origin."""
    A = torch.tensor([[0.0, 0.0, 0.0], [1e18, -1e18, 3.0], [1.0, 2.0, 3.0]])
    B = torch.tensor([[0.5, 0.5, 0.5]])
    pad = torch.full((7, 3), float("inf"))
    assert torch.equal(min_dist2_plain(A, torch.cat([B, pad])), min_dist2_plain(A, B))
    assert torch.isinf(min_dist2_plain(A, pad)).all()


def test_int_bits_of_nonnegative_floats_sort_as_the_floats():
    rng = np.random.default_rng(3)
    special = np.array([0.0, np.inf, np.finfo(np.float32).tiny, np.finfo(np.float32).max,
                        np.finfo(np.float32).smallest_subnormal, 1.0, 2.0], np.float32)
    denormal = (rng.integers(1, 1 << 23, 500).astype(np.int32)).view(np.float32)
    normal = np.abs(rng.normal(size=2000) * 10.0 ** rng.integers(-30, 30, 2000)).astype(np.float32)
    x = np.concatenate([special, denormal, normal, normal[:50]])
    rng.shuffle(x)
    assert np.all(x >= 0) and np.all(np.signbit(x) == 0)
    bits = x.view(np.int32)
    assert np.array_equal(np.sort(bits).view(np.float32), np.sort(x))
    i, j = rng.integers(0, len(x), (2, 5000))
    assert np.array_equal(bits[i] < bits[j], x[i] < x[j])
    assert np.array_equal(bits[i] == bits[j], x[i] == x[j])
    # the sum of squares the kernel forms is never -0
    assert not np.signbit(np.float32(-0.0) * np.float32(-0.0) + np.float32(0.0))


def test_plan_for_one_chunk_problems():
    """A problem that fills the card with one chunk keeps B whole."""
    plan = _launch_plan(1024 * 132 * 8, 1000, 132, 8)
    assert plan.chunks == 1 and plan.chunk_len == 1000 and plan.m_pad == 1000
