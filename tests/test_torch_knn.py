"""The port's k-nearest-neighbour engine on the CPU (the kernel's plain
version) against ``pbr3d.ops.neighbors.knn`` and a float64 cKDTree.

Tolerances.  Distances against the JAX package and against scipy: rtol 2e-3,
atol 2e-4 (tests/test_eval.py:24-40; the JAX package forms
|a|² + |b|² − 2a·b).  Against the float64 tree on the float32 points the
direct difference is good to a few ulp of d².  Indices: on integer
coordinates and on duplicated points both forms are exact, so they must
equal the JAX package's; on float clouds two neighbours whose distances lie
within the expansion's error of each other may swap there, and the tests
count such entries instead of assuming none."""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from pbr3d.ops import neighbors as jax_neighbors
from pbr3d_torch.ops import cuda_kernels, neighbors
from pbr3d_torch.ops.cuda_kernels import knn_kernel, knn_launch_plan, knn_plain

pytest_plugins = ["torch_threads"]

EPS = float(np.finfo(np.float32).eps)


@pytest.fixture
def rng():
    """Fresh for every test, so no test's data depends on which ran before."""
    return np.random.default_rng(0)


def _cloud(rng, n):
    return rng.normal(size=(n, 3)).astype(np.float32)


def _lattice(side):
    return np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3).astype(np.float32)


def _knn(A, B, k):
    d, i = neighbors.knn(A, B, k, device="cpu")
    return d.numpy(), i.numpy()


@pytest.mark.parametrize("k", [1, 2, 20])
def test_float_clouds_match_jax_and_kdtree(rng, k):
    A, B = _cloud(rng, 700), _cloud(rng, 1100)
    d, idx = _knn(A, B, k)
    jd, jidx = jax_neighbors.knn(A, B, k)
    assert d.shape == (700, k) and d.dtype == np.float32 and idx.dtype == np.int64
    np.testing.assert_allclose(d, jd, rtol=2e-3, atol=2e-4)
    ref, ridx = cKDTree(B.astype(np.float64)).query(A.astype(np.float64), k=k)
    ref, ridx = ref.reshape(d.shape), ridx.reshape(d.shape)
    np.testing.assert_allclose(d, ref, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(d.astype(np.float64) ** 2, ref**2, rtol=16 * EPS, atol=0)
    assert np.all(np.diff(d, axis=1) >= 0)
    # the float64 tree orders distinct distances as the direct difference does
    assert np.array_equal(idx, ridx)
    # the JAX package may swap two neighbours within its expansion's error:
    # where its index differs, its neighbour is as near, to that error
    swapped = idx != jidx
    err = 8 * EPS * ((A.astype(np.float64) ** 2).sum(1) + (B.astype(np.float64) ** 2).sum(1).max())
    theirs = ((A[:, None, :].astype(np.float64) - B[jidx].astype(np.float64)) ** 2).sum(-1)
    assert np.all(np.abs(theirs - ref**2)[swapped] <= 2 * err[:, None].repeat(k, 1)[swapped])
    assert swapped.mean() < 0.01


@pytest.mark.parametrize("k", [1, 2, 7, 20])
def test_integer_lattice_indices_equal_jax(k):
    """Distances tie exactly and by the thousand: the lower index wins."""
    G = _lattice(9)
    d, idx = _knn(G[::3], G, k)
    jd, jidx = jax_neighbors.knn(G[::3], G, k)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(d, jd)
    s = neighbors.self_nn_dist(G, device="cpu").numpy()
    np.testing.assert_array_equal(s, jax_neighbors.self_nn_dist(G))
    assert np.all(s == 1.0)


def test_duplicated_points_indices_equal_jax(rng):
    pool = rng.integers(-4, 5, size=(40, 3)).astype(np.float32)
    A, B = pool[rng.integers(0, 40, 300)], pool[rng.integers(0, 40, 500)]
    d, idx = _knn(A, B, 20)
    jd, jidx = jax_neighbors.knn(A, B, 20)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(d, jd)
    assert (d[:, 0] == 0).all()  # every query has its duplicates in B


@pytest.mark.parametrize("n,m,k", [(5, 3, 5), (4, 1, 2), (7, 19, 20), (3, 20, 20)])
def test_k_above_the_point_count(rng, n, m, k):
    A, B = _cloud(rng, n), _cloud(rng, m)
    d, idx = _knn(A, B, k)
    jd, jidx = jax_neighbors.knn(A, B, k)
    np.testing.assert_array_equal(np.isinf(d), np.isinf(jd))
    np.testing.assert_array_equal(idx, jidx)  # trailing entries point at column 0
    np.testing.assert_allclose(d[np.isfinite(d)], jd[np.isfinite(jd)], rtol=2e-3, atol=2e-4)
    assert np.all(idx[:, min(k, m):] == idx[:, :1])


def test_empty_inputs(rng):
    A = _cloud(rng, 6)
    d, idx = _knn(A, np.zeros((0, 3), np.float32), 3)
    assert d.shape == (6, 3) and np.all(np.isposinf(d)) and np.all(idx == 0)
    d, idx = _knn(np.zeros((0, 3), np.float32), A, 3)
    assert d.shape == (0, 3) and idx.shape == (0, 3)


def test_knn_of_one_is_min_dist(rng):
    A, B = _cloud(rng, 400), _cloud(rng, 333)
    d2, _ = knn_plain(torch.from_numpy(A), torch.from_numpy(B), 1)
    np.testing.assert_array_equal(d2[:, 0].numpy(),
                                  cuda_kernels.min_dist2_plain(torch.from_numpy(A), torch.from_numpy(B)).numpy())


def test_plain_tiles_rows(rng, monkeypatch):
    A, B = _cloud(rng, 301), _cloud(rng, 97)
    whole = knn_plain(torch.from_numpy(A), torch.from_numpy(B), 5)
    monkeypatch.setattr(cuda_kernels, "_PLAIN_PAIRS", 97 * 16)
    tiled = knn_plain(torch.from_numpy(A), torch.from_numpy(B), 5)
    assert torch.equal(whole[0], tiled[0]) and torch.equal(whole[1], tiled[1])


@pytest.mark.parametrize("n,m", [(1, 1), (100, 3), (50000, 50000), (3000, 100003), (400000, 1400000), (5, 10**7)])
def test_launch_plan(n, m):
    for cap, (sms, per_sm) in zip(cuda_kernels.KNN_CAPACITIES, [(132, 4), (132, 5), (132, 3), (16, 2), (132, 3), (132, 2), (1, 1)]):
        plan = knn_launch_plan(n, m, cap, sms, per_sm)
        assert plan.m_pad % cuda_kernels.KNN_B_STEP == 0 and 0 <= plan.m_pad - m < cuda_kernels.KNN_B_STEP
        assert plan.chunk_len % cuda_kernels.KNN_B_STEP == 0 and plan.chunk_len > 0
        assert plan.chunks == -(-plan.m_pad // plan.chunk_len) and 1 <= plan.chunks <= cuda_kernels.MAX_CHUNKS
        assert plan.query_tiles == -(-n // cuda_kernels.knn_queries_per_block(cap))
        if plan.chunks > 1:  # split only to fill the card, and never into crumbs
            assert plan.chunk_len >= cuda_kernels.MIN_CHUNK


def test_capacity_and_k_range():
    assert [cuda_kernels.knn_capacity(k) for k in (1, 2, 3, 5, 16, 17, 20, 21, 32)] == [1, 2, 4, 8, 16, 20, 20, 32, 32]
    for k in (0, 33):
        with pytest.raises(ValueError, match="k must be"):
            cuda_kernels.knn_capacity(k)


def test_kernel_wrapper_takes_cuda_tensors_only(rng):
    before = knn_kernel.launches
    A = torch.from_numpy(_cloud(rng, 4))
    with pytest.raises(ValueError, match="CUDA"):
        knn_kernel(A, A, 2)
    with pytest.raises(ValueError, match="unsupported devices"):
        neighbors.knn2(A.to("meta"), A.to("meta"), 2)
    d2, idx = neighbors.knn2(A, A, 1)
    np.testing.assert_array_equal(idx[:, 0].numpy(), np.arange(4))
    assert knn_kernel.launches == before
