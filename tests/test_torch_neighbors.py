"""The port's nearest-neighbour engine on the CPU (its plain version) against
the JAX package's Pallas kernel (interpret mode), its XLA path and scipy.

Tolerance against the JAX package: it forms |a|² + |b|² − 2a·b, which errs
by about 8·ε·(|a|² + |b|²) per point (ε = float32 machine epsilon); the
port's direct difference errs by a few ulp of the distance itself."""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from pbr3d.ops.neighbors import _xla_min_dist2
from pbr3d.ops.pallas_kernels import min_dist2_pallas
from pbr3d_torch.ops import neighbors
from pbr3d_torch.ops.cuda_kernels import min_dist2_kernel, min_dist2_plain

pytest_plugins = ["torch_threads"]

EPS = float(np.finfo(np.float32).eps)


def _cloud(rng, n):
    return rng.normal(size=(n, 3)).astype(np.float32)


def _expansion_tol(A, B, d2):
    return 8 * EPS * ((A.astype(np.float64) ** 2).sum(1) + (B.astype(np.float64) ** 2).sum(1).max()) \
        + 4 * EPS * d2


def _plain(A, B):
    return min_dist2_plain(torch.from_numpy(A), torch.from_numpy(B)).numpy()


def test_plain_vs_pallas_interpret(rng):
    A, B = _cloud(rng, 600), _cloud(rng, 900)
    ours = _plain(A, B)
    ref = min_dist2_pallas(A, B, interpret=True)
    assert np.all(np.abs(ours - ref) <= _expansion_tol(A, B, ours))


@pytest.mark.parametrize("n,m", [(1, 1), (5, 3000), (1025, 17), (777, 1311), (2049, 2)])
def test_plain_vs_xla_ragged(rng, n, m):
    A, B = _cloud(rng, n), _cloud(rng, m)
    ours = _plain(A, B)
    ref = _xla_min_dist2(A, B, tile=256)
    assert ours.shape == (n,) and ours.dtype == np.float32
    assert np.all(np.abs(ours - ref) <= _expansion_tol(A, B, ours))


def test_plain_vs_kdtree(rng):
    A, B = _cloud(rng, 777), _cloud(rng, 1311)
    d = neighbors.min_dist(A, B, device="cpu")
    ref, _ = cKDTree(B).query(A, k=1)
    np.testing.assert_allclose(d, ref, rtol=2e-3, atol=2e-4)  # tests/test_eval.py:16-21
    # the direct difference is accurate to a few ulp of d² itself
    ref64, _ = cKDTree(B.astype(np.float64)).query(A.astype(np.float64), k=1)
    np.testing.assert_allclose(_plain(A, B), ref64**2, rtol=4 * EPS, atol=0)


def test_empty_inputs(rng):
    A = _cloud(rng, 7)
    out = _plain(A, np.zeros((0, 3), np.float32))
    assert out.shape == (7,) and np.all(np.isposinf(out))
    assert _plain(np.zeros((0, 3), np.float32), A).shape == (0,)
    assert np.all(np.isposinf(neighbors.min_dist(A, np.zeros((0, 3)), device="cpu")))


def test_plain_tiles_rows(rng, monkeypatch):
    """Row tiling of the plain version changes nothing."""
    A, B = _cloud(rng, 301), _cloud(rng, 97)
    whole = _plain(A, B)
    import pbr3d_torch.ops.cuda_kernels as ck

    monkeypatch.setattr(ck, "_PLAIN_PAIRS", 97 * 16)
    np.testing.assert_array_equal(_plain(A, B), whole)


def test_kernel_wrapper_takes_cuda_tensors_only(rng):
    before = min_dist2_kernel.launches
    A = torch.from_numpy(_cloud(rng, 4))
    with pytest.raises(ValueError, match="CUDA"):
        min_dist2_kernel(A, A)
    with pytest.raises(ValueError, match="unsupported devices"):
        neighbors.min_dist2(A.to("meta"), A.to("meta"))
    assert min_dist2_kernel.launches == before
    np.testing.assert_array_equal(neighbors.min_dist2(A, A).numpy(), np.zeros(4, np.float32))
    assert min_dist2_kernel.launches == before
