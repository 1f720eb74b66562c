"""``pbr3d_torch.ops.morphology`` against ``pbr3d.ops.morphology`` and scipy
on the same seeded inputs.  The binary operators are bit-equal; the Gaussian
is float32 sums in another order than XLA's convolution and scipy's float64
correlation: within 2e-5 on volumes of O(1) values."""

import numpy as np
import pytest
import scipy.ndimage

from pbr3d.ops import morphology as jax_morph
from pbr3d_torch.ops import morphology as morph

pytest_plugins = ["torch_threads"]


@pytest.fixture
def rng():
    """Fresh for every test, so no test's data depends on which ran before."""
    return np.random.default_rng(0)


def _masks(rng):
    return [rng.random((23, 31)) > 0.6, rng.random((12, 9, 14)) > 0.7, rng.random((1, 17)) > 0.5,
            np.ones((5, 6), bool), np.zeros((4, 4, 4), bool)]


@pytest.mark.parametrize("name", ["binary_dilation", "binary_erosion", "binary_closing"])
@pytest.mark.parametrize("iterations", [1, 3])
def test_cross_operators_bit_equal(rng, name, iterations):
    for m in _masks(rng):
        ours = getattr(morph, name)(m, iterations, device="cpu").numpy()
        ref = np.asarray(getattr(jax_morph, name)(m, iterations))
        assert ours.dtype == bool
        np.testing.assert_array_equal(ours, ref)
    m = _masks(rng)[1]
    np.testing.assert_array_equal(morph.binary_dilation(m, 2, device="cpu").numpy(),
                                  scipy.ndimage.binary_dilation(m, iterations=2))
    np.testing.assert_array_equal(morph.binary_erosion(m, 2, device="cpu").numpy(),
                                  scipy.ndimage.binary_erosion(m, iterations=2))


@pytest.mark.parametrize("ksize", [1, 2, 3, 4, 5, 8])
def test_closing_square_bit_equal_odd_and_even(rng, ksize):
    for m in _masks(rng)[:4]:
        ours = morph.binary_closing_square(m, ksize, device="cpu").numpy()
        np.testing.assert_array_equal(ours, np.asarray(jax_morph.binary_closing_square(m, ksize)))


@pytest.mark.parametrize("connectivity", ["full", "face"])
def test_remove_small_regions_bit_equal(rng, connectivity):
    for m in _masks(rng)[:2] + [np.zeros((6, 6), bool)]:
        for min_area in (1, 3, 10):
            np.testing.assert_array_equal(morph.remove_small_regions(m, min_area, connectivity),
                                          jax_morph.remove_small_regions(m, min_area, connectivity))


@pytest.mark.parametrize("sigma", [0.5, 1.0, 2.5])
def test_gaussian_filter_matches_jax_and_scipy(rng, sigma):
    # the last volume is narrower than the 2.5-sigma kernel's radius
    for vol in (rng.random((20, 17, 9)), rng.random((33, 40)), rng.random((3, 25))):
        vol = vol.astype(np.float32)
        ours = morph.gaussian_filter(vol, sigma, device="cpu").numpy()
        assert ours.dtype == np.float32 and ours.shape == vol.shape
        np.testing.assert_allclose(ours, np.asarray(jax_morph.gaussian_filter(vol, sigma)), rtol=0, atol=2e-5)
        np.testing.assert_allclose(ours, scipy.ndimage.gaussian_filter(vol, sigma), rtol=0, atol=2e-5)
    np.testing.assert_array_equal(morph._gaussian_kernel1d(1.0), jax_morph._gaussian_kernel1d(1.0))
    assert len(morph._gaussian_kernel1d(1.0)) == 9
