"""Every name of the JAX package's subpackage ``__all__`` lists imports from
the port's counterpart, and the port's ``__all__`` lists the same names.

Names on the port's do-not-port list would be left out here, with the
reason; none of those names is in these ``__all__`` lists (the multi-device
``pbr3d.parallel`` is not a counterpart at all)."""

import importlib

import pytest

pytest_plugins = ["torch_threads"]

SUBPACKAGES = ["carving", "camera", "io", "ops", "deform", "eval", "segmentation"]
#: name -> why the port leaves it out (empty: every name has a counterpart).
NOT_PORTED: dict = {}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_match_jax(sub):
    ref = importlib.import_module(f"pbr3d.{sub}")
    ours = importlib.import_module(f"pbr3d_torch.{sub}")
    expected = [n for n in ref.__all__ if n not in NOT_PORTED]
    assert list(ours.__all__) == expected
    for name in expected:
        obj = getattr(ours, name)
        assert getattr(obj, "__module__", obj.__name__).startswith("pbr3d_torch.")
        assert getattr(ref, name).__name__.split(".")[-1] == obj.__name__.split(".")[-1]


def test_stage1_module_has_the_jax_functions():
    from pbr3d.carving import stage1 as ref
    from pbr3d_torch.carving import stage1 as ours

    jax_names = {n for n, v in vars(ref).items() if callable(v) and getattr(v, "__module__", "") == ref.__name__}
    assert jax_names <= set(vars(ours))
