"""The serial route of the port's study entries on the monuments of
``torch_run_all_cases``: ``pipeline.run_pipeline`` and a one-monument
``run_all`` against Akbar's three stages chained by hand, and how
``run_all_body`` treats a monument that fails and a device fault."""

import numpy as np
import pytest
import torch

from pbr3d.camera.geometry import params_to_vector
from pbr3d_torch import pipeline as tpipe

from torch_run_all_cases import (  # noqa: F401  (fixtures: fx, draws, root, jax_keypoint_fit)
    KW2, KW3, _scenes, draws, fx, jax_keypoint_fit, root,
)

pytest_plugins = ["torch_threads"]


@pytest.fixture(scope="module")
def chained(root, draws, jax_keypoint_fit):
    """Akbar through the port's three stages, one call after the other."""
    grid = tpipe.run_stage1("Akbar", root, 128, device="cpu")
    cams = tpipe.run_stage2("Akbar", grid, root, draws=draws, device="cpu", **KW2)
    deforms, grid3 = tpipe.run_stage3("Akbar", grid, cams["final"]["front"], root, device="cpu", **KW3)
    return grid, cams, deforms, grid3


def _same_as_chained(res, chained):
    grid, cams, deforms, grid3 = chained
    np.testing.assert_array_equal(res.grid_stage1, grid)
    for tag in cams:
        for view in cams[tag]:
            np.testing.assert_array_equal(params_to_vector(res.cameras[tag][view]),
                                          params_to_vector(cams[tag][view]))
    assert res.deform_params == deforms
    np.testing.assert_array_equal(res.grid_stage3, grid3)


def test_run_pipeline_equals_chaining_the_stages(chained, root, draws, tmp_path, capsys):
    res = tpipe.run_pipeline("Akbar", root, 128, tmp_path, stage2_kw=dict(KW2, draws=draws),
                             stage3_kw=KW3, device="cpu")
    _same_as_chained(res, chained)
    assert all(res.timings[k] > 0 for k in ("stage1", "stage2", "stage3"))
    err = capsys.readouterr().err
    assert "[Akbar] stage1" in err and "grid=(128, 123, 128)" in err
    assert "[Akbar] stage2" in err and "views=['front', 'drone']" in err
    assert "[Akbar] stage3" in err and "parts=6" in err
    assert len([p for p in tmp_path.rglob("*") if p.is_file()]) == 1 + 3 + 2


def test_run_all_of_one_monument_takes_the_serial_route_with_an_injected_grid(
        chained, root, draws, monkeypatch):
    """One monument alone batches nothing; ``run_pipeline`` with a grid and
    its time injected skips stage 1 and reports the given time."""
    calls = []
    body = tpipe.run_pipeline_body
    monkeypatch.setattr(tpipe, "run_pipeline_body", lambda *a, **k: calls.append(k) or body(*a, **k))
    res = tpipe.run_all(["Akbar"], strict=True, data_root=root, max_dim=128,
                        stage2_kw=dict(KW2, draws=draws), stage3_kw=KW3, device="cpu")
    assert list(res) == ["Akbar"] and len(calls) == 1 and calls[0]["grid_stage1"] is None
    _same_as_chained(res["Akbar"], chained)
    monkeypatch.setattr(tpipe, "carve_monument_fused", None)  # stage 1 must not run
    inj = tpipe.run_pipeline("Akbar", root, 128, grid_stage1=chained[0], stage1_time=1.25,
                             stage2_kw=dict(KW2, draws=draws), stage3_kw=KW3, device="cpu")
    assert inj.timings["stage1"] == 1.25 and inj.grid_stage1 is chained[0]
    _same_as_chained(inj, chained)


TINY2 = dict(generations=1, population=8, seed=0)
TINY3 = dict(KW3, part_names=["chhatris"], exact_verify=False)


def _with_blank(root):
    scenes = _scenes(root)
    blank = {v: np.zeros_like(mask) for v, mask in scenes["Akbar"].views.items()}
    return {"Blank": tpipe.SceneMasks(scenes["Akbar"].front, blank, scenes["Akbar"].nb4),
            "Akbar": scenes["Akbar"]}


def test_a_monument_whose_views_all_fail_raises_under_strict(root):
    with pytest.raises(RuntimeError, match="Blank: no view passed camera estimation"):
        tpipe.run_all_body(_with_blank(root), strict=True, max_dim=128, stage2_kw=TINY2,
                           stage3_kw=TINY3, device="cpu")


@pytest.mark.parametrize("batch_stage2", [True, False])
def test_a_monument_whose_views_all_fail_is_skipped_without_strict(root, batch_stage2, capsys):
    res = tpipe.run_all_body(_with_blank(root), strict=False, batch_stage2=batch_stage2, max_dim=128,
                             stage2_kw=TINY2, stage3_kw=TINY3, device="cpu")
    assert list(res) == ["Akbar"] and list(res["Akbar"].deform_params) == ["chhatris"]
    err = capsys.readouterr().err
    assert "[stage2] Blank/front skipped" in err and "[stage2] Blank/drone skipped" in err
    assert "Blank: no view passed camera estimation" in err
    assert ("[run_all] Blank stage3 FAILED" if batch_stage2 else "[run_all] Blank FAILED") in err


@pytest.mark.parametrize("fault", [torch.OutOfMemoryError("CUDA out of memory"),
                                   RuntimeError("CUDA error: an illegal memory access"),
                                   ValueError("no such part")])
def test_a_device_fault_is_raised_whatever_strict_says(root, fault, monkeypatch, capsys):
    """``strict=False`` reports and skips a monument that fails, but never a
    device fault."""
    body = tpipe.run_stage3_body

    def stage3(m, *a, **k):
        if m == "Bibi":
            raise fault
        return body(m, *a, **k)

    monkeypatch.setattr(tpipe, "run_stage3_body", stage3)
    run = lambda: tpipe.run_all_body(_scenes(root), strict=False, max_dim=128, stage2_kw=TINY2,
                                     stage3_kw=TINY3, device="cpu")
    if isinstance(fault, ValueError):
        assert list(run()) == ["Akbar"]
        assert "[run_all] Bibi stage3 FAILED" in capsys.readouterr().err
    else:
        with pytest.raises(type(fault), match="CUDA"):
            run()
