"""``pbr3d_torch.utils.profiling`` on the CPU: ``StageTimer`` sums and
report (the same text as the JAX package's for the same times),
``device_sync`` without CUDA, and ``device_trace`` writing a Chrome trace."""

import json
import time
from unittest import mock

import pytest
import torch

from pbr3d.utils import profiling as jax_profiling
from pbr3d_torch.utils import profiling


def test_device_sync_without_cuda():
    assert not torch.cuda.is_initialized()
    profiling.device_sync()
    assert not torch.cuda.is_initialized()


@pytest.mark.parametrize("sync", [True, False])
def test_stage_timer_sums_and_fences(sync):
    calls = []
    t = profiling.StageTimer(sync=sync)
    with mock.patch.object(profiling, "device_sync", lambda: calls.append(1)):
        for _ in range(2):
            with t.stage("carve"):
                time.sleep(0.01)
        with t.stage("recolor"):
            pass
        with pytest.raises(ValueError):
            with t.stage("recolor"):
                raise ValueError
    assert list(t.times) == ["carve", "recolor"]
    assert t.times["carve"] >= 0.02
    assert len(calls) == (8 if sync else 0)  # both edges of each of 4 stages


def test_stage_timer_report_matches_jax():
    ours, ref = profiling.StageTimer(sync=False), jax_profiling.StageTimer(sync=False)
    ours.times = {"part": 1.25, "guided": 0.5, "extrude": 12.0625}
    ref.times = dict(ours.times)
    assert ours.report() == ref.report()
    assert ours.report().splitlines()[-1] == "       total:   13.812 s"


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(tmp_path / "trace") as log_dir:
        assert log_dir == tmp_path / "trace"
        a = torch.arange(1000, dtype=torch.float32)
        (a * 2 + 1).sum()
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mul" in names and "aten::sum" in names
