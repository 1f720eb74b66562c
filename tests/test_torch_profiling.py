"""``pbr3d_torch.utils.profiling`` on the CPU: ``StageTimer`` sums and
report (the same text as the JAX package's for the same times),
``device_sync`` without CUDA, ``device_trace`` writing a Chrome trace, and
the span and counter recorder (off, nesting, threads, pool tasks, counts,
``recording()``, no fence, the text exporter, the profiler's clock)."""

import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
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


# ---- the span and counter recorder ---------------------------------------------------------

class _Unformattable:
    """An attribute whose rendering fails: proof that nothing formats it."""

    def __format__(self, spec):
        raise AssertionError("formatted while recording is off")

    __str__ = __repr__ = lambda self: self.__format__("")


def _no_clock():
    raise AssertionError("a clock was read while recording is off")


def test_off_a_span_records_nothing_prints_nothing_formats_nothing_and_reads_no_clock(capsys):
    assert profiling._rec is None
    with mock.patch.object(profiling.time, "time_ns", _no_clock), \
            mock.patch.object(profiling.time, "perf_counter", _no_clock), \
            mock.patch.object(profiling, "Span", None):
        ctx = profiling.span("stage3.opd.joint", part=_Unformattable())
        assert ctx is profiling.span("stage1.guided") is profiling.trace("study") is profiling.carry("q")
        with ctx:
            profiling.count("stage3.round_trips")
        fn = object()
        assert profiling.carried(fn, "stage3.queued", monument=_Unformattable()) is fn
    assert capsys.readouterr().err == ""


def test_nested_spans_link_to_their_parent_and_trace_and_threads_keep_their_own_stacks():
    seen = {}

    def other():
        with profiling.span("other"):
            seen["other"] = threading.get_native_id()

    with profiling.recording() as spans:
        with profiling.trace("study", monument="Akbar"):
            with profiling.span("stage1"):
                with profiling.span("stage1.guided"):
                    t = threading.Thread(target=other)
                    t.start()
                    t.join()
            with profiling.span("stage2"):
                pass
    by = {s.name: s for s in spans}
    assert [s.name for s in spans] == ["other", "stage1.guided", "stage1", "stage2", "study"]
    study = by["study"]
    assert study.parent is None and study.trace is not None and study.attrs == {"monument": "Akbar"}
    assert by["stage1"].parent == study.id and by["stage2"].parent == study.id
    assert by["stage1.guided"].parent == by["stage1"].id
    assert {s.trace for s in spans if s.name != "other"} == {study.trace}
    # a plain thread has its own stack: no parent, no trace
    assert by["other"].parent is None and by["other"].trace is None and by["other"].tid == seen["other"]
    assert study.tid == threading.get_native_id() and study.ident == threading.get_ident()
    for s in spans:
        assert s.start_ns <= s.end_ns
    assert study.start_ns <= by["stage1"].start_ns <= by["stage1"].end_ns <= by["stage2"].start_ns
    # a trace inside an open trace is a plain span of it; two outermost ones differ
    with profiling.recording() as spans:
        with profiling.trace("study"):
            with profiling.trace("study"):
                pass
        with profiling.trace("clouds"):
            pass
    inner, outer, clouds = spans
    assert inner.trace == outer.trace != clouds.trace and inner.parent == outer.id


def test_a_pool_task_carries_the_submitters_trace_and_parent_and_records_its_wait():
    with profiling.recording() as spans:
        with profiling.trace("study"):
            with profiling.span("stage2"), ThreadPoolExecutor(max_workers=1) as ex:
                block = threading.Event()
                ex.submit(block.wait)  # the worker is busy: the next task waits in the queue

                def task(m):
                    with profiling.span("stage3.body", monument=m):
                        profiling.count("stage3.round_trips")
                    return threading.get_native_id()

                fut = ex.submit(profiling.carried(task, "stage3.queued", monument="Bibi"), "Bibi")
                time.sleep(0.02)
                block.set()
                worker = fut.result()
                plain = ex.submit(profiling.carried(task), "Taj").result()
    by = {(s.name, s.attrs.get("monument")): s for s in spans}
    stage2, study = by[("stage2", None)], by[("study", None)]
    queued, body = by[("stage3.queued", "Bibi")], by[("stage3.body", "Bibi")]
    assert queued.parent == body.parent == by[("stage3.body", "Taj")].parent == stage2.id
    assert {queued.trace, body.trace, by[("stage3.body", "Taj")].trace} == {study.trace}
    assert queued.tid == body.tid == worker == plain != threading.get_native_id()
    assert queued.end_ns - queued.start_ns >= 15_000_000 and queued.end_ns <= body.start_ns
    assert body.counts == {"stage3.round_trips": 1}


def test_counts_attach_to_the_innermost_open_span():
    with profiling.recording() as spans:
        profiling.count("stage3.round_trips")  # no span open: dropped
        with profiling.span("stage3.body"):
            profiling.count("stage3.round_trips")
            with profiling.span("stage3.opd.joint", part="dome"):
                profiling.count("stage3.round_trips", 3)
                profiling.count("other")
            profiling.count("stage3.round_trips")
    joint, body = spans
    assert joint.counts == {"stage3.round_trips": 3, "other": 1}
    assert body.counts == {"stage3.round_trips": 2}


def test_recording_yields_exactly_the_spans_finished_inside_it_once_at_a_time():
    with profiling.printing():  # on, but nothing kept: a span ends before the recording
        with profiling.span("before"):
            pass
    outer = profiling.span("open across")
    with profiling.recording() as spans:
        outer.__enter__()  # opened while recording is on
        with profiling.span("inside"):
            pass
        with pytest.raises(RuntimeError):
            with profiling.recording():
                pass
    outer.__exit__(None, None, None)  # finished after it: not kept
    assert [s.name for s in spans] == ["inside"]
    assert profiling._rec is None and profiling.span("after") is profiling._OFF


def test_no_span_fences_the_device():
    def fence():
        raise AssertionError("a span synchronised the device")

    with mock.patch.object(profiling, "device_sync", fence), mock.patch.object(torch.cuda, "synchronize", fence):
        with profiling.recording() as spans, profiling.printing():
            with profiling.trace("study"), profiling.span("stage1"):
                with profiling.carry("stage3.queued"), profiling.span("stage3.body"):
                    profiling.count("stage3.round_trips")
    assert [s.name for s in spans] == ["stage3.queued", "stage3.body", "stage1", "study"]


def test_the_text_exporter_prints_name_attrs_and_host_seconds(capsys):
    with profiling.printing():
        with profiling.span("stage3.resweep", part="dome", sweep=1):
            time.sleep(0.01)
        with profiling.span("stage1.guided"):
            pass
    lines = capsys.readouterr().err.splitlines()
    assert lines[0].startswith("[prof] stage3.resweep[part=dome,sweep=1]: ") and lines[0].endswith("s")
    assert float(lines[0].split(": ")[1][:-1]) >= 0.01
    assert lines[1].startswith("[prof] stage1.guided: ")
    assert profiling._rec is None


def test_a_span_and_a_profiler_record_of_the_same_block_share_the_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.recording() as spans:
            with profiling.span("block"), record_function("block"):
                time.sleep(0.02)
    rec = next(e for e in prof.profiler.kineto_results.events() if e.name() == "block")
    (s,) = spans
    assert abs(rec.start_ns() - s.start_ns) < 1_000_000
    assert abs(rec.end_ns() - s.end_ns) < 1_000_000
