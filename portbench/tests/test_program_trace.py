"""The bridge to the program's spans (``harness/program_trace.py``) on the CPU:
the rule that puts an idle gap down to a span, on synthetic CUDA and runtime
records; each new metric's reading on a fake run; the bridge leaving every
other reading of a traced run as it was; and a traced run of a tiny study
and a tiny notebook-5 cell, whose span metrics read the program's own spans.

    python -m pytest portbench/tests/test_program_trace.py -q
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from conftest import REPO, tiny_nb5, tiny_study

from portbench.harness import device as dev
from portbench.harness import program_trace as pt
from portbench.harness.bench import Run, load_module

PB = REPO / "portbench"
MS = 1_000_000
MAIN, WORKER = 0x7F00_1111_2000, 0x7F00_3333_4000  # pthread idents of two threads


@dataclass
class FakeSpan:
    name: str
    id: int
    parent: int | None
    start_ns: int
    end_ns: int
    ident: int = MAIN
    trace: int | None = 1
    attrs: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @property
    def tid(self):
        return self.ident % 100_000


class FakeEvent:
    """One of kineto's records: a CUDA record, or a runtime record (CPU)
    carrying the launching thread's pthread ident's low 32 bits."""

    def __init__(self, start, end, corr, thread=None, name="kernel"):
        self._a, self._b, self._c, self._t, self._n = start, end, corr, thread, name

    def device_type(self):
        return DeviceType.CPU if self._t is not None else DeviceType.CUDA

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def correlation_id(self):
        return self._c

    def device_resource_id(self):
        return self._t & 0xFFFFFFFF

    def name(self):
        return self._n


def fake_prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))


def study_spans():
    """A study of 100 ms on the main thread (stage 2 to 60 ms) with one
    stage-3 body on a worker (40-90 ms) under it, waiting from 30 to 40 ms."""
    return [
        FakeSpan("study", 1, None, 0, 100 * MS),
        FakeSpan("stage2", 2, 1, 10 * MS, 60 * MS),
        FakeSpan("stage2.main_search", 3, 2, 20 * MS, 50 * MS),
        FakeSpan("stage3.queued", 4, 2, 30 * MS, 40 * MS, ident=WORKER, attrs={"monument": "Bibi"}),
        FakeSpan("stage3.body", 5, 2, 40 * MS, 90 * MS, ident=WORKER, attrs={"monument": "Bibi"},
                 counts={"stage3.round_trips": 2}),
        FakeSpan("stage3.opd.joint", 6, 5, 45 * MS, 80 * MS, ident=WORKER, attrs={"part": "dome"},
                 counts={"stage3.round_trips": 5}),
    ]


# ---- the rule --------------------------------------------------------------------------------

def test_a_gap_goes_to_the_launching_threads_innermost_span():
    spans = pt.SpanIndex(study_spans())
    # busy 0-46 ms; a gap 46-48 ms ended by the worker's launch, another 49-50 ms by the main thread's
    device = [(0, 46 * MS, 1), (48 * MS, 49 * MS, 2), (50 * MS, 100 * MS, 3)]
    runtime = {1: MAIN & 0xFFFFFFFF, 2: WORKER & 0xFFFFFFFF, 3: MAIN & 0xFFFFFFFF}
    gaps, rules = pt.attribute(device, runtime, 0, 100 * MS, spans)
    assert [(a, b, s.name) for a, b, s in gaps] == [(46 * MS, 48 * MS, "stage3.opd.joint"),
                                                     (49 * MS, 50 * MS, "stage2.main_search")]
    assert rules == {"thread": 2, "any": 0, "none": 0}
    assert spans.label(gaps[0][2]) == "stage3.opd.joint[Bibi,dome]"
    assert spans.under(gaps[0][2], "stage3.body") and not spans.under(gaps[1][2], "stage3.body")


def test_without_the_launching_thread_a_gap_goes_to_the_latest_innermost_span_and_never_to_a_wait():
    spans = pt.SpanIndex(study_spans())
    # a gap 32-38 ms (the worker only waits: its queued span is no work) ended by a
    # record with no runtime record, and the unit's trailing gap 80-90 ms
    device = [(0, 32 * MS, 7), (38 * MS, 80 * MS, 8)]
    gaps, rules = pt.attribute(device, {}, 0, 90 * MS, spans)
    assert [(a, b, s.name) for a, b, s in gaps] == [(32 * MS, 38 * MS, "stage2.main_search"),
                                                     (80 * MS, 90 * MS, "stage3.body")]
    assert rules == {"thread": 0, "any": 2, "none": 0}
    # a launching thread with no span open falls back to any thread's
    device = [(0, 92 * MS, 1), (96 * MS, 100 * MS, 2)]
    gaps, rules = pt.attribute(device, {2: WORKER & 0xFFFFFFFF}, 0, 100 * MS, spans)
    assert gaps[0][2].name == "study" and rules == {"thread": 0, "any": 1, "none": 0}


def test_a_gap_with_no_span_open_keeps_the_benchmarks_label():
    bench_spans = dev.Spans([("unit", 0, 200 * MS)])
    events = [FakeEvent(0, 60 * MS, 1), FakeEvent(0, 1, 1, thread=MAIN),
              FakeEvent(150 * MS, 160 * MS, 2), FakeEvent(0, 1, 2, thread=MAIN),
              FakeEvent(170 * MS, 175 * MS, 3), FakeEvent(0, 1, 3, thread=WORKER)]
    run = Run(config={}, mix={}, seed=1)
    bridge = pt.probe(run)
    bridge.spans = study_spans()  # (as a recording would have it)
    out = dev.read_trace(fake_prof(events), 0, 200 * MS, bench_spans)
    bridge._traced((fake_prof(events), 0, 200 * MS, bench_spans), {}, out)
    # 60-150 ms: midpoint 105 ms, the main thread's study has ended: no span open
    assert out.idle_gaps == [["unit", 0.09], ["unit", 0.025], ["unit", 0.01]]
    # 160-170 ms ended by the worker; the trailing 175-200 ms: nothing open either
    assert [s for _, _, s in bridge.gaps] == [None, None, None]


def test_the_summarys_longest_gaps_are_relabelled_with_the_spans():
    bench_spans = dev.Spans([("unit", 0, 100 * MS)])
    events = [FakeEvent(0, 46 * MS, 1), FakeEvent(0, 1, 1, thread=MAIN),
              FakeEvent(48 * MS, 49 * MS, 2), FakeEvent(0, 1, 2, thread=WORKER),
              FakeEvent(52 * MS, 55 * MS, 3), FakeEvent(0, 1, 3, thread=MAIN)]
    run = Run(config={}, mix={}, seed=1)
    bridge = pt.probe(run)
    assert pt.probe(run) is None  # one bridge a run
    bridge.spans = study_spans()
    out = dev.read_trace(fake_prof(events), 0, 100 * MS, bench_spans)
    assert out.idle_gaps[0][0] == "unit"
    bridge._traced((fake_prof(events), 0, 100 * MS, bench_spans), {}, out)
    # 46-48 ms by the worker's launch; 49-52 ms by the main thread's, whose search
    # ended at 50 ms; the trailing 55-100 ms by the latest span open at 77.5 ms
    assert out.idle_gaps == [["stage3.opd.joint[Bibi,dome]", 0.045], ["stage2", 0.003],
                             ["stage3.opd.joint[Bibi,dome]", 0.002]]
    assert sum(b - a for a, b, _ in bridge.gaps) == round((out.window_s - out.busy_s) * 1e9)


def test_a_label_is_cut_to_64_characters():
    s = FakeSpan("stage3.opd.joint", 1, None, 0, 1, attrs={"monument": "M" * 40, "part": "p" * 40})
    assert len(pt.SpanIndex([s]).label(s)) == 64


# ---- each new metric on a fake run -----------------------------------------------------------

def metric(name):
    return load_module(PB / "metrics" / f"{name}.py")


def fake_run(spans, gaps=None):
    run = Run(config={}, mix={}, seed=1)
    bridge = pt.probe(run)
    bridge.spans = spans
    if gaps is not None:
        bridge.gaps, bridge.index = gaps, pt.SpanIndex(spans)
    return run


def second_study():
    """The same study shifted to 200 ms, trace 2, a tail of 50 ms and a
    wait of 20 ms."""
    out = []
    for s in study_spans():
        t = FakeSpan(**{**s.__dict__, "id": s.id + 100, "parent": s.parent and s.parent + 100, "trace": 2,
                        "start_ns": s.start_ns + 200 * MS, "end_ns": s.end_ns + 200 * MS})
        if t.name == "stage3.queued":
            t.start_ns -= 10 * MS
        if t.name == "stage3.body":
            t.end_ns += 20 * MS
        out.append(t)
    return out


def test_the_study_metrics_read_each_study_and_average():
    run = fake_run(study_spans() + second_study())
    assert metric("stage3.tail_s").read(run) == pytest.approx((0.030 + 0.050) / 2)
    assert metric("stage3.queue_s").read(run) == pytest.approx((0.010 + 0.020) / 2)
    assert metric("stage3.round_trips").read(run) == 7
    # no study recorded, or a program without the recorder: nothing to read
    for name in ("stage3.tail_s", "stage3.queue_s", "stage3.round_trips", "stage3.device_idle_s"):
        assert metric(name).read(fake_run([])) is None or name == "stage3.device_idle_s"
        assert metric(name).read(Run(config={}, mix={}, seed=1)) is None
    # a span outside any study is not read
    stray = FakeSpan("stage3.body", 900, None, 0, 10**12, trace=None, counts={"stage3.round_trips": 9})
    assert metric("stage3.tail_s").read(fake_run(study_spans() + [stray])) == pytest.approx(0.030)


def test_the_device_idle_of_stage_3_is_the_gaps_under_a_body():
    spans = study_spans()
    gaps = [(0, 2 * MS, spans[0]), (46 * MS, 48 * MS, spans[5]), (85 * MS, 100 * MS, spans[4]),
            (30 * MS, 31 * MS, spans[2]), (101 * MS, 102 * MS, None)]
    assert metric("stage3.device_idle_s").read(fake_run(spans, gaps)) == pytest.approx(0.017)
    assert metric("stage3.device_idle_s").read(fake_run(spans)) is None  # no traced unit read


def test_the_clouds_metrics_read_each_pass_and_average():
    def one_pass(trace, io_ms, icp_ms):
        base = 1000 * trace
        out = [FakeSpan("clouds", base, None, 0, 10**9, trace=trace)]
        for k, ms in enumerate(io_ms):
            out.append(FakeSpan(("io.load_ply", "io.load_voxel_grid", "io.load_obj")[k], base + 1 + k, base, 0,
                                ms * MS, trace=trace))
        for k, ms in enumerate(icp_ms):
            out.append(FakeSpan("clouds.icp", base + 10 + k, base, 0, ms * MS, trace=trace,
                                attrs={"side": ("left", "right", "back")[k]}))
        return out

    run = fake_run(one_pass(1, [10, 20, 300], [5, 6, 7]) + one_pass(2, [12, 18, 340], [4, 6, 8]))
    assert metric("clouds.io_s").read(run) == pytest.approx((0.330 + 0.370) / 2)
    assert metric("clouds.icp_s").read(run) == pytest.approx(0.018)
    assert metric("clouds.io_s").read(fake_run([])) is None
    assert metric("clouds.icp_s").read(Run(config={}, mix={}, seed=1)) is None


# ---- the bridge changes no other reading -------------------------------------------------------

def test_the_bridge_leaves_the_summary_and_the_other_metrics_as_they_were():
    """A fake traced unit with kernels of splat-IoU, min-dist and knn: the
    summary's busy and window, its operations, kernel times and gap lengths,
    and every accepted trace metric read the same with the bridge on."""
    names = ["void (anonymous namespace)::splat_kernel(float const*)", "(anonymous namespace)::count_kernel()",
             "(anonymous namespace)::min_dist2_kernel(float const*)",
             "void (anonymous namespace)::knn1_scan_kernel<8>(float const*)", "Memcpy HtoD (Pageable -> Device)"]
    events = []
    for k in range(40):
        a = k * 2 * MS + (k % 3) * 100_000
        events += [FakeEvent(a, a + MS + (k % 5) * 50_000, k + 1, name=names[k % len(names)]),
                   FakeEvent(a - 1000, a - 500, k + 1, thread=(MAIN, WORKER)[k % 2], name="cudaLaunchKernel")]
    spans = [FakeSpan("study", 1, None, 0, 100 * MS),
             FakeSpan("stage3.body", 2, 1, 10 * MS, 95 * MS, ident=WORKER)]
    bench_spans = dev.Spans([("unit", 0, 100 * MS)])

    def readings(summary):
        run = Run(config={}, mix={}, seed=1)
        run.trace_summary = summary
        out = {}
        for name in ("device_idle_share.study", "device_idle_share.nb5"):
            out[name] = metric(name).read(run)
        from portbench.harness import roofline

        out["splat"] = roofline.share_pct(1e-4, summary, ("(anonymous namespace)::splat_kernel",
                                                           "(anonymous namespace)::count_kernel"))
        out["neighbors"] = roofline.share_pct(1e-4, summary, ("(anonymous namespace)::min_dist2_kernel",
                                                               "(anonymous namespace)::knn1_scan_kernel"))
        return out

    before = dev.read_trace(fake_prof(events), 0, 100 * MS, bench_spans)
    original = dev.read_trace
    run = Run(config={}, mix={}, seed=1)
    bridge = pt.probe(run)
    bridge.install()
    try:
        bridge.spans = spans
        after = dev.read_trace(fake_prof(events), 0, 100 * MS, bench_spans)
    finally:
        bridge.remove()
    assert dev.read_trace is original  # taken off again
    for key in ("window_s", "busy_s", "device_ops", "records", "first_s", "last_s", "kernel_s"):
        assert getattr(after, key) == getattr(before, key), key
    assert [s for _, s in after.idle_gaps] == [s for _, s in before.idle_gaps]
    assert {label for label, _ in before.idle_gaps} == {"unit"}
    assert {label for label, _ in after.idle_gaps} <= {"study", "stage3.body"}
    assert readings(after) == readings(before)
    assert sum(b - a for a, b, _ in bridge.gaps) == pytest.approx((before.window_s - before.busy_s) * 1e9, abs=1)


def test_a_program_without_the_recorder_records_nothing_and_the_metrics_are_left_out(monkeypatch):
    from pbr3d_torch.utils import profiling

    monkeypatch.delattr(profiling, "recording")
    run = Run(config={}, mix={}, seed=1)
    bridge = pt.probe(run).install()
    try:
        out = dev.read_trace(fake_prof([FakeEvent(0, MS, 1)]), 0, 10 * MS, dev.Spans([("unit", 0, 10 * MS)]))
    finally:
        bridge.remove()
    assert out.idle_gaps == [["unit", 0.009]] and bridge.spans is None
    for name in ("stage3.tail_s", "stage3.queue_s", "stage3.device_idle_s", "stage3.round_trips",
                 "clouds.io_s", "clouds.icp_s"):
        assert metric(name).read(run) is None, name


# ---- traced runs of tiny cells on the CPU --------------------------------------------------------

SPAN_METRICS = {"study": ("stage3.tail_s", "stage3.queue_s", "stage3.device_idle_s", "stage3.round_trips"),
                "nb5": ("clouds.io_s", "clouds.icp_s")}


def test_a_traced_tiny_study_reads_the_programs_spans(tree):
    from portbench.harness.bench import execute

    cell = tiny_study(tree)
    for m in tree.bench["per_layer"]:
        if m["name"] in SPAN_METRICS["study"] + ("stage2_s",):
            m["workloads"].append(cell)
    line = execute(tree.bench, cell, 2**31 + 5, 0.01, True, device="cpu", root=tree.pb)
    got = line["metrics"]
    # one monument takes the serial route: no pool, no wait; no device trace on the CPU
    assert set(got) >= {"stage3.tail_s", "stage3.round_trips", "stage2_s"}
    assert "stage3.queue_s" not in got and "stage3.device_idle_s" not in got
    assert got["stage3.round_trips"]["value"] > 0 and got["stage3.round_trips"]["unit"] == "count"
    assert 0 < got["stage3.tail_s"]["value"]
    from pbr3d_torch.utils import profiling

    assert profiling._rec is None  # the recording ended with the window


def test_a_traced_tiny_nb5_pass_reads_the_programs_spans(tree):
    from portbench.harness.bench import execute

    cell = tiny_nb5(tree)
    for m in tree.bench["per_layer"]:
        if m["name"] in SPAN_METRICS["nb5"]:
            m["workloads"].append(cell)
    line = execute(tree.bench, cell, 2**31 + 6, 0.01, True, device="cpu", root=tree.pb)
    got = line["metrics"]
    assert set(SPAN_METRICS["nb5"]) <= set(got)
    assert 0 < got["clouds.icp_s"]["value"] and 0 < got["clouds.io_s"]["value"]
