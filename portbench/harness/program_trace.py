"""The program's own spans in a traced run, and the traced unit's idle gaps
put down to them.

The program records spans and counters with ``pbr3d_torch.utils.profiling``
(``recording()``): a static name, attributes, a parent, a trace id (one per
study or notebook-5 pass), the thread and ``time.time_ns`` edges, the clock
of kineto's records.  The bridge is one probe a run, installed by the first
metric that asks for it, for the window of a traced run only:

* ``install()`` enters ``recording()`` and ``remove()`` leaves it; a program
  without the recorder records nothing, and the metrics that read it are
  left out;
* on ``portbench.harness.device.read_trace`` (looked up at call time), after
  it returns, every idle gap of the traced unit's CUDA records is put down
  to one program span (:func:`attribute`), the result kept for the metrics,
  and the summary's ten longest gaps relabelled with the spans' names.

The rule.  A gap belongs to the innermost span open at its midpoint on the
thread that enqueued the device record ending it: the record's correlation
id names a CUDA runtime record, whose ``device_resource_id`` is the
launching thread's ``pthread_self`` (low 32 bits, which the span keeps as
``ident``).  Where that thread has no span open (or the gap ends the unit),
the gap belongs to the most recently started innermost span open on any
thread; where none is open it keeps the benchmark's label.  Spans that hold
no work of their thread (``WAITS``: a pool task's wait) are never chosen.
"""

from __future__ import annotations

import bisect
import sys
from collections import defaultdict

from portbench.harness.probes import Probe

KEY = "program_trace"
#: Spans that stand for a wait, not for work of the thread that records them.
WAITS = frozenset({"stage3.queued"})
#: Attributes named in a gap's label, from the span or its nearest ancestor.
LABEL_ATTRS = ("monument", "part", "side")
LABEL_CHARS = 64
#: The spans that the log's idle totals by stage are gathered under (the nearest one).
STAGES = ("stage3.body", "stage2.prep", "stage2", "stage1", "clouds", "study")
_MASK = 0xFFFFFFFF


def probe(run):
    """The run's bridge, the first time a metric asks; then None."""
    if KEY in run.metric_state:
        return None
    bridge = run.metric_state[KEY] = Bridge()
    return bridge


class Bridge(Probe):
    def __init__(self):
        super().__init__([("portbench.harness.device", "read_trace")], self._traced)
        self.spans = None  # the recorded spans (a live list), or None: no recorder
        self.gaps = None  # [(start_ns, end_ns, span or None)] of the traced unit
        self.index = None  # SpanIndex of the spans at the traced unit's read
        self._ctx = None

    def install(self) -> "Bridge":
        try:
            from pbr3d_torch.utils import profiling
        except ImportError:
            profiling = None
        recording = getattr(profiling, "recording", None)
        if recording is not None:
            self._ctx = recording()
            self.spans = self._ctx.__enter__()
        return super().install()

    def remove(self) -> None:
        super().remove()
        if self._ctx is not None:
            ctx, self._ctx = self._ctx, None
            ctx.__exit__(None, None, None)

    def _traced(self, args, kwargs, out) -> None:
        if self.spans is None:
            return
        prof, t0_ns, t1_ns, bench_spans = args[:4]
        device, runtime = trace_records(prof)
        spans = SpanIndex(list(self.spans))
        gaps, rules = attribute(device, runtime, t0_ns, t1_ns, spans)
        self.gaps, self.index = gaps, spans
        top = sorted(((b - a, a, b, s) for a, b, s in gaps), key=lambda g: g[:3], reverse=True)
        top = top[:len(out.idle_gaps)]
        # the same gaps as the summary's, longest first: relabelled in place
        if [ns / 1e9 for ns, *_ in top] == [sec for _, sec in out.idle_gaps]:
            out.idle_gaps = [[spans.label(s) if s is not None else bench_spans.label((a + b) // 2), ns / 1e9]
                             for ns, a, b, s in top]
        by_label, by_stage = {}, {}
        for a, b, s in gaps:
            name = spans.label(s) if s is not None else "(no span)"
            by_label[name] = by_label.get(name, 0) + (b - a)
            stage = next((x.name for x in spans.ancestors(s) if x.name in STAGES), "(none)")
            by_stage[stage] = by_stage.get(stage, 0) + (b - a)
        idle = sum(b - a for a, b, _ in gaps)

        def totals(d, n):
            return "; ".join(f"{k} {v / 1e9:.4f} s" for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n])

        print(f"[portbench] program trace: {len(self.spans)} spans; {len(gaps)} idle gaps, {idle / 1e9!r} s; "
              f"put down by the launching thread {rules['thread']}, by any thread {rules['any']}, "
              f"to no span {rules['none']}; by stage: {totals(by_stage, 10)}; longest totals: {totals(by_label, 15)}",
              file=sys.stderr, flush=True)


def trace_records(prof):
    """(CUDA records ``[(start_ns, end_ns, correlation id)]``, ``{correlation
    id: launching thread}`` of the runtime records) of a ``torch.profiler``
    trace, from kineto's own records."""
    from torch.autograd import DeviceType

    device, runtime = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            device.append((e.start_ns(), e.end_ns(), e.correlation_id()))
        else:
            c = e.correlation_id()
            if c:
                runtime[c] = e.device_resource_id()
    return device, runtime


def idle_gaps(device, t0_ns: int, t1_ns: int):
    """Every idle gap of the records inside ``[t0_ns, t1_ns]``, as
    ``device.read_trace`` finds them: ``[(start_ns, end_ns, correlation id of
    the record that ends it, or None)]``."""
    recs = sorted((max(a, t0_ns), min(b, t1_ns), c) for a, b, c in device)
    end, gaps = t0_ns, []
    for a, b, c in recs:
        if b <= a:
            continue
        if a > end:
            gaps.append((end, a, c))
        end = max(end, b)
    if t1_ns > end:
        gaps.append((end, t1_ns, None))
    return gaps


class SpanIndex:
    """The spans by thread, for the innermost span open at an instant."""

    def __init__(self, spans):
        self.by_id = {s.id: s for s in spans}
        threads = defaultdict(list)
        for s in spans:
            if s.name not in WAITS:
                threads[s.ident & _MASK].append(s)
        self.threads = {k: (v, [s.start_ns for s in v])
                        for k, v in ((k, sorted(v, key=lambda s: s.start_ns)) for k, v in threads.items())}

    def innermost(self, thread, t: int):
        """The innermost span open at ``t`` on ``thread`` (spans of one
        thread nest), or None."""
        if thread not in self.threads:
            return None
        spans, starts = self.threads[thread]
        i = bisect.bisect_right(starts, t) - 1
        s = spans[i] if i >= 0 else None
        while s is not None and s.end_ns < t:
            p = self.by_id.get(s.parent)
            s = p if p is not None and p.ident == s.ident and p.name not in WAITS else None
        return s

    def latest(self, t: int):
        """The most recently started of the threads' innermost spans open
        at ``t``, or None."""
        open_ = [s for s in (self.innermost(k, t) for k in self.threads) if s is not None]
        return max(open_, key=lambda s: s.start_ns, default=None)

    def ancestors(self, s):
        while s is not None:
            yield s
            s = self.by_id.get(s.parent)

    def under(self, s, name: str) -> bool:
        """Whether ``s`` is a span ``name`` or lies under one."""
        return any(a.name == name for a in self.ancestors(s))

    def label(self, s) -> str:
        """The span's name, with the monument, part or side of it or its
        nearest ancestor in brackets, cut to 64 characters."""
        vals = []
        for key in LABEL_ATTRS:
            v = next((a.attrs[key] for a in self.ancestors(s) if key in a.attrs), None)
            if v is not None:
                vals.append(str(v))
        return (s.name + (f"[{','.join(vals)}]" if vals else ""))[:LABEL_CHARS]


def attribute(device, runtime, t0_ns: int, t1_ns: int, index: SpanIndex):
    """(``[(start_ns, end_ns, span or None)]`` for every idle gap of the
    unit, counts of the gaps by the rule that placed them)."""
    out, rules = [], {"thread": 0, "any": 0, "none": 0}
    for a, b, c in idle_gaps(device, t0_ns, t1_ns):
        mid = (a + b) // 2
        thread = runtime.get(c) if c is not None else None
        s = index.innermost(thread & _MASK, mid) if thread is not None else None
        if s is not None:
            rules["thread"] += 1
        else:
            s = index.latest(mid)
            rules["any" if s is not None else "none"] += 1
        out.append((a, b, s))
    return out, rules


# ---- readers of the metrics -------------------------------------------------------------

def bridge(run):
    """The run's bridge, if it recorded anything."""
    b = run.metric_state.get(KEY)
    return b if b is not None and b.spans is not None else None


def traces(run, root: str):
    """The recorded traces whose outermost span is named ``root`` (a study,
    a notebook-5 pass): a list of their spans, one list a trace."""
    b = bridge(run)
    if b is None:
        return []
    spans = list(b.spans)
    roots = {s.trace for s in spans if s.parent is None and s.name == root and s.trace is not None}
    by_trace = defaultdict(list)
    for s in spans:
        if s.trace in roots:
            by_trace[s.trace].append(s)
    return [by_trace[t] for t in sorted(by_trace)]


def mean(values):
    values = list(values)
    return sum(values) / len(values) if values else None


def seconds(spans, name: str) -> float:
    return sum(s.end_ns - s.start_ns for s in spans if s.name == name) / 1e9
