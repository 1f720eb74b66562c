"""The card: the look for it, its name and power limit, and the reading of a
``torch.profiler`` trace of its CUDA activity.

The trace reading is a copy of ``bench_torch.py::device_profile`` (the busy
union over kineto's CUDA records, kernels by name), read against the traced
window's own wall and with the idle gaps labelled by the benchmark's spans.
"""

from __future__ import annotations

import contextlib
import re
import subprocess
import sys
import time
from dataclasses import dataclass, field

import torch


def cards_or_exit(count: int) -> None:
    """Exit with code 2, printing no result, unless ``count`` CUDA cards are
    there."""
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs only on the card", file=sys.stderr)
        raise SystemExit(2)
    if torch.cuda.device_count() < count:
        print(f"portbench: {torch.cuda.device_count()} CUDA devices, the cell needs {count}", file=sys.stderr)
        raise SystemExit(2)


def card_power() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (copy of
    ``bench_torch.py::query_card``), or why they could not be read."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             check=True, capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.strip().splitlines()[0] if out.strip() else "nvidia-smi printed nothing"


@dataclass
class Spans:
    """The benchmark's own host spans, ``(name, start_ns, end_ns)`` on the
    wall clock that kineto's records use (``time.time_ns``)."""

    items: list = field(default_factory=list)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.time_ns()))

    def label(self, t_ns: int) -> str:
        """The innermost span open at ``t_ns`` (the shortest that covers it)."""
        open_ = [(b - a, n) for n, a, b in self.items if a <= t_ns <= b]
        return min(open_)[1] if open_ else "outside the spans"


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: list  # [(name, seconds)], most time first
    idle_gaps: list  # [(label, seconds)], longest first
    records: int
    first_s: float  # the first record's start after the window's start
    last_s: float  # the last record's end before the window's end
    kernel_s: dict = field(default_factory=dict)  # kernel_base(name) -> seconds in the window


def read_trace(prof, t0_ns: int, t1_ns: int, spans: Spans, top: int = 10) -> TraceSummary:
    """Busy union, top device operations and longest idle gaps of the CUDA
    records of ``prof`` inside the host window ``[t0_ns, t1_ns]``.  The
    trace's own records are read, not ``prof.events()``: building the event
    tree of a study's ~1.5 M launches takes minutes."""
    from torch.autograd import DeviceType

    raw = [(e.start_ns(), e.end_ns(), e.name())
           for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]
    first = min((a for a, _, _ in raw), default=t1_ns)
    last = max((b for _, b, _ in raw), default=t0_ns)
    recs = sorted((max(a, t0_ns), min(b, t1_ns), name) for a, b, name in raw)
    recs = [r for r in recs if r[1] > r[0]]
    busy, end, gaps = 0, t0_ns, []
    for a, b, _ in recs:
        if a > end:
            gaps.append((a - end, end, a))
        busy += max(0, b - max(a, end))
        end = max(end, b)
    if t1_ns > end:
        gaps.append((t1_ns - end, end, t1_ns))
    by_name: dict = {}
    for a, b, name in recs:
        by_name[name] = by_name.get(name, 0) + (b - a)
    by_base: dict = {}
    for name, ns in by_name.items():
        base = kernel_base(name)
        by_base[base] = by_base.get(base, 0) + ns
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(gaps, reverse=True)[:top]
    return TraceSummary(
        window_s=(t1_ns - t0_ns) / 1e9, busy_s=busy / 1e9,
        device_ops=[[short_name(name), ns / 1e9] for name, ns in ops],
        idle_gaps=[[spans.label((a + b) // 2), ns / 1e9] for ns, a, b in gaps], records=len(recs),
        first_s=(first - t0_ns) / 1e9, last_s=(t1_ns - last) / 1e9,
        kernel_s={base: ns / 1e9 for base, ns in by_base.items()})


_BASE = re.compile(r"(?:void )?((?:\(anonymous namespace\)::)?[A-Za-z_][\w:]*)")


def kernel_base(name: str) -> str:
    """A device record's kernel without its return type, template arguments
    and parameters: ``void (anonymous namespace)::knn1_scan_kernel<8>(float
    const*, ...)`` -> ``(anonymous namespace)::knn1_scan_kernel``."""
    m = _BASE.match(name)
    return m.group(1) if m else name


def short_name(name: str, keep: int = 120) -> str:
    """A kernel's name cut to ``keep`` characters (templated names run to
    thousands)."""
    return name if len(name) <= keep else name[: keep - 3] + "..."


@contextlib.contextmanager
def cuda_trace():
    """``torch.profiler`` over the block, CUDA activity only (a long
    multi-threaded run's host events are many and are not read here)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield prof
