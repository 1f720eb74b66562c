"""Tracing and timing helpers: the device fence, a per-stage wall timer, the
program's span and counter recorder, and a ``torch.profiler`` trace around a
region.

The recorder.  :func:`span` marks a region of the host's work: a static
``name`` (one per boundary, such as ``stage3.opd.windowA``) and ``attrs``
for what varies (``monument``, ``part``, ``view`` ...).  Each finished span
is a :class:`Span`: its id, its parent (the innermost open span on the same
thread, or the span that submitted the pool task it runs in, see
:func:`carry`), its trace id (one per outermost :func:`trace`: a study, a
notebook-5 pass), the native thread id, ``start_ns`` and ``end_ns`` from
``time.time_ns`` (the clock of ``torch.profiler``'s records, so a span can
label the device's idle gaps) and the :func:`count` counters of its block.
Spans never fence the device.

Off (the default) a span is one global read and one call that returns a
shared no-op context: no record, no id, no clock read.  :func:`recording`
turns it on and yields the finished spans, in memory; ``PBR3D_PROFILE=1``
(or :func:`printing`) prints ``[prof] <name>[<attrs>]: T s`` at each
span's end, host time taken from the same record.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

#: ``PBR3D_PROFILE=1`` prints every span as it ends (see :func:`printing`).
PROFILE = os.environ.get("PBR3D_PROFILE", "") not in ("", "0")


def device_sync() -> None:
    """Wait for all queued CUDA work; nothing to wait for if CUDA never ran."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StageTimer:
    """Accumulates wall times per named stage, fencing the device at both
    edges of each stage so asynchronous launches can't leak work across
    stages."""

    def __init__(self, sync: bool = True):
        self.times: Dict[str, float] = {}
        self._sync = sync

    @contextlib.contextmanager
    def stage(self, name: str):
        if self._sync:
            device_sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync:
                device_sync()
            self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"{k:>12}: {v:8.3f} s" for k, v in self.times.items()]
        lines.append(f"{'total':>12}: {total:8.3f} s")
        return "\n".join(lines)


class Span:
    """One finished span.  ``parent`` and ``trace`` are None outside any
    span and any trace; ``tid`` is ``threading.get_native_id()`` and
    ``ident`` ``threading.get_ident()`` of the thread that ran it."""

    __slots__ = ("name", "attrs", "id", "parent", "trace", "tid", "ident", "start_ns", "end_ns", "counts")

    def __init__(self, name, attrs, id, parent, trace, start_ns):
        self.name, self.attrs, self.id, self.parent, self.trace = name, attrs, id, parent, trace
        self.tid, self.ident = threading.get_native_id(), threading.get_ident()
        self.start_ns, self.end_ns, self.counts = start_ns, start_ns, {}

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def label(self) -> str:
        """``name[k=v,...]``, the text exporter's rendering."""
        if not self.attrs:
            return self.name
        return f"{self.name}[{','.join(f'{k}={v}' for k, v in self.attrs.items())}]"


class _Carried:
    """A pool task's base on its worker's stack: the submitter's span and
    trace; counts made directly under it are dropped."""

    __slots__ = ("id", "trace", "counts")

    def __init__(self, id, trace):
        self.id, self.trace, self.counts = id, trace, None


class _Recorder:
    """What is switched on: ``spans`` (the list :func:`recording` yields) or
    None, and ``text`` (print each span)."""

    def __init__(self):
        self.spans: Optional[list] = None
        self.text = False
        self._local = threading.local()

    def stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def finish(self, s: Span) -> None:
        spans = self.spans
        if spans is not None:
            spans.append(s)  # one append under the interpreter lock: thread-safe
        if self.text:
            print(f"[prof] {s.label()}: {s.seconds:.3f}s", file=sys.stderr, flush=True)


_ids = itertools.count(1)
_lock = threading.Lock()
#: The active recorder, or None: the one global a span reads when off.
_rec: Optional[_Recorder] = None
if PROFILE:
    _rec = _Recorder()
    _rec.text = True


class _Off:
    """The shared no-op context of every span while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    __slots__ = ("rec", "name", "attrs", "root", "span")

    def __init__(self, rec, name, attrs, root):
        self.rec, self.name, self.attrs, self.root = rec, name, attrs, root

    def __enter__(self):
        stack = self.rec.stack()
        parent, tr = (stack[-1].id, stack[-1].trace) if stack else (None, None)
        if tr is None and self.root:
            tr = next(_ids)
        s = self.span = Span(self.name, self.attrs, next(_ids), parent, tr, time.time_ns())
        stack.append(s)
        return None

    def __exit__(self, *exc):
        s = self.span
        s.end_ns = time.time_ns()
        self.rec.stack().pop()
        self.rec.finish(s)
        return False


def span(name: str, **attrs):
    """A span around the block: ``with span("stage3.opd.joint", part=p):``."""
    rec = _rec
    if rec is None:
        return _OFF
    return _Open(rec, name, attrs, False)


def trace(name: str, **attrs):
    """A span that starts a new trace id when no trace is open on this
    thread (an outermost study or notebook-5 pass); inside one it is a plain
    span of that trace."""
    rec = _rec
    if rec is None:
        return _OFF
    return _Open(rec, name, attrs, True)


def spanned(name: str):
    """Decorator: every call of the function is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to ``counts[name]`` of the innermost open span on this
    thread."""
    rec = _rec
    if rec is None:
        return
    stack = rec.stack()
    if stack:
        c = stack[-1].counts
        if c is not None:
            c[name] = c.get(name, 0) + n


class _Carry:
    __slots__ = ("rec", "parent", "trace", "name", "attrs", "t0")

    def __init__(self, rec, name, attrs):
        stack = rec.stack()
        self.rec, self.name, self.attrs = rec, name, attrs
        self.parent, self.trace = (stack[-1].id, stack[-1].trace) if stack else (None, None)
        self.t0 = time.time_ns() if name is not None else 0

    def __enter__(self):
        if self.name is not None:
            s = Span(self.name, self.attrs, next(_ids), self.parent, self.trace, self.t0)
            s.end_ns = time.time_ns()
            self.rec.finish(s)
        self.rec.stack().append(_Carried(self.parent, self.trace))
        return None

    def __exit__(self, *exc):
        self.rec.stack().pop()
        return False


def carry(name: Optional[str] = None, **attrs):
    """Taken where a pool task is submitted, entered by the task in its own
    thread: the task's spans take the submitter's innermost span as parent
    and its trace id.  With ``name``, the wait from the submit to the
    task's start is recorded as a span of that name (``stage3.queued``)."""
    rec = _rec
    if rec is None:
        return _OFF
    return _Carry(rec, name, attrs)


def carried(fn, name: Optional[str] = None, **attrs):
    """``fn`` to submit to a pool: it runs under the :func:`carry` taken
    now (``fn`` itself while recording is off)."""
    ctx = carry(name, **attrs)
    if ctx is _OFF:
        return fn

    def task(*args, **kwargs):
        with ctx:
            return fn(*args, **kwargs)

    return task


@contextlib.contextmanager
def recording():
    """Switch recording on for the block; yields the list of the spans
    finished inside it (in the order they end, from every thread).  One at
    a time in a process."""
    global _rec
    with _lock:
        rec = _rec if _rec is not None else _Recorder()
        if rec.spans is not None:
            raise RuntimeError("profiling.recording() is already entered in this process")
        spans = rec.spans = []
        _rec = rec
    try:
        yield spans
    finally:
        with _lock:
            rec.spans = None
            if not rec.text:
                _rec = None


@contextlib.contextmanager
def printing():
    """The text exporter for the block: each span prints ``[prof]
    <name>[<attrs>]: T s`` on stderr as it ends (host time; nothing is
    fenced).  ``PBR3D_PROFILE=1`` turns it on for the whole process."""
    global _rec
    with _lock:
        rec = _rec if _rec is not None else _Recorder()
        was, rec.text = rec.text, True
        _rec = rec
    try:
        yield
    finally:
        with _lock:
            rec.text = was
            if rec.spans is None and not was:
                _rec = None


@contextlib.contextmanager
def device_trace(log_dir: Optional[str | Path] = None):
    """``torch.profiler`` trace of a region: host operators, and the CUDA
    kernels and copies when CUDA is available.  On exit the Chrome trace is
    written to ``log_dir`` (default: ``pbr3d_trace`` in the temporary
    directory) as ``trace_<pid>_<ns>.json`` (open it in Perfetto or
    ``chrome://tracing``).  Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir) if log_dir is not None else Path(tempfile.gettempdir()) / "pbr3d_trace"
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as p:
        try:
            yield log_dir
        finally:
            device_sync()
    p.export_chrome_trace(str(log_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"))
