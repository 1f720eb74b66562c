"""Tracing and timing helpers, as in ``pbr3d.utils.profiling``: the device
fence, a per-stage wall timer, the env-gated ``[prof]`` phase timer and a
``torch.profiler`` trace around a region."""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import torch

#: ``PBR3D_PROFILE=1`` turns :func:`prof` regions into stderr timing lines
#: (device-fenced); otherwise they are free no-ops.
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


@contextlib.contextmanager
def prof(name: str, sync: bool = True):
    """Env-gated phase timer: prints ``[prof] name: T s`` when enabled."""
    if not PROFILE:
        yield
        return
    if sync:
        device_sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            device_sync()
        print(f"[prof] {name}: {time.perf_counter() - t0:.2f}s",
              file=sys.stderr, flush=True)


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
