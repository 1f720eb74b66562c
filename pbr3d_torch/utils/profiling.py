"""Env-gated phase timer, as in ``pbr3d.utils.profiling``."""

from __future__ import annotations

import contextlib
import os
import sys
import time

import torch

#: ``PBR3D_PROFILE=1`` turns :func:`prof` regions into stderr timing lines
#: (device-fenced); otherwise they are free no-ops.
PROFILE = os.environ.get("PBR3D_PROFILE", "") not in ("", "0")


def _device_sync() -> None:
    """Wait for all queued CUDA work; nothing to wait for if CUDA never ran."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def prof(name: str, sync: bool = True):
    """Env-gated phase timer: prints ``[prof] name: T s`` when enabled."""
    if not PROFILE:
        yield
        return
    if sync:
        _device_sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            _device_sync()
        print(f"[prof] {name}: {time.perf_counter() - t0:.2f}s",
              file=sys.stderr, flush=True)
