"""CUDA streams for worker threads.

PyTorch's current stream is a per-thread setting, and every thread starts on
the device's default stream, where the work of all of them would run in one
queue.  A worker thread that should overlap with the others runs inside
:func:`worker_stream`.  A device tensor that one thread made and another
uses must be :func:`adopt`-ed by the user: the caching allocator hands a
freed block out again in the order of the stream that allocated it, and
knows of no other stream that still reads it unless it is told.

The allocator also keeps its cache of freed blocks per stream, so a block
freed on one stream serves no other.  Worker streams are therefore taken
from a pool of idle ones and handed back, and a process uses as many
streams as it ever had workers at once: with a new stream for every task
(PyTorch deals out 32 in turn) the golden-resolution study grew the reserved
memory to the whole card while 7 GB were allocated.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List

import torch

_IDLE: Dict[int, List["torch.cuda.Stream"]] = {}  # device index -> idle worker streams
_IDLE_LOCK = threading.Lock()


@contextlib.contextmanager
def worker_stream(device, after=None):
    """Run this thread's work on ``device`` on a stream of its own for the
    length of the block.  The stream first waits for what is queued on
    ``after`` (the submitting thread's stream, with its uploads and sweeps;
    default: the device's default stream), and the block's end waits for the
    stream, so what the block returns is complete.  On a CPU device this
    does nothing."""
    device = torch.device(device)
    if device.type != "cuda":
        yield
        return
    index = device.index if device.index is not None else torch.cuda.current_device()
    with _IDLE_LOCK:
        idle = _IDLE.setdefault(index, [])
        stream = idle.pop() if idle else torch.cuda.Stream(device)
    stream.wait_stream(after if after is not None else torch.cuda.default_stream(device))
    try:
        with torch.cuda.stream(stream):
            yield
    finally:
        stream.synchronize()
        with _IDLE_LOCK:
            idle.append(stream)


def adopt(tensor: torch.Tensor) -> torch.Tensor:
    """Tell the allocator that this thread's current stream uses ``tensor``,
    which another stream may have allocated."""
    if tensor.is_cuda:
        tensor.record_stream(torch.cuda.current_stream(tensor.device))
    return tensor
