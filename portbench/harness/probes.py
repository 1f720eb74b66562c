"""Probes on the program's op-level calls.

A probe replaces a function where its callers bind it (a module attribute
that they look up at call time, such as ``pbr3d_torch.eval.inter.min_dist2``)
by a wrapper that calls it and hands ``(args, kwargs, out)`` to a recorder.
Probes are taken off in the reverse order.
"""

from __future__ import annotations

import importlib
import threading

import numpy as np


class Probe:
    def __init__(self, targets, record):
        """``targets``: ``[(module name, attribute)]``; ``record(args,
        kwargs, out)`` is called after each call."""
        self.targets, self.record = list(targets), record
        self._saved: list = []

    def install(self) -> "Probe":
        for mod_name, attr in self.targets:
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
            setattr(mod, attr, self._wrap(orig))
            self._saved.append((mod, attr, orig))
        return self

    def remove(self) -> None:
        while self._saved:
            mod, attr, orig = self._saved.pop()
            setattr(mod, attr, orig)

    def _wrap(self, fn):
        def probed(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.record(args, kwargs, out)
            return out

        probed.__wrapped__ = fn
        return probed


class Reservoir:
    """A uniform sample of at most ``k`` items of a stream of unknown
    length, drawn from ``seed`` (reservoir sampling); thread-safe."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.items = k, np.random.default_rng(seed), 0, []
        self._lock = threading.Lock()

    def offer(self, make):
        """Count one item; if it is drawn, store ``make()`` (called only
        then, so an item that is not kept costs nothing)."""
        with self._lock:
            i = self.seen
            self.seen += 1
            if i < self.k:
                slot = len(self.items)
                self.items.append(None)
            else:
                slot = int(self.rng.integers(0, i + 1))
                if slot >= self.k:
                    return
            self.items[slot] = make()


class CallLog:
    """Every call's record, thread-safe."""

    def __init__(self):
        self.items, self._lock = [], threading.Lock()

    def add(self, item) -> None:
        with self._lock:
            self.items.append(item)
