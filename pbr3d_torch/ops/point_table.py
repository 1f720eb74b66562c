"""Device point table of one label grid, as in ``pbr3d.ops.point_table``.

One pass over the dense grid on the device gives:

* the occupied voxels in ``np.where`` raster order (``torch.nonzero`` keeps
  it), as int16 (x, y, z) = (d2, d1, d0) coordinates and uint8 labels.  The
  order matters: the rebuild's collision rule downstream is order-defined;
* the same-label 6-neighbour surface flag of each point (a grid face counts
  as surface), so every part's own shell is a filter of the table;
* per-part point counts, shell counts and exact int64 coordinate sums, from
  which :meth:`PointTable.center` gives the float64 centroid of the
  reference's ``points.mean(axis=0)`` (deformation_estimation.py:72-74).

The JAX package pads the table to a power-of-two bucket and sums in two
int32 limbs; here the table has the exact point count and the sums are
int64.  Per-part windows (every ``stride``-th point of a part, or of its
shell, in rank order) are exact-size ``nonzero`` selections.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

#: Part-id segments 0..10 (config.PART_IDS values are 1..10).
_K = 11


def _interior3(g: torch.Tensor) -> torch.Tensor:
    """Same-label interior: all 6 face neighbours carry the same label; a
    voxel on a grid face is never interior."""
    interior = torch.ones(g.shape, dtype=torch.bool, device=g.device)
    for ax in range(3):
        n = g.shape[ax]
        if n < 2:
            return torch.zeros_like(interior)
        same = g.narrow(ax, 1, n - 1) == g.narrow(ax, 0, n - 1)
        interior.narrow(ax, 0, n - 1).logical_and_(same)
        interior.narrow(ax, 1, n - 1).logical_and_(same)
        interior.narrow(ax, 0, 1).fill_(False)
        interior.narrow(ax, n - 1, 1).fill_(False)
    return interior


@dataclasses.dataclass
class PointTable:
    """Compacted point set of one label grid, on the device."""

    coords: torch.Tensor  # (N, 3) int16 (x, y, z), raster order
    labels: torch.Tensor  # (N,) uint8
    surf: torch.Tensor  # (N,) bool — same-label 6-neighbour shell flag
    counts: np.ndarray  # (K,) int64 per part id
    shell_counts: np.ndarray  # (K,) int64
    sums: np.ndarray  # (K, 3) int64 — exact per-part coordinate sums
    shape: Tuple[int, int, int]
    n: int  # occupied voxels

    def count(self, pid: int) -> int:
        return int(self.counts[pid])

    def shell_count(self, pid: int) -> int:
        return int(self.shell_counts[pid])

    def center(self, pid: int) -> np.ndarray:
        """Float64 centroid of the part's full point set: the exact integer
        sum over the count."""
        c = max(self.count(pid), 1)
        return self.sums[pid].astype(np.float64) / c

    def _window(self, sel: torch.Tensor, stride: int) -> torch.Tensor:
        idx = torch.nonzero(sel, as_tuple=True)[0]
        return self.coords[idx[::stride]]

    def part_window(self, pid: int, stride: int = 1) -> torch.Tensor:
        """(M, 3) int16: every ``stride``-th point of the part, raster order."""
        return self._window(self.labels == pid, stride)

    def shell_window(self, pid: int, stride: int = 1) -> torch.Tensor:
        """(M, 3) int16: every ``stride``-th point of the part's own shell."""
        return self._window((self.labels == pid) & self.surf, stride)


def build_point_table(grid_labels, *, device) -> PointTable:
    """Build the point table of a ``(D0, D1, D2)`` uint8 label grid (host
    array or device tensor) on ``device``."""
    g = torch.as_tensor(grid_labels, device=device)
    D0, D1, D2 = (int(s) for s in g.shape[:3])
    flat = g.reshape(-1)
    idx = torch.nonzero(flat, as_tuple=True)[0]
    labels = flat[idx]
    surf = (~_interior3(g)).reshape(-1)[idx]
    coords = torch.stack([idx % D2, (idx // D2) % D1, idx // (D2 * D1)], dim=1)

    seg = labels.to(torch.int64)
    counts = torch.zeros(_K, dtype=torch.int64, device=g.device)
    counts.index_add_(0, seg, torch.ones_like(seg))
    shell_counts = torch.zeros(_K, dtype=torch.int64, device=g.device)
    shell_counts.index_add_(0, seg, surf.to(torch.int64))
    sums = torch.zeros((_K, 3), dtype=torch.int64, device=g.device)
    sums.index_add_(0, seg, coords)
    return PointTable(
        coords=coords.to(torch.int16), labels=labels, surf=surf,
        counts=counts.cpu().numpy(), shell_counts=shell_counts.cpu().numpy(),
        sums=sums.cpu().numpy(), shape=(D0, D1, D2), n=int(idx.shape[0]),
    )
