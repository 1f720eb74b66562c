"""Iso-surface extraction: classic marching cubes + marching tetrahedra, as
in ``pbr3d.ops.isosurface`` (which replaces ``skimage.measure.marching_cubes``).

``marching_cubes`` is the production extractor (cube-edge vertex topology
matching skimage's); its 256-case table is GENERATED at import time from
first principles rather than transcribed.  ``marching_tetrahedra`` is a
second, independently derived extractor (every cube splits into 6 tetrahedra
around the main diagonal), kept to cross-validate the cube table.

Winding is made globally consistent by orienting every triangle against the
field gradient: normals point toward decreasing field values, i.e. outward
for occupancy/density grids.

The tables are host numpy, made once and uploaded; the extraction runs as
tensor ops on ``device`` and returns device tensors.  Cells, triangles and
vertices come out in the JAX package's order: slabs along dim 0, cells in
raster order, table columns in turn, and vertices welded by
``torch.unique(dim=0)`` on coordinates rounded at 1e-5 (the lexicographic
order ``np.unique(axis=0)`` gives).  The interpolation is float32 with every
product and sum a rounding of its own, as numpy computes it.

Output: vertices (N, 3) float32 in (d0, d1, d2) grid index space, faces
(M, 3) int32.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

# Cube corner offsets (d0, d1, d2), classic MC numbering.
_CORNERS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    np.int64,
)

# Six tetrahedra sharing the main diagonal corner0-corner6.
_TETS = np.array(
    [
        [0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6],
        [0, 7, 4, 6], [0, 4, 5, 6], [0, 5, 1, 6],
    ],
    np.int64,
)

# Tet edges as (corner a, corner b) local indices.
_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int64)

# For each of the 16 inside-bit cases: up to 2 triangles as edge-index
# triples (-1 padded).  One-vertex cases cut the 3 edges incident to that
# vertex; two-vertex cases cut the 4 edges crossing the in/out partition (a
# quad, split into 2 triangles).  Winding is fixed afterwards via the field
# gradient, so only the edge *sets* matter here.
_CASES = -np.ones((16, 2, 3), np.int64)
_INCIDENT = {0: [0, 1, 2], 1: [0, 3, 4], 2: [1, 3, 5], 3: [2, 4, 5]}
for _v in range(4):
    _CASES[1 << _v, 0] = _INCIDENT[_v]
    _CASES[15 ^ (1 << _v), 0] = _INCIDENT[_v]
_QUADS = {
    0b0011: [1, 2, 3, 4],  # v0,v1 in: edges 02,03,12,13
    0b0101: [0, 2, 3, 5],  # v0,v2 in: edges 01,03,12,23
    0b1001: [0, 1, 4, 5],  # v0,v3 in: edges 01,02,13,23
}
for _code, (_a, _b, _c, _d) in _QUADS.items():
    # quad a-b-d-c (a,b share one endpoint side): split (a,b,c) + (b,d,c)
    for _k in (_code, 15 ^ _code):
        _CASES[_k, 0] = [_a, _b, _c]
        _CASES[_k, 1] = [_b, _d, _c]

# The 12 cube edges as corner pairs, classic MC numbering.  Each pair is
# CANONICALLY ORIENTED low-corner -> high-corner (lexicographic grid
# position): the interpolation t = (level-va)/(vb-va) then evaluates with
# bit-identical float rounding in BOTH cells sharing the edge, so welding
# always fuses the shared cut vertex.
_MC_EDGES = np.array(
    [
        [0, 1], [1, 2], [3, 2], [0, 3],
        [4, 5], [5, 6], [7, 6], [4, 7],
        [0, 4], [1, 5], [2, 6], [3, 7],
    ],
    np.int64,
)

# The 6 faces as corner quads in cyclic order.
_MC_FACES = np.array(
    [
        [0, 1, 2, 3], [4, 5, 6, 7],
        [0, 1, 5, 4], [2, 3, 7, 6],
        [1, 2, 6, 5], [3, 0, 4, 7],
    ],
    np.int64,
)

_EDGE_OF_PAIR = {}
for _ei, (_a, _b) in enumerate(_MC_EDGES):
    _EDGE_OF_PAIR[(int(_a), int(_b))] = _ei
    _EDGE_OF_PAIR[(int(_b), int(_a))] = _ei


def _face_pairings(face, inside):
    """Pair the cut edges of one face along the iso-contour.

    The 2-cut face has one connection; the ambiguous 4-cut face (diagonal
    corners inside) is split with the asymptotic decider, the tie of a binary
    field at level .5 resolved as OUTSIDE: the inside corners stay SEPARATED,
    and each cut edge connects to the cut edge sharing its INSIDE corner.
    The decision depends only on the shared face's corners, so adjacent
    cells agree edge for edge and the mesh is watertight by construction."""
    quad = [int(c) for c in face]
    cut = []
    for k in range(4):
        a, b = quad[k], quad[(k + 1) % 4]
        if inside[a] != inside[b]:
            cut.append((k, _EDGE_OF_PAIR[(a, b)]))
    if not cut:
        return []
    if len(cut) == 2:
        return [(cut[0][1], cut[1][1])]
    out = []
    for k in range(4):
        if inside[quad[k]]:
            e_prev = _EDGE_OF_PAIR[(quad[(k - 1) % 4], quad[k])]
            e_next = _EDGE_OF_PAIR[(quad[k], quad[(k + 1) % 4])]
            out.append((e_prev, e_next))
    return out


def _build_mc_table():
    """(256, _MC_MAXT, 3) int64 edge-index triangles (-1 padded): for each
    corner sign pattern, the iso-contour loops over the 6 cube faces,
    fan-triangulated."""
    table = []
    maxt = 0
    for code in range(256):
        inside = [(code >> v) & 1 == 1 for v in range(8)]
        # adjacency over cut edges: each cut edge lies on exactly 2 faces
        adj = {}
        for face in _MC_FACES:
            for ei, ej in _face_pairings(face, inside):
                adj.setdefault(ei, []).append(ej)
                adj.setdefault(ej, []).append(ei)
        tris = []
        seen = set()
        for start in sorted(adj):
            if start in seen:
                continue
            loop = [start]
            seen.add(start)
            prev, cur = None, start
            while True:
                nxts = [e for e in adj[cur] if e != prev]
                nxt = nxts[0] if nxts else adj[cur][0]
                if nxt == start:
                    break
                loop.append(nxt)
                seen.add(nxt)
                prev, cur = cur, nxt
            for k in range(1, len(loop) - 1):
                tris.append((loop[0], loop[k], loop[k + 1]))
        maxt = max(maxt, len(tris))
        table.append(tris)
    out = -np.ones((256, maxt, 3), np.int64)
    for code, tris in enumerate(table):
        for k, t in enumerate(tris):
            out[code, k] = t
    return out


_MC_TABLE = _build_mc_table()
_MC_MAXT = _MC_TABLE.shape[1]


@functools.lru_cache(maxsize=None)
def _on(device: str, name: str) -> torch.Tensor:
    """A module-level table, uploaded to ``device`` once."""
    return torch.as_tensor(globals()[name], device=device)


def _cells(sub: torch.Tensor):
    """Corner values (C, 8) of every cell of a slab, cells in raster order,
    and the slab's cell-grid shape."""
    nx, ny, nz = sub.shape[0] - 1, sub.shape[1] - 1, sub.shape[2] - 1
    vals = torch.stack(
        [sub[o[0]: o[0] + nx, o[1]: o[1] + ny, o[2]: o[2] + nz].reshape(-1) for o in _CORNERS.tolist()], -1)
    return vals, (nx, ny, nz)


def _origins(active: torch.Tensor, shape) -> torch.Tensor:
    """(C', 3) int64 origins of the active cells, in raster order."""
    return torch.nonzero(active.reshape(shape))


def _cut_points(corner_pos: torch.Tensor, va, vb, a, b, level: float) -> torch.Tensor:
    """Iso-crossings along the edges a -> b: (T, E, 3) float32."""
    denom = vb - va
    t = torch.where(denom.abs() > 1e-12,
                    (level - va) / torch.where(denom == 0, torch.ones_like(denom), denom),
                    torch.full_like(denom, 0.5))
    t = t.clamp(0.0, 1.0)
    pa, pb = corner_pos[:, a], corner_pos[:, b]
    step = t[..., None] * (pb - pa)
    return pa + step


def cross_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product of (N, 3) rows with every product and difference a
    rounding of its own, as ``np.cross`` computes it (one fused kernel could
    contract them into multiply-adds)."""
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], -1)


def _emit(pts: torch.Tensor, te: torch.Tensor, g: torch.Tensor, x0: int, out: list) -> None:
    """Append the triangles ``te`` (T, 3) edge indices (-1: none) over the
    cut points ``pts`` (T, E, 3), wound against the gradient ``g`` (T, 3)
    float64 and moved to the slab's offset."""
    have = te[:, 0] >= 0
    if not bool(have.any()):
        return
    p = torch.gather(pts[have], 1, te[have][:, :, None].expand(-1, -1, 3))  # (M, 3, 3)
    n = cross_rows(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]).to(torch.float64)
    gh = g[have]
    dot = n[:, 0] * gh[:, 0]
    dot = dot + n[:, 1] * gh[:, 1]
    dot = dot + n[:, 2] * gh[:, 2]
    p = torch.where((dot > 0)[:, None, None], p.flip(1), p)
    shift = torch.zeros(3, dtype=torch.float32, device=p.device)
    shift[0] = float(x0)
    out.append((p + shift).reshape(-1, 3))


def _weld(all_tris: list, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge duplicate vertices (rounded at 1e-5) and drop degenerate faces."""
    if not all_tris:
        return (torch.zeros((0, 3), dtype=torch.float32, device=device),
                torch.zeros((0, 3), dtype=torch.int32, device=device))
    flat = torch.cat(all_tris)
    quant = torch.round(flat.to(torch.float64) * 1e5).to(torch.int64)
    uniq, inv = torch.unique(quant, dim=0, return_inverse=True)
    # divided by a tensor: a CUDA division by a Python scalar multiplies by
    # its reciprocal, which is not numpy's correctly rounded quotient
    verts = (uniq.to(torch.float64) / torch.tensor(1e5, dtype=torch.float64, device=uniq.device)).to(torch.float32)
    faces = inv.reshape(-1, 3).to(torch.int32)
    good = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    return verts, faces[good]


def marching_tetrahedra(grid, level: float = 0.5, slab: int = 64, *, device):
    """Extract the iso-surface of a 3D scalar grid at ``level``.

    Returns (vertices (N, 3) float32 in index space, faces (M, 3) int32), on
    ``device``.  Processes the grid in slabs along dim 0 to bound memory."""
    grid = torch.as_tensor(grid, device=device).to(torch.float32)
    dev = str(grid.device)
    corners, cases = _on(dev, "_CORNERS"), _on(dev, "_CASES")
    all_tris: list = []
    for x0 in range(0, grid.shape[0] - 1, slab):
        sub = grid[x0: min(x0 + slab + 1, grid.shape[0])]
        if sub.shape[0] - 1 <= 0:
            continue
        vals, shape = _cells(sub)
        inside8 = vals > level
        active = ~(inside8.all(1) | (~inside8).all(1))
        if not bool(active.any()):
            continue
        origins = _origins(active, shape)
        vals = vals[active]
        for tet in _TETS:
            tv = vals[:, tet.tolist()]  # (C, 4)
            inside = (tv > level).to(torch.int64)
            code = inside[:, 0] | (inside[:, 1] << 1) | (inside[:, 2] << 2) | (inside[:, 3] << 3)
            act = (code != 0) & (code != 15)
            if not bool(act.any()):
                continue
            o, v, c = origins[act], tv[act], code[act]
            corner_pos = (corners[tet.tolist()][None] + o[:, None, :]).to(torch.float32)
            # every edge oriented canonically (lexicographic corner position),
            # so cells sharing a cube edge compute the cut with identical
            # rounding and the weld always fuses it
            ga, gb = tet[_EDGES[:, 0]], tet[_EDGES[:, 1]]
            swap = np.array([tuple(_CORNERS[x]) > tuple(_CORNERS[y]) for x, y in zip(ga, gb)])
            a = np.where(swap, _EDGES[:, 1], _EDGES[:, 0]).tolist()
            b = np.where(swap, _EDGES[:, 0], _EDGES[:, 1]).tolist()
            pts = _cut_points(corner_pos, v[:, a], v[:, b], a, b, level)
            # constant gradient of the linear field inside the tet
            rel = (_CORNERS[tet[1:]] - _CORNERS[tet[0]]).astype(np.float64)
            minv_t = torch.as_tensor(np.linalg.inv(rel).T.copy(), device=grid.device)
            g = (v[:, 1:] - v[:, 0:1]).to(torch.float64) @ minv_t
            tris_e = cases[c]  # (T, 2, 3)
            for k in range(2):
                _emit(pts, tris_e[:, k], g, x0, all_tris)
    return _weld(all_tris, grid.device)


def marching_cubes(grid, level: float = 0.5, slab: int = 64, *, device):
    """Classic marching cubes (cube-edge vertices only, watertight).

    Same contract as :func:`marching_tetrahedra` and
    ``skimage.measure.marching_cubes``: vertices (N, 3) float32 in (d0, d1,
    d2) index space, faces (M, 3) int32, on ``device``.  Triangle winding is
    oriented against the cell-mean field gradient (outward for occupancy
    grids)."""
    grid = torch.as_tensor(grid, device=device).to(torch.float32)
    dev = str(grid.device)
    corners, table = _on(dev, "_CORNERS"), _on(dev, "_MC_TABLE")
    a, b = _MC_EDGES[:, 0].tolist(), _MC_EDGES[:, 1].tolist()
    all_tris: list = []

    def side(vals, cols):  # numpy sums a short row left to right
        return ((vals[:, cols[0]] + vals[:, cols[1]]) + vals[:, cols[2]]) + vals[:, cols[3]]

    for x0 in range(0, grid.shape[0] - 1, slab):
        sub = grid[x0: min(x0 + slab + 1, grid.shape[0])]
        if sub.shape[0] - 1 <= 0:
            continue
        vals, shape = _cells(sub)
        code = torch.zeros(vals.shape[0], dtype=torch.int64, device=grid.device)
        for v in range(8):
            code |= (vals[:, v] > level).to(torch.int64) << v
        active = (code != 0) & (code != 255)
        if not bool(active.any()):
            continue
        origins, vals, code = _origins(active, shape), vals[active], code[active]
        corner_pos = (corners[None] + origins[:, None, :]).to(torch.float32)
        pts = _cut_points(corner_pos, vals[:, a], vals[:, b], a, b, level)
        # cell-mean gradient for winding (central differences of corners)
        g = torch.stack([
            side(vals, (1, 2, 5, 6)) - side(vals, (0, 3, 4, 7)),
            side(vals, (2, 3, 6, 7)) - side(vals, (0, 1, 4, 5)),
            side(vals, (4, 5, 6, 7)) - side(vals, (0, 1, 2, 3)),
        ], -1).to(torch.float64)
        tris_e = table[code]  # (C, MAXT, 3)
        for k in range(_MC_MAXT):
            _emit(pts, tris_e[:, k], g, x0, all_tris)
    return _weld(all_tris, grid.device)
