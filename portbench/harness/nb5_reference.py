"""The plain reference of notebook 5's answers, in float64 numpy and scipy's
``cKDTree``.  It imports nothing of the program: from the clouds and the
mesh that a pass used, it recomputes what the pass reported.

* the pair table (reference ``utils/eval_helpers_inter.py``): each cloud
  subsampled without replacement by ``numpy.random.default_rng(seed)``
  (``seed`` for the first cloud, ``seed + 1`` for the second), as float32;
  the squared chamfer distance, the F-score at τ;
* the NN regularity: each point's distance to its nearest other point, their
  mean and population standard deviation;
* the surface metrics over k-nearest-neighbour vertex neighbourhoods: the
  spread of the vertex normals' angles, the smallest covariance eigenvalue
  (sample covariance), the distance to the neighbourhood's mean;
* the symmetric completion of the aligned SfM cloud (the z-mirror and the
  two quarter turns), against which each side that ICP aligns has to have
  moved, and the float64 ICPs from that completion (cKDTree
  correspondences, a Kabsch fit a step), whose gain in fit the program's
  have to reach;
* the clouds' making: the most points that lie within the threshold of a
  plane through three of the SfM cloud's points (RANSAC over triples drawn
  by numpy), against as many as the aligned cloud puts in one slab of z;
  the best rotation that takes the SfM cloud onto the aligned one, and how
  far that leaves a point; the grids' occupied voxels; the CAD samples'
  distance to the OBJ's triangles, their share of each of eight slices of
  equal area along each axis, and their ground;
* the clouds' normalisation (each shifted to its least corner, scaled by its
  largest extent, its top put at y = 0).

``dtype`` float64 is the reference; the control computes in bfloat16, one
precision below the program's float32.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial import cKDTree


def rodrigues_rotation(axis, angle: float) -> np.ndarray:
    """Rotation matrix about ``axis`` by ``angle`` (rad)."""
    a = np.asarray(axis, np.float64)
    a = a / (np.linalg.norm(a) + 1e-12)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def subsample(P: np.ndarray, n: int, seed: int) -> np.ndarray:
    """At most ``n`` points of ``P`` (float32), drawn without replacement."""
    P = np.asarray(P)
    if len(P) > n:
        P = P[np.random.default_rng(seed).choice(len(P), n, replace=False)]
    return P.astype(np.float32)


def _lower(x: np.ndarray, dtype) -> np.ndarray:
    """``x`` rounded to ``dtype`` (bfloat16 for the control), as float64."""
    if dtype == torch.float64:
        return np.asarray(x, np.float64)
    return torch.as_tensor(np.asarray(x, np.float64)).to(dtype).double().numpy()


def nn_dist(A: np.ndarray, B: np.ndarray, k: int = 1, *, dtype=torch.float64) -> np.ndarray:
    """Distances of the ``k`` nearest points of ``B`` to each point of ``A``
    ((N,) for k = 1, else (N, k))."""
    A, B = _lower(A, dtype), _lower(B, dtype)
    d, _ = cKDTree(B).query(A, k=k)
    return _lower(d, dtype)


def chamfer_f1(A, B, tau: float, max_points: int, seed: int, *, dtype=torch.float64):
    """(squared chamfer distance, F-score at ``tau``) of clouds A, B."""
    a, b = subsample(A, max_points, seed), subsample(B, max_points, seed + 1)
    dA, dB = nn_dist(a, b, dtype=dtype), nn_dist(b, a, dtype=dtype)
    prec, rec = float(np.mean(dA < tau)), float(np.mean(dB < tau))
    f1 = 0.0 if prec + rec == 0 else 2 * prec * rec / (prec + rec)
    return float(np.mean(dA * dA) + np.mean(dB * dB)), f1


def nn_stats(P, max_points: int = 50000, seed: int = 0, *, dtype=torch.float64):
    """(mean, population std) of each point's distance to its nearest other
    point."""
    p = subsample(P, max_points, seed)
    d = nn_dist(p, p, k=2, dtype=dtype)[:, 1]
    return float(d.mean()), float(d.std())


def surface_stats(verts, faces, k: int = 20, *, dtype=torch.float64):
    """(normal angle spread in degrees, roughness, curvature) of a mesh, each
    a mean over its vertices."""
    v = _lower(np.asarray(verts, np.float32), dtype)
    f = np.asarray(faces, np.int64)
    v0, v1, v2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    n = np.cross(v1 - v0, v2 - v0)
    n = n / (np.linalg.norm(n, axis=1, keepdims=True) + 1e-8)
    vn = np.zeros_like(v)
    np.add.at(vn, f.reshape(-1), np.repeat(n, 3, axis=0))
    vn = vn / (np.linalg.norm(vn, axis=1, keepdims=True) + 1e-8)
    _, idx = cKDTree(v).query(v, k=k)
    nbr, nbr_n = v[idx], vn[idx]
    ang = np.degrees(np.arccos(np.clip((nbr_n * vn[:, None, :]).sum(-1), -1.0, 1.0)))
    centred = nbr - nbr.mean(1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centred, centred) / (k - 1)
    rough = np.linalg.eigvalsh(cov)[:, 0]
    curv = np.linalg.norm(nbr.mean(1) - v, axis=1)
    return float(_lower(ang.std(1), dtype).mean()), float(rough.mean()), float(curv.mean())


def symmetric_completion(front: np.ndarray) -> dict:
    """The naive 4-way completion of the reference (notebook 5, L67-96):
    back is the z-mirror about the z mid-plane; left and right are the
    +-90 degree turns about y through the cloud's centre, each then mirrored
    in x."""
    front = np.asarray(front, np.float64)
    center = front.mean(0)
    z_mid = (front[:, 2].min() + front[:, 2].max()) / 2.0
    back = front.copy()
    back[:, 2] = 2 * z_mid - back[:, 2]

    def spin(sign):
        p = (front - center) @ rodrigues_rotation([0.0, 1.0, 0.0], sign * np.pi / 2).T
        p[:, 0] = -p[:, 0]
        return p + center

    return {"front": front, "back": back, "left": spin(1.0), "right": spin(-1.0)}


def split_completed(completed: np.ndarray) -> dict:
    """The program's completed cloud, the concatenation of front, back,
    left and right, of one size each, back into its sides."""
    c = np.asarray(completed, np.float64)
    n = len(c) // 4
    return {"front": c[:n], "back": c[n:2 * n], "left": c[2 * n:3 * n], "right": c[3 * n:]}


def sides_unmoved(sparse: np.ndarray, completed: np.ndarray, tol: float = 1e-9) -> tuple:
    """(how many of the three sides that ICP aligns (back, left, right) lie
    where the symmetric completion put them, to ``tol``; the least move of
    a side, its largest coordinate move).  A sound ICP moves each side by
    at least its first Kabsch step."""
    start, got = symmetric_completion(sparse), split_completed(completed)
    moves = [float(np.abs(got[k] - start[k]).max()) for k in ("back", "left", "right")]
    return sum(m <= tol for m in moves), min(moves)


# ---- the clouds -----------------------------------------------------------------------------

def normalize(points, *, dtype=torch.float64) -> np.ndarray:
    """(p - min) / (largest extent + 1e-8), then y shifted so its max is 0."""
    p = torch.as_tensor(_lower(points, dtype)).to(dtype)
    mn = p.amin(0)
    out = (p - mn) / ((p.amax(0) - mn).amax() + 1e-8)
    out[:, 1] -= out[:, 1].amax()
    return out.double().numpy()


def occupied_points(npz_path) -> np.ndarray:
    """A voxel-grid artifact's occupied voxels (any colour channel above 0,
    or a label above 0) as (x, y, z) = (d2, d1, d0), in raster order; float64."""
    with np.load(npz_path) as f:
        g = f["voxel_grid"]
    occ = np.any(g > 0, axis=-1) if g.ndim == 4 else g > 0
    d0, d1, d2 = np.nonzero(occ)
    return np.stack([d2, d1, d0], 1).astype(np.float64)


def points_gap(got, want) -> float:
    """Largest coordinate gap of two clouds of one size; inf where the sizes
    differ."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return float("inf")
    return float(np.abs(got - want).max()) if len(want) else 0.0


def _plane_counts(p: np.ndarray, triples: np.ndarray, thresh: float, dtype) -> tuple:
    """(unit normals (C, 3), inlier counts (C,)) of the planes through the
    ``triples`` of ``p``, computed in ``dtype``; degenerate triples count -1."""
    P = torch.as_tensor(_lower(p, dtype)).to(dtype)
    tri = P[torch.as_tensor(triples)]
    n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    norm = torch.linalg.vector_norm(n.double(), dim=1)
    n = (n.double() / norm.clamp_min(1e-300)[:, None]).to(dtype)
    d = -(n * tri[:, 0]).sum(1)
    counts = torch.empty(len(triples), dtype=torch.int64)
    step = max(1, (1 << 24) // max(1, len(P)))
    for c0 in range(0, len(triples), step):
        dist = (P @ n[c0:c0 + step].T + d[c0:c0 + step]).abs()
        counts[c0:c0 + step] = (dist < thresh).sum(0)
    counts[norm <= 1e-12] = -1
    return n.double().numpy(), counts.numpy()


def plane_fit(points, thresh: float = 0.01, iterations: int = 1000, seed: int = 0, *,
              dtype=torch.float64) -> tuple:
    """RANSAC: (unit normal, inlier count) of the plane through three points
    of ``points`` with the most points within ``thresh``, over
    ``iterations`` triples drawn by ``numpy.random.default_rng(seed)``."""
    p = np.asarray(points, np.float64)
    triples = np.random.default_rng(seed).integers(0, len(p), (iterations, 3))
    normals, counts = _plane_counts(p, triples, thresh, dtype)
    best = int(np.argmax(counts))
    return normals[best], int(counts[best])


def slab_inliers(points, thresh: float = 0.01) -> int:
    """The most points within ``thresh`` of one plane z = c (any c)."""
    z = np.sort(np.asarray(points, np.float64)[:, 2])
    return int((np.searchsorted(z, z + 2 * thresh, side="left") - np.arange(len(z))).max()) if len(z) else 0


def rotation_to_z(normal) -> np.ndarray:
    """The rotation that takes ``normal`` (or its opposite, whichever has
    z >= 0) onto +z, about their common perpendicular."""
    n = np.asarray(normal, np.float64)
    n = n / np.linalg.norm(n)
    n = -n if n[2] < 0 else n
    axis = np.cross(n, [0.0, 0.0, 1.0])
    s = np.linalg.norm(axis)
    return np.eye(3) if s < 1e-12 else rodrigues_rotation(axis / s, float(np.arctan2(s, n[2])))


def align_to_z(points, normal, *, dtype=torch.float64) -> np.ndarray:
    """``points`` turned so that ``normal`` points along +z, in ``dtype``."""
    p = torch.as_tensor(_lower(points, dtype)).to(dtype)
    R = torch.as_tensor(_lower(rotation_to_z(normal), dtype)).to(dtype)
    return (p @ R.T).double().numpy()


def rigid_gap(src, dst) -> float:
    """How far the best rotation about the origin (Kabsch) of ``src`` leaves
    a point from ``dst``: the largest distance; inf where the sizes differ."""
    a, b = np.asarray(src, np.float64), np.asarray(dst, np.float64)
    if a.shape != b.shape:
        return float("inf")
    U, _, Vt = np.linalg.svd(a.T @ b)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ D @ U.T
    return float(np.linalg.norm(b - a @ R.T, axis=1).max())


def truncated_mse(P, Q, max_corr: float = 0.05) -> float:
    """Mean over the points of ``P`` of min(distance to ``Q``, max_corr)^2."""
    # points farther than max_corr read inf and count as max_corr; the bound
    # keeps a query of far points short
    d, _ = cKDTree(np.asarray(Q, np.float64)).query(np.asarray(P, np.float64), k=1, distance_upper_bound=max_corr)
    return float((np.minimum(d, max_corr) ** 2).mean())


def icp(P, Q, max_corr: float = 0.05, iterations: int = 30, tol: float = 1e-7) -> np.ndarray:
    """Point-to-point ICP of ``P`` onto ``Q`` in float64 (cKDTree
    correspondences within ``max_corr``, a Kabsch fit a step), stopping after
    ``iterations`` steps or when the correspondences' mean squared distance
    changes by under ``tol``; the aligned ``P``."""
    P, Q = np.asarray(P, np.float64).copy(), np.asarray(Q, np.float64)
    tree, prev = cKDTree(Q), np.inf
    for _ in range(iterations):
        d, idx = tree.query(P, k=1, distance_upper_bound=max_corr)
        keep = d < max_corr
        if keep.sum() < 3:
            break
        A, B = P[keep], Q[idx[keep]]
        ca, cb = A.mean(0), B.mean(0)
        U, _, Vt = np.linalg.svd((A - ca).T @ (B - cb))
        R = Vt.T @ U.T
        if np.linalg.det(R) < 0:
            Vt[-1] *= -1
            R = Vt.T @ U.T
        P = P @ R.T + (cb - R @ ca)
        err = float((d[keep] ** 2).mean())
        if abs(prev - err) < tol:
            break
        prev = err
    return P


def icp_gains(start: dict, left, right, back) -> float:
    """How much the three ordered ICPs (left and right onto the front, back
    onto the aligned left) lowered the sides' truncated mean squared
    distance to their targets, summed."""
    front = start["front"]
    return ((truncated_mse(start["left"], front) - truncated_mse(left, front))
            + (truncated_mse(start["right"], front) - truncated_mse(right, front))
            + (truncated_mse(start["back"], left) - truncated_mse(back, left)))


def icp_gain_shortfall(sparse, completed) -> float:
    """1 - (the program's ICP gains) / (the reference's float64 ICP gains
    from the same symmetric completion of the program's aligned SfM cloud)."""
    start, got = symmetric_completion(sparse), split_completed(completed)
    left = icp(start["left"], start["front"])
    want = icp_gains(start, left, icp(start["right"], start["front"]), icp(start["back"], left))
    return 1.0 - icp_gains(start, got["left"], got["right"], got["back"]) / want if want > 0 else float("inf")


# ---- the CAD surface samples ----------------------------------------------------------------

#: The notebook's CAD axes: (x, y, z) -> (x, z, y); y is then negated.
CAD_AXIS_SWAP = np.array([[1, 0, 0], [0, 0, 1], [0, 1, 0]], np.float64)


def read_obj(path) -> tuple:
    """(vertices (V, 3) float64, triangles (F, 3) int64, 0-based) of a
    Wavefront OBJ of triangles, ``v x y z`` and ``f a b c`` lines."""
    verts, faces = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                verts.append(line[2:])
            elif line.startswith("f "):
                faces.append(" ".join(t.split("/")[0] for t in line[2:].split()))
    v = np.loadtxt(verts, dtype=np.float64, ndmin=2)
    f = np.loadtxt(faces, dtype=np.int64, ndmin=2) - 1
    return v, f


def cad_frame(verts) -> np.ndarray:
    """The OBJ's vertices in the notebook's frame: axes swapped, y negated."""
    v = np.asarray(verts, np.float64) @ CAD_AXIS_SWAP.T
    v[:, 1] = -v[:, 1]
    return v


def _segment_dist(p, a, b):
    ab = b - a
    t = np.clip(((p - a) * ab).sum(-1) / np.maximum((ab * ab).sum(-1), 1e-300), 0.0, 1.0)
    return np.linalg.norm(p - (a + t[..., None] * ab), axis=-1)


def triangle_dist(p, a, b, c):
    """Distance of each point ``p`` (..., 3) to the triangle (a, b, c)."""
    v0, v1, v2 = b - a, c - a, p - a
    d00, d01, d11 = (v0 * v0).sum(-1), (v0 * v1).sum(-1), (v1 * v1).sum(-1)
    d20, d21 = (v2 * v0).sum(-1), (v2 * v1).sum(-1)
    den = d00 * d11 - d01 * d01
    ok = den > 1e-300
    safe = np.where(ok, den, 1.0)
    v = (d11 * d20 - d01 * d21) / safe
    w = (d00 * d21 - d01 * d20) / safe
    inside = ok & (v >= 0) & (w >= 0) & (v + w <= 1)
    n = np.cross(v0, v1)
    plane = np.abs((v2 * n).sum(-1)) / np.sqrt(np.maximum((n * n).sum(-1), 1e-300))
    edges = np.minimum(np.minimum(_segment_dist(p, a, b), _segment_dist(p, b, c)), _segment_dist(p, c, a))
    return np.where(inside, plane, edges)


class Mesh:
    """A triangle mesh and a k-d tree of its triangles' centroids."""

    def __init__(self, verts, faces):
        self.verts = np.asarray(verts, np.float64)
        self.faces = np.asarray(faces, np.int64)
        self.tri = self.verts[self.faces]
        centroids = self.tri.mean(1)
        self.tree = cKDTree(centroids)
        # a point of a triangle lies within this of the triangle's centroid
        self.reach = float(np.linalg.norm(self.tri - centroids[:, None], axis=-1).max()) if len(self.tri) else 0.0

    def distance(self, points, k: int = 32, chunk: int = 8192) -> tuple:
        """(distance of each point to the mesh, the triangle it is nearest),
        over the ``k`` triangles whose centroids lie nearest to it."""
        P = np.asarray(points, np.float64)
        k = min(k, len(self.tri))
        _, near = self.tree.query(P, k=k)
        near = near.reshape(len(P), k)
        dist, which = np.empty(len(P)), np.empty(len(P), np.int64)
        for i in range(0, len(P), chunk):
            t = self.tri[near[i:i + chunk]]
            d = triangle_dist(P[i:i + chunk, None, :], t[..., 0, :], t[..., 1, :], t[..., 2, :])
            j = d.argmin(1)
            dist[i:i + chunk] = d[np.arange(len(j)), j]
            which[i:i + chunk] = near[i:i + chunk][np.arange(len(j)), j]
        return dist, which


def ground_shift(samples, mesh: Mesh, lowest: int = 8, probe: int = 512) -> float:
    """The shift along y that puts the samples back on the mesh.  Each of
    the ``lowest`` samples lies on a triangle that the vertical line through
    it meets; of the shifts to the triangles those lines meet, the one that
    leaves ``probe`` samples (a fixed spread of them) nearest the mesh."""
    S = np.asarray(samples, np.float64)
    a, b, c = mesh.tri[:, 0], mesh.tri[:, 1], mesh.tri[:, 2]
    e1, e2 = (b - a)[:, [0, 2]], (c - a)[:, [0, 2]]
    den = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    ok = np.abs(den) > 1e-12
    safe = np.where(ok, den, 1.0)
    shifts = []
    for s in S[np.argsort(S[:, 1], kind="stable")[:lowest]]:
        # barycentric coordinates of (s.x, s.z) in each triangle's (x, z) shadow
        q = s[[0, 2]] - a[:, [0, 2]]
        v = (q[:, 0] * e2[:, 1] - q[:, 1] * e2[:, 0]) / safe
        w = (e1[:, 0] * q[:, 1] - e1[:, 1] * q[:, 0]) / safe
        hit = ok & (v >= -1e-9) & (w >= -1e-9) & (v + w <= 1 + 1e-9)
        shifts.append(s[1] - (a[:, 1] + v * (b - a)[:, 1] + w * (c - a)[:, 1])[hit])
    shifts = np.unique(np.round(np.concatenate(shifts), 9))
    sub = S[np.linspace(0, len(S) - 1, min(probe, len(S))).astype(np.int64)]
    best, best_off = float("nan"), np.inf
    for shift in shifts:
        moved = sub - [0.0, shift, 0.0]
        # most probes of a wrong shift have no centroid within reach; a bound
        # query of them is short
        near, _ = mesh.tree.query(moved, k=1, distance_upper_bound=mesh.reach)
        if not np.isfinite(np.median(near)):
            continue
        off = float(np.median(mesh.distance(moved, k=8)[0]))
        if off < best_off:
            best, best_off = float(shift), off
    return best


def coverage_gap(which, mesh: Mesh, n: int, groups: int = 8) -> float:
    """How far the samples' counts stray from an area-weighted draw of ``n``:
    the triangles sorted along each axis by their centroids and cut into
    ``groups`` slices of equal area; the largest |count - expected| /
    expected over the slices of the three axes."""
    tri = mesh.tri
    area = 0.5 * np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    cent = tri.mean(1)
    worst = 0.0
    for axis in range(3):
        order = np.argsort(cent[:, axis], kind="stable")
        cum = np.cumsum(area[order]) - area[order] / 2
        g = np.empty(len(tri), np.int64)
        g[order] = np.minimum(groups - 1, (groups * cum / area.sum()).astype(np.int64))
        expected = n * np.bincount(g, weights=area, minlength=groups) / area.sum()
        count = np.bincount(g[np.asarray(which, np.int64)], minlength=groups)
        worst = max(worst, float((np.abs(count - expected) / np.maximum(expected, 1e-300)).max()))
    return worst


def sample_surface(verts, faces, n: int, seed: int, *, dtype=torch.float64) -> np.ndarray:
    """``n`` area-weighted uniform samples of the mesh's surface, from
    ``numpy.random.default_rng(seed)``, the points made in ``dtype``."""
    rng = np.random.default_rng(seed)
    tri = np.asarray(verts, np.float64)[np.asarray(faces, np.int64)]
    area = np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    pick = rng.choice(len(tri), n, p=area / area.sum())
    u, v = rng.random((n, 1)), rng.random((n, 1))
    flip = u + v > 1
    u, v = np.where(flip, 1 - u, u), np.where(flip, 1 - v, v)
    t = torch.as_tensor(_lower(tri[pick], dtype)).to(dtype)
    uu, vv = torch.as_tensor(u).to(dtype), torch.as_tensor(v).to(dtype)
    return (t[:, 0] + uu * (t[:, 1] - t[:, 0]) + vv * (t[:, 2] - t[:, 0])).double().numpy()

