"""Inter-method data preparation (notebook 5): SfM cloud alignment, symmetric
completion, ICP, as in ``pbr3d.eval.preprocess`` (the re-design of the
reference's Open3D pipeline; method documented in
results/4.Inter-method_3D/README.md:28-46).

Steps (reference bytecode L32-L120):
1. load sparse + dense COLMAP PLYs; crop dense to the sparse bbox;
2. RANSAC facade-plane fit on the sparse cloud (dist 0.01, 3 points,
   1000 iters) + Rodrigues rotation aligning the plane normal to +Z;
3. naive 4-way symmetric completion: back = z-mirror about z-mid; left/right
   = ±90° y-spins about the cloud center with an x-mirror;
4. ordered point-to-point ICP refinement (Left->Front, Right->Front,
   Back->Left; max correspondence distance 0.05);
5. load the carved voxel grid; load the CAD OBJ, swap axes
   [[1,0,0],[0,0,1],[0,1,0]], sample 50k surface points, flip y, align
   ground planes (min-y).

RANSAC scores all candidate planes in one device pass, ICP's
correspondences come from the k-nearest-neighbour kernel, and the rigid
estimate is a Kabsch SVD.  Clouds are float64 tensors on ``device``; the
point-plane distances are explicit products (never a TF32 matmul), the 3x3
Kabsch work and the small rotation matrices are float64.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from pbr3d_torch.io.artifacts import load_voxel_grid_labels
from pbr3d_torch.io.pointcloud import load_obj, load_ply, sample_mesh_surface
from pbr3d_torch.ops.isosurface import cross_rows
from pbr3d_torch.ops.neighbors import knn
from pbr3d_torch.utils import profiling


def _f64(points, device) -> torch.Tensor:
    return torch.as_tensor(points, device=device).to(torch.float64)


def flip_y_axis(points, *, device) -> torch.Tensor:
    """Negate y (recovered reference L12-17)."""
    p = _f64(points, device).clone()
    p[:, 1] = -p[:, 1]
    return p


def rodrigues_rotation(axis, angle: float) -> np.ndarray:
    """Rotation matrix about ``axis`` by ``angle`` (rad); host float64."""
    a = np.asarray(axis, np.float64)
    a = a / (np.linalg.norm(a) + 1e-12)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


#: Candidate planes scored at once: bounds the (points, candidates) temporary.
_RANSAC_PAIRS = 1 << 26


def _ransac_plane_scores(pts: torch.Tensor, triples: torch.Tensor, dist_thresh: float):
    """(normals (C, 3), d (C,), inlier counts (C,)) of the planes through the
    candidate ``triples`` (C, 3) of point indices, for float32 ``pts``
    (N, 3).  Degenerate (collinear) triples score -1."""
    tri = pts[triples]  # (C, 3, 3)
    normals = cross_rows(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    norms = torch.linalg.norm(normals, dim=1, keepdim=True)
    normals = normals / norms.clamp_min(1e-12)
    d = -(normals * tri[:, 0]).sum(dim=1)
    inliers = torch.empty(len(triples), dtype=torch.int64, device=pts.device)
    step = max(1, _RANSAC_PAIRS // max(1, len(pts)))
    px, py, pz = (pts[:, c][:, None] for c in range(3))
    for c0 in range(0, len(triples), step):
        n = normals[c0: c0 + step]
        # three explicit float32 products: the point-plane distance is held
        # against a 0.01 threshold
        dist = (px * n[:, 0][None] + py * n[:, 1][None] + pz * n[:, 2][None] + d[c0: c0 + step][None]).abs()
        inliers[c0: c0 + step] = (dist < dist_thresh).sum(dim=0)
    inliers = torch.where(norms[:, 0] > 1e-9, inliers, torch.full_like(inliers, -1))
    return normals, d, inliers


def segment_plane(
    points,
    distance_threshold: float = 0.01,
    num_iterations: int = 1000,
    seed: int = 0,
    triples=None,
    *,
    device,
) -> Tuple[np.ndarray, torch.Tensor]:
    """RANSAC plane fit; returns ((a,b,c,d) host float64, inlier index tensor).

    Open3D's ``segment_plane`` contract (3-point minimal sets, inlier count
    scoring), all candidates scored on the device.  ``triples``
    (num_iterations, 3) gives the candidate index triples; by default they
    are drawn from a ``torch.Generator`` seeded with ``seed``."""
    p64 = _f64(points, device)
    pts = p64.to(torch.float32)
    if triples is None:
        gen = torch.Generator().manual_seed(seed)
        triples = torch.randint(0, len(pts), (num_iterations, 3), generator=gen)
    triples = torch.as_tensor(np.asarray(triples), device=device).to(torch.int64)
    normals, d, inliers = _ransac_plane_scores(pts, triples, distance_threshold)
    best = int(torch.argmax(inliers))
    n = normals[best].to(torch.float64)
    dd = float(d[best])
    dist = (p64[:, 0] * n[0] + p64[:, 1] * n[1] + p64[:, 2] * n[2] + dd).abs()
    idx = torch.nonzero(dist < distance_threshold)[:, 0]
    n = n.cpu().numpy()
    return np.array([n[0], n[1], n[2], dd]), idx


def align_plane_to_z(points, plane: np.ndarray, *, device) -> torch.Tensor:
    """Rotate so the plane normal maps to +Z (Rodrigues, reference L52-60)."""
    plane = np.asarray(plane, np.float64)
    n = plane[:3] / np.linalg.norm(plane[:3])
    if n[2] < 0:
        n = -n
    target = np.array([0.0, 0.0, 1.0])
    axis = np.cross(n, target)
    s = np.linalg.norm(axis)
    p = _f64(points, device)
    if s < 1e-12:
        return p.clone()
    angle = float(np.arctan2(s, np.dot(n, target)))
    R = rodrigues_rotation(axis / s, angle)
    return p @ torch.as_tensor(R.T.copy(), device=device)


def icp_point_to_point(
    source,
    target,
    max_correspondence_distance: float = 0.05,
    max_iterations: int = 30,
    tol: float = 1e-7,
    *,
    device,
) -> Tuple[torch.Tensor, np.ndarray]:
    """Rigid point-to-point ICP (Open3D ``registration_icp`` equivalent).

    Returns (aligned source points, float64 tensor on ``device``; 4x4
    transform, host float64).  Correspondences are float32 nearest
    neighbours; the Kabsch estimate is float64."""
    src = _f64(source, device).clone()
    tgt = _f64(target, device)
    tgt32 = tgt.to(torch.float32).contiguous()
    T = np.eye(4)
    prev_err = np.inf
    for _ in range(max_iterations):
        d, idx = knn(src.to(torch.float32), tgt32, 1, device=device)
        d, idx = d[:, 0], idx[:, 0]
        keep = d < max_correspondence_distance
        if int(keep.sum()) < 3:
            break
        P = src[keep]
        Q = tgt[idx[keep]]
        cp, cq = P.mean(0), Q.mean(0)
        H = ((P - cp).T @ (Q - cq)).cpu().numpy()
        U, _, Vt = np.linalg.svd(H)
        R = Vt.T @ U.T
        if np.linalg.det(R) < 0:
            Vt[-1] *= -1
            R = Vt.T @ U.T
        t = cq.cpu().numpy() - R @ cp.cpu().numpy()
        src = src @ torch.as_tensor(R.T.copy(), device=device) + torch.as_tensor(t, device=device)
        Ti = np.eye(4)
        Ti[:3, :3] = R
        Ti[:3, 3] = t
        T = Ti @ T
        dk = d[keep]
        err = float((dk * dk).mean())
        if abs(prev_err - err) < tol:
            break
        prev_err = err
    return src, T


def symmetric_completion(front, *, device) -> Dict[str, torch.Tensor]:
    """Naive 4-way symmetric completion (reference L67-96):
    back = z-mirror about z-mid; left/right = ±90° y-spins about the cloud
    center composed with an x-mirror."""
    front = _f64(front, device)
    center = front.mean(0)
    z_mid = (front[:, 2].amin() + front[:, 2].amax()) / 2.0

    back = front.clone()
    back[:, 2] = 2 * z_mid - back[:, 2]

    def spin(sign):
        R = rodrigues_rotation(np.array([0.0, 1.0, 0.0]), sign * np.pi / 2)
        p = (front - center) @ torch.as_tensor(R.T.copy(), device=device)
        p[:, 0] = -p[:, 0]  # x-mirror
        return p + center

    return {"front": front, "back": back, "left": spin(+1.0), "right": spin(-1.0)}


def ground_align_y(points, reference, *, device) -> torch.Tensor:
    """Shift so min-y matches the reference cloud's min-y (reference L110+)."""
    p = _f64(points, device).clone()
    p[:, 1] += _f64(reference, device)[:, 1].amin() - p[:, 1].amin()
    return p


CAD_AXIS_SWAP = np.array([[1, 0, 0], [0, 0, 1], [0, 1, 0]], np.float64)


def build_taj_clouds(
    root: str | Path,
    sparse_ply: str = "segmented_point_cloud_final.ply",
    dense_ply: str = "fused.ply",
    voxel_npz: str = "Taj_voxel_grid.npz",
    cad_obj: str = "synthetic_taj.obj",
    cad_samples: int = 50000,
    seed: int = 0,
    triples=None,
    *,
    device,
) -> Dict[str, torch.Tensor]:
    """Assemble the notebook-5 comparison clouds (reference L67-L120).

    Inputs missing from disk are skipped (the reference snapshot itself lacks
    ``fused.ply`` and ``synthetic_taj.obj``).  Returns a dict of float64
    point clouds on ``device``; keys follow the reference: "Sparse", "Dense
    (Cropped)", "Completed (ICP Aligned)", "Carved Grid", "Synthetic".
    ``triples`` is handed to :func:`segment_plane`."""
    with profiling.trace("clouds"):
        root = Path(root)
        out: Dict[str, torch.Tensor] = {}

        sparse = load_ply(root / sparse_ply)["points"]
        with profiling.span("clouds.plane_fit"):
            plane, _ = segment_plane(sparse, 0.01, 1000, seed, triples, device=device)
        with profiling.span("clouds.align"):
            sparse = align_plane_to_z(sparse, plane, device=device)
        out["Sparse"] = sparse

        if (root / dense_ply).exists():
            dense = _f64(load_ply(root / dense_ply)["points"], device)
            lo, hi = sparse.amin(0), sparse.amax(0)
            dense = dense[((dense >= lo) & (dense <= hi)).all(dim=1)]
            with profiling.span("clouds.align"):
                out["Dense (Cropped)"] = align_plane_to_z(dense, plane, device=device)

        # 4-way symmetric completion + ordered ICP (L->F, R->F, B->L)
        with profiling.span("clouds.complete"):
            sides = symmetric_completion(sparse, device=device)
        with profiling.span("clouds.icp", side="left"):
            left, _ = icp_point_to_point(sides["left"], sides["front"], 0.05, device=device)
        with profiling.span("clouds.icp", side="right"):
            right, _ = icp_point_to_point(sides["right"], sides["front"], 0.05, device=device)
        with profiling.span("clouds.icp", side="back"):
            back, _ = icp_point_to_point(sides["back"], left, 0.05, device=device)
        out["Completed (ICP Aligned)"] = torch.cat([sides["front"], back, left, right])

        if (root / voxel_npz).exists():
            if torch.device(device).type == "cuda":  # inflated in steps, decoded on the card
                grid = load_voxel_grid_labels(root / voxel_npz, device=device)
            else:
                grid = torch.as_tensor(load_voxel_grid_labels(root / voxel_npz), device=device)
            d0, d1, d2 = torch.nonzero(grid > 0, as_tuple=True)
            out["Carved Grid"] = torch.stack([d2, d1, d0], 1).to(torch.float64)

        if (root / cad_obj).exists():
            verts, faces = load_obj(root / cad_obj)
            verts = verts @ CAD_AXIS_SWAP.T
            with profiling.span("clouds.cad_sample"):
                pts = sample_mesh_surface(verts, faces, cad_samples, seed)
            pts = flip_y_axis(pts, device=device)
            with profiling.span("clouds.ground"):
                out["Synthetic"] = ground_align_y(pts, out["Completed (ICP Aligned)"], device=device)

    return out
