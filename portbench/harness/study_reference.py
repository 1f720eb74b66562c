"""The plain reference of the study's answers, in float64 PyTorch and numpy.

It imports nothing of the program and takes no table or weight that the
program made: it recomputes, from the inputs of each answer, what the answer
says.

* the pinhole camera of the reference (``utils/camera_geometry.py:3-27``):
  9 numbers (cam_pos, target, f, cx, cy), up (0, 1, 0), or (0, 0, 1) when the
  view direction is (anti)parallel to it; ``u = X/Z f + cx``,
  ``v = -Y/Z f + cy`` with Z clamped to 1e-8;
* the splat (``utils/projection_utils.py:5-23``): pixels rounded half to
  even, points outside the plane or not valid dropped, the last point wins a
  pixel; the colour-exact IoU per part and its mean
  (``utils/camera_estimation.py:770-788``);
* the z-buffer (``utils/eval_helpers_intra.py:134-160``): per pixel the
  least camera Z of the points with Z > 1e-6, a voxel at (x, y, z) =
  (d2, d1, d0); a part is visible where its least Z is within 1e-3 of every
  other part's (the notebook-4 visible IoU, ``:168-190``);
* the keypoint fit's loss (``utils/camera_estimation.py``): the sum of the
  squared (L2) or smoothed absolute (L1) pixel residuals of the masked
  keypoints;
* the three gates of ``bench.py:72-136``.

``dtype`` is float64 for the reference and bfloat16 for the control (the
reference computed one precision below the program's float32).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

#: Label ids (reference ``utils/config.py:29-40``: the colour order, 1-based,
#: 0 empty, 10 background).
PART_IDS = {"full_building": 1, "chhatris": 2, "plinth": 3, "dome": 4, "front_minarets": 5,
            "back_minarets": 6, "small_minarets": 7, "main_door": 8, "windows": 9}
#: The searched parts of the notebook-4 table (``eval_helpers_intra.py:564``).
NB4_PARTS = ("dome", "chhatris", "main_door", "windows", "plinth")
VIS_EPS = 1e-3
Z_VALID_MIN = 1e-6
Z_CLAMP = 1e-8
#: ``np.isclose(a, 1.0)``'s bound, for the degenerate up vector.
ISCLOSE_TOL = 1e-8 + 1e-5
#: The gates (``bench.py:72-74``).
STAGE1_IOU_MIN = 0.92
STAGE3_WHOLE_IOU_MIN = 0.80
STAGE3_MEAN_PART_IOU_MIN = 0.50


def cam_vector(cam: dict) -> np.ndarray:
    """(9,) float64 of a camera dict's float32 numbers."""
    return np.concatenate([np.asarray(cam["cam_pos"], np.float32).ravel(),
                           np.asarray(cam["target"], np.float32).ravel(),
                           np.asarray([cam["f"], cam["cx"], cam["cy"]], np.float32)]).astype(np.float64)


def rotation(eye: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """World-to-camera rows (x, y, z axes) ``(..., 3, 3)``."""
    z = target - eye
    z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
    degenerate = ((z[..., 1].abs() - 1.0).abs() <= ISCLOSE_TOL)[..., None]
    up = torch.zeros_like(z)
    up[..., 1] = 1.0
    alt = torch.zeros_like(z)
    alt[..., 2] = 1.0
    up = torch.where(degenerate, alt, up)
    x = torch.linalg.cross(up, z, dim=-1)
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-2)


def project(pts: torch.Tensor, cams: torch.Tensor):
    """(u, v, Z) ``(..., N)`` of points ``(..., N, 3)`` under cameras
    ``(..., 9)``, in the dtype of both."""
    R = rotation(cams[..., 0:3], cams[..., 3:6])
    d = pts - cams[..., None, 0:3]
    X, Y, Z = (torch.einsum("...nj,...j->...n", d, R[..., r, :]) for r in range(3))
    Zc = Z.clamp_min(Z_CLAMP)
    u = X / Zc * cams[..., 6, None] + cams[..., 7, None]
    v = -(Y / Zc) * cams[..., 6, None] + cams[..., 8, None]
    return u, v, Z


def _pixels(u, v, ok, H: int, W: int, Ht, Wt):
    """Flat pixel index of each projection, ``H * W`` for the dropped ones."""
    ur, vr = torch.round(u), torch.round(v)
    ok = ok & (ur >= 0) & (ur < Wt) & (vr >= 0) & (vr < Ht)
    pix = torch.where(ok, vr.clamp(0, H - 1).long() * W + ur.clamp(0, W - 1).long(), H * W)
    return pix, ok


# --------------------------------------------------------------------------- stage 2


def splat_mean_iou(cams, pts, labels, valid, gt, part_ids, hw=None, *, dtype=torch.float64,
                   chunk: int = 16) -> torch.Tensor:
    """(V, P) float64 mean part IoU of the splat of each view's points under
    each of its P cameras against the view's ground truth; the arguments as
    the program's ``splat_iou`` call takes them (``cams (V, P, 9)``, ``pts
    (V, N, 3)``, ``labels``/``valid (V, N)``, ``gt (V, H, W)``, ``hw (V, 2)``
    or None)."""
    V, P = cams.shape[:2]
    N = pts.shape[1]
    H, W = gt.shape[1:]
    ids = torch.as_tensor([int(i) for i in np.asarray(part_ids).reshape(-1)], device=gt.device)
    out = torch.empty((V, P), dtype=torch.float64, device=gt.device)
    order = torch.arange(N, device=gt.device)
    for v in range(V):
        Ht, Wt = (H, W) if hw is None else (int(hw[v, 0]), int(hw[v, 1]))
        ok0 = torch.ones(N, dtype=torch.bool, device=gt.device) if valid is None else valid[v].bool()
        g = gt[v].reshape(-1).long()
        gk = g[None, :] == ids[:, None]  # (K, HW)
        for p0 in range(0, P, chunk):
            c = cams[v, p0:p0 + chunk].to(dtype)
            u, vv, _ = project(pts[v].to(dtype)[None].expand(c.shape[0], N, 3), c)
            pix, ok = _pixels(u, vv, ok0[None], H, W, Ht, Wt)
            seg = pix + torch.arange(c.shape[0], device=gt.device)[:, None] * (H * W + 1)
            win = torch.full((c.shape[0] * (H * W + 1),), -1, dtype=torch.long, device=gt.device)
            win.scatter_reduce_(0, seg.reshape(-1), torch.where(ok, order[None], -1).reshape(-1), "amax")
            win = win.view(c.shape[0], H * W + 1)[:, : H * W]
            img = torch.where(win >= 0, labels[v].long()[win.clamp_min(0)], 0)  # (c, HW)
            pk = img[:, None, :] == ids[None, :, None]  # (c, K, HW)
            inter = (pk & gk[None]).sum(-1).double()
            union = (pk | gk[None]).sum(-1).double()
            iou = torch.where(union > 0, inter / union.clamp_min(1), torch.zeros_like(union))
            out[v, p0:p0 + c.shape[0]] = iou.mean(-1)
    return out


def keypoint_loss(x, vox, img, mask, loss_type: str = "L2", *, dtype=torch.float64) -> torch.Tensor:
    """(V,) loss of the fits' cameras ``x (V, 9)`` on their keypoints."""
    u, v, _ = project(vox.to(dtype), x.to(dtype))
    m = mask.to(dtype)
    r = torch.stack([u - img[..., 0].to(dtype), v - img[..., 1].to(dtype)], -1) * m[..., None]
    if loss_type == "L1":
        return (torch.sqrt(r * r + 1e-12) * m[..., None]).sum((-1, -2))
    return (r * r).sum((-1, -2))


# --------------------------------------------------------------------------- stage 1 and 3


def grid_sha256(grid: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(grid, np.uint8).tobytes()).hexdigest()


def part_zbuffers(grid: np.ndarray, cam: np.ndarray, H: int, W: int, ids, *, device,
                  dtype=torch.float64) -> torch.Tensor:
    """(len(ids), H, W) least camera Z of each part's voxels (inf where none
    projects), float64."""
    g = torch.as_tensor(np.ascontiguousarray(grid), device=device)
    d0, d1, d2 = torch.nonzero(g, as_tuple=True)
    lab = g[d0, d1, d2].long()
    pts = torch.stack([d2, d1, d0], 1).to(dtype)
    u, v, Z = project(pts, torch.as_tensor(cam, device=device).to(dtype))
    pix, ok = _pixels(u, v, Z > Z_VALID_MIN, H, W, H, W)
    ids_t = torch.as_tensor(list(ids), device=device)
    slot = torch.full((16,), len(ids), dtype=torch.long, device=device)
    slot[ids_t] = torch.arange(len(ids), device=device)
    s = slot[lab]
    seg = torch.where(ok & (s < len(ids)), s * (H * W + 1) + pix, len(ids) * (H * W + 1))
    zb = torch.full(((len(ids) + 1) * (H * W + 1),), float("inf"), dtype=torch.float64, device=device)
    zb.scatter_reduce_(0, seg, Z.double(), "amin")
    return zb.view(len(ids) + 1, H * W + 1)[: len(ids), : H * W].view(len(ids), H, W)


def _iou(a: torch.Tensor, b: torch.Tensor) -> float:
    union = int((a | b).sum())
    return int((a & b).sum()) / union if union else 0.0


def present_parts(grid: np.ndarray) -> list:
    counts = np.bincount(np.asarray(grid).reshape(-1), minlength=16)
    return [p for p, i in PART_IDS.items() if counts[i] > 0]


def visible_part_ious(grid_init: np.ndarray, grid_def: np.ndarray, cam: dict, mask: np.ndarray, *, device,
                      dtype=torch.float64) -> dict:
    """part -> notebook-4 visible IoU of the deformed grid, for the parts of
    the init grid that the mask holds."""
    H, W = mask.shape[:2]
    parts = present_parts(grid_init)
    zb = part_zbuffers(grid_def, cam_vector(cam), H, W, [PART_IDS[p] for p in parts], device=device,
                       dtype=dtype)
    m = torch.as_tensor(np.asarray(mask), device=device).long()
    out = {}
    for i, p in enumerate(parts):
        gt = m == PART_IDS[p]
        if not bool(gt.any()):
            continue
        rest = torch.cat([zb[:i], zb[i + 1:]]).amin(0) if len(parts) > 1 else torch.full_like(zb[i], float("inf"))
        out[p] = _iou(zb[i] < rest + VIS_EPS, gt)
    return out


def whole_iou(grid3: np.ndarray, cam: dict, mask: np.ndarray, grid1: np.ndarray, *, device,
              dtype=torch.float64) -> float:
    """The notebook-4 "whole" cell: pixels where some part of the deformed
    grid projects against the mask pixels whose label the stage-1 grid
    holds."""
    H, W = mask.shape[:2]
    ids = [PART_IDS[p] for p in present_parts(grid3)]
    zb = part_zbuffers(grid3, cam_vector(cam), H, W, ids, device=device, dtype=dtype)
    m = torch.as_tensor(np.asarray(mask), device=device).long()
    held = [i for i in np.unique(np.asarray(grid1)) if i > 0]
    gt = torch.isin(m, torch.as_tensor(held, device=device))
    return _iou(torch.isfinite(zb.amin(0)), gt)


def stage1_iou(grid: np.ndarray, gold_occupied: np.ndarray):
    """Occupancy IoU against the golden occupancy, the larger grid strided
    down to the other's resolution and both cropped to their common shape;
    None when the shapes still differ by more than 2 along an axis."""
    occ = np.asarray(grid) > 0
    gold = gold_occupied
    if max(gold.shape) >= max(occ.shape):
        f = max(1, round(max(gold.shape) / max(occ.shape)))
        gold = gold[::f, ::f, ::f]
    else:
        f = max(1, round(max(occ.shape) / max(gold.shape)))
        occ = occ[::f, ::f, ::f]
    if any(abs(a - b) > 2 for a, b in zip(gold.shape, occ.shape)):
        return None
    crop = tuple(slice(0, min(a, b)) for a, b in zip(gold.shape, occ.shape))
    a, b = occ[crop], gold[crop]
    union = np.logical_or(a, b).sum()
    return float(np.logical_and(a, b).sum() / union) if union else 0.0
