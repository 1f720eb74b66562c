"""IoU-driven search over the 4-DoF part deformation, as in
``pbr3d.deform.search``.

The automated replacement for the reference's slider viewer
(``launch_deform_viewer_fixed_camera``, utils/deformation_estimation.py:15-356):
each part's deform maximises the notebook-4 visibility-aware binary IoU of
the part under the fixed stage-2 camera (utils/eval_helpers_intra.py:
168-190,560-748), plus, in the ensemble objective, its neighbours' visible
IoUs and a hinge on their identity floors.  See the JAX module for the
search schedule and why each stage exists; names and decisions are kept
one for one.

Split between device and host, as in the JAX package:

* device (``device``): the candidate objectives — a ``(P, 4)`` batch of
  deforms is warped (:mod:`pbr3d_torch.deform.warp`), z-buffered
  (:func:`pbr3d_torch.ops.projection.zbuffer_soa`) and scored in one
  batched pass; ``_eval_chunked`` bounds each pass by a point budget;
* host (numpy): every decision.  The float32 score components are
  downloaded, combined in float64, picked with ``np.argmax``, pruned with
  ``np.argsort`` and accepted with ``np.array_equal``, exactly as the JAX
  package does, so equal scores give equal decisions.  The maintained
  per-part z-buffers, ``rest_zb``, the neighbour bundles and the floors
  are host planes.

Planes.  The JAX package pads image planes to multiples of 128 and bounds
points by ``true_hw``.  Here a candidate's z-buffer is computed at the true
(H, W) and padded to even dims with +inf (``_pad_plane_hw``), so the 2x2
half-resolution pools see the same padding (inf / False) as the JAX ones,
and no point can land in the pad.

Not ported: the ``PointCache`` route (``table=None`` builds a point table)
and the ``batcher`` routes (the multi-device eval batcher).
"""

from __future__ import annotations

import functools
import itertools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from pbr3d_torch import config
from pbr3d_torch.camera.geometry import params_to_vector
from pbr3d_torch.deform.warp import deform_coords, deform_coords_soa
from pbr3d_torch.ops.point_table import build_point_table
from pbr3d_torch.ops.projection import (
    partwise_iou,
    partwise_zbuffers,
    splat_labels,
    zbuffer_soa,
)
from pbr3d_torch.utils import profiling

IDENTITY_DEFORM = np.array([1.0, 0.0, 1.0, 0.0], np.float32)  # sy, dy, sxz, dxz

#: Parts pinned to the identity deform by default (the notebook-4 minarets
#: row z-tests the INIT minaret points against the deformed grid).
PIN_IDENTITY_PARTS = ("front_minarets", "back_minarets")

#: Visibility epsilon of the intra-method eval (eval_helpers_intra.py:168).
VIS_EPS = 1e-3

#: Hinge-penalty weight on regressing another part's visible IoU below its
#: all-identity baseline.
NEIGHBOR_PENALTY = 3.0


def _pad_plane_hw(H: int, W: int) -> Tuple[int, int]:
    """Even plane dims: the half-resolution terms pool 2x2."""
    return H + H % 2, W + W % 2


def _pad_planes(z: torch.Tensor, Hp: int, Wp: int) -> torch.Tensor:
    """``(..., H, W)`` z-buffers padded with +inf to ``(..., Hp, Wp)``."""
    H, W = z.shape[-2:]
    if (H, W) == (Hp, Wp):
        return z
    return torch.nn.functional.pad(z, (0, Wp - W, 0, Hp - H), value=float("inf"))


def _cam(cam_vec: torch.Tensor):
    return cam_vec[0:3], cam_vec[3:6], cam_vec[6], cam_vec[7], cam_vec[8]


def _candidate_zbuffers(deforms, coords, cam_vec, image_hw, voxel_shape, center, approx):
    """``(..., Hp, Wp)`` min-Z image per deform, +inf padded to even dims."""
    xs, ys, zs, v = deform_coords_soa(coords, None, image_hw, voxel_shape, deforms,
                                      center, approx=approx)
    H, W = image_hw
    return _pad_planes(zbuffer_soa(xs, ys, zs, v, *_cam(cam_vec), H, W), *_pad_plane_hw(H, W))


def _iou(inter: torch.Tensor, union: torch.Tensor) -> torch.Tensor:
    """float32 ``inter/union`` of integer counts, 0 where the union is empty."""
    inter, union = inter.to(torch.float32), union.to(torch.float32)
    return torch.where(union > 0, inter / union.clamp_min(1.0), torch.zeros_like(union))


def _own_visible_iou(zc, rest_zbuf, gt_part):
    visible = zc < rest_zbuf + VIS_EPS
    return _iou((visible & gt_part).sum((-2, -1)), (visible | gt_part).sum((-2, -1)))


def _batch_deform_iou(
    deforms: torch.Tensor,  # (P, 4)
    coords: torch.Tensor,  # (N, 3)
    cam_vec: torch.Tensor,  # (9,)
    gt_labels: torch.Tensor,  # (H, W) label plane
    part_id: int,
    image_hw,
    voxel_shape,
    center: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Unoccluded colour-exact splat IoU per candidate (the reference
    viewer's on-screen number, camera_estimation.py:770-788); diagnostics.

    ``center=None`` pivots on the float32 mean of ``coords`` (the JAX
    default): the integer sum (exact in float64, and in float32 below
    2^24) over the count, one float32 division."""
    if center is None:
        s = coords.to(torch.float64).sum(0).to(torch.float32)
        center = s / torch.tensor(float(max(coords.shape[0], 1)), device=coords.device)
    c, v = deform_coords(coords, None, image_hw, voxel_shape, deforms, center)
    H, W = image_hw
    labels = torch.full((c.shape[-2],), part_id, dtype=torch.uint8, device=c.device)
    out = []
    for i in range(c.shape[0]):
        img = splat_labels(c[i].to(torch.float32), labels, v[i], *_cam(cam_vec), H, W)
        out.append(partwise_iou(img, gt_labels, [part_id])[0][0])
    return torch.stack(out)


def _batch_deform_visible_iou(
    deforms: torch.Tensor,  # (P, 4)
    coords: torch.Tensor,  # (N, 3) int16/float32
    cam_vec: torch.Tensor,  # (9,)
    gt_part: torch.Tensor,  # (Hp, Wp) bool — mask == part id
    rest_zbuf: torch.Tensor,  # (Hp, Wp) f32 — min-Z of all OTHER parts
    image_hw,  # true (H, W)
    voxel_shape,  # (D, H, W)
    center: torch.Tensor,  # (3,) f32 — FULL part centroid
    approx: bool = False,
) -> torch.Tensor:
    """(P,) visibility-aware binary IoU per candidate — the notebook-4
    metric: with zbuf = min(rest, part_min) the eval's |Z - zbuf| < eps test
    reduces to ``part_min < rest + eps``."""
    zc = _candidate_zbuffers(deforms, coords, cam_vec, image_hw, voxel_shape, center, approx)
    return _own_visible_iou(zc, rest_zbuf, gt_part)


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last axis, left to right (the JAX package's
    reduction order, whatever the device)."""
    out = x[..., 0]
    for i in range(1, x.shape[-1]):
        out = out + x[..., i]
    return out


def _batch_deform_visible_iou_penalized(
    deforms: torch.Tensor,  # (P, 4)
    coords: torch.Tensor,  # (N, 3)
    cam_vec: torch.Tensor,  # (9,)
    gt_part: torch.Tensor,  # (Hp, Wp) bool
    rest_zbuf: torch.Tensor,  # (Hp, Wp) f32
    image_hw,
    voxel_shape,
    center: torch.Tensor,  # (3,) f32
    nb_zb: torch.Tensor,  # (Q, Hp/2, Wp/2) f32 — neighbours' z-buffers, min-pooled
    nb_base: torch.Tensor,  # (Q, Hp/2, Wp/2) bool — neighbour visible vs rest-excluding-{self, part}
    nb_gt: torch.Tensor,  # (Q, Hp/2, Wp/2) bool — neighbour GT planes, max-pooled
    nb_floor: torch.Tensor,  # (Q,) f32 — neighbour identity floors (half-res)
    nb_valid: torch.Tensor,  # (Q,) bool
    approx: bool = False,
) -> torch.Tensor:
    """(P, 3) float32 score components per candidate: own visible IoU, the
    sum of the neighbours' half-res visible IoUs under the candidate's
    occlusion, and the sum of their hinge drops below the floors.  The host
    combines them as ``own + gain_w·gain − NEIGHBOR_PENALTY·drop``.

    Neighbour q is visible where ``base_q & (zb_q < zc + eps)`` (zc = the
    candidate's 2x2 min-pooled z-buffer): two masked sums per neighbour."""
    zc = _candidate_zbuffers(deforms, coords, cam_vec, image_hw, voxel_shape, center, approx)
    own = _own_visible_iou(zc, rest_zbuf, gt_part)
    P, Hp, Wp = zc.shape
    zc2 = zc.reshape(P, Hp // 2, 2, Wp // 2, 2).amin(dim=(2, 4))
    vis_q = nb_base & (nb_zb < zc2[:, None] + VIS_EPS)  # (P, Q, h2, w2)
    iou_q = _iou((vis_q & nb_gt).sum((-2, -1)), (vis_q | nb_gt).sum((-2, -1)))
    zero = torch.zeros_like(iou_q)
    gain = torch.where(nb_valid, iou_q, zero)
    drop = torch.where(nb_valid, (nb_floor - iou_q).clamp_min(0.0), zero)
    return torch.stack([own, _seq_sum(gain), _seq_sum(drop)], dim=1)


def deformed_zbuffer(
    deform,  # (4,)
    coords: torch.Tensor,  # (N, 3)
    cam_vec: torch.Tensor,
    image_hw,
    voxel_shape,
    center: torch.Tensor,  # (3,) f32 — FULL part centroid
) -> torch.Tensor:
    """(Hp, Wp) min-Z image of one part at one deform, exact warp (inf where
    empty, and in the even-dims pad)."""
    return _candidate_zbuffers(deform, coords, cam_vec, image_hw, voxel_shape, center, False)


def all_part_zbuffers(
    pts: torch.Tensor,  # (N, 3) int16/f32 — ALL occupied voxels
    labels: torch.Tensor,  # (N,)
    cam_vec,
    parts,  # part names
    image_hw,
) -> Dict[str, np.ndarray]:
    """part -> (Hp, Wp) host min-Z image, every part in one reduction."""
    H, W = image_hw
    cv = torch.as_tensor(np.asarray(cam_vec, np.float32), device=pts.device)
    ids = [config.PART_IDS[p] for p in parts]
    zbs = _pad_planes(partwise_zbuffers(pts, labels, None, *_cam(cv), ids, H, W),
                      *_pad_plane_hw(H, W)).cpu().numpy()
    profiling.count("stage3.round_trips")
    return {p: zbs[i] for i, p in enumerate(parts)}


#: Max candidate-points per batched pass (bounds device memory: each point
#: of each candidate holds ~100 B of warp and projection temporaries).
_POINT_BUDGET = 1 << 26

#: Largest candidate batch, as a multiple of the search's ``chunk``.
_CHUNK_MAX_MULT = 4


def _eval_chunked(deforms: np.ndarray, chunk_cap: int, fn=None, approx=False,
                  **kw) -> np.ndarray:
    """Evaluate P candidates in passes of at most ``_POINT_BUDGET`` point-
    candidates (exact P: no padding rows); returns the downloaded float32
    (P,) IoUs or (P, 3) components."""
    P = deforms.shape[0]
    n = kw["coords"].shape[0]
    cost = n if approx else 7 * n
    if fn is None:
        fn = _batch_deform_visible_iou
    else:
        nbq = kw["nb_zb"]
        cost += (nbq.shape[0] * nbq.shape[1] * nbq.shape[2]) // 4
    chunk = max(1, min(_POINT_BUDGET // max(1, cost), _CHUNK_MAX_MULT * chunk_cap))
    dev = kw["coords"].device
    d = torch.as_tensor(np.asarray(deforms, np.float32), device=dev)
    outs = [fn(d[i:i + chunk], approx=approx, **kw) for i in range(0, P, chunk)]
    profiling.count("stage3.candidates", P)
    profiling.count("stage3.round_trips")
    return torch.cat(outs).cpu().numpy()


def optimize_part_deform(
    grid_labels,
    part: str,
    mask_labels: np.ndarray,
    cam: Dict,
    *,
    device,
    rest_zbuf: Optional[np.ndarray] = None,
    search_stride: int = 8,
    surface_stride: int = 2,
    scale_range=(0.5, 2.0, 11),
    shift_range=(-100.0, 100.0, 9),
    refine_steps: int = 3,
    chunk: int = 64,
    mode: str = "separable",
    joint_steps: int = 5,
    exact_topk: int = 12,
    coarse_cap: int = 24576,
    fine_cap: int = 65536,
    _device_full=None,
    _zb_identity=None,
    _nb=None,
    _gain_w: float = 0.0,
    _dual_gain_w: Optional[float] = None,
    _dual_out: Optional[Dict] = None,
    _incumbent: Optional[np.ndarray] = None,
    _zb_incumbent: Optional[np.ndarray] = None,
    _window: Optional[Tuple[float, int]] = None,
    _seed_cands: Optional[np.ndarray] = None,
    _return_zb: bool = False,
    _table=None,
):
    """Best (scale_y, shift_y, scale_xz, shift_xz) for one part + its IoU
    (+ its full-set z-buffer with ``_return_zb``), on ``device``.

    The JAX package's schedule and arguments, one for one (see
    ``pbr3d.deform.search.optimize_part_deform``): separable coarse A/B
    over the lattices on the coarse shell with the approx warp (or the
    ``_window`` resweep grids around the incumbent), the joint 4-D pass
    with seed anchoring, an approx refine round at ±step/2, an exact
    (7-jitter) round at ±step/6 pre-ranked to the ``exact_topk`` leaders,
    then full-set acceptance against identity on the same objective.
    ``search_stride`` is kept for the JAX signature: the point-table path
    strides shells by ``surface_stride`` and the caps only.  Planes are
    host numpy at ``_pad_plane_hw(H, W)``."""
    pid = config.PART_IDS[part]
    table = _table if _table is not None else build_point_table(grid_labels, device=device)
    n_pts = table.count(pid)
    if n_pts == 0:
        out = (IDENTITY_DEFORM.copy(), 0.0)
        return (out + (None,)) if _return_zb else out
    voxel_shape = tuple(int(s) for s in table.shape)
    H, W = mask_labels.shape[:2]
    image_hw = (H, W)
    Hp, Wp = _pad_plane_hw(H, W)
    gt_p = np.zeros((Hp, Wp), bool)
    gt_p[:H, :W] = np.asarray(mask_labels) == pid
    rest = np.full((Hp, Wp), np.inf, np.float32)
    if rest_zbuf is not None:
        rest[: rest_zbuf.shape[0], : rest_zbuf.shape[1]] = rest_zbuf

    n_shell = max(table.shell_count(pid), 1)
    s_f = max(surface_stride, -(-n_shell // fine_cap))
    s_c = max(2 * surface_stride, -(-n_shell // coarse_cap))
    p_s = table.shell_window(pid, s_f)
    p_sc = table.shell_window(pid, s_c)
    center = torch.tensor(np.asarray(table.center(pid), np.float32), device=device)
    p_f = _device_full if _device_full is not None else table.part_window(pid, 1)

    gt = torch.as_tensor(gt_p, device=device)
    rest_d = torch.as_tensor(rest, device=device)
    cam_vec = torch.tensor(params_to_vector(cam), device=device)
    nb_kw = {}
    if _nb is not None:
        nb_kw = dict(fn=_batch_deform_visible_iou_penalized, **{
            f"nb_{k}": torch.as_tensor(_nb[k], device=device)
            for k in ("zb", "base", "gt", "floor", "valid")})

    def ev(deforms, pp, approx):
        # (P,) own IoU without _nb; (P, 3) score components with it
        return _eval_chunked(
            np.asarray(deforms, np.float32), chunk, approx=approx,
            coords=pp, cam_vec=cam_vec, gt_part=gt, rest_zbuf=rest_d,
            image_hw=image_hw, voxel_shape=voxel_shape, center=center, **nb_kw,
        )

    def zb_full(deform):
        profiling.count("stage3.round_trips")
        return deformed_zbuffer(torch.as_tensor(np.asarray(deform, np.float32), device=device),
                                p_f, cam_vec, image_hw, voxel_shape, center).cpu().numpy()

    gw = float(_gain_w)
    dual = (_dual_gain_w is not None and _nb is not None
            and float(_dual_gain_w) != gw)
    diverged = False

    def sc(vals, w):
        """Combine device score components under gain weight ``w``."""
        if vals.ndim == 1:
            return vals
        return vals[:, 0] + w * vals[:, 1] - NEIGHBOR_PENALTY * vals[:, 2]

    def pick(cands, vals):
        nonlocal diverged
        bp = cands[int(np.argmax(sc(vals, gw)))]
        if dual and not diverged:
            be = cands[int(np.argmax(sc(vals, float(_dual_gain_w))))]
            if not np.array_equal(bp, be):
                diverged = True
        return bp

    def _lattice(rng):
        """linspace of one (lo, hi, n) triple, or the sorted union of a
        list of them; the step follows the finest triple."""
        if isinstance(rng[0], (tuple, list)):
            vals = np.unique(np.concatenate(
                [np.linspace(a, b, n) for a, b, n in rng]).round(9))
            step = min((b - a) / max(n - 1, 1) for a, b, n in rng)
            return vals, step
        a, b, n = rng
        return np.linspace(a, b, n), (b - a) / max(n - 1, 1)

    scales, scale_step = _lattice(scale_range)
    shifts, shift_step = _lattice(shift_range)

    seeds = None
    if _seed_cands is not None:
        seeds = np.asarray(_seed_cands, np.float32).reshape(-1, 4)
        if not len(seeds):
            seeds = None

    def with_seeds(c):
        return c if seeds is None else np.concatenate([c, seeds])

    seed_anchor = None
    if _window is not None:
        # Resweep mode: local separable offset grids around the incumbent.
        span, nw = _window
        base0 = (np.asarray(_incumbent, np.float32).copy()
                 if _incumbent is not None else IDENTITY_DEFORM.copy())
        rs_ = np.linspace(-span * scale_step, span * scale_step, nw)
        rd_ = np.linspace(-span * shift_step, span * shift_step, nw)
        ca = np.array(
            [base0 + np.array([a, b, 0.0, 0.0], np.float32)
             for a, b in itertools.product(rs_, rd_)], np.float32)
        ca = with_seeds(np.concatenate([IDENTITY_DEFORM[None], base0[None], ca]))
        with profiling.span("stage3.opd.windowA", part=part):
            best = pick(ca, ev(ca, p_sc, True))
        cb = np.array(
            [best + np.array([0.0, 0.0, a, b], np.float32)
             for a, b in itertools.product(rs_, rd_)], np.float32)
        cb = with_seeds(np.concatenate([IDENTITY_DEFORM[None], best[None], cb]))
        with profiling.span("stage3.opd.windowB", part=part):
            best = pick(cb, ev(cb, p_sc, True))
    elif mode == "full":  # diagnostic: the full 4-D cross product
        coarse = np.array(
            [(sy, dy, sxz, dxz) for sy, sxz, dy, dxz in
             itertools.product(scales, scales, shifts, shifts)],
            np.float32,
        )
        coarse = with_seeds(np.concatenate([IDENTITY_DEFORM[None], coarse]))
        best = pick(coarse, ev(coarse, p_sc, True))
    else:
        # stage A: (scale_y, shift_y) with xz identity
        ca = np.array(
            [(sy, dy, 1.0, 0.0) for sy, dy in itertools.product(scales, shifts)],
            np.float32,
        )
        ca = with_seeds(np.concatenate([IDENTITY_DEFORM[None], ca]))
        with profiling.span("stage3.opd.coarseA", part=part):
            best = pick(ca, ev(ca, p_sc, True))
        # stage B: (scale_xz, shift_xz) given the best y
        cb = np.array(
            [(best[0], best[1], sxz, dxz)
             for sxz, dxz in itertools.product(scales, shifts)],
            np.float32,
        )
        cb = with_seeds(np.concatenate([best[None], cb]))
        with profiling.span("stage3.opd.coarseB", part=part):
            vb = ev(cb, p_sc, True)
        best = pick(cb, vb)
        if seeds is not None:
            # the best seed anchors an extra local grid in the joint pass
            bs = pick(cb[-len(seeds):], vb[-len(seeds):])
            if not np.array_equal(bs, best):
                seed_anchor = bs

    if _window is None and mode != "full" and joint_steps:
        # Joint pass over (scale_y, scale_xz) around the separable winner
        # (and the seed anchor): ``joint_steps`` values spanning ±1.5 steps.
        js = np.linspace(-1.5 * scale_step, 1.5 * scale_step, joint_steps)
        joffs = np.array(
            [(a, 0.0, c, 0.0) for a, c in itertools.product(js, js)],
            np.float32,
        )
        anchors = [best] + ([seed_anchor] if seed_anchor is not None else [])
        joint = np.concatenate(
            [np.concatenate([a[None].astype(np.float32),
                             a[None].astype(np.float32) + joffs])
             for a in anchors])
        joint = with_seeds(joint)
        with profiling.span("stage3.opd.joint", part=part):
            best = pick(joint, ev(joint, p_sc, True))

    # local refinement rounds around the coarse optimum: approx at +-step/2,
    # then exact (7-jitter + rounding) at +-step/6
    for span_s, span_d, approx in (
        (scale_step / 2, shift_step / 2, True),
        (scale_step / 6, shift_step / 6, False),
    ):
        rs = np.linspace(-span_s, span_s, refine_steps)
        rd = np.linspace(-span_d, span_d, refine_steps)
        fine = np.array(
            [best + np.array([a, b, c, d], np.float32)
             for a, c, b, d in itertools.product(rs, rs, rd, rd)],
            np.float32,
        )
        fine = with_seeds(np.concatenate([best[None], fine]))
        with profiling.span("stage3.opd.refine", part=part, approx=approx):
            if not approx and len(fine) > exact_topk > 0:
                # exact-evaluate only the approx objective's leaders + the
                # incumbent (row 0)
                pre = ev(fine, p_s, True)
                kp_ = np.argsort(sc(pre, gw))[-exact_topk:]
                if dual and not diverged:
                    ke_ = np.argsort(sc(pre, float(_dual_gain_w)))[-exact_topk:]
                    if set(kp_.tolist()) != set(ke_.tolist()):
                        diverged = True
                keep = np.unique(np.concatenate([[0], kp_]))
                fine = fine[keep]
            best = pick(fine, ev(fine, p_s, approx))

    # full-set acceptance: keep the winner only if it beats identity on the
    # complete point set, on the same objective the search optimised
    zb_id = _zb_identity if _zb_identity is not None else zb_full(IDENTITY_DEFORM)
    iou_id = _visible_iou_from_zb(zb_id, rest, gt_p)

    def _finish(out2, zb):
        if _dual_out is not None and diverged:
            _dual_out["diverged"] = True
        return (out2 + (zb,)) if _return_zb else out2

    if np.array_equal(best, IDENTITY_DEFORM):
        return _finish((IDENTITY_DEFORM.copy(), float(iou_id)), None)
    if (_zb_incumbent is not None and _incumbent is not None
            and np.array_equal(best, np.asarray(_incumbent, np.float32))):
        # the resweep landed back on the incumbent, whose full-set z-buffer
        # the caller maintains
        iou_inc = _visible_iou_from_zb(_zb_incumbent, rest, gt_p)
        return _finish((np.asarray(best, np.float32), float(iou_inc)),
                       _zb_incumbent)
    with profiling.span("stage3.opd.accept_zb", part=part):
        zb_best = zb_full(best)
    iou_best = _visible_iou_from_zb(zb_best, rest, gt_p)
    score_best, score_id = iou_best, iou_id
    if _nb is not None:
        g_b, d_b = _nb_components(_nb, zb_best)
        g_i, d_i = _nb_components(_nb, zb_id)
        score_best = iou_best + gw * g_b - NEIGHBOR_PENALTY * d_b
        score_id = iou_id + gw * g_i - NEIGHBOR_PENALTY * d_i
        if dual and not diverged:
            w2 = float(_dual_gain_w)
            acc_e = ((iou_best + w2 * g_b - NEIGHBOR_PENALTY * d_b)
                     > (iou_id + w2 * g_i - NEIGHBOR_PENALTY * d_i))
            if acc_e != (score_best > score_id):
                diverged = True
    if score_best <= score_id:
        return _finish((IDENTITY_DEFORM.copy(), float(iou_id)), None)
    return _finish((np.asarray(best, np.float32), float(iou_best)), zb_best)


def _min_pool2(z: np.ndarray) -> np.ndarray:
    # the four strided corners: the JAX package's reshape-min, ~50x faster
    # in numpy (a two-axis reduce over length-2 axes)
    return np.minimum(np.minimum(z[0::2, 0::2], z[0::2, 1::2]),
                      np.minimum(z[1::2, 0::2], z[1::2, 1::2]))


def _max_pool2(z: np.ndarray) -> np.ndarray:
    return np.maximum(np.maximum(z[0::2, 0::2], z[0::2, 1::2]),
                      np.maximum(z[1::2, 0::2], z[1::2, 1::2]))


def _nb_components(nb: Dict, zb_part: np.ndarray) -> Tuple[float, float]:
    """Host mirror of the device neighbour terms: (gain, drop) = (sum of
    the neighbours' half-res visible IoUs, sum of their hinge drops)."""
    zc2 = _min_pool2(np.asarray(zb_part))
    vis = nb["base"] & (nb["zb"] < zc2[None] + VIS_EPS)
    inter = np.sum(vis & nb["gt"], axis=(1, 2)).astype(np.float64)
    union = np.sum(vis | nb["gt"], axis=(1, 2)).astype(np.float64)
    iou = np.where(union > 0, inter / np.maximum(union, 1.0), 0.0)
    gain = np.where(nb["valid"], iou, 0.0)
    drop = np.where(nb["valid"], np.maximum(nb["floor"] - iou, 0.0), 0.0)
    return float(gain.sum()), float(drop.sum())


def _nb_score(nb: Dict, zb_part: np.ndarray, gain_w: float = 1.0) -> float:
    """Combined neighbour score at ``gain_w`` (see ``_nb_components``)."""
    g, d = _nb_components(nb, zb_part)
    return gain_w * g - NEIGHBOR_PENALTY * d


def _visible_iou_from_zb(
    zb_part: np.ndarray, rest_zbuf: np.ndarray, gt_part: np.ndarray
) -> float:
    """The notebook-4 visible IoU given the part's min-Z image (host)."""
    visible = zb_part < rest_zbuf + VIS_EPS
    union = np.logical_or(visible, gt_part).sum()
    if union == 0:
        return 0.0
    return float(np.logical_and(visible, gt_part).sum() / union)


def _deform_vec(d: Dict) -> np.ndarray:
    return np.array(
        [d["scale_y"], d["shift_y"], d["scale_xz"], d["shift_xz"]], np.float32
    )


def rigid_consistency_seed(
    deform_q: np.ndarray, center_p: np.ndarray, center_q: np.ndarray,
    py: float,
) -> np.ndarray:
    """Part q's deform re-pivoted to part p's centroid: scales copied,
    ``dy_p = dy_q - (cp_y - cq_y)(sy_q - 1)/py``, xz shift copied."""
    dq = np.asarray(deform_q, np.float32)
    dy = dq[1] - (float(center_p[1]) - float(center_q[1])) * (dq[0] - 1.0) / py
    return np.array([dq[0], dy, dq[2], dq[3]], np.float32)


def _part_sets(table, parts):
    """part -> (full point set, count) and part -> float32 device centroid."""
    dev = table.coords.device
    part_sets, centers = {}, {}
    for p in parts:
        pid = config.PART_IDS[p]
        part_sets[p] = (table.part_window(pid, 1), table.count(pid))
        centers[p] = torch.tensor(np.asarray(table.center(pid), np.float32), device=dev)
    return part_sets, centers


def prepare_shared_state(mask_labels, cam, parts, table):
    """(part_sets, centers, zb_identity) for :func:`refine_parts`, computed
    once and shared read-only by the portfolio chains (``_part_sets`` and
    the host identity z-buffers)."""
    H, W = np.asarray(mask_labels).shape[:2]
    part_sets, centers = _part_sets(table, parts)
    zb_identity = all_part_zbuffers(table.coords, table.labels, params_to_vector(cam),
                                    parts, (H, W))
    return part_sets, centers, zb_identity


def refine_parts(
    grid_labels,
    mask_labels: np.ndarray,
    cam: Dict,
    part_names: Sequence[str] | None = None,
    *,
    device,
    pin_identity: Sequence[str] = PIN_IDENTITY_PARTS,
    overrides: Optional[Dict[str, Dict]] = None,
    verify: bool = True,
    sweeps: int = 2,
    first_gain_w: float = 0.0,
    table=None,
    zb_identity_out: Optional[Dict[str, np.ndarray]] = None,
    part_sets_out: Optional[Dict] = None,
    zb_identity_in: Optional[Dict[str, np.ndarray]] = None,
    part_sets_in: Optional[Dict] = None,
    centers_in: Optional[Dict] = None,
    dual_gain_w: Optional[float] = None,
    pass0_done=None,
    pass0_snapshot_out: Optional[Dict] = None,
    pass0_prefix: Optional[Dict] = None,
    resweep_window: Optional[Tuple[float, int]] = None,
    seed_cands: Optional[Dict[str, np.ndarray]] = None,
    follow_seeds: bool = True,
    **kw,
) -> Dict[str, Dict]:
    """Optimise every present part on ``device``; returns {part: {deform,
    iou, gt_px}} like the reference's saved_params
    (deformation_estimation.py:262-286).

    The JAX package's chain, one for one (``pbr3d.deform.search.
    refine_parts``): largest parts first, each conditioned on the others'
    current z-buffers; pinned and overridden parts skipped; a dual-scored
    pass 0 (``dual_gain_w``, ``pass0_done``, ``pass0_snapshot_out``,
    ``pass0_prefix``); ensemble conditioning resweeps (``sweeps``,
    ``resweep_window``) with rigid-consistency seeds; the staleness
    fixpoint; and, with ``verify``, the init-anchored revert.  Without a
    ``table`` one is built from ``grid_labels``.  The JAX package's
    ``_refine_parts_body`` is the part of this function after the table."""
    if part_names is None:
        part_names = [p for p in config.PART_NAMES if p != "background"]
    overrides = overrides or {}
    if table is None:
        table = build_point_table(grid_labels, device=device)
    parts = [p for p in part_names if table.count(config.PART_IDS[p]) > 0]
    if not parts:
        return {}
    H, W = np.asarray(mask_labels).shape[:2]
    Hp, Wp = _pad_plane_hw(H, W)
    cam_vec = torch.tensor(params_to_vector(cam), device=device)
    voxel_shape = tuple(int(s) for s in table.shape)
    gt_full = np.asarray(mask_labels)

    if part_sets_in is not None and centers_in is not None:
        # shared read-only by the portfolio chains; each chain's mutable
        # state lives in its own `state`/`zbs` dicts
        part_sets, centers = dict(part_sets_in), dict(centers_in)
    else:
        with profiling.span("stage3.part_sets"):
            part_sets, centers = _part_sets(table, parts)

    if part_sets_out is not None:
        part_sets_out.update({p: part_sets[p][0] for p in parts})

    def zb_at(p: str, deform: np.ndarray) -> np.ndarray:
        profiling.count("stage3.round_trips")
        return deformed_zbuffer(
            torch.as_tensor(np.asarray(deform, np.float32), device=device),
            part_sets[p][0], cam_vec, (H, W), voxel_shape, centers[p],
        ).cpu().numpy()

    state: Dict[str, np.ndarray] = {p: IDENTITY_DEFORM.copy() for p in parts}
    if zb_identity_in is not None and all(p in zb_identity_in for p in parts):
        zb_identity = {p: zb_identity_in[p] for p in parts}
    else:
        # identity deform + the 7-jitter rounding reproduce the integer
        # coordinates, so the direct projection is deformed_zbuffer at
        # identity
        with profiling.span("stage3.identity_zbufs"):
            zb_identity = all_part_zbuffers(table.coords, table.labels,
                                            params_to_vector(cam), parts, (H, W))
    if zb_identity_out is not None:
        zb_identity_out.update(zb_identity)
    zbs: Dict[str, np.ndarray] = {}
    for p in parts:
        if p in overrides:
            state[p] = _deform_vec(overrides[p])
            zbs[p] = zb_at(p, state[p])
        else:
            zbs[p] = zb_identity[p]

    def rest_zb(p: str) -> np.ndarray:
        others = [zbs[q] for q in parts if q != p]
        if not others:
            return np.full((Hp, Wp), np.inf, np.float32)
        return np.minimum.reduce(others)

    @functools.lru_cache(maxsize=None)
    def _gt_plane(p: str):
        g = np.zeros((Hp, Wp), bool)
        g[:H, :W] = gt_full == config.PART_IDS[p]
        return g

    # Init-state floors: every part's visible IoU with the whole grid at
    # identity, at full and at half resolution.
    floor_full: Dict[str, float] = {}
    floor_half: Dict[str, float] = {}
    zb2_identity = {p: _min_pool2(zb_identity[p]) for p in parts}
    gt2 = {p: _max_pool2(_gt_plane(p)) for p in parts}
    for p in parts:
        others = [zb_identity[q] for q in parts if q != p]
        rest_i = (np.minimum.reduce(others) if others
                  else np.full((Hp, Wp), np.inf, np.float32))
        floor_full[p] = _visible_iou_from_zb(zb_identity[p], rest_i, _gt_plane(p))
        others2 = [zb2_identity[q] for q in parts if q != p]
        rest2 = (np.minimum.reduce(others2) if others2
                 else np.full((Hp // 2, Wp // 2), np.inf, np.float32))
        vis2 = zb2_identity[p] < rest2 + VIS_EPS
        u2 = np.logical_or(vis2, gt2[p]).sum()
        floor_half[p] = float(np.logical_and(vis2, gt2[p]).sum() / u2) if u2 else 0.0

    NB_Q = 8  # fixed neighbour axis, as in the JAX package's bundles

    def nb_bundle(p: str) -> Optional[Dict]:
        """Half-res neighbour z-buffers/GT/floors for the cross-part terms
        (gain-weight free: every consumer combines the components with its
        own weight).  Rows past the neighbours are padding (``valid``
        False), so host sums run in the JAX package's order."""
        others = [q for q in parts if q != p]
        if not others or len(others) > NB_Q:
            return None
        h2, w2 = Hp // 2, Wp // 2
        nb = {
            "zb": np.full((NB_Q, h2, w2), np.inf, np.float32),
            "base": np.zeros((NB_Q, h2, w2), bool),
            "gt": np.zeros((NB_Q, h2, w2), bool),
            "floor": np.zeros((NB_Q,), np.float32),
            "valid": np.zeros((NB_Q,), bool),
        }
        Z = np.stack([_min_pool2(zbs[q]) for q in others])  # (Q, h2, w2)
        if len(others) > 1:  # the two smallest, as the JAX package's sort
            m1, m2 = np.partition(Z, 1, axis=0)[:2]
        else:
            m1, m2 = Z[0], np.full_like(Z[0], np.inf)
        for i, q in enumerate(others):
            # min over the others excluding q (ties make m2 == m1, correct)
            rest_excl = np.where(Z[i] == m1, m2, m1)
            nb["zb"][i] = Z[i]
            nb["base"][i] = Z[i] < rest_excl + VIS_EPS
            nb["gt"][i] = gt2[q]
            nb["floor"][i] = floor_half[q]
            nb["valid"][i] = True
        return nb

    # largest parts first; parts absent from the mask can only score 0
    searched = [
        p for p in sorted(parts, key=lambda q: -part_sets[q][1])
        if p not in pin_identity and p not in overrides
        and _gt_plane(p).sum() > 0
    ]

    def env_sig(p: str) -> bytes:
        return b"".join(state[q].tobytes() for q in parts if q != p)

    centers_np = {p: centers[p].cpu().numpy() for p in parts}
    profiling.count("stage3.round_trips", len(parts))
    py_ratio = float(voxel_shape[1]) / float(H)

    def _seeds_for(p: str):
        """Candidate seeds of p's search: the caller's, and (with
        ``follow_seeds``) every moved part's deform re-pivoted to p and
        copied verbatim."""
        rows = []
        if seed_cands and p in seed_cands:
            rows.extend(np.asarray(seed_cands[p], np.float32).reshape(-1, 4))
        if follow_seeds:
            cp = centers_np[p]
            for q in parts:
                if q == p or np.array_equal(state[q], IDENTITY_DEFORM):
                    continue
                dq = np.asarray(state[q], np.float32)
                rows.append(rigid_consistency_seed(dq, cp, centers_np[q], py_ratio))
                rows.append(dq.copy())
        if not rows:
            return None
        uniq = []
        for r in rows:
            if not any(np.array_equal(r, u) for u in uniq):
                uniq.append(r)
        return np.stack(uniq)

    def search_part(p: str, gain_w: float = 0.0, dual_out=None,
                    incumbent=None, window=None):
        return optimize_part_deform(
            None, p, mask_labels, cam, device=device,
            rest_zbuf=rest_zb(p),
            _table=table,
            _device_full=part_sets[p][0],
            _zb_identity=zb_identity[p],
            _nb=nb_bundle(p),
            _gain_w=gain_w,
            _dual_gain_w=dual_gain_w if dual_out is not None else None,
            _dual_out=dual_out,
            _incumbent=incumbent,
            _zb_incumbent=zbs[p] if incumbent is not None else None,
            _window=window,
            _seed_cands=_seeds_for(p),
            _return_zb=True,
            **kw,
        )

    dual_out = {"diverged": False} if dual_gain_w is not None else None
    env_at_search: Dict[str, bytes] = {}
    prefix_idx = -1
    if pass0_prefix is not None and pass0_prefix.get("idx", 0) > 0:
        # adopt the sibling chain's pass-0 prefix: the parts decided before
        # its first gain-weight divergence are identical under either weight
        prefix_idx = int(pass0_prefix["idx"])
        for q, v in pass0_prefix["state"].items():
            state[q] = np.asarray(v, np.float32).copy()
        zbs.update(pass0_prefix["zbs"])
        env_at_search.update(pass0_prefix["env"])
    for i, p in enumerate(searched):
        if i < prefix_idx:
            continue
        env_at_search[p] = env_sig(p)
        with profiling.span("stage3.part_search", part=p):
            deform, _, zb_new = search_part(p, gain_w=first_gain_w, dual_out=dual_out)
            if (pass0_snapshot_out is not None and dual_out is not None
                    and dual_out["diverged"]
                    and "idx" not in pass0_snapshot_out):
                # first divergence: freeze the pre-update chain state (the
                # z-buffers are never updated in place, so references do)
                pass0_snapshot_out.update(
                    idx=i,
                    state={q: state[q].copy() for q in parts},
                    zbs=dict(zbs),
                    env=dict(env_at_search),
                )
            if not np.array_equal(deform, state[p]):
                state[p] = deform
                zbs[p] = zb_new if zb_new is not None else zb_at(p, deform)
    if pass0_done is not None:
        pass0_done(bool(dual_out["diverged"]) if dual_out else None)

    # Conditioning resweeps under the ensemble objective (gain weight 1):
    # sweep 1 re-searches every part when pass 0 used another objective,
    # later sweeps only parts whose occlusion environment moved.
    for sweep in range(1, max(1, sweeps)):
        if sweep == 1 and first_gain_w != 1.0:
            stale = list(searched)
        else:
            stale = [p for p in searched if env_sig(p) != env_at_search[p]]
        if not stale:
            break
        for p in stale:
            env_at_search[p] = env_sig(p)
            with profiling.span("stage3.resweep", part=p, sweep=sweep):
                deform, _, zb_new = search_part(
                    p, gain_w=1.0, incumbent=state[p], window=resweep_window)
                if np.array_equal(deform, state[p]):
                    continue
                zb_cand = zb_new if zb_new is not None else zb_identity[p]
                nb = nb_bundle(p)
                rest = rest_zb(p)

                def _score(zb):
                    s = _visible_iou_from_zb(zb, rest, _gt_plane(p))
                    return s + (_nb_score(nb, zb, 1.0) if nb else 0.0)

                if _score(zb_cand) > _score(zbs[p]) + 1e-6:
                    state[p] = deform
                    zbs[p] = zb_cand

    # Final staleness re-score (image math only): revert any deformed part
    # that ended net-negative against identity under the final
    # conditioning; iterate to a fixpoint.
    for _ in range(len(searched)):
        reverted_any = False
        for p in searched:
            if np.array_equal(state[p], IDENTITY_DEFORM):
                continue
            nb = nb_bundle(p)
            rest = rest_zb(p)

            def _score(zb):
                s = _visible_iou_from_zb(zb, rest, _gt_plane(p))
                return s + (_nb_score(nb, zb, 1.0) if nb else 0.0)

            if _score(zb_identity[p]) > _score(zbs[p]) + 1e-6:
                state[p] = IDENTITY_DEFORM.copy()
                zbs[p] = zb_identity[p]
                reverted_any = True
        if not reverted_any:
            break

    if verify:
        # Init-anchored verify: no part's visible IoU under the final
        # occlusion may fall below its identity floor.  A regressed deformed
        # part is reverted; a regressed identity part gets its worst
        # deformed neighbour reverted.
        def cur_iou(p):
            return _visible_iou_from_zb(zbs[p], rest_zb(p), _gt_plane(p))

        for _ in range(2 * len(parts)):
            reverted = False
            for p in parts:
                if p in overrides:
                    continue  # human-forced deforms are not second-guessed
                if cur_iou(p) + 1e-6 >= floor_full[p]:
                    continue
                if not np.array_equal(state[p], IDENTITY_DEFORM):
                    state[p] = IDENTITY_DEFORM.copy()
                    zbs[p] = zb_identity[p]
                    reverted = True
                    continue
                offenders = [
                    q for q in searched
                    if q != p and not np.array_equal(state[q], IDENTITY_DEFORM)
                ]
                best_q, best_gain = None, -np.inf
                for q in offenders:
                    saved = zbs[q]
                    zbs[q] = zb_identity[q]
                    gain = cur_iou(p)
                    zbs[q] = saved
                    if gain > best_gain:
                        best_q, best_gain = q, gain
                if best_q is not None and best_gain > cur_iou(p) + 1e-6:
                    state[best_q] = IDENTITY_DEFORM.copy()
                    zbs[best_q] = zb_identity[best_q]
                    reverted = True
            if not reverted:
                break

    out = {}
    for p in parts:
        iou = _visible_iou_from_zb(zbs[p], rest_zb(p), _gt_plane(p))
        out[p] = {
            "deform": {
                "scale_y": float(state[p][0]),
                "shift_y": float(state[p][1]),
                "scale_xz": float(state[p][2]),
                "shift_xz": float(state[p][3]),
            },
            "iou": iou,
            # parts absent from the mask score 0; consumers exclude them
            "gt_px": int(_gt_plane(p).sum()),
        }
    return out
