"""Mask-IoU camera refinement, as in ``pbr3d.camera.align`` — the automated
replacement for the reference's interactive "smart aligner"
(utils/camera_estimation.py:479-768).

The search maximises the mean per-part colour-exact IoU between the splat of
the selected parts' surface shell and the selected-parts mask:

  1. random-search generations with the reference's step sizes
     (cam ±[50,50,100], target ±[50,50,100], f ±50, cx/cy ±20), shrinking
     0.7x after 3 stagnant generations, frozen after 4 shrinks;
  2. coordinate descent: all ±delta probes of the 9 DoF per round (at each
     of ``cd_mags`` times delta), delta halved on failure, from 20;
  3. optional ``lock_xy_equal`` tying cam x/y to target x/y.

The whole state stays on the device: the accept/shrink/freeze rules are
``torch.where`` updates, so no generation waits on the host.  A candidate
batch is one batched splat + IoU (``_batch_iou``): on the card one call of
the hand-written kernel :func:`pbr3d_torch.ops.cuda_kernels.splat_iou_kernel`
(a memset and three launches), on the CPU its plain version; populations
above ``pop_chunk`` run in chunks of it.

Draws.  The JAX package draws its proposals from ``jax.random`` (threefry),
which torch cannot reproduce.  ``draws=None`` takes them from a
``torch.Generator`` on the device seeded with ``seed``; ``draws`` may instead
map each seed to a ``(generations, population, 9)`` float32 array of
uniform [-1, 1) draws, or be a function ``(seed, generations, population)``
that returns one — for the JAX package's own,
``jax.random.uniform(k, (population, 9), f32, -1, 1)`` for each ``k`` in
``jax.random.split(PRNGKey(seed), generations)`` — and then the search
follows the JAX trajectory wherever the objectives agree.  ``population`` is
rounded exactly as the JAX package rounds it (see :func:`_pop_chunk` and
:func:`refine_cameras_batched`), so the same draws fit.

Several views.  :func:`_search` carries a leading view axis: the views of
one group run through the same launches, each with its own points, plane,
start and step scale, and all with the same draws.
:func:`refine_cameras_batched` (``run_all``'s search of all views) groups
the views as the JAX package does.  On this card the reason to group is the
launch count: a generation is a handful of small launches (the splat-IoU
kernel's four and the state's updates) and leaves the device mostly idle,
and a group of V views costs the launches of one.

Not ported: the one-hot matmul objective the JAX package uses for coarse
planes of at most 2^18 pixels (inside its half-resolution recursion and in
every grouped coarse search); the port splats exactly everywhere.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pbr3d_torch import config
from pbr3d_torch.camera.geometry import params_to_vector, vector_to_params
from pbr3d_torch.carving.voxel import bucket_size, points_by_parts, surface_points_by_parts
from pbr3d_torch.ops.cameramath import _fma
from pbr3d_torch.ops.cuda_kernels import splat_iou_kernel, splat_iou_plain
from pbr3d_torch.utils import profiling
from pbr3d_torch.utils.streams import adopt

#: Reference step sizes (camera_estimation.py:605-616).
_STEPS0 = np.array([50, 50, 100, 50, 50, 100, 50, 20, 20], np.float32)

#: Image planes with more pixels than this run their random-search
#: generations at half resolution, then coordinate descent at native
#: resolution from the upscaled optimum.
_COARSE_PLANE_PIXELS = 512 * 512

#: Point-candidates (points x cameras x views) per evaluated batch: the JAX
#: package's bound on its projection intermediates.
_POINT_BUDGET = 1 << 26

#: Plane pixels x cameras x views per evaluated batch: bounds the splat
#: planes, which the point budget does not see.  Candidates are scored
#: independently, so a smaller batch changes no score.
_PLANE_BUDGET = 1 << 28

Draws = Optional[Union[Mapping[int, np.ndarray], Callable[[int, int, int], np.ndarray]]]


def _batch_iou(cam_vecs: torch.Tensor, pts, labels, gt_labels, part_ids, H: int, W: int,
               valid=None, hw=None):
    """(P,) float32 mean part IoU of each (P, 9) camera's splat of ``pts``
    (N, 3) with uint8 ``labels`` (N,) against ``gt_labels (H, W)``; or
    ``(V, P)`` for V views at once, in the layout of
    :func:`pbr3d_torch.ops.cuda_kernels.splat_iou_kernel`: ``pts (V, N, 3)``,
    ``labels``/``valid (V, N)``, ``gt_labels (V, H, W)`` and ``hw (V, 2)``
    int32 each view's true plane inside (H, W).  CUDA tensors go to
    ``splat_iou_kernel``, CPU tensors to ``splat_iou_plain``; each call adds
    one to the counter ``stage2.splat_calls``."""
    if (gt_labels.shape[-2], gt_labels.shape[-1]) != (H, W):
        raise ValueError(f"ground truth {tuple(gt_labels.shape)} is not on the ({H}, {W}) plane")
    if cam_vecs.device.type == "cuda":
        score = splat_iou_kernel
    elif cam_vecs.device.type == "cpu":
        score = splat_iou_plain
    else:
        raise ValueError(f"_batch_iou: unsupported device {cam_vecs.device}")
    profiling.count("stage2.splat_calls")
    if cam_vecs.dim() == 2:
        return score(cam_vecs[None].contiguous(), pts[None].contiguous(), labels[None].contiguous(),
                     None if valid is None else valid[None].contiguous(), gt_labels[None].contiguous(),
                     part_ids, hw)[0]
    # _search's chunk slices of the candidates are strided
    return score(cam_vecs.contiguous(), pts, labels, valid, gt_labels, part_ids, hw)


def _pop_chunk(n_points: int, population: int, n_views: int = 1) -> Tuple[int, int]:
    """(pop_chunk, effective population): the JAX package's memory bound of
    ~2^26 point-candidates per batch on its point bucket times the views of
    the group, floored to a power of two, and the population rounded to a
    multiple of it."""
    pop_chunk = max(1, min(population, _POINT_BUDGET // max(1, bucket_size(n_points) * n_views)))
    pop_chunk = 1 << (pop_chunk.bit_length() - 1)
    return pop_chunk, max(pop_chunk, (population // pop_chunk) * pop_chunk)


def _uniform_draws(draws: Draws, seed: int, generations: int, population: int, device):
    if not generations:
        return torch.empty((0, population, 9), device=device)
    if draws is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        u = torch.rand((generations, population, 9), generator=gen, device=device)
        return u * 2.0 - 1.0
    given = draws(seed, generations, population) if callable(draws) else draws[seed]
    u = torch.as_tensor(np.asarray(given, np.float32), device=device)
    if tuple(u.shape) != (generations, population, 9):
        raise ValueError(f"draws for seed {seed} have shape {tuple(u.shape)}, "
                         f"need {(generations, population, 9)}")
    return u


def _search(
    init_vecs: torch.Tensor,  # (V, 9)
    pts: torch.Tensor,  # (V, N, 3)
    labels: torch.Tensor,  # (V, N)
    valid,  # (V, N) bool, or None: every point valid
    gt_labels: torch.Tensor,  # (V, H, W)
    hw,  # (V, 2) int32 image bounds inside (H, W), or None
    part_ids,
    u: torch.Tensor,  # (generations, population, 9) uniform [-1, 1)
    cd_rounds: int,
    lock_xy_equal: bool,
    pop_chunk: int,
    step_scales: torch.Tensor,  # (V,) float32
    cd_mags: Tuple[float, ...] = (1.0,),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random search, then coordinate descent, of V views side by side;
    returns (best (V, 9), IoU (V,)) as device tensors.  Every view takes the
    same draws; nothing else couples them."""
    dev = init_vecs.device
    V = init_vecs.shape[0]
    H, W = gt_labels.shape[-2:]
    chunk = max(1, min(pop_chunk, _PLANE_BUDGET // (V * H * W)))

    def lock(c):
        return torch.cat([c[..., 3:5], c[..., 2:]], dim=-1) if lock_xy_equal else c

    def eval_batch(vecs):  # (V, P, 9) -> (V, P)
        return torch.cat([
            _batch_iou(vecs[:, i:i + chunk], pts, labels, gt_labels, part_ids, H, W, valid, hw)
            for i in range(0, vecs.shape[1], chunk)
        ], dim=1)

    def take_best(cands, ious, best, biou, alive):
        i = ious.argmax(dim=1, keepdim=True)  # first maximum, as jnp.argmax
        top = ious.gather(1, i)[:, 0]
        imp = (top > biou) & alive
        cand = cands.gather(1, i[:, :, None].expand(V, 1, 9))[:, 0]
        return imp, torch.where(imp[:, None], cand, best), torch.where(imp, top, biou)

    best = init_vecs
    biou = eval_batch(init_vecs[:, None])[:, 0]
    steps = torch.tensor(_STEPS0, device=dev) * step_scales[:, None]
    stall = torch.zeros(V, dtype=torch.int32, device=dev)
    shrinks = torch.zeros(V, dtype=torch.int32, device=dev)
    for g in range(u.shape[0]):
        alive = shrinks < 4  # the reference's host loop broke after 4 shrinks
        cand = lock(_fma(u[g][None], steps[:, None], best[:, None]))
        imp, best, biou = take_best(cand, eval_batch(cand), best, biou, alive)
        stall = torch.where(imp, 0, stall + alive.to(torch.int32))
        do_shrink = (stall >= 3) & alive
        steps = torch.where(do_shrink[:, None], steps * 0.7, steps)
        shrinks = shrinks + do_shrink.to(torch.int32)
        stall = torch.where(do_shrink, 0, stall)

    # Coordinate descent: all ±delta probes of the 9 DoF at each magnitude
    # in one batch; (1.0,) is the classic schedule.
    eye = torch.eye(9, dtype=torch.float32, device=dev)
    offs = torch.cat([eye, -eye])
    mags = torch.tensor(np.asarray(cd_mags, np.float32), device=dev)
    delta = 20.0 * step_scales
    yes = torch.ones(V, dtype=torch.bool, device=dev)
    for _ in range(cd_rounds):
        probes = lock((best[:, None, None] + offs * (delta[:, None] * mags)[:, :, None, None])
                      .reshape(V, -1, 9))
        imp, best, biou = take_best(probes, eval_batch(probes), best, biou, yes)
        delta = torch.where(imp, delta, delta * 0.5)
    return best, biou


def _search_one(init_vec: torch.Tensor, pts, labels, mask_sel, part_ids, u, cd_rounds,
                lock_xy_equal, pop_chunk, step_scale: float = 1.0, cd_mags=(1.0,)):
    """:func:`_search` of one view at its true plane ``mask_sel (H, W)`` and
    point count, from ``init_vec (9,)``; returns (best (9,), IoU)."""
    dev = init_vec.device
    best, biou = _search(
        init_vec[None], pts[None], labels[None], None,
        torch.as_tensor(mask_sel, device=dev)[None], None, part_ids, u, cd_rounds,
        lock_xy_equal, pop_chunk, torch.tensor([step_scale], dtype=torch.float32, device=dev),
        tuple(cd_mags),
    )
    return best[0], biou[0]


def _final_params(best: np.ndarray, H: int, W: int) -> Dict:
    params = vector_to_params(np.asarray(best, np.float64), H=H, W=W)
    return {
        "cam_pos": np.asarray(params["cam_pos"], np.float64),
        "target": np.asarray(params["target"], np.float64),
        "f": float(params["f"]),
        "cx": float(params["cx"]),
        "cy": float(params["cy"]),
        "H": H,
        "W": W,
    }


def refine_cameras_batched(
    jobs: Dict,
    *,
    generations: int = 40,
    population: int = 64,
    cd_rounds: int = 6,
    seed: int = 0,
    lock_xy_equal: bool = False,
    coarse_stride: int = 2,
    polish: bool = True,
    point_cap: int = 32768,
    plane_cap: int = 160_000,
    cd_mags: Tuple[float, ...] = (1.0,),
    draws: Draws = None,
    device,
) -> Dict:
    """All views' mask-IoU camera refinements on ``device``, grouped.

    ``jobs``: key -> dict(grid_labels=..., mask_labels=..., parts=[...],
    init_params=..., points=optional precomputed (pts, labels) shell as
    arrays or tensors, step_scale=optional proposal-step multiplier).
    Returns key -> (params, best IoU) like :func:`refine_camera_mask_iou`.

    1. Per view a coarse factor s in {1, 2, 4, 8} keeps the search plane at
       or under ``plane_cap`` pixels (the mask is strided by s; f, cx, cy are
       divided by s and multiplied back), and a point stride of at least
       ``coarse_stride`` keeps the shell at or under ``point_cap`` points.
    2. Views are grouped by the JAX package's key (the coarse plane rounded
       up to 128, the strided shell's point bucket); each group's random
       search runs as one :func:`_search`, padded to its largest member.
       The population is rounded by the group's size as the JAX package
       rounds it, and every view of every group takes the draws of ``seed``.
    3. ``polish=False`` returns the coarse optimum with its coarse IoU (for
       ranking a view's starts against each other).  Otherwise every view's
       coordinate descent runs at native resolution on the full shell from
       its coarse optimum, and its IoU is returned.  Nothing waits on the
       host before all of it is queued.
    """
    keys = list(jobs)
    uploaded: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
    prep = {}
    for k in keys:
        j = jobs[k]
        mask = np.asarray(j["mask_labels"])
        H, W = mask.shape[:2]
        if j.get("points") is None:
            pts, labels = surface_points_by_parts(j["grid_labels"], j["parts"], device=device)
        else:
            if id(j["points"]) not in uploaded:  # views and starts of a monument share a shell
                uploaded[id(j["points"])] = tuple(
                    adopt(torch.as_tensor(a, device=device)) for a in j["points"])
            pts, labels = uploaded[id(j["points"])]
        sel = mask_labels_selected(mask, j["parts"])
        s = 1
        while (H // s) * (W // s) > plane_cap and s < 8:
            s *= 2
        init = dict(j["init_params"])
        for f in ("f", "cx", "cy"):
            init[f] = float(init[f]) / s
        stride = max(coarse_stride, -(-pts.shape[0] // point_cap))
        prep[k] = dict(
            pts=pts, labels=labels, sel=sel, s=s, H=H, W=W, coarse_mask=sel[::s, ::s], init=init,
            part_ids=config.part_ids(j["parts"]), stride=stride,
            n_coarse=len(range(0, pts.shape[0], stride)),
            step_scale=float(j.get("step_scale", 1.0)),
        )

    # ---- phase 1: grouped coarse random search ----
    groups: Dict[Tuple[Tuple[int, int], int], list] = {}
    for k in keys:
        hw = tuple(-(-x // 128) * 128 for x in prep[k]["coarse_mask"].shape[:2])
        groups.setdefault((hw, bucket_size(prep[k]["n_coarse"])), []).append(k)

    coarse: Dict = {}  # key -> ((9,) float64 native-pixel optimum, coarse IoU), on the device
    for (_, bucket), gkeys in groups.items():
        V = len(gkeys)
        members = [prep[k] for k in gkeys]
        N = max(p["n_coarse"] for p in members)
        Hg = max(p["coarse_mask"].shape[0] for p in members)
        Wg = max(p["coarse_mask"].shape[1] for p in members)
        pts_b = torch.zeros((V, N, 3), dtype=torch.float32, device=device)
        lab_b = torch.zeros((V, N), dtype=torch.uint8, device=device)
        val_b = torch.zeros((V, N), dtype=torch.bool, device=device)
        gt_b = np.zeros((V, Hg, Wg), np.uint8)
        for i, p in enumerate(members):
            n = p["n_coarse"]
            pts_b[i, :n] = p["pts"][:: p["stride"]]
            lab_b[i, :n] = p["labels"][:: p["stride"]]
            val_b[i, :n] = True
            cm = p["coarse_mask"]
            gt_b[i, : cm.shape[0], : cm.shape[1]] = cm
        hw_b = torch.tensor([p["coarse_mask"].shape[:2] for p in members], dtype=torch.int32, device=device)
        pop_chunk, pop = _pop_chunk(bucket, population, V)
        best, biou = _search(
            torch.tensor(np.stack([params_to_vector(p["init"]) for p in members]), device=device),
            pts_b, lab_b, val_b, torch.as_tensor(gt_b, device=device), hw_b,
            members[0]["part_ids"], _uniform_draws(draws, seed, generations, pop, device),
            0, lock_xy_equal, pop_chunk,
            torch.tensor([p["step_scale"] for p in members], dtype=torch.float32, device=device),
        )
        best = best.double()
        best[:, 6:9] *= torch.tensor([[p["s"]] for p in members], dtype=torch.float64, device=device)
        for i, k in enumerate(gkeys):  # f, cx, cy back in native pixels
            coarse[k] = (best[i], biou[i])

    if polish:
        # ---- phase 2: native-resolution coordinate descent, all queued ----
        u = torch.empty((0, 1, 9), device=device)
        for k in keys:
            p = prep[k]
            coarse[k] = _search_one(
                coarse[k][0].float(), p["pts"], p["labels"], p["sel"], p["part_ids"], u, cd_rounds,
                lock_xy_equal, _pop_chunk(p["pts"].shape[0], population)[0], p["step_scale"], cd_mags)
    out = {}
    for k in keys:  # in the jobs' order, whatever the groups' was
        best, biou = coarse[k]
        out[k] = (_final_params(best.cpu().numpy(), prep[k]["H"], prep[k]["W"]), float(biou))
    return out


def mask_labels_selected(mask_labels: np.ndarray, parts: Sequence[str]) -> np.ndarray:
    """Zero out non-selected parts (the aligner compares against the
    selected-parts mask, reference: camera_estimation.py:489)."""
    ids = config.part_ids(parts)
    return np.where(np.isin(mask_labels, ids), mask_labels, 0).astype(np.uint8)


def refine_camera_mask_iou(
    grid_labels,
    mask_labels: np.ndarray,
    parts_for_alignment: Sequence[str],
    init_params: Dict,
    *,
    generations: int = 40,
    population: int = 64,
    cd_rounds: int = 6,
    seed: int = 0,
    lock_xy_equal: bool = False,
    step_scale: float = 1.0,
    cd_mags: Tuple[float, ...] = (1.0,),
    draws: Draws = None,
    device,
    _allow_coarse: bool = True,
) -> Tuple[Dict, float]:
    """Automated mask-IoU camera refinement on ``device``.  Returns (params,
    best IoU); the params include H/W like the reference's saved "final"
    tag (camera_estimation.py:536-541).  ``grid_labels`` is a host array or
    a device tensor; ``draws`` is described in the module docstring.  Each
    call adds one to the counter ``stage2.searches`` (its own half-resolution
    stage does not count again)."""
    if _allow_coarse:
        profiling.count("stage2.searches")
    H, W = mask_labels.shape[:2]

    if _allow_coarse and H * W > _COARSE_PLANE_PIXELS:
        # Random search at half resolution (4x cheaper per candidate), then
        # native-resolution coordinate descent from the upscaled optimum.
        half_init = dict(init_params)
        for k in ("f", "cx", "cy"):
            half_init[k] = float(init_params[k]) / 2.0
        kw = dict(population=population, cd_rounds=cd_rounds, seed=seed,
                  lock_xy_equal=lock_xy_equal, step_scale=step_scale, cd_mags=cd_mags,
                  draws=draws, device=device, _allow_coarse=False)
        half, _ = refine_camera_mask_iou(
            grid_labels, mask_labels[::2, ::2], parts_for_alignment, half_init,
            generations=generations, **kw,
        )
        native_init = {
            "cam_pos": half["cam_pos"],
            "target": half["target"],
            "f": half["f"] * 2.0,
            "cx": half["cx"] * 2.0,
            "cy": half["cy"] * 2.0,
        }
        return refine_camera_mask_iou(
            grid_labels, mask_labels, parts_for_alignment, native_init,
            generations=0, **kw,
        )

    # Surface shell, not the solid: the same silhouettes (rays enter
    # through the shell) at a fraction of the points.
    pts, labels = surface_points_by_parts(grid_labels, parts_for_alignment, device=device)
    pop_chunk, population = _pop_chunk(pts.shape[0], population)
    best, best_iou = _search_one(
        torch.tensor(params_to_vector(init_params), device=device), pts, labels,
        mask_labels_selected(mask_labels, parts_for_alignment),
        config.part_ids(parts_for_alignment),
        _uniform_draws(draws, seed, generations, population, device),
        cd_rounds, lock_xy_equal, pop_chunk, float(step_scale), cd_mags,
    )
    return _final_params(best.cpu().numpy(), H, W), float(best_iou)


def evaluate_camera_iou(
    grid_labels,
    mask_labels: np.ndarray,
    parts_for_alignment: Sequence[str],
    cam: Dict,
    *,
    device,
) -> float:
    """Mean per-part IoU of the solid's splat under one camera — the
    reference's ``evaluate`` objective (camera_estimation.py:597-603)."""
    H, W = mask_labels.shape[:2]
    pts, labels = points_by_parts(grid_labels, parts_for_alignment, device=device)
    gt = torch.as_tensor(mask_labels_selected(mask_labels, parts_for_alignment), device=device)
    cam_vec = torch.tensor(params_to_vector(cam), device=device)[None]
    return float(_batch_iou(cam_vec, pts, labels, gt, config.part_ids(parts_for_alignment), H, W)[0])
