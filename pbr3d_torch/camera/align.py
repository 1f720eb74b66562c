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
batch is one batched splat + IoU (``_batch_iou``); populations above
``pop_chunk`` run in chunks of it.

Draws.  The JAX package draws its proposals from ``jax.random`` (threefry),
which torch cannot reproduce.  ``draws=None`` takes them from a
``torch.Generator`` on the device seeded with ``seed``; ``draws`` may instead
map each seed to a ``(generations, population, 9)`` float32 array of
uniform [-1, 1) draws — for the JAX package's own,
``jax.random.uniform(k, (population, 9), f32, -1, 1)`` for each ``k`` in
``jax.random.split(PRNGKey(seed), generations)`` — and then the search
follows the JAX trajectory wherever the objectives agree.  ``population`` is
rounded exactly as the JAX package rounds it (see :func:`_pop_chunk`), so
the same draws fit.

Not ported here: ``refine_cameras_batched`` (``run_all``'s search of all
views at once) and the one-hot matmul objective the JAX package uses inside
its half-resolution recursion; the port splats exactly everywhere.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from pbr3d_torch import config
from pbr3d_torch.camera.geometry import params_to_vector, vector_to_params
from pbr3d_torch.carving.voxel import bucket_size, points_by_parts, surface_points_by_parts
from pbr3d_torch.ops.cameramath import _fma
from pbr3d_torch.ops.projection import partwise_iou, splat_labels

#: Reference step sizes (camera_estimation.py:605-616).
_STEPS0 = np.array([50, 50, 100, 50, 50, 100, 50, 20, 20], np.float32)

#: Image planes with more pixels than this run their random-search
#: generations at half resolution, then coordinate descent at native
#: resolution from the upscaled optimum.
_COARSE_PLANE_PIXELS = 512 * 512

Draws = Optional[Mapping[int, np.ndarray]]


def _batch_iou(cam_vecs: torch.Tensor, pts, labels, gt_labels, part_ids, H: int, W: int):
    """(P,) float32 mean part IoU of each (P, 9) camera's splat of ``pts``
    against ``gt_labels (H, W)``."""
    img = splat_labels(
        pts, labels, None, cam_vecs[:, 0:3], cam_vecs[:, 3:6],
        cam_vecs[:, 6], cam_vecs[:, 7], cam_vecs[:, 8], H, W,
    )
    return partwise_iou(img, gt_labels, part_ids)[1]


def _pop_chunk(n_points: int, population: int) -> Tuple[int, int]:
    """(pop_chunk, effective population): the JAX package's memory bound of
    ~2^26 point-candidates per batch on its point bucket, floored to a power
    of two, and the population rounded to a multiple of it."""
    pop_chunk = max(1, min(population, (1 << 26) // bucket_size(n_points)))
    pop_chunk = 1 << (pop_chunk.bit_length() - 1)
    return pop_chunk, max(pop_chunk, (population // pop_chunk) * pop_chunk)


def _uniform_draws(draws: Draws, seed: int, generations: int, population: int, device):
    if draws is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        u = torch.rand((generations, population, 9), generator=gen, device=device)
        return u * 2.0 - 1.0
    u = torch.as_tensor(np.asarray(draws[seed], np.float32), device=device)
    if tuple(u.shape) != (generations, population, 9):
        raise ValueError(f"draws for seed {seed} have shape {tuple(u.shape)}, "
                         f"need {(generations, population, 9)}")
    return u


def _search(
    init_vec: torch.Tensor,
    pts: torch.Tensor,
    labels: torch.Tensor,
    gt_labels: torch.Tensor,
    part_ids,
    H: int, W: int,
    u: torch.Tensor,  # (generations, population, 9) uniform [-1, 1)
    cd_rounds: int,
    lock_xy_equal: bool,
    pop_chunk: int,
    step_scale: float = 1.0,
    cd_mags: Tuple[float, ...] = (1.0,),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random search, then coordinate descent; returns (best (9,), IoU) as
    device tensors."""
    dev = init_vec.device

    def lock(c):
        return torch.cat([c[:, 3:5], c[:, 2:]], dim=1) if lock_xy_equal else c

    def eval_batch(vecs):
        return torch.cat([
            _batch_iou(vecs[i:i + pop_chunk], pts, labels, gt_labels, part_ids, H, W)
            for i in range(0, vecs.shape[0], pop_chunk)
        ])

    def take_best(cands, ious, best, biou, alive):
        i = ious.argmax().reshape(1)  # first maximum, as jnp.argmax
        top = ious.index_select(0, i)[0]
        imp = (top > biou) & alive
        return imp, torch.where(imp, cands.index_select(0, i)[0], best), torch.where(imp, top, biou)

    best = init_vec
    biou = eval_batch(init_vec[None])[0]
    steps = torch.tensor(_STEPS0, device=dev) * step_scale
    stall = torch.zeros((), dtype=torch.int32, device=dev)
    shrinks = torch.zeros((), dtype=torch.int32, device=dev)
    for g in range(u.shape[0]):
        alive = shrinks < 4  # the reference's host loop broke after 4 shrinks
        cand = lock(_fma(u[g], steps[None], best[None]))
        imp, best, biou = take_best(cand, eval_batch(cand), best, biou, alive)
        stall = torch.where(imp, 0, stall + alive.to(torch.int32))
        do_shrink = (stall >= 3) & alive
        steps = torch.where(do_shrink, steps * 0.7, steps)
        shrinks = shrinks + do_shrink.to(torch.int32)
        stall = torch.where(do_shrink, 0, stall)

    # Coordinate descent: all ±delta probes of the 9 DoF at each magnitude
    # in one batch; (1.0,) is the classic schedule.
    eye = torch.eye(9, dtype=torch.float32, device=dev)
    offs = torch.cat([eye, -eye])
    mags = torch.tensor(np.asarray(cd_mags, np.float32), device=dev)
    delta = torch.tensor(20.0, dtype=torch.float32, device=dev) * step_scale
    yes = torch.ones((), dtype=torch.bool, device=dev)
    for _ in range(cd_rounds):
        probes = lock((best[None, None] + offs[None] * (delta * mags)[:, None, None]).reshape(-1, 9))
        imp, best, biou = take_best(probes, eval_batch(probes), best, biou, yes)
        delta = torch.where(imp, delta, delta * 0.5)
    return best, biou


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
    a device tensor; ``draws`` is described in the module docstring."""
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
    gt = torch.as_tensor(mask_labels_selected(mask_labels, parts_for_alignment), device=device)
    pop_chunk, population = _pop_chunk(pts.shape[0], population)
    u = _uniform_draws(draws, seed, generations, population, device) if generations else \
        torch.empty((0, population, 9), device=device)
    best, best_iou = _search(
        torch.tensor(params_to_vector(init_params), device=device),
        pts, labels, gt, config.part_ids(parts_for_alignment), H, W,
        u, cd_rounds, lock_xy_equal, pop_chunk, float(step_scale), tuple(cd_mags),
    )
    params = vector_to_params(best.cpu().numpy().astype(np.float64), H=H, W=W)
    out = {
        "cam_pos": np.asarray(params["cam_pos"], np.float64),
        "target": np.asarray(params["target"], np.float64),
        "f": float(params["f"]),
        "cx": float(params["cx"]),
        "cy": float(params["cy"]),
        "H": H,
        "W": W,
    }
    return out, float(best_iou)


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
