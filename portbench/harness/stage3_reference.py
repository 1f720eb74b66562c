"""The plain reference of stage 3's rebuild, in float64 PyTorch and numpy,
beside ``study_reference.py``.

It imports nothing of the program: from the padded stage-1 grid, the deform
parameters that stage 3 returned and the shape of the front mask it searched
against, it rebuilds the deformed grid as the reference's
``utils/deformation_estimation.py`` does (the part-wise warp, lines 70-124;
the rebuild, ``save_deformed_grid``, lines 288-313):

* a part's points are its voxels, (x, y, z) = (d2, d1, d0); its centroid is
  their mean;
* about the centroid, each point is scaled and shifted symmetrically::

      x' = (x - cx)·scale_xz + shift_xz·(W / W_img)·sign(x - cx) + cx
      y' = (y - cy)·scale_y  - shift_y ·(H / H_img)                + cy
      z' = (z - cz)·scale_xz + shift_xz·(D / W_img)·sign(z - cz) + cz

  with (D, H, W) the padded grid's shape and (H_img, W_img) the mask's;
* seven copies of each warped point, jittered by 0 and ±0.25 along each
  axis, are rounded half to even; copies that leave the grid are dropped;
* the parts are scattered in the palette's order (``PART_IDS``), later
  parts overwriting earlier ones; a part without deform parameters is not
  scattered.

Departures from the reference: every number is float64 (the reference's
numpy default) or ``dtype`` (bfloat16 for the control), where the program
warps in float32 with XLA's fused multiply-add, so a point whose warped
coordinate lies within a float32 rounding of a half may round the other
way; the ratios and the centroid are float64 divisions.  The notebook-4
recount of the rebuilt grid is ``study_reference.visible_part_ious``.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness.study_reference import PART_IDS

#: The jitter copies (``deformation_estimation.py:70-98``): (dx, dy, dz).
JITTER = ((0, 0, 0), (0.25, 0, 0), (-0.25, 0, 0), (0, 0.25, 0), (0, -0.25, 0), (0, 0, 0.25), (0, 0, -0.25))
#: Points warped a pass (each holds seven copies of a few float64 numbers).
CHUNK = 1 << 22


def _scatter_part(out: torch.Tensor, pts: torch.Tensor, d: dict, ratios, label: int, dtype) -> None:
    """Warp one part's points ``(N, 3)`` (x, y, z) by the deform ``d`` and
    write ``label`` where its copies land, in place."""
    D, H, W = out.shape
    px, py, pz = (torch.tensor(r, dtype=dtype, device=out.device) for r in ratios)
    sy, dy, sxz, dxz = (torch.tensor(float(d[k]), dtype=dtype, device=out.device)
                        for k in ("scale_y", "shift_y", "scale_xz", "shift_xz"))
    c = pts.to(torch.float64).mean(0).to(dtype)
    jit = torch.tensor(JITTER, dtype=dtype, device=out.device)
    hi = torch.tensor([W - 1, H - 1, D - 1], dtype=torch.float64, device=out.device)
    for s in range(0, pts.shape[0], CHUNK):
        q = pts[s:s + CHUNK].to(dtype) - c
        w = torch.stack([q[:, 0] * sxz + dxz * px * torch.sign(q[:, 0]),
                         q[:, 1] * sy - dy * py,
                         q[:, 2] * sxz + dxz * pz * torch.sign(q[:, 2])], 1) + c
        r = torch.round(w[None] + jit[:, None]).reshape(-1, 3).double()
        r = r[((r >= 0) & (r <= hi)).all(1)].long()
        out.view(-1).index_fill_(0, (r[:, 2] * H + r[:, 1]) * W + r[:, 0], label)


def rebuild(grid_init_padded: np.ndarray, deforms: dict, mask_hw, *, device="cpu",
            dtype=torch.float64) -> np.ndarray:
    """The deformed uint8 label grid that ``deforms`` (``{part: {"deform":
    {scale_y, shift_y, scale_xz, shift_xz}, ...}}``, stage 3's answer) make
    of the padded stage-1 grid, for a front mask of shape ``mask_hw``."""
    g = torch.as_tensor(np.ascontiguousarray(grid_init_padded), device=device)
    D, H, W = g.shape
    h_img, w_img = (int(v) for v in mask_hw[:2])
    ratios = (W / w_img, H / h_img, D / w_img)
    out = torch.zeros_like(g, dtype=torch.uint8)
    for part, pid in sorted(PART_IDS.items(), key=lambda kv: kv[1]):
        if part not in deforms:
            continue
        d0, d1, d2 = torch.nonzero(g == pid, as_tuple=True)
        if d0.numel():
            _scatter_part(out, torch.stack([d2, d1, d0], 1), deforms[part]["deform"], ratios, pid, dtype)
    return out.cpu().numpy()
