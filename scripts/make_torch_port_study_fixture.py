"""Write ``tests/fixtures/torch_port_study.npz``: the inputs and the JAX
package's stage-1 anchors of the five-monument study, at golden resolution
(512; Akbar 128) and at 256, for driving ``pbr3d_torch.pipeline.run_all`` on
the card.

Runs on the CPU with JAX in about three minutes (the four 512 carves go
through ``carve_monuments_batched`` one scene at a time to bound the host's
memory; the five 256 scenes go through it together, its stacked route)::

    JAX_PLATFORMS=cpu python scripts/make_torch_port_study_fixture.py

Masks.  The reference's PNG masks are not in the repo, so each monument's
three front label planes are recovered from its committed stage-1 grid
(``results_temp_golden/1.Orthographic_Voxel_Carving`` and, at 256,
``results_temp/1.Orthographic_Voxel_Carving``): the grid is un-reoriented to
(W, H, D) and each (x, y) column reads the label of its front-most occupied
voxel along depth.  ``back_minarets`` reads as ``front_minarets`` (the
recolour is stage 1's last step).  Interior labels (doors, windows) stay in
the semantic plane; the exterior plane reads the front-most voxel that is not
an interior one (Charminar's windows sit on its minarets, not only on
``full_building``, and the windows of its open arches on nothing at all);
``binary`` is ``exterior > 0``.  This is an
approximation of the PNG masks (columns that stage 1 carved away entirely
are lost, so every silhouette is a little narrower), which is why the anchor
is the JAX package's own carve of these masks and not the committed grid.
An interior pixel over a minaret column reads as the minaret in the semantic
plane too (only Charminar has such pixels): on the narrower recovered
minarets the guided window carve cuts a sliver of a few voxels loose, which
stage 1's recolour then counts as one of the two front-most minarets, and
the front right minaret comes out as a back one.

Stage 1 also drops the mask's ``back_minarets`` pixels (no carve group holds
that label), so the recovered planes have none, while the PNG masks do: as a
front VIEW such a plane caps the camera search's mean part IoU at 0.5 and
leaves the keypoint fit without the back minarets' correspondences.  The
front view of stages 2 and 3 is therefore planted like the drone view: the
JAX stage-1 grid rendered through the committed front camera.

Contents, for ``r`` in (golden, 256) and each monument ``M``:

* ``{r}_{M}_binary``, ``{r}_{M}_exterior``, ``{r}_{M}_semantic``: (H, W) uint8;
* ``{r}_{M}_front``: the planted front view of stages 2 and 3 — the JAX
  stage-1 grid rendered through the committed front camera of that
  resolution at its own H, W (the recovered planes' shape), each pixel the
  label of its nearest voxel (Charminar's minarets are drawn over its
  building, see ``main``); ``{r}_{M}_front_cam`` is that camera's 9-vector;
* ``{r}_{M}_drone``: a planted drone view — every occupied voxel of the JAX
  stage-1 grid splatted through the committed drone camera of that
  resolution (``results_temp*/2.Perspective_Camera_Estimation/
  {M}_camera_params_final.json``) at its own H, W; ``{r}_{M}_drone_cam`` is
  that camera's 9-vector;
* ``{r}_{M}_shape`` (3,), ``{r}_{M}_sha256`` (str), ``{r}_{M}_counts`` (11,):
  the JAX ``carve_monuments_batched`` grid on those masks: its shape, the
  sha256 of its uint8 bytes (C order) and its voxel count per label 0..10;
* ``seconds``: how long this script ran.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np
import scipy.ndimage

from pbr3d import config
from pbr3d.config import PART_IDS, labels_to_rgb

#: resolution tag -> (committed results directory, max_dim handed to run_all)
RESOLUTIONS = {"golden": ("results_temp_golden", None), "256": ("results_temp", 256)}
STAGE1_DIR = "1.Orthographic_Voxel_Carving"
STAGE2_DIR = "2.Perspective_Camera_Estimation"


def recover_front_planes(grid: np.ndarray):
    """(binary, exterior_labels, semantic_labels), each (H, W) uint8, from a
    reoriented stage-1 label grid (see the module docstring)."""
    g = np.transpose(np.flip(grid, axis=1), (2, 1, 0))  # (W, H, D)
    g = np.where(g == PART_IDS["back_minarets"], PART_IDS["front_minarets"], g).astype(np.uint8)

    def front_most(vol):
        return np.take_along_axis(vol, (vol > 0).argmax(axis=2)[:, :, None], axis=2)[:, :, 0].T.copy()

    interior = np.isin(g, [PART_IDS[p] for p in config.INTERIOR_PARTS])
    sem = front_most(g)
    ext = front_most(np.where(interior, 0, g))
    # A column that holds interior voxels only: a wall thinner than the
    # extrusion is painted through and takes the exterior label of the
    # nearest column that shows one, while an opening of the exterior mask
    # was empty, and the extrusion painted its slab from the grid's first
    # voxel.
    painted_through = (ext == 0) & (sem > 0) & ((g > 0).argmax(axis=2).T > 0)
    near = scipy.ndimage.distance_transform_edt(ext == 0, return_distances=False, return_indices=True)
    ext[painted_through] = ext[near[0][painted_through], near[1][painted_through]]
    interior_over_minaret = (ext == PART_IDS["front_minarets"]) & np.isin(
        sem, [PART_IDS[p] for p in config.INTERIOR_PARTS])
    sem[interior_over_minaret] = PART_IDS["front_minarets"]
    return (ext > 0).astype(np.uint8), ext, sem


def planted_front(grid: np.ndarray, cam: dict) -> np.ndarray:
    """(H, W) uint8 label plane: every occupied voxel of ``grid`` projected
    through ``cam`` at its own H, W, the nearest one seen in each pixel."""
    import jax.numpy as jnp

    from pbr3d.carving.voxel import all_points
    from pbr3d.ops.cameramath import project_points

    H, W = int(cam["H"]), int(cam["W"])
    pts, labels = all_points(grid)
    u, v, z = (np.asarray(a) for a in project_points(
        jnp.asarray(pts, jnp.float32), np.asarray(cam["cam_pos"], np.float32),
        np.asarray(cam["target"], np.float32), cam["f"], cam["cx"], cam["cy"]))
    ur, vr = np.rint(u), np.rint(v)
    ok = (ur >= 0) & (ur < W) & (vr >= 0) & (vr < H) & (z > 1e-6)
    pix = (vr[ok] * W + ur[ok]).astype(np.int64)
    order = np.lexsort((z[ok], pix))  # by pixel, nearest first
    first = np.unique(pix[order], return_index=True)[1]
    out = np.zeros(H * W, np.uint8)
    out[pix[order][first]] = np.asarray(labels)[ok][order][first]
    return out.reshape(H, W)


def grid_digest(grid: np.ndarray):
    """(shape, sha256 of the C-ordered uint8 bytes, voxel count per label 0..10)."""
    g = np.ascontiguousarray(grid, np.uint8)
    return (np.asarray(g.shape, np.int32), hashlib.sha256(g.tobytes()).hexdigest(),
            np.bincount(g.reshape(-1), minlength=11).astype(np.int64))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=REPO / "tests/fixtures/torch_port_study.npz")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from pbr3d.camera.geometry import params_to_vector
    from pbr3d.carving.fused import carve_monuments_batched
    from pbr3d.io.artifacts import load_voxel_grid_labels
    from pbr3d.io.masks import MaskSet

    spec = importlib.util.spec_from_file_location(
        "make_torch_port_stage2_fixture", REPO / "scripts" / "make_torch_port_stage2_fixture.py")
    stage2_fx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(stage2_fx)

    out = {}
    for tag, (results, _) in RESOLUTIONS.items():
        sets = {}
        for m in config.MONUMENTS:
            committed = load_voxel_grid_labels(REPO / results / STAGE1_DIR / f"{m}_voxel_grid.npz")
            binary, ext, sem = recover_front_planes(committed)
            out[f"{tag}_{m}_binary"], out[f"{tag}_{m}_exterior"], out[f"{tag}_{m}_semantic"] = \
                binary, ext, sem
            sets[m] = MaskSet(semantic=labels_to_rgb(sem), exterior=labels_to_rgb(ext),
                              binary=binary, semantic_labels=sem, exterior_labels=ext)
        if tag == "256":
            t0 = time.perf_counter()
            grids = carve_monuments_batched(sets)
            print(f"{tag}: five scenes stacked, {time.perf_counter() - t0:.1f} s", flush=True)
        else:
            grids = {}
            for m in config.MONUMENTS:
                t0 = time.perf_counter()
                grids.update(carve_monuments_batched({m: sets[m]}))
                print(f"{tag}: {m} {grids[m].shape} {time.perf_counter() - t0:.1f} s", flush=True)
        for m in config.MONUMENTS:
            grid = np.asarray(grids[m])
            shape, digest, counts = grid_digest(grid)
            out[f"{tag}_{m}_shape"], out[f"{tag}_{m}_sha256"], out[f"{tag}_{m}_counts"] = \
                shape, digest, counts
            cams = json.loads(
                (REPO / results / STAGE2_DIR / f"{m}_camera_params_final.json").read_text())
            # Charminar's windows come from the window variant of its front
            # mask, which only stage 1's semantic plane reads: the views of
            # stages 2 and 3 do not show them (on its minarets they would cut
            # each minaret's region into pieces), so its planted views see
            # through the window voxels.
            seen = grid if m != "Charminar" else np.where(
                np.isin(grid, [PART_IDS[p] for p in config.INTERIOR_PARTS]), 0, grid).astype(np.uint8)
            cam = cams["drone"]
            out[f"{tag}_{m}_drone"] = stage2_fx.planted_view(seen, cam, cam["H"], cam["W"])
            out[f"{tag}_{m}_drone_cam"] = params_to_vector(cam)
            front = planted_front(seen, cams["front"])
            if m == "Charminar":
                # Its back minarets stand behind the open arcades and show in
                # pieces between the arches; the 2D minaret pairing takes each
                # piece for a minaret.  Its front view draws the minarets
                # whole, over the building, as the search's objective renders
                # them (it projects the minarets alone).
                minarets = planted_front(np.where(np.isin(seen, config.part_ids(
                    ("front_minarets", "back_minarets"))), seen, 0).astype(np.uint8), cams["front"])
                front = np.where(minarets > 0, minarets, front).astype(np.uint8)
            out[f"{tag}_{m}_front"] = front
            out[f"{tag}_{m}_front_cam"] = params_to_vector(cams["front"])
            if out[f"{tag}_{m}_front"].shape != out[f"{tag}_{m}_semantic"].shape:
                raise SystemExit(f"{tag} {m}: the committed front camera's image is not the mask's shape")
            print(f"{tag}: {m} grid {tuple(shape)} sha256 {digest[:12]} occupied "
                  f"{int(counts[1:].sum())} drone {out[f'{tag}_{m}_drone'].shape} labels "
                  f"{np.unique(out[f'{tag}_{m}_drone']).tolist()} front labels "
                  f"{np.unique(out[f'{tag}_{m}_front']).tolist()}", flush=True)
        del grids

    out["seconds"] = np.float64(time.perf_counter() - t_start)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} {os.path.getsize(args.out)} bytes in {float(out['seconds']):.0f} s")


if __name__ == "__main__":
    main()
