"""Write ``tests/fixtures/torch_port_presets.npz``: the JAX package's
unfused stage-1 route (``pbr3d.carving.stage1.carve_monument``) on the masks
smoke phase 9 carves, as hashes and label counts (no grids), and its
``find_symmetry_axis`` on Bibi's front plane.

Runs on the CPU with JAX (about 30 minutes; each 512 carve takes 2-6
minutes; the file is rewritten after every carve)::

    JAX_PLATFORMS=cpu python scripts/make_torch_port_preset_fixture.py

Masks: the five study monuments' front planes of
``tests/fixtures/torch_port_study.npz`` at golden resolution (512; Akbar 128)
and at 256, and Bibi@512 of ``tests/fixtures/torch_port_Bibi_512.npz``.

Contents (``shape`` (3,) int32, ``sha256`` of the C-ordered uint8 bytes,
``counts`` (11,) voxels per label 0..10):

* ``default_{r}_{M}_{shape,sha256,counts}``: the default preset, ``r`` in
  (golden, 256), each monument ``M``, and ``default_bibi512_*``: the
  default preset on Bibi@512.  Where such a grid differs from the fused
  route's (the study fixture's hash, or the Bibi@512 fixture's grid) the
  script says so: the unfused route sweeps every part's occupancy in a
  component's bbox, the fused route (as the reference) the component's own;
* ``other_256_{M}_*`` and ``other_bibi512_*``: the test preset
  ``chip_smoke.OTHER_ANGLE_GROUPS`` (group angles other than the global
  90°) at 256 and on Bibi@512;
* ``symmetry_axis_bibi512``: ``find_symmetry_axis`` of
  ``labels_to_rgb(exterior_labels)`` of Bibi@512;
* ``seconds_{key}``: each carve's seconds, and ``seconds``: the script's.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

OUT = REPO / "tests/fixtures/torch_port_presets.npz"


def _digest(g: np.ndarray):
    g = np.ascontiguousarray(g, np.uint8)
    return (np.asarray(g.shape, np.int32), hashlib.sha256(g.tobytes()).hexdigest(),
            np.bincount(g.reshape(-1), minlength=11).astype(np.int64))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from chip_smoke import OTHER_ANGLE_GROUPS, STUDY, FIXTURE
    from pbr3d import config
    from pbr3d.carving.stage1 import carve_monument
    from pbr3d.config import labels_to_rgb
    from pbr3d.io.masks import MaskSet
    from pbr3d.segmentation.crop import find_symmetry_axis

    t_all = time.perf_counter()
    other = dataclasses.replace(config.DEFAULT_CARVE_PRESET, group_jobs=OTHER_ANGLE_GROUPS)

    def masks(binary, ext, sem):
        return MaskSet(semantic=labels_to_rgb(sem), exterior=labels_to_rgb(ext),
                       binary=binary, semantic_labels=sem, exterior_labels=ext)

    out = {}

    def carve(key, ms, preset, fused_sha256=None):
        t0 = time.perf_counter()
        grid = np.asarray(carve_monument(ms, preset))
        out[f"seconds_{key}"] = time.perf_counter() - t0
        out[f"{key}_shape"], out[f"{key}_sha256"], out[f"{key}_counts"] = _digest(grid)
        same = "" if fused_sha256 is None else (
            ", = the fused route's" if out[f"{key}_sha256"] == fused_sha256 else ", NOT the fused route's")
        print(f"{key}: {grid.shape} sha256 {out[f'{key}_sha256'][:12]}{same} "
              f"in {out[f'seconds_{key}']:.1f} s", flush=True)
        # written after every carve: a 512 carve takes minutes
        np.savez_compressed(args.out, **out)

    fxs = np.load(STUDY)
    fx = np.load(FIXTURE)
    bibi = masks(fx["binary"], fx["exterior_labels"], fx["semantic_labels"])
    out["symmetry_axis_bibi512"] = np.int64(find_symmetry_axis(labels_to_rgb(fx["exterior_labels"])))
    print(f"symmetry axis of Bibi@512's front plane: {int(out['symmetry_axis_bibi512'])}", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    carve("other_bibi512", bibi, other)
    carve("default_bibi512", bibi, config.DEFAULT_CARVE_PRESET, _digest(fx["grid"])[1])
    for tag in ("256", "golden"):
        for m in config.MONUMENTS:
            ms = masks(*(fxs[f"{tag}_{m}_{k}"] for k in ("binary", "exterior", "semantic")))
            if tag == "256":
                carve(f"other_256_{m}", ms, other)
            carve(f"default_{tag}_{m}", ms, config.DEFAULT_CARVE_PRESET, str(fxs[f"{tag}_{m}_sha256"]))
    out["seconds"] = time.perf_counter() - t_all
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} in {out['seconds']:.0f} s")


if __name__ == "__main__":
    main()
