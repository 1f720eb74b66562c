"""Stage artifacts: npz voxel grids and camera JSONs in the reference's
``results/`` layout.

A copy of ``pbr3d.io.artifacts``: importing it from ``pbr3d.io`` would
import ``pbr3d.io.masks`` and with it ``cv2``, which the port does not need
on its main path.

* voxel grids: ``np.savez_compressed(path, voxel_grid=uint8 (W,H,D,3))``
  (reference: notebook 1 cell 9, notebook 3 cell 9).
* cameras: ``{view: {cam_pos, target, f, cx, cy[, H, W]}}`` JSON
  (reference: notebook 2 cell 11; loader utils/eval_helpers_intra.py:56-75).
"""

from __future__ import annotations

import functools
import json
import zipfile
from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from pbr3d_torch.config import OTHER_ID, _decode_table, labels_to_rgb, rgb_to_labels
from pbr3d_torch.utils import profiling

#: Bytes of the npz member inflated a step on the streamed route (taken down
#: to a multiple of 3, so a step holds whole voxels).
_STREAM_CHUNK = 12 << 20


def save_voxel_grid(path: str | Path, labels: np.ndarray) -> None:
    """Save a uint8 label grid (W,H,D) as a reference-format RGB npz."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, voxel_grid=labels_to_rgb(np.asarray(labels)))


def load_voxel_grid_rgb(path: str | Path) -> np.ndarray:
    """uint8 (W,H,D,3) RGB voxel grid (reference: eval_helpers_intra.py:19-23)."""
    return np.load(path)["voxel_grid"]


@profiling.spanned("io.load_voxel_grid")
def load_voxel_grid_labels(path: str | Path, device=None):
    """uint8 (W,H,D) label grid (non-palette colors -> OTHER_ID, none expected).

    With ``device=None`` a numpy array decoded on the host.  With a device a
    uint8 tensor there, equal to the host route's labels: a uint8 C-order
    ``(..., 3)`` member is inflated in steps straight from the zip and each
    step decoded where the labels go (counted as ``io.load_voxel_grid.device``);
    any other member is decoded on the host and uploaded."""
    if device is None:
        return rgb_to_labels(load_voxel_grid_rgb(path))
    labels = _stream_labels(path, torch.device(device))
    if labels is None:
        return torch.as_tensor(rgb_to_labels(load_voxel_grid_rgb(path)), device=device)
    profiling.count("io.load_voxel_grid.device")
    return labels


@functools.cache
def _device_decode_table(other_id: int, device: torch.device) -> torch.Tensor:
    """:func:`pbr3d_torch.config._decode_table` on ``device`` (a constant of the
    palette: one copy a process and device)."""
    return torch.from_numpy(_decode_table(other_id)).to(device)


def _rgb_member_shape(f) -> Optional[tuple]:
    """Shape of the ``.npy`` whose header ``f`` is at, read past the header;
    None unless it holds uint8 ``(..., 3)`` in C order."""
    version = np.lib.format.read_magic(f)
    if version == (1, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
    elif version == (2, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
    else:
        return None
    return shape if dtype == np.uint8 and not fortran and shape and shape[-1] == 3 else None


def _stream_labels(path: str | Path, device: torch.device, other_id: int = OTHER_ID) -> Optional[torch.Tensor]:
    """The ``voxel_grid`` member's labels on ``device``, inflated
    :data:`_STREAM_CHUNK` bytes a step and decoded there by the palette table
    (keys ``r << 16 | g << 8 | b``), so the RGB array is never whole on the
    host or the device.  On CUDA each step is read into one of two pinned
    buffers and copied without blocking: the host inflates step i + 1 while the
    device takes step i.  None where the member is missing, not uint8, in
    Fortran order or not ``(..., 3)``."""
    if not zipfile.is_zipfile(path):
        return None
    with zipfile.ZipFile(path) as zf:
        if "voxel_grid.npy" not in zf.namelist():
            return None
        with zf.open("voxel_grid.npy") as f:
            shape = _rgb_member_shape(f)
            if shape is None:
                return None
            nbytes, step = 3 * int(np.prod(shape[:-1])), _STREAM_CHUNK // 3 * 3
            table = _device_decode_table(other_id, device)
            out = torch.empty(nbytes // 3, dtype=torch.uint8, device=device)
            cuda = device.type == "cuda"
            bufs = [torch.empty(min(step, nbytes), dtype=torch.uint8, pin_memory=cuda) for _ in range(2 if cuda else 1)]
            freed = [None] * len(bufs)
            for k, a in enumerate(range(0, nbytes, step)):
                b, i = min(a + step, nbytes), k % len(bufs)
                if freed[i] is not None:
                    freed[i].synchronize()  # its last copy has left
                if f.readinto(bufs[i][: b - a].numpy()) != b - a:
                    raise ValueError(f"{path}: the npz member ends before its header's shape")
                rgb = bufs[i][: b - a].to(device, non_blocking=True)
                if cuda:
                    freed[i] = torch.cuda.Event()
                    freed[i].record(torch.cuda.current_stream(device))
                rgb = rgb.view(-1, 3).to(torch.int32)
                key = rgb[:, 0] << 16 | rgb[:, 1] << 8 | rgb[:, 2]
                torch.index_select(table, 0, key, out=out[a // 3 : b // 3])
    return out.view(shape[:-1])


def _to_json_safe(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, dict):
        return {k: _to_json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_json_safe(v) for v in obj]
    return obj


def save_camera_params(path: str | Path, params_by_view: Mapping[str, Mapping]) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(_to_json_safe(dict(params_by_view)), f, indent=2)


def load_camera_json(path: str | Path, view: str) -> Dict[str, np.ndarray | float]:
    """One view's camera from a reference-format JSON."""
    with open(path) as f:
        data = json.load(f)
    if view not in data:
        raise KeyError(f"View '{view}' not found in {Path(path).name}")
    cam = data[view]
    return {
        "cam_pos": np.array(cam["cam_pos"], dtype=np.float32),
        "target": np.array(cam["target"], dtype=np.float32),
        "f": float(cam["f"]),
        "cx": float(cam["cx"]),
        "cy": float(cam["cy"]),
    }


def voxel_grid_iou(a: np.ndarray, b: np.ndarray) -> float:
    """Occupancy IoU between two grids (label (W,H,D) or RGB (W,H,D,3)).

    The golden-regression metric: per-stage voxel-IoU vs ``results/``.
    """
    occ_a = np.any(a > 0, axis=-1) if a.ndim == 4 else a > 0
    occ_b = np.any(b > 0, axis=-1) if b.ndim == 4 else b > 0
    if occ_a.shape != occ_b.shape:
        raise ValueError(f"shape mismatch: {occ_a.shape} vs {occ_b.shape}")
    union = np.logical_or(occ_a, occ_b).sum()
    if union == 0:
        return float("nan")
    return float(np.logical_and(occ_a, occ_b).sum() / union)


def colored_voxel_grid_iou(a: np.ndarray, b: np.ndarray) -> float:
    """Exact-label IoU over occupied voxels of either grid."""
    la = rgb_to_labels(a) if a.ndim == 4 else a
    lb = rgb_to_labels(b) if b.ndim == 4 else b
    occ = (la > 0) | (lb > 0)
    union = occ.sum()
    if union == 0:
        return float("nan")
    return float(((la == lb) & occ).sum() / union)
