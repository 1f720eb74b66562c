"""Part palette, label ids, monuments and carve presets of the port.

The port's own copy of what it uses from ``pbr3d.config`` (the JAX
package's config, which the port does not import): the same names with the
same values, which ``tests/test_torch_config.py`` holds against it.

Label convention
----------------
* 3D voxel grids: ``0`` = empty (black), ``1..10`` = the ten parts.
* 2D masks:       ``1..10`` = the ten parts, ``OTHER_ID`` (11) = any pixel
  whose colour matches no part colour (e.g. bilinear-resize blends — these
  count as foreground for silhouette carving).

``rgb_to_labels`` decodes through a 2^24-entry lookup table indexed by
``r << 16 | g << 8 | b`` instead of one pass over the voxels per palette
colour; it returns exactly what the JAX package's loop returns.
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

# Part colours (reference: utils/config.py:29-40) — order defines label ids.
PART_COLORS: Dict[str, Tuple[int, int, int]] = {
    "full_building": (253, 248, 96),
    "chhatris": (1, 220, 5),
    "plinth": (63, 138, 173),
    "dome": (190, 0, 255),
    "front_minarets": (0, 0, 255),
    "back_minarets": (5, 223, 223),
    "small_minarets": (255, 180, 80),
    "main_door": (180, 140, 255),
    "windows": (255, 120, 230),
    "background": (216, 224, 251),
}

PART_COLORS_NP: Dict[str, np.ndarray] = {
    k: np.array(v, dtype=np.uint8) for k, v in PART_COLORS.items()
}

PART_NAMES: List[str] = list(PART_COLORS.keys())

#: name -> label id (1-based; 0 is reserved for "empty").
PART_IDS: Dict[str, int] = {name: i + 1 for i, name in enumerate(PART_NAMES)}

EMPTY_ID: int = 0
BACKGROUND_ID: int = PART_IDS["background"]  # 10
#: 2D-mask label for foreground pixels matching no palette colour.
OTHER_ID: int = len(PART_NAMES) + 1  # 11
NUM_LABELS: int = OTHER_ID + 1  # ids 0..11

#: (NUM_LABELS, 3) uint8 — row i is the RGB colour of label i.  Row 0 is
#: black (empty); row OTHER_ID is a sentinel, never decoded as a part.
PALETTE: np.ndarray = np.zeros((NUM_LABELS, 3), dtype=np.uint8)
for _name, _i in PART_IDS.items():
    PALETTE[_i] = PART_COLORS[_name]
PALETTE[OTHER_ID] = (1, 1, 1)

INTERIOR_PARTS: List[str] = ["main_door", "windows"]  # utils/config.py:43

MAX_DIM: int = 256  # utils/config.py:45

MONUMENTS: List[str] = ["Akbar", "Bibi", "Charminar", "Itimad", "Taj"]

# Mask-file suffix map (reference: utils/config.py:6-27).
MONUMENT_CONFIG: Dict[str, Dict[str, object]] = {
    "Akbar": {"front": ["_front_mask.png"], "drone": "_drone_mask.png"},
    "Bibi": {"front": ["_front_mask.png"], "drone": "_drone_mask.png"},
    "Charminar": {
        "front": ["_front_mask.png", "_front_mask_win.png"],
        "drone": "_drone_mask.png",
    },
    "Itimad": {"front": ["_front_mask.png"], "drone": "_drone_mask.png"},
    "Taj": {"front": ["_front_mask.png"], "drone": "_drone_mask.png"},
}

#: Resolution each golden stage-1 grid was produced at.
GOLDEN_MAX_DIM: Dict[str, int] = {
    "Akbar": 128,
    "Bibi": 512,
    "Charminar": 512,
    "Itimad": 512,
    "Taj": 512,
}

#: Zero-padding appended to grid dim 1 before stage-3 deformation.
STAGE3_PAD: Dict[str, int] = {
    "Akbar": 0,
    "Bibi": 60,
    "Charminar": 0,
    "Itimad": 60,
    "Taj": 60,
}


@dataclasses.dataclass(frozen=True)
class CarvePreset:
    """Hyper-parameters of one stage-1 carving run (reference: notebook 1
    cell 7)."""

    #: (part-name group, sweep angle interval) pairs carved against their own
    #: 2D mask under global symmetry.
    group_jobs: Tuple[Tuple[Tuple[str, ...], int], ...] = (
        (("full_building",), 90),
        (("chhatris",), 90),
        (("plinth",), 90),
        (("front_minarets",), 90),
        (("small_minarets",), 90),
        (("dome",), 90),
    )
    #: part -> finer sweep interval for per-component carving.
    part_symmetry: Tuple[Tuple[str, int], ...] = (
        ("dome", 5),
        ("chhatris", 45),
        ("front_minarets", 5),
        ("small_minarets", 5),
    )
    #: interior part -> inward extrusion depth (voxels).
    extrusion_depths: Tuple[Tuple[str, int], ...] = (
        ("main_door", 20),
        ("windows", 10),
    )
    #: global silhouette sweep interval.
    global_angle_interval: int = 90
    recolor_back_minarets: bool = True


DEFAULT_CARVE_PRESET = CarvePreset()


def labels_to_rgb(labels: np.ndarray) -> np.ndarray:
    """uint8 label array (...,) -> uint8 RGB array (..., 3)."""
    return PALETTE[np.asarray(labels)]


#: Voxels per step of :func:`rgb_to_labels`; bounds its uint32 keys to 16 MB.
_DECODE_CHUNK = 1 << 22


@functools.cache
def _decode_table(other_id: int) -> np.ndarray:
    """(2^24,) uint8 label of every RGB colour, keyed ``r << 16 | g << 8 | b``:
    black is ``EMPTY_ID``, part colours their ids, the rest ``other_id``."""
    table = np.full(1 << 24, other_id, dtype=np.uint8)
    table[0] = EMPTY_ID
    for i in PART_IDS.values():
        r, g, b = (int(c) for c in PALETTE[i])
        table[r << 16 | g << 8 | b] = i
    return table


def rgb_to_labels(rgb: np.ndarray, other_id: int = OTHER_ID) -> np.ndarray:
    """uint8 RGB (..., 3) -> uint8 labels.

    Exact palette matches map to their part id; exact black maps to
    ``EMPTY_ID``; anything else (e.g. resize blends, and values of another
    dtype that are no uint8) maps to ``other_id``.
    """
    rgb = np.asarray(rgb)
    flat = rgb.reshape(-1, 3)
    table = _decode_table(other_id)
    out = np.empty(flat.shape[0], dtype=np.uint8)
    for i0 in range(0, flat.shape[0], _DECODE_CHUNK):
        c = flat[i0 : i0 + _DECODE_CHUNK]
        c8 = c.astype(np.uint8, copy=False)
        key = c8[:, 0].astype(np.uint32) << 16
        key |= c8[:, 1].astype(np.uint32) << 8
        key |= c8[:, 2]
        labels = table[key]
        if c8 is not c:  # another dtype: only exact uint8 values can match
            labels[~np.all(c == c8, axis=-1)] = other_id
        out[i0 : i0 + _DECODE_CHUNK] = labels
    return out.reshape(rgb.shape[:-1])


def part_ids(names: Sequence[str]) -> np.ndarray:
    """Part names -> int32 label-id vector."""
    return np.array([PART_IDS[n] for n in names], dtype=np.int32)


def data_root(default: str | Path = "/root/reference/data") -> Path:
    """Default dataset root (the reference's ``data/`` layout)."""
    return Path(default)


def golden_root(default: str | Path = "/root/reference/results") -> Path:
    """Default golden-artifact root (the reference's ``results/`` layout)."""
    return Path(default)
