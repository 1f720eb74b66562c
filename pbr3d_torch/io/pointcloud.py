"""Point-cloud / mesh file IO: PLY (ascii + binary_little_endian) and OBJ,
the port's own copy of ``pbr3d.io.pointcloud`` (host file formats, numpy
only; the two packages read each other's files).

Replaces the reference's Open3D/trimesh loaders (recovered reference:
utils/preprocess_helpers bytecode ``load_ply`` L32, CAD loading L67+).
Supports the formats the reference data uses:
``segmented_point_cloud_final.ply`` is binary LE with double xyz + uchar rgb.
The surface sampler keeps numpy's ``default_rng(seed)`` draws on the host,
so both packages sample the same points.
"""

from __future__ import annotations

import io
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pbr3d_torch.utils import profiling

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@profiling.spanned("io.load_ply")
def load_ply(path: str | Path) -> Dict[str, np.ndarray]:
    """Load a PLY point cloud.

    Returns a dict with ``points (N, 3) float64`` and, when present,
    ``colors (N, 3) uint8`` and ``normals (N, 3) float64``.
    """
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype_str)])
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tok = line.strip().split()
            if not tok:
                continue
            key = tok[0].decode()
            if key == "format":
                fmt = tok[1].decode()
            elif key == "comment":
                continue
            elif key == "element":
                cur = (tok[1].decode(), int(tok[2]), [])
                elements.append(cur)
            elif key == "property":
                if tok[1] == b"list":
                    cur[2].append((tok[-1].decode(), ("list", tok[2].decode(), tok[3].decode())))
                else:
                    cur[2].append((tok[-1].decode(), _PLY_TYPES[tok[1].decode()]))
            elif key == "end_header":
                break

        out: Dict[str, np.ndarray] = {}
        for name, count, props in elements:
            if name != "vertex":
                # skip non-vertex elements (faces etc. — the reference only
                # consumes PLY *point clouds*)
                if fmt == "ascii":
                    for _ in range(count):
                        f.readline()
                else:
                    # cannot skip list properties without parsing; stop here
                    break
                continue
            if any(isinstance(d, tuple) for _, d in props):
                raise ValueError("list properties on vertices are unsupported")
            if fmt == "ascii":
                data = np.loadtxt(
                    [f.readline() for _ in range(count)],
                    dtype=np.float64,
                ).reshape(count, len(props))
                rec = {p: data[:, i] for i, (p, _) in enumerate(props)}
            else:
                endian = "<" if "little" in fmt else ">"
                dt = np.dtype([(p, endian + d) for p, d in props])
                raw = np.frombuffer(f.read(count * dt.itemsize), dtype=dt, count=count)
                rec = {p: raw[p] for p, _ in props}
            if all(k in rec for k in ("x", "y", "z")):
                out["points"] = np.stack(
                    [rec["x"], rec["y"], rec["z"]], 1).astype(np.float64)
            if all(k in rec for k in ("red", "green", "blue")):
                out["colors"] = np.stack(
                    [rec["red"], rec["green"], rec["blue"]], 1).astype(np.uint8)
            if all(k in rec for k in ("nx", "ny", "nz")):
                out["normals"] = np.stack(
                    [rec["nx"], rec["ny"], rec["nz"]], 1).astype(np.float64)
        if "points" not in out:
            raise ValueError(f"{path}: no vertex x/y/z found")
        return out


def save_ply(path: str | Path, points: np.ndarray, colors: Optional[np.ndarray] = None):
    """Write a binary-LE PLY (double xyz [+ uchar rgb]) — the reference
    artifact format."""
    points = _host(points).astype(np.float64, copy=False)
    n = len(points)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property double {c}" for c in "xyz"]
    if colors is not None:
        header += [f"property uchar {c}" for c in ("red", "green", "blue")]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if colors is None:
            f.write(points.astype("<f8").tobytes())
        else:
            colors = _host(colors).astype(np.uint8, copy=False)
            dt = np.dtype([("x", "<f8"), ("y", "<f8"), ("z", "<f8"),
                           ("red", "u1"), ("green", "u1"), ("blue", "u1")])
            rec = np.empty(n, dt)
            rec["x"], rec["y"], rec["z"] = points.T
            rec["red"], rec["green"], rec["blue"] = colors.T
            f.write(rec.tobytes())


#: What a block-parsed ``v`` / ``f`` line may hold after its key: plain
#: decimals, and plain indices of under 19 digits (no int64 overflow), between
#: ASCII blanks.  A file with anything else takes the per-line route.
_V_CHARS = b"0123456789+-.eE \t\n"
_F_CHARS = b"0 \t\n"
_DIGITS_TO_0 = bytes.maketrans(b"123456789", b"000000000")


def _lines(text: np.ndarray, starts: np.ndarray, ends: np.ndarray, rows: np.ndarray) -> bytes:
    """The lines ``rows`` of ``text`` joined, one slice a run of consecutive lines."""
    edge = np.diff(np.r_[0, rows.view(np.int8), 0])
    view = memoryview(text)
    return b"".join(view[a:b] for a, b in zip(starts[edge[:-1] == 1], ends[np.flatnonzero(edge == -1) - 1]))


def _load_obj_blocks(data: bytes) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """:func:`load_obj` of an ASCII file (``\\n`` or ``\\r\\n`` line ends)
    whose ``v`` lines all hold the same number (at least 3) of coordinates and
    whose ``f`` lines are all triangles of plain positive indices: every ``v``
    line, then every ``f`` line, converted by one ``np.loadtxt`` each.  None
    for any other file."""
    if not data.isascii():
        return None
    if b"\r" in data:
        data = data.replace(b"\r\n", b"\n")
        if b"\r" in data:
            return None
    if not data.endswith(b"\n"):
        data += b"\n"
    text = np.frombuffer(data, np.uint8).copy()
    ends = np.flatnonzero(text == ord("\n")) + 1
    starts = np.r_[0, ends[:-1]]
    # a line's key is its first byte where its second is a blank (an empty line has no second byte)
    key = np.where(text[np.minimum(starts + 1, ends - 1)] == ord(" "), text[starts], 0)
    is_v, is_f = key == ord("v"), key == ord("f")
    if not is_v.any():
        return None
    text[starts[is_v | is_f]] = ord(" ")
    v_text, f_text = _lines(text, starts, ends, is_v), _lines(text, starts, ends, is_f)
    f_zeros = f_text.translate(_DIGITS_TO_0)
    if v_text.translate(None, _V_CHARS) or f_zeros.translate(None, _F_CHARS) or b"0" * 19 in f_zeros:
        return None
    try:
        verts = np.loadtxt(io.StringIO(v_text.decode()), np.float64, comments=None, ndmin=2)
        faces = np.loadtxt(io.StringIO(f_text.decode()), np.int64, comments=None, ndmin=2) if f_text else None
    except ValueError:  # a token loadtxt refuses, or rows of unequal width
        return None
    # np.loadtxt skips a line left blank after its key
    if len(verts) != is_v.sum() or verts.shape[1] < 3:
        return None
    if faces is not None and (faces.shape != (is_f.sum(), 3) or (faces < 1).any()):
        return None
    return np.ascontiguousarray(verts[:, :3]), np.asarray([], np.int64) if faces is None else faces - 1


def _load_obj_lines(path: str | Path) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`load_obj` one line at a time: any OBJ, with n-gons
    fan-triangulated, ``a/b/c`` indices and negative (relative) indices."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(t.split("/")[0]) for t in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


@profiling.spanned("io.load_obj")
def load_obj(path: str | Path) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal OBJ mesh loader: vertices (V, 3) float64 + triangulated faces
    (F, 3) int64, 0-based.  A file of equal-width ``v`` lines and plain
    triangles (a CAD export) is parsed in two blocks and counted as
    ``io.load_obj.block``; any other file one line at a time.  Both routes
    give the same arrays, bit for bit."""
    with open(path, "rb") as f:
        mesh = _load_obj_blocks(f.read())
    if mesh is None:
        return _load_obj_lines(path)
    profiling.count("io.load_obj.block")
    return mesh


def sample_mesh_surface(
    verts: np.ndarray, faces: np.ndarray, n: int, seed: int = 0
) -> np.ndarray:
    """Area-weighted uniform surface sampling (replaces trimesh.sample); host
    arrays in, (n, 3) float64 host array out."""
    verts, faces = _host(verts), _host(faces)
    rng = np.random.default_rng(seed)
    tri = verts[faces]
    areas = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1
    )
    probs = areas / areas.sum()
    choice = rng.choice(len(faces), n, p=probs)
    u = rng.random((n, 1))
    v = rng.random((n, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    t = tri[choice]
    return t[:, 0] + u * (t[:, 1] - t[:, 0]) + v * (t[:, 2] - t[:, 0])
