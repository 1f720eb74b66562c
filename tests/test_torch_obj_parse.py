"""``pbr3d_torch.io.pointcloud.load_obj`` against the per-line parse it
replaced and against the JAX package's ``load_obj``: the same arrays, bit
for bit, on every OBJ text, whichever route (block or per-line) the file
takes; and the ``io.load_obj.block`` counter says which route that was."""

import io

import numpy as np
import pytest

from pbr3d.io import pointcloud as jax_pc
from pbr3d_torch.io import pointcloud as pc
from pbr3d_torch.utils import profiling

pytest_plugins = ["torch_threads"]


def per_line_load_obj(path):
    """The per-line parse as ``load_obj`` had it before the block route."""
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


def _standin() -> bytes:
    """A CAD export as notebook 5's stand-in writes it: ``v %.6f %.6f %.6f``
    then ``f %d %d %d``."""
    rng = np.random.default_rng(15)
    out = io.BytesIO()
    np.savetxt(out, rng.integers(0, 400, (1500, 3)) * 0.5 + rng.random((1500, 3)), fmt="v %.6f %.6f %.6f")
    np.savetxt(out, rng.integers(1, 1501, (3000, 3)), fmt="f %d %d %d")
    return out.getvalue()


def _g17() -> bytes:
    rng = np.random.default_rng(17)
    v = rng.normal(size=(300, 3)) * 10.0 ** rng.integers(-30, 30, (300, 3))
    lines = ["v " + " ".join("%.17g" % x for x in row) for row in v]
    lines += ["f %d %d %d" % tuple(t) for t in rng.integers(1, 301, (200, 3))]
    return ("\n".join(lines) + "\n").encode()


_TRI = "f 1 2 3\nf 2 3 4\n"
_QUAD = "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0.5\nv 0.5 1.5 0.25\n"

#: (name, text, takes the block route)
CASES = [
    ("standin", _standin(), True),
    ("g17_negative_exponents", _g17(), True),
    ("w_coordinate", ("v 1 2 3 1\nv -4 5.5 6 0.5\nv 7 8 9e-3 1\nv 1 1 1 1\n" + _TRI).encode(), True),
    ("six_colour_values", ("v 1 2 3 0.1 0.2 0.3\nv 4 5 6 1 0 0\nv 7 8 9 0 1 0\nv 0 0 1 0 0 1\n" + _TRI).encode(),
     True),
    ("crlf", b"v 1 2 3\r\nv 4 5 6\r\nv 7 8 9\r\nv 1 0 0\r\nf 1 2 3\r\nf 2 3 4\r\n", True),
    ("no_final_newline", b"v 1 2 3\nv 4 5 6\nv 7 8 9\nv 1 0 0\nf 1 2 3\nf 2 3 4", True),
    ("crlf_no_final_newline", b"v 1 2 3\r\nv 4 5 6\r\nv 7 8 9\r\nv 1 0 0\r\nf 1 2 3\r\nf 2 3 4", True),
    ("other_lines_between", (
        "# exported\no taj\nv 1 2 3\nvn 0 0 1\nv 4 5 6\nvt 0.5 0.5\nv 7 8 9\n# mid\ng body\nv 1 0 0\n"
        "usemtl stone\nvn 1 0 0\nf 1 2 3\n# c\nf 2 3 4\n").encode(), True),
    ("blanks_and_tabs", b"v  1\t2 3  \nv 4   5\t6\n\n   \nv 7 8 9\t\nv 1 0 0\nf 1  2\t3 \nf\t9 9 9\nf 2 3 4\n", True),
    ("v_after_f", b"v 1 2 3\nv 4 5 6\nf 1 2 3\nf 2 3 4\nv 7 8 9\nv 1 0 0\nf 4 3 1\n", True),
    ("no_faces", b"# points only\nv 1 2 3\nv 4 5 6\nvn 0 0 1\n", True),
    ("quad_and_pentagon", (_QUAD + "f 1 2 3 4\nf 1 2 3 4 5\nf 1 3 5\n").encode(), False),
    ("slash_forms", (_QUAD + "f 1/1/1 2/2/2 3/3/3\nf 2//1 3//1 4//1\nf 1/4 3/5 5/6\n").encode(), False),
    ("negative_indices", (_QUAD + "f -1 -2 -3\nf 1 2 3\nv 2 2 2\nf -1 -3 -5\n").encode(), False),
    ("mixed_widths", b"v 1 2 3\nv 4 5 6 1\nv 7 8 9\nf 1 2 3\n", False),
    ("zero_index", b"v 1 2 3\nv 4 5 6\nv 7 8 9\nf 0 1 2\nv 1 1 1\n", False),
    ("signed_index", b"v 1 2 3\nv 4 5 6\nv 7 8 9\nf +1 +2 3\n", False),
    ("nan_inf_underscore", b"v nan 1 2\nv -inf 1_0 3\nv 1e400 2 3\nf 1 2 3\n", False),
    ("lone_cr", b"v 1 2 3\rv 4 5 6\rv 7 8 9\rf 1 2 3\r", False),
    ("utf8_comment", "# café\nv 1 2 3\nv 4 5 6\nv 7 8 9\nf 1 2 3\n".encode(), False),
    ("float_index", b"v 1 2 3\nv 4 5 6\nv 7 8 9\nf 1.0 2 3\n", False),
    ("blank_v_line", b"v 1 2 3\nv \nv 7 8 9\nf 1 2 3\n", False),
    ("index_overflow", b"v 1 2 3\nv 4 5 6\nv 7 8 9\nf 99999999999999999999 1 2\n", False),
    ("nineteen_digit_index", b"v 1 2 3\nv 4 5 6\nv 7 8 9\nf 0000000000000000001 2 3\n", False),
    ("no_vertices", b"# empty\nf 1 2 3\n", False),
    ("empty_file", b"", False),
]


def _load(fn, path):
    try:
        return fn(path)
    except Exception as e:  # the per-line route's error is part of its result
        return type(e)


def _assert_same(got, want):
    if isinstance(want, type):
        assert got is want
        return
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(got[0].view(np.int64), want[0].view(np.int64))
    assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("name,text,block", CASES, ids=[c[0] for c in CASES])
def test_load_obj_equals_per_line_and_jax(tmp_path, name, text, block):
    path = tmp_path / f"{name}.obj"
    path.write_bytes(text)
    ours = _load(pc.load_obj, path)
    _assert_same(ours, _load(per_line_load_obj, path))
    _assert_same(ours, _load(jax_pc.load_obj, path))


@pytest.mark.parametrize("name,text,block", CASES, ids=[c[0] for c in CASES])
def test_load_obj_block_counter(tmp_path, name, text, block):
    path = tmp_path / f"{name}.obj"
    path.write_bytes(text)
    with profiling.recording() as spans:
        _load(pc.load_obj, path)
    (span,) = [s for s in spans if s.name == "io.load_obj"]
    assert span.counts.get("io.load_obj.block", 0) == int(block)


def test_block_conversion_matches_float_bits():
    """The block route's decimal conversion gives ``float()``'s bits on
    ``%.17g`` and ``%.6f`` text."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=20001) * 10.0 ** rng.integers(-300, 300, 20001)
    for fmt in ("%.17g", "%.6f"):
        words = [fmt % v for v in x]
        text = ("v " + "\nv ".join(" ".join(words[i:i + 3]) for i in range(0, len(words), 3)) + "\n").encode()
        verts, _ = pc._load_obj_blocks(text)
        assert np.array_equal(verts.ravel().view(np.int64), np.array([float(w) for w in words]).view(np.int64))
