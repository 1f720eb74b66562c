"""The port's device half of ``ops/components.py`` on the CPU: the plain
labeller and the plain statistics, which stand in for the CUDA kernels
(``pbr3d_torch/csrc/components.cu``) on CPU tensors, against scipy, the
port's host helpers and the JAX package on the same seeded masks; numpy
models of the kernels' run, merge and statistics steps; and the routing of
the public entries.

Tolerances: labels, n, bboxes and counts are equal (integer work).  The
plain statistics equal ``_host_component_stats`` bit for bit, centroids
included (exact int64 sums, one float64 division, as the host's float64
bincounts and dot products give them).  Against the JAX package's
``component_stats`` centroids are held to rtol 1e-6 on rows 1..n: it sums
coordinates in float32 (``pbr3d/ops/components.py:388``).

The kernels themselves run only on the card, where ``chip_smoke.py``
(phase 2) holds them to these plain versions and to host scipy."""

import numpy as np
import pytest
import scipy.ndimage
import torch

from pbr3d.ops import components as jax_components
from pbr3d_torch.ops import components as C
from pbr3d_torch.ops import cuda_kernels as ck


#: Shapes that several cases share, so that the JAX package compiles its
#: relaxation for few shapes.
SMALL = (9, 10, 11)
PLANE = (37, 41)


def _helix(levels: int = 5, sy: int = 8, sz: int = 9) -> np.ndarray:
    """A 3-D spiral one voxel thick: at every even x an open rectangular
    ring in (y, z), entered where the ring below it ended through one voxel
    at the odd x between; the rings stay two voxels apart, so under either
    connectivity it is one long path."""
    ring = ([(0, z) for z in range(sz)] + [(y, sz - 1) for y in range(1, sy)]
            + [(sy - 1, z) for z in range(sz - 2, -1, -1)] + [(y, 0) for y in range(sy - 2, 0, -1)])
    g = np.zeros((2 * levels - 1, sy + 2, sz + 2), bool)
    start = 0
    for level in range(levels):
        for j in range(len(ring) - 2):
            y, z = ring[(start + j) % len(ring)]
            g[2 * level, y + 1, z + 1] = True
        start = (start + len(ring) - 3) % len(ring)
        if level + 1 < levels:
            y, z = ring[start]
            g[2 * level + 1, y + 1, z + 1] = True
    return g


def _slab() -> np.ndarray:
    """A one-voxel-thick slab across a 3-D grid, with holes, and a few
    voxels off it."""
    rng = np.random.default_rng(7)
    g = np.zeros(SMALL, bool)
    g[4] = rng.random(SMALL[1:]) < 0.7
    g[0, 0, :3] = g[8, 9, 10] = True
    return g


def _checker(shape) -> np.ndarray:
    return np.indices(shape).sum(axis=0) % 2 == 0


def _mask(case: str) -> np.ndarray:
    kind, _, arg = case.partition(":")
    if kind in ("random3d", "random2d", "odd_a", "odd_b"):
        shape = {"random3d": (13, 17, 19), "random2d": PLANE, "odd_a": (1, 7, 300), "odd_b": (5, 1, 9)}[kind]
        density = float(arg or 0.6)
        return np.random.default_rng([len(shape), int(density * 100)]).random(shape) < density
    return {
        "slab": _slab, "single_on": lambda: np.ones((1, 1, 1), bool),
        "single_off": lambda: np.zeros((1, 1, 1), bool), "empty": lambda: np.zeros(SMALL, bool),
        "full": lambda: np.ones(SMALL, bool), "helix": _helix,
        "checker3d": lambda: _checker(SMALL), "checker2d": lambda: _checker(PLANE),
    }[kind]()


CASES = ([f"random3d:{d}" for d in (0.3, 0.6, 0.75)] + [f"random2d:{d}" for d in (0.3, 0.6, 0.75)]
         + ["odd_a", "odd_b", "slab", "single_on", "single_off", "empty", "full", "helix", "checker3d",
            "checker2d"])
CONNECTIVITIES = ["face", "full"]


def _scipy(mask: np.ndarray, connectivity: str):
    structure = np.ones((3,) * mask.ndim, bool) if connectivity == "full" else None
    labels, n = scipy.ndimage.label(mask, structure=structure)
    return labels.astype(np.int32), int(n)


def _plain(mask: np.ndarray, connectivity: str):
    labels, n = C.connected_components_device(torch.from_numpy(mask), connectivity)
    assert labels.dtype == torch.int32 and labels.device.type == "cpu" and labels.shape == mask.shape
    return labels.numpy(), n


@pytest.mark.parametrize("connectivity", CONNECTIVITIES)
@pytest.mark.parametrize("case", CASES)
def test_plain_labeller_equals_scipy_host_and_jax(case, connectivity, monkeypatch):
    """Labels and n equal scipy's, the host labeller's and both JAX routes'
    (on the CPU the JAX package runs its device relaxation; past ``max_k``
    components its ``connected_components_device`` falls back to the host,
    where the port needs no fallback)."""
    monkeypatch.delenv("PBR3D_COMPONENTS", raising=False)
    mask = _mask(case)
    ref, n_ref = _scipy(mask, connectivity)
    labels, n = _plain(mask, connectivity)
    assert n == n_ref
    np.testing.assert_array_equal(labels, ref)
    host, n_host = C._host_scipy_label(mask, connectivity)
    assert n_host == n
    np.testing.assert_array_equal(host, labels)
    jax_labels, jax_n = jax_components.connected_components(mask, connectivity)
    assert jax_n == n
    np.testing.assert_array_equal(jax_labels, labels)
    jax_dev, jax_dev_n = jax_components.connected_components_device(mask, connectivity)
    assert jax_dev_n == n
    np.testing.assert_array_equal(np.asarray(jax_dev), labels)
    if case.startswith("checker") and connectivity == "face":
        assert n > 256  # past the JAX package's max_k


def test_the_cases_cover_what_they_name():
    counts = {c: {k: _scipy(_mask(c), k)[1] for k in CONNECTIVITIES} for c in ("helix", "checker3d", "slab")}
    assert counts["helix"] == {"face": 1, "full": 1} and _helix().sum() > 100 and _helix().shape == SMALL
    assert counts["checker3d"]["face"] == 495 and counts["checker3d"]["full"] == 1
    assert counts["slab"]["face"] > counts["slab"]["full"] > 1


def _model_labels(mask: np.ndarray, connectivity: str, seed: int):
    """A numpy model of the kernels' labelling: each voxel's parent the first
    voxel of its run along z; then every foreground voxel, in a random order
    (the card runs them in none), unites with the half stencil off its row,
    skipping what ``voxel_kernel``'s merge steps skip; union links the
    larger root under the smaller; then roots, their inclusive count, and
    the relabel."""
    vol = mask.reshape((1,) * (3 - mask.ndim) + mask.shape)
    X, Y, Z = vol.shape
    m = vol.reshape(-1)
    big = ck.COMPONENTS_BIG
    parent = np.full(m.size, big, np.int64)
    for row in range(X * Y):
        start = None
        for z in range(Z):
            i = row * Z + z
            start = (start if start is not None else i) if m[i] else None
            if m[i]:
                parent[i] = start

    def find(i):
        while parent[i] != i:
            i = parent[i]
        return i

    def unite(a, b):
        a, b = find(a), find(b)
        parent[max(a, b)] = min(a, b)

    for i in np.random.default_rng(seed).permutation(np.flatnonzero(m)):
        x, y, z = np.unravel_index(i, vol.shape)
        zprev = z > 0 and m[i - 1]
        if connectivity == "face":
            for dx, dy in ((0, -1), (-1, 0)):
                if x + dx >= 0 and y + dy >= 0:
                    j = i + dx * Y * Z + dy * Z
                    if m[j] and not (zprev and m[j - 1]):
                        unite(i, j)
            continue
        for dx, dy in ((0, -1), (-1, -1), (-1, 0), (-1, 1)):
            if x + dx < 0 or not 0 <= y + dy < Y:
                continue
            col, before = i + dx * Y * Z + dy * Z, False
            for dz in range(1 if zprev else -1, 2):
                if 0 <= z + dz < Z:
                    fg = bool(m[col + dz])
                    if fg and not before:
                        unite(i, col + dz)
                    before = fg
    roots = np.array([find(i) if m[i] else big for i in range(m.size)], np.int64)
    rank = np.cumsum(roots == np.arange(m.size))
    labels = np.where(roots < big, rank[np.minimum(roots, m.size - 1)], 0).astype(np.int32)
    return labels.reshape(mask.shape), int(rank[-1]) if m.size else 0


@pytest.mark.parametrize("connectivity", CONNECTIVITIES)
@pytest.mark.parametrize("case", ["random3d:0.3", "random3d:0.6", "random2d:0.6", "odd_a", "slab", "helix",
                                  "checker3d", "checker2d", "full", "single_on"])
def test_model_of_the_kernel_labelling_equals_scipy(case, connectivity):
    """The run, merge (with its skips) and compress steps give scipy's labels
    in any order of the unions."""
    mask = _mask(case)
    ref, n_ref = _scipy(mask, connectivity)
    for seed in range(2):
        labels, n = _model_labels(mask, connectivity, seed)
        assert n == n_ref
        np.testing.assert_array_equal(labels, ref)


def _model_stats(labels: np.ndarray, n: int, seg: int = 16):
    """A numpy model of ``stats_kernel``: segments of ``seg`` voxels of a
    row, each run of one label folded into one update, the z-sum of a run
    (za + zb) * count / 2."""
    vol = labels.reshape((1,) * (3 - labels.ndim) + labels.shape)
    rows = n + 1
    mins = np.full((rows, 3), ck.COMPONENTS_BIG, np.int64)
    maxs = np.full((rows, 3), -1, np.int64)
    count = np.zeros(rows, np.int64)
    sums = np.zeros((rows, 3), np.int64)
    for x, y in np.ndindex(vol.shape[:2]):
        for z0 in range(0, vol.shape[2], seg):
            line = vol[x, y, z0 : z0 + seg]
            starts = np.flatnonzero(np.diff(line, prepend=line[0] - 1))
            for a, b in zip(starts, np.append(starts[1:], line.size)):
                label, za, zb = int(line[a]), z0 + a, z0 + b - 1
                if 0 < label < rows:
                    c = zb - za + 1
                    mins[label] = np.minimum(mins[label], (x, y, za))
                    maxs[label] = np.maximum(maxs[label], (x, y, zb))
                    count[label] += c
                    sums[label] += (c * x, c * y, (za + zb) * c // 2)
    return mins, maxs, count, sums


def _labels_and_n(case: str, connectivity: str = "face"):
    return _scipy(_mask(case), connectivity)


@pytest.mark.parametrize("case", ["random3d:0.6", "random2d:0.3", "odd_a", "helix", "checker2d", "full", "empty"])
def test_model_of_the_kernel_stats_equals_the_plain_stats(case):
    labels, n = _labels_and_n(case)
    vol = torch.from_numpy(labels.reshape((1,) * (3 - labels.ndim) + labels.shape))
    for got, want in zip(_model_stats(labels, n), ck.component_stats_plain(vol, n)):
        np.testing.assert_array_equal(got, want.numpy())


def _assert_stats_bit_equal(ours: dict, ref: dict):
    assert set(ours) == set(ref)
    for key in ref:
        assert ours[key].dtype == ref[key].dtype and ours[key].shape == ref[key].shape, key
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
        if ours[key].dtype == np.float64:
            np.testing.assert_array_equal(ours[key].view(np.int64), ref[key].view(np.int64), err_msg=key)


@pytest.mark.parametrize("connectivity", CONNECTIVITIES)
@pytest.mark.parametrize("case", CASES)
def test_plain_stats_bit_equal_to_the_host(case, connectivity):
    labels, n = _labels_and_n(case, connectivity)
    _assert_stats_bit_equal(C.component_stats(torch.from_numpy(labels), n), C._host_component_stats(labels, n))


def test_plain_stats_rows_of_absent_ids_and_ignored_labels():
    """Ids without voxels keep the host's fill; labels past n are ignored by
    both."""
    labels, n = _labels_and_n("random3d:0.6")
    labels = labels.copy()
    labels[labels == 3] = 0
    for m in (n + 4, n - 2):
        _assert_stats_bit_equal(C.component_stats(torch.from_numpy(labels), m), C._host_component_stats(labels, m))


def test_plain_stats_of_large_coordinates_are_exact():
    """A component far out along every axis, whose float32 sums would round:
    the centroid is the exact mean."""
    labels = np.zeros((3, 4, 70000), np.int32)
    labels[1, 2:, 40000:] = labels[2, 3, 1:3] = 1
    labels[0, 0, 69999] = 2
    ours = C.component_stats(torch.from_numpy(labels), 2)
    _assert_stats_bit_equal(ours, C._host_component_stats(labels, 2))
    zs = np.concatenate([np.arange(40000, 70000)] * 2 + [np.arange(1, 3)])
    assert ours["centroid"][1, 2] == zs.sum() / zs.size


@pytest.mark.parametrize("case", ["random3d:0.6", "random2d:0.75", "helix", "checker3d", "slab"])
def test_plain_stats_against_jax(case, monkeypatch):
    """Bboxes and counts equal the JAX package's on rows 1..n, centroids
    within rtol 1e-6 (its sums are float32)."""
    monkeypatch.delenv("PBR3D_COMPONENTS", raising=False)
    labels, n = _labels_and_n(case)
    ours = C.component_stats(torch.from_numpy(labels), n)
    ref = jax_components.component_stats(labels, n)
    for key in ("bbox_min", "bbox_max", "count"):
        np.testing.assert_array_equal(ours[key][1:], np.asarray(ref[key])[1 : n + 1], err_msg=key)
    np.testing.assert_allclose(ours["centroid"][1:], np.asarray(ref["centroid"])[1 : n + 1], rtol=1e-6, atol=0)


def test_numpy_input_takes_the_host_helpers(monkeypatch):
    mask = _mask("random3d:0.6")
    ref, n_ref = _scipy(mask, "full")
    calls = []
    for name in ("_host_scipy_label", "_host_component_stats"):
        fn = getattr(C, name)
        monkeypatch.setattr(C, name, lambda *a, _fn=fn, _name=name, **k: calls.append(_name) or _fn(*a, **k))
    monkeypatch.setattr(C, "components_plain", lambda *a: pytest.fail("a numpy mask reached the plain labeller"))
    monkeypatch.setattr(C, "component_stats_plain", lambda *a: pytest.fail("numpy labels reached the plain stats"))
    labels, n = C.connected_components(mask, "full")
    assert isinstance(labels, np.ndarray) and n == n_ref
    np.testing.assert_array_equal(labels, ref)
    stats = C.component_stats(labels, n)
    assert calls == ["_host_scipy_label", "_host_component_stats"]
    _assert_stats_bit_equal(stats, C.__dict__["_host_component_stats"](labels, n))


def test_tensor_input_takes_the_device_route(monkeypatch):
    mask = _mask("random2d:0.6")
    ref, n_ref = _scipy(mask, "face")
    monkeypatch.setattr(C, "_host_scipy_label", lambda *a: pytest.fail("a tensor reached the host labeller"))
    monkeypatch.setattr(C, "_host_component_stats", lambda *a, **k: pytest.fail("a tensor reached the host stats"))
    labels, n = C.connected_components(torch.from_numpy(mask), "face")
    assert isinstance(labels, np.ndarray) and labels.dtype == np.int32 and n == n_ref
    np.testing.assert_array_equal(labels, ref)
    stats = C.component_stats(torch.from_numpy(labels), n)
    assert stats["bbox_min"].shape == (n + 1, 2) and stats["count"].dtype == np.float64


@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8, torch.int64])
def test_device_labeller_takes_any_mask_dtype_and_layout(dtype):
    """bool, uint8 (values above 1 too) and other dtypes alike; a transposed
    view labels as its contiguous copy; ``max_k`` has no effect."""
    mask = _mask("random3d:0.6")
    t = torch.from_numpy(mask.astype(np.uint8) * 3).to(dtype).permute(2, 0, 1)
    assert not t.is_contiguous()
    ref, n_ref = _scipy(np.ascontiguousarray(mask.transpose(2, 0, 1)), "full")
    for max_k in (256, 2):
        labels, n = C.connected_components_device(t, "full", max_k=max_k)
        assert n == n_ref
        np.testing.assert_array_equal(labels.numpy(), ref)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """The CUDA wrappers take CUDA tensors only (a CPU tensor raises before
    anything is built), and the device entry refuses 1-D masks."""
    mask = torch.ones((2, 3, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        ck.components_kernel(mask, False)
    with pytest.raises(ValueError, match="CUDA"):
        ck.component_stats_kernel(mask.to(torch.int32), 1)
    with pytest.raises(ValueError, match="2 or 3 dims"):
        C.connected_components_device(torch.ones(5, dtype=torch.bool))
