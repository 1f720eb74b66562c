"""The port's device half of ``ops/components.py`` on the CPU: the plain
labeller and the plain statistics, which stand in for the CUDA kernels
(``pbr3d_torch/csrc/components.cu``) on CPU tensors, against scipy, the
port's host helpers and the JAX package on the same seeded masks; numpy
models of the kernels' passes (the run pass's bit words, the merge pass's
unions from the words, the rank pass's row counts and in-row numbers, the
in-place label pass, the statistics' carried runs) against scipy and the
plain statistics, in random orders; and the routing of the public
entries.

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


#: Voxels of one 32-bit word of a row's bits; lanes of a warp.
WORD = 32
LANES = 32
FULL32 = 0xFFFFFFFF


def _top_bit(v: int) -> int:
    return v.bit_length() - 1


def _bits(v: int):
    while v:
        yield (v & -v).bit_length() - 1
        v &= v - 1


def _vol(a: np.ndarray) -> np.ndarray:
    return a.reshape((1,) * (3 - a.ndim) + a.shape)


def _nonzero_nibble(x: int) -> int:
    """``nonzero_nibble``: the non-zero bytes of a 32-bit word as bits 0..3."""
    high = ((((x & 0x7F7F7F7F) + 0x7F7F7F7F) | x) & 0x80808080) & FULL32
    return (((high >> 7) * 0x01020408) & FULL32) >> 24


def _model_runs(vol: np.ndarray, shift: int = 0):
    """``runs_kernel``: a lane takes 16 voxels of the row a step, a warp 512,
    from the one or two aligned 16-byte vectors that hold them (the mask
    starting ``shift`` bytes past an alignment; a second vector only where
    it starts before the mask's end); two lanes' halves make one word; a run
    starts where a set voxel follows an unset one, the lane before's bit 15
    (or the last step's) carried in.  Returns the words (rows, W) and the
    run starts' flat indices."""
    X, Y, Z = vol.shape
    rows, W = X * Y, -(-Z // WORD)
    end = shift + vol.size
    flat = np.zeros(-(-end // 16) * 16 + 32, np.uint8)  # what the 16-byte vectors may read
    flat[shift:end] = vol.reshape(-1)

    def vector_bits(at):  # ``nonzero_bits`` of the vector at ``at``
        return sum(_nonzero_nibble(int.from_bytes(bytes(flat[at + 4 * k : at + 4 * k + 4]), "little")) << 4 * k
                   for k in range(4))

    words = np.zeros((rows, W), np.uint32)
    starts = []
    for r in range(rows):
        carry = 0
        for z0 in range(0, Z, 512):
            h = []
            for lane in range(LANES):
                z, bits = z0 + 16 * lane, 0
                if z < Z:
                    at = shift + r * Z + z
                    off = at & 15
                    bits = vector_bits(at - off) >> off
                    if off and at - off + 16 < end:
                        bits |= vector_bits(at - off + 16) << (16 - off)
                    if Z - z < 16:
                        bits &= (1 << (Z - z)) - 1
                    bits &= 0xFFFF
                h.append(bits)
            for lane in range(0, LANES, 2):
                w = z0 // WORD + lane // 2
                if w < W:
                    words[r, w] = h[lane] | h[lane + 1] << 16
            for lane in range(LANES):
                prev = carry if lane == 0 else h[lane - 1] >> 15
                starts += [r * Z + z0 + 16 * lane + k for k in _bits(h[lane] & ~(h[lane] << 1 | prev) & 0xFFFF)]
            carry = h[31] >> 15
    return words, starts


def _zero_before(bits: list, w0: int, carry: int):
    """``zero_before``: the last zero bit before each lane's word, as a row
    position (-1: none), by a max-scan with the step's carry; and the new
    carry."""
    inc, out = carry, []
    for lane, b in enumerate(bits):
        out.append(inc)
        if ~b & FULL32:
            inc = max(inc, WORD * (w0 + lane) + _top_bit(~b & FULL32))
    return out, inc


def _run_start(bits: int, w: int, bit: int, before: int) -> int:
    m = ~bits & ((1 << bit) - 1)
    return (WORD * w + _top_bit(m) if m else before) + 1


def _neighbour_rows(x: int, y: int, X: int, Y: int, full: bool):
    for dx, dy in ((0, -1), (-1, 0)) + (((-1, -1), (-1, 1)) if full else ()):
        if x + dx >= 0 and 0 <= y + dy < Y:
            yield (x + dx) * Y + y + dy


def _zero_below(row_words: np.ndarray, bits: int, w: int, bit: int) -> int:
    """``zero_below``: the last zero before bit ``bit`` of word w, walking
    back over full words; -1: none."""
    m = ~bits & ((1 << bit) - 1)
    while m == 0 and w > 0:
        w -= 1
        m = ~int(row_words[w]) & FULL32
    return WORD * w + _top_bit(m) if m else -1


def _model_merge_pairs(words: np.ndarray, shape, full: bool):
    """``merge_kernel``: for each word of each row against the same word of
    each neighbour row of lower index, the (run start, run start) pairs it
    unites, from the words alone: the first bit of each run of D = row AND
    neighbour (dilated by one voxel along z under full connectivity), and
    under full the bits of D where a neighbour run starts one voxel on."""
    X, Y, Z = shape
    W = words.shape[1]
    pairs = []
    for row, w in np.ndindex(X * Y, W):
        A = words[row]
        a = int(A[w])
        if not a:
            continue
        a_prev = int(A[w - 1]) >> 31 if w else 0
        y, x = row % Y, row // Y
        for nrow in _neighbour_rows(x, y, X, Y, full):
            B = words[nrow]
            b = int(B[w])
            b_before = int(B[w - 1]) if w else 0
            b_prev = b_before >> 31
            if full:
                b_next = int(B[w + 1]) & 1 if w + 1 < W else 0
                d = a & (b | (b << 1 & FULL32) | b_prev | b >> 1 | b_next << 31)
                d_prev = a_prev & (b_before >> 30 | b_prev | b) & 1
                nxt = d & ~b & (b >> 1 | b_next << 31)
            else:
                d, d_prev, nxt = a & b, a_prev & b_prev, 0
            firsts = d & ~((d << 1 & FULL32) | d_prev)
            for bit in _bits(firsts | nxt):
                sa = row * Z + _zero_below(A, a, w, bit) + 1
                b_left = b >> (bit - 1) & 1 if bit else b_prev
                if firsts >> bit & 1 and (b_left | b >> bit & 1):
                    pairs.append((sa, nrow * Z + _zero_below(B, b, w, bit) + 1))
                if nxt >> bit & 1:
                    pairs.append((sa, nrow * Z + WORD * w + bit + 1))
    return pairs


def _find(L: np.ndarray, i: int) -> int:
    """``find_root``: parents until an entry points at itself or is negative."""
    p = L[i]
    while p >= 0 and p != i:
        i, p = p, L[p]
    return i


ROWS_PER_TILE = ck.COMPONENTS_ROWS_PER_TILE
AGGREGATE, INCLUSIVE = 1 << 32, 2 << 32


def _model_tile_scan(totals: list, rng) -> list:
    """``tile_prefix``: each tile publishes its aggregate, adds up its
    predecessors' states back to an inclusive one (waiting where a state is
    not published yet), and publishes its inclusive count; the tiles' reads
    and writes interleaved at random.  Returns each tile's prefix."""
    state = [0] * len(totals)
    prefix = [None] * len(totals)

    def tile(t):
        if t == 0:
            state[0] = INCLUSIVE | totals[0]
            prefix[0] = 0
            return
        state[t] = AGGREGATE | totals[t]
        got, k = 0, t - 1
        while True:
            yield
            v = state[k]
            if v < AGGREGATE:
                continue
            got += v & FULL32
            if v >= INCLUSIVE:
                break
            k -= 1
        state[t] = INCLUSIVE | (got + totals[t])
        prefix[t] = got

    running = [g for g in (tile(t) for t in range(len(totals))) if g is not None]
    while running:
        k = int(rng.integers(len(running)))
        try:
            next(running[k])
        except StopIteration:
            running.pop(k)
    return prefix


def _model_rank(words: np.ndarray, shape, L: np.ndarray, rng):
    """``rank_kernel`` in place on L, the rows in a random order: each run
    start points at its root, the row's roots get -1, -2, ... in raster
    order; then ``scan_kernel``: tiles of ``ROWS_PER_TILE`` rows scan their
    counts by look-back.  Returns offsets: the roots of the rows before each row,
    and n last."""
    X, Y, Z = shape
    W = words.shape[1]
    rows = X * Y
    totals = np.zeros(rows, np.int64)
    for row in rng.permutation(rows):
        top, total = 0, 0
        for w0 in range(0, W, LANES):
            A = [int(words[row, w0 + lane]) if w0 + lane < W else 0 for lane in range(LANES)]
            prev = [top] + [a >> 31 for a in A[:-1]]
            roots = []
            for lane, (a, pv) in enumerate(zip(A, prev)):
                for bit in _bits(a & ~((a << 1 & FULL32) | pv)):
                    i = row * Z + WORD * (w0 + lane) + bit
                    if L[i] == i:
                        roots.append(i)
                    else:
                        L[i] = _find(L, L[i])
            for k, i in enumerate(roots):  # lanes in order, bits in order: raster order
                L[i] = -(total + k + 1)
            total += len(roots)
            top = A[-1] >> 31
        totals[row] = total
    tiles = [int(totals[t : t + ROWS_PER_TILE].sum()) for t in range(0, rows, ROWS_PER_TILE)]
    prefix = _model_tile_scan(tiles, rng)
    offsets = np.zeros(rows + 1, np.int64)
    for row in range(rows):
        t = row // ROWS_PER_TILE
        offsets[row] = prefix[t] + totals[t * ROWS_PER_TILE : row].sum()
    offsets[rows] = offsets[rows - 1] + totals[rows - 1]
    return offsets


def _find_compress(L: np.ndarray, i: int) -> int:
    """``find_compress``: the root, and i's entry pointed at it."""
    r = _find(L, i)
    L[i] = r
    return r


def _rank_of(L: np.ndarray, offsets: np.ndarray, s: int, Z: int) -> int:
    v = L[s]
    if v >= 0:
        s, v = v, L[v]
        if v > 0:
            return int(v)
    return int(offsets[s // Z] - v)


def _model_label_steps(words: np.ndarray, shape, L: np.ndarray, offsets: np.ndarray, row: int, vec: bool):
    """``label_kernel`` on one row, a generator of its steps: each step looks
    up every voxel's rank (lane l: with ``vec`` 4 voxels at z0 + 128 j + 4 l,
    else the voxels z0 + 32 i + l), then writes the step's labels in place
    over L; a step of background writes zeros."""
    X, Y, Z = shape
    W = words.shape[1]
    base, zero, open_rank = row * Z, -1, 0
    for w0 in range(0, W, LANES):
        A = [int(words[row, w0 + lane]) if w0 + lane < W else 0 for lane in range(LANES)]
        z0 = WORD * w0
        if not any(A):  # background throughout: zeros, no lookups
            zero = z0 + WORD * LANES - 1
            yield
            L[base + z0 : base + min(Z, z0 + WORD * LANES)] = 0
            continue
        before, zero = _zero_before(A, w0, zero)
        lab = {}
        for lane in range(LANES):
            last_start, last_rank = -2, 0
            for i in range(32):
                src, bit = (4 * (i // 4) + lane // 8, 4 * (lane % 8) + i % 4) if vec else (i, lane)
                v = 0
                if A[src] >> bit & 1:
                    start = _run_start(A[src], w0 + src, bit, before[src])
                    if start != last_start:
                        last_start = start
                        last_rank = open_rank if start < z0 else _rank_of(L, offsets, base + start, Z)
                    v = last_rank
                lab[z0 + WORD * src + bit] = v
        yield
        open_rank = lab[z0 + 1023]
        for z, v in lab.items():
            if z < Z:
                L[base + z] = v


def _model_labels(mask: np.ndarray, connectivity: str, seed: int):
    """A numpy model of the kernels' labelling, in a random order wherever
    the card runs in none: the runs pass (on a mask ``seed % 16`` bytes past
    an alignment); the merge pass's unions from the
    words, applied in a random order (union links the larger root under the
    smaller); the rank pass over the rows in a random order, with its tile
    scan; and the label pass in place over L, its rows' steps interleaved
    at random (each row's steps in order)."""
    rng = np.random.default_rng(seed)
    vol = _vol(mask)
    X, Y, Z = vol.shape
    words, starts = _model_runs(vol, shift=seed % 16)
    L = np.full(vol.size, -7, np.int64)  # the label buffer: torch.empty
    L[starts] = starts
    pairs = _model_merge_pairs(words, vol.shape, connectivity == "full")
    for k in rng.permutation(len(pairs)):
        a, b = pairs[k]
        if L[a] == L[b]:  # one parent: one set
            continue
        a, b = (_find_compress(L, i) for i in (a, b))
        L[max(a, b)] = min(a, b)
    offsets = _model_rank(words, vol.shape, L, rng)
    vec = Z % 4 == 0 and seed % 2 == 0
    running = [_model_label_steps(words, vol.shape, L, offsets, row, vec) for row in range(X * Y)]
    while running:
        k = int(rng.integers(len(running)))
        try:
            next(running[k])
        except StopIteration:
            running.pop(k)
    return L.astype(np.int32).reshape(mask.shape), int(offsets[-1])


def _word_rows(Z: int) -> np.ndarray:
    """A (4, 8, Z) mask of rows of Z voxels: random in x = 0..1, empty at
    x = 2, and at x = 3 a diagonal across a word boundary (joined under
    full connectivity only; y = 0..1), two runs split by a one-voxel gap at
    a word boundary over a single voxel over a row split the same way
    (y = 3..5), and runs that cross the 32-voxel words (y = 7)."""
    g = np.random.default_rng(Z).random((4, 8, Z)) < 0.55
    g[2:] = False
    g[3, 7, 20:45] = g[3, 7, 60:100] = True
    if Z >= 34:
        g[3, 0, 31] = g[3, 1, 32] = True
        g[3, 3, :] = g[3, 5, :] = True
        g[3, 3, 32] = g[3, 5, 32] = False
        g[3, 4, 32] = True
    return g


WORD_ROWS = (1, 31, 32, 33, 127, 128, 129, 513)


def _model_mask(case: str) -> np.ndarray:
    return _word_rows(int(case.split(":")[1])) if case.startswith("rows:") else _mask(case)


MODEL_CASES = (["random3d:0.3", "random3d:0.6", "random2d:0.6", "odd_a", "slab", "helix", "checker3d", "checker2d",
                "full", "single_on"] + [f"rows:{z}" for z in WORD_ROWS])


def test_model_nonzero_nibble_of_every_byte():
    """The run pass's byte test: a byte's bit is set iff the byte is non-zero,
    every byte value in every position."""
    rng = np.random.default_rng(0)
    for v in range(256):
        for pos in range(4):
            others = rng.integers(0, 256, 3)
            b = np.insert(others, pos, v).astype(np.uint8)
            x = int.from_bytes(bytes(b), "little")
            assert _nonzero_nibble(x) == sum(1 << k for k in range(4) if b[k]), (v, pos, b)


@pytest.mark.parametrize("case", MODEL_CASES)
def test_model_of_the_run_pass_packs_every_word_boundary(case):
    """The words equal numpy's little-endian bit packing of each row (bits
    past Z unset), and the run starts are the set voxels after unset ones,
    on a mask at every alignment."""
    vol = _vol(_model_mask(case))
    rows = vol.reshape(-1, vol.shape[2]).astype(bool)
    for shift in (0, 5, 15):
        words, starts = _model_runs(vol, shift)
        padded = np.zeros((rows.shape[0], words.shape[1] * WORD), bool)
        padded[:, : rows.shape[1]] = rows
        np.testing.assert_array_equal(words, np.packbits(padded, axis=1, bitorder="little").view("<u4"))
        first = rows & ~np.pad(rows, ((0, 0), (1, 0)))[:, :-1]
        assert starts == list(np.flatnonzero(first))


@pytest.mark.parametrize("connectivity", CONNECTIVITIES)
@pytest.mark.parametrize("case", MODEL_CASES)
def test_model_of_the_kernel_labelling_equals_scipy(case, connectivity):
    """The run pass, the merge pass's unions from the words, the rank pass
    (row counts, in-row numbers) and the in-place label pass give scipy's
    labels and n in any order of the unions, the rows and the steps."""
    mask = _model_mask(case)
    ref, n_ref = _scipy(mask, connectivity)
    for seed in (0, 1, 7):
        labels, n = _model_labels(mask, connectivity, seed)
        assert n == n_ref
        np.testing.assert_array_equal(labels, ref)


def test_the_word_rows_hold_what_they_name():
    """Under full connectivity the diagonal across the word boundary is one
    component and the gap rows are joined through the single voxel; under
    face they are apart."""
    g = _word_rows(513)
    face, full = (_scipy(g[3], c)[0] for c in CONNECTIVITIES)
    assert face[0, 31] != face[1, 32] and full[0, 31] == full[1, 32]
    assert face[3, 0] != face[3, 33] and full[3, 0] == full[3, 33] == full[4, 32] == full[5, 0] == full[5, 33]
    assert face[4, 32] not in (face[3, 0], face[5, 0]) and face[5, 0] != face[5, 33]


def test_model_merge_makes_one_union_per_run_pair():
    """Solid rows make one union per neighbour row, not one per voxel."""
    vol = np.ones((2, 3, 513), bool)
    words, _ = _model_runs(vol)
    assert len(_model_merge_pairs(words, vol.shape, False)) == 7  # (x, y - 1): 2 x 2; (x - 1, y): 3
    assert len(_model_merge_pairs(words, vol.shape, True)) == 11  # and (x - 1, y +- 1): 2 + 2


def _model_stats(labels: np.ndarray, n: int, seg: int = 2048, per: int = 4):
    """A numpy model of ``stats_kernel``: a warp takes ``seg`` voxels of a
    row in steps of 32 ``per`` (lane l: ``per`` labels at z0 + per l); a step
    equal to the open run's label throughout is skipped, an all-background
    step closes the open run; otherwise the open run ends before the step
    where the step's first label differs from it, runs start where a label
    differs from the one before, end where the next differs, and the run
    open at the step's end is carried to the next step and the segment's
    end.  Returns the statistics and the updates made."""
    vol = _vol(labels)
    X, Y, Z = vol.shape
    rows = n + 1
    step = LANES * per
    mins = np.full((rows, 3), ck.COMPONENTS_BIG, np.int64)
    maxs = np.full((rows, 3), -1, np.int64)
    count = np.zeros(rows, np.int64)
    sums = np.zeros((rows, 3), np.int64)
    updates = []

    def add_run(label, x, y, za, zb):
        if 0 < label < rows:
            c = zb - za + 1
            mins[label] = np.minimum(mins[label], (x, y, za))
            maxs[label] = np.maximum(maxs[label], (x, y, zb))
            count[label] += c
            sums[label] += (c * x, c * y, (za + zb) * c // 2)
            updates.append((label, x, y, za, zb))

    for x, y in np.ndindex(X, Y):
        for zs in range(0, Z, seg):
            ze = min(Z, zs + seg)
            line = np.zeros(ze - zs + step, np.int64)
            line[: ze - zs] = vol[x, y, zs:ze]
            open_, open_start = 0, zs
            for z0 in range(zs, ze, step):
                v = line[z0 - zs : z0 - zs + step]
                if (v == open_).all():
                    continue
                if (v == 0).all():
                    add_run(open_, x, y, open_start, z0 - 1)
                    open_ = 0
                    continue
                if v[0] != open_:
                    add_run(open_, x, y, open_start, z0 - 1)
                prev = np.concatenate([[open_], v[:-1]])
                start = open_start
                for i in range(step):
                    if v[i] != prev[i]:
                        start = z0 + i
                    if i < step - 1 and v[i + 1] != v[i]:
                        add_run(int(v[i]), x, y, start, z0 + i)
                open_, open_start = int(v[-1]), start
            add_run(open_, x, y, open_start, ze - 1)
    return (mins, maxs, count, sums), updates


STATS_CASES = (["random3d:0.6", "random2d:0.3", "odd_a", "helix", "checker2d", "full", "empty"]
               + [f"rows:{z}" for z in WORD_ROWS])


def _labels_and_n(case: str, connectivity: str = "face"):
    return _scipy(_model_mask(case), connectivity)


@pytest.mark.parametrize("case", STATS_CASES)
def test_model_of_the_kernel_stats_equals_the_plain_stats(case):
    labels, n = _labels_and_n(case)
    vol = torch.from_numpy(_vol(labels))
    for seg, per in ((2048, 4), (128, 4), (2048, 1)):
        got, _ = _model_stats(labels, n, seg, per)
        for g, want in zip(got, ck.component_stats_plain(vol, n)):
            np.testing.assert_array_equal(g, want.numpy())


def test_model_stats_make_one_update_a_run():
    """A run makes one update however many steps it spans; steps of
    background and steps inside the open run make none."""
    labels = np.zeros((2, 3, 1100), np.int32)
    labels[0, 0] = 1                               # one run across the whole row
    labels[0, 1, 100:900] = 2                      # a run over seven steps
    labels[1, 2, ::2] = 3                          # 550 one-voxel runs
    for per in (4, 1):
        _, updates = _model_stats(labels, 3, per=per)
        by_label = [sum(u[0] == k for u in updates) for k in (1, 2, 3)]
        assert by_label == [1, 1, 550]
        assert (1, 0, 0, 0, 1099) in updates and (2, 0, 1, 100, 899) in updates


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


@pytest.mark.parametrize("tiles", [1, 2, 3, 17])
def test_model_tile_scan_is_the_exclusive_prefix(tiles):
    """The look-back gives every tile the count of the tiles before it, in
    any interleaving, zero counts included."""
    for seed in range(5):
        rng = np.random.default_rng([tiles, seed])
        totals = [int(v) for v in rng.integers(0, 3, tiles)]
        assert _model_tile_scan(totals, rng) == list(np.cumsum([0] + totals[:-1]))
