"""Hand-written CUDA kernels for Hopper — the counterpart of
``pbr3d.ops.pallas_kernels``.

``min_dist2_kernel`` replaces ``pbr3d.ops.pallas_kernels._min_dist2_kernel``
(see ``pbr3d_torch/csrc/min_dist2.cu`` for its design); ``knn_kernel`` is
the k-nearest-neighbour kernel of the same family
(``pbr3d_torch/csrc/knn.cu``), which replaces the XLA program
``pbr3d.ops.neighbors._knn_padded``; ``components_kernel`` and
``component_stats_kernel`` (``pbr3d_torch/csrc/components.cu``) label the
connected components of a mask and measure them, replacing the XLA
programs ``pbr3d.ops.components._label_roots``, ``_label_dense_device``
and ``_component_stats_jit``.  Stage 2's two device programs follow:
``lm_fit_kernel`` (``pbr3d_torch/csrc/lm_fit.cu``) runs the keypoint
Levenberg-Marquardt fit, replacing ``pbr3d.camera.estimate._lm_fit``, and
``splat_iou_kernel`` (``pbr3d_torch/csrc/splat_iou.cu``) scores candidate
cameras by the splat + mean part IoU of ``pbr3d.camera.align._candidate_iou``.
The kernels are built from
``pbr3d_torch/csrc/`` at first use by ``nvcc`` for ``sm_90a`` (one compile
per source, all started together, then one link) into a shared library with
a plain C interface, under ``build/torch_kernels/`` at the root of the
checkout, and called through ``ctypes``.  The library is rebuilt only when a hash of the sources and
flags changes.  Nothing is built or loaded when this module is imported.

Beside each kernel sits its plain PyTorch version, which the CPU tests use
and the on-card smoke compares the kernel against.  A kernel wrapper
accepts CUDA tensors only and raises on anything else, and on a failed
build or launch; choosing the plain version for CPU tensors is the job of
:func:`pbr3d_torch.ops.neighbors.min_dist2`,
:func:`pbr3d_torch.ops.neighbors.knn2`, the device functions of
:mod:`pbr3d_torch.ops.components`,
:func:`pbr3d_torch.camera.estimate._lm_fit` and
:func:`pbr3d_torch.camera.align._batch_iou`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple, Sequence

import numpy as np
import torch

from pbr3d_torch.ops.cameramath import _ISCLOSE_TOL, project_points
from pbr3d_torch.ops.projection import partwise_iou, splat_labels

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_SOURCES = ("min_dist2.cu", "knn.cu", "components.cu", "lm_fit.cu", "splat_iou.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Queries one block of the kernel covers (128 threads x 8 queries), and the
#: B points per step of its loop; the library is checked against both.
QUERIES_PER_BLOCK = 1024
B_STEP = 8
#: Launch-plan limits: B points per chunk at the least, chunks at the most
#: (the grid's y dimension), and the share of the last wave's slots a plan
#: should fill.
MIN_CHUNK = 64
MAX_CHUNKS = 65535
WAVE_FILL = 0.97

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


#: One build at a time in a process: the threads of ``run_all``'s
#: preparation pool may reach their first kernel together.
_BUILD_LOCK = threading.Lock()


def build_library() -> Path:
    """Path of the kernels' library, built first when the sources or flags
    changed.  One thread of a process builds at a time, and a thread that
    waited finds the library its predecessor built; processes build into
    their own temporary names and rename into place.  Raises if ``nvcc`` is
    missing or the build fails; the compiler's output, ``-Xptxas -v``'s
    registers, shared memory and spills included, goes beside the library
    with the suffix ``.log``."""
    from torch.utils.cpp_extension import CUDA_HOME

    sources = [_CSRC / s for s in _SOURCES]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.read_bytes())
    lib_path = BUILD_DIR / f"pbr3d_kernels_{digest.hexdigest()[:16]}.so"
    with _BUILD_LOCK:
        if lib_path.exists():
            return lib_path
        if CUDA_HOME is None:
            raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc")
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        objects = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
        compiles = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                    for src, obj in zip(sources, objects)]
        log = ""
        try:
            for src, proc in zip(sources, compiles):
                text = proc.communicate()[0]
                if proc.returncode:
                    raise RuntimeError(f"nvcc failed with {proc.returncode} on {src.name}:\n{text}")
                log += text
            res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objects)],
                                 capture_output=True, text=True)
            if res.returncode:
                raise RuntimeError(f"nvcc link failed with {res.returncode}:\n{res.stdout}{res.stderr}")
        finally:
            for proc in compiles:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            for obj in objects:
                obj.unlink(missing_ok=True)
        lib_path.with_suffix(".log").write_text(log + res.stdout + res.stderr)
        os.replace(tmp, lib_path)
    return lib_path


@functools.cache
def load_extension() -> ctypes.CDLL:
    """Load the kernels' library (:func:`build_library` builds it when the
    sources changed).  Raises if ``nvcc`` is missing or the build fails.  The
    compiler's output is in the returned library's ``build_log``."""
    lib_path = build_library()
    log_path = lib_path.with_suffix(".log")
    lib = ctypes.CDLL(str(lib_path))
    lib.pbr3d_min_dist2.argtypes = [_P, _I64, _P, _I64, _P, _I64, _I64, _P, _P]
    lib.pbr3d_min_dist2.restype = _I32
    lib.pbr3d_min_dist2_blocks_per_sm.argtypes = [ctypes.POINTER(_I32)]
    lib.pbr3d_min_dist2_blocks_per_sm.restype = _I32
    lib.pbr3d_cuda_error_string.argtypes = [_I32]
    lib.pbr3d_cuda_error_string.restype = ctypes.c_char_p
    got = (lib.pbr3d_min_dist2_queries_per_block(), lib.pbr3d_min_dist2_b_step())
    if got != (QUERIES_PER_BLOCK, B_STEP):
        raise RuntimeError(f"{lib_path.name}: queries per block and B step {got}, "
                           f"expected {(QUERIES_PER_BLOCK, B_STEP)}")
    lib.pbr3d_knn.argtypes = [_P, _I64, _P, _I64, _P, _I64, _I64, _P, _P, _I32, _P, _P, _P]
    lib.pbr3d_knn.restype = _I32
    lib.pbr3d_knn_capacity.argtypes = [_I32]
    lib.pbr3d_knn_queries_per_block.argtypes = [_I32]
    lib.pbr3d_knn_blocks_per_sm.argtypes = [_I32, ctypes.POINTER(_I32)]
    lib.pbr3d_knn_blocks_per_sm.restype = _I32
    got = (lib.pbr3d_knn_b_step(), tuple(lib.pbr3d_knn_queries_per_block(c) for c in KNN_CAPACITIES),
           tuple(lib.pbr3d_knn_capacity(k) for k in (1, 3, 20, KNN_MAX_K, KNN_MAX_K + 1)))
    want = (KNN_B_STEP, tuple(map(knn_queries_per_block, KNN_CAPACITIES)),
            tuple(map(knn_capacity, (1, 3, 20, KNN_MAX_K))) + (0,))
    if got != want:
        raise RuntimeError(f"{lib_path.name}: knn's step, blocks and capacities {got}, expected {want}")
    lib.pbr3d_components.argtypes = [_P, _I32, _I32, _I32, _I32, _P, _P, _P, _P, _P]
    lib.pbr3d_components.restype = _I32
    lib.pbr3d_component_stats.argtypes = [_P, _I32, _I32, _I32, _I32, _P, _P, _P, _P, _P]
    lib.pbr3d_component_stats.restype = _I32
    got = (lib.pbr3d_components_big(), lib.pbr3d_components_rows_per_tile())
    if got != (COMPONENTS_BIG, COMPONENTS_ROWS_PER_TILE):
        raise RuntimeError(f"{lib_path.name}: components' voxel bound and rows per tile {got}, "
                           f"expected {(COMPONENTS_BIG, COMPONENTS_ROWS_PER_TILE)}")
    lib.pbr3d_lm_fit.argtypes = [_P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, ctypes.c_float,
                                 _P, _P, _P, _P]
    lib.pbr3d_lm_fit.restype = _I32
    lib.pbr3d_splat_iou.argtypes = [_P, _P, _P, _P, _P, _P, ctypes.POINTER(_I32), _I32, _I32, _I32, _I32,
                                    _I32, _I32, ctypes.c_float, _P, _P, _P]
    lib.pbr3d_splat_iou.restype = _I32
    got = (lib.pbr3d_lm_fit_threads(), lib.pbr3d_splat_iou_max_parts())
    if got != (LM_THREADS, SPLAT_IOU_MAX_PARTS):
        raise RuntimeError(f"{lib_path.name}: the LM's threads and splat-IoU's part bound {got}, "
                           f"expected {(LM_THREADS, SPLAT_IOU_MAX_PARTS)}")
    lib.build_log = log_path.read_text() if log_path.exists() else ""
    return lib


def _raise_on(err: int, what: str) -> None:
    if err:
        msg = load_extension().pbr3d_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


class LaunchPlan(NamedTuple):
    query_tiles: int  # grid x: blocks of QUERIES_PER_BLOCK queries
    chunk_len: int    # B points per chunk, a multiple of B_STEP
    chunks: int       # grid y: chunks of B
    m_pad: int        # B points after padding to a multiple of B_STEP


@functools.lru_cache(maxsize=64)
def _launch_plan(n: int, m: int, sm_count: int, blocks_per_sm: int,
                 queries_per_block: int = QUERIES_PER_BLOCK, b_step: int = B_STEP) -> LaunchPlan:
    """Grid of a kernel of the min-dist family for n queries and m > 0 points
    of B (by default the min-dist kernel's blocks and step).

    Takes the fewest chunks whose grid fills at least ``WAVE_FILL`` of the
    card's slots (SMs x resident blocks per SM) over its waves, counting a
    chunk shorter than ``chunk_len`` as idle slots; where none does (small
    problems), the chunking that fills most."""
    tiles = -(-n // queries_per_block)
    m_pad = -(-m // b_step) * b_step
    slots = sm_count * blocks_per_sm
    best_fill, best = -1.0, None
    for c in range(1, max(1, min(MAX_CHUNKS, m_pad // MIN_CHUNK)) + 1):
        chunk_len = -(-(-(-m_pad // c)) // b_step) * b_step  # ceil(m_pad / c), up to b_step
        chunks = -(-m_pad // chunk_len)
        waves = -(-tiles * chunks // slots)
        fill = tiles * m_pad / (waves * slots * chunk_len)
        plan = LaunchPlan(tiles, chunk_len, chunks, m_pad)
        if fill >= WAVE_FILL:
            return plan
        if fill > best_fill:
            best_fill, best = fill, plan
    return best


@functools.cache
def _card_slots(index: int) -> tuple:
    """(SMs, resident blocks of the min-dist kernel per SM) of a card."""
    lib = load_extension()
    blocks = _I32(0)
    with torch.cuda.device(index):
        _raise_on(lib.pbr3d_min_dist2_blocks_per_sm(ctypes.byref(blocks)), "occupancy query")
    if blocks.value < 1:
        raise RuntimeError("the min-dist kernel fits no block on an SM")
    return torch.cuda.get_device_properties(index).multi_processor_count, blocks.value


def _check_points(t: torch.Tensor, name: str) -> None:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != 2 or t.shape[1] != 3:
        raise ValueError(f"{name} must have shape (N, 3), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def min_dist2_kernel(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """min_j |A[i] - B[j]|² for A (N, 3), B (M, 3) contiguous float32 CUDA
    tensors on one device; (N,) float32, +inf where M = 0.  Launches on the
    current stream without synchronising; N = 0 or M = 0 launches nothing."""
    _check_points(A, "A")
    _check_points(B, "B")
    if A.device != B.device:
        raise ValueError(f"A is on {A.device}, B on {B.device}")
    n, m = A.shape[0], B.shape[0]
    if n == 0 or m == 0:
        return torch.full((n,), float("inf"), dtype=torch.float32, device=A.device)
    lib = load_extension()
    plan = _launch_plan(n, m, *_card_slots(A.device.index))
    out = torch.empty((n,), dtype=torch.float32, device=A.device)
    B4 = torch.empty((plan.m_pad, 4), dtype=torch.float32, device=A.device)  # packed by the call
    with torch.cuda.device(A.device):
        err = lib.pbr3d_min_dist2(A.data_ptr(), n, B.data_ptr(), m, B4.data_ptr(), plan.m_pad,
                                  plan.chunk_len, out.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "min_dist2 launch")
    min_dist2_kernel.launches += 1
    return out


min_dist2_kernel.launches = 0

#: Query rows per step of the plain version, sized so that its (rows, M)
#: temporaries stay near 2**24 elements.
_PLAIN_PAIRS = 1 << 24


def min_dist2_plain(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`min_dist2_kernel`: the same direct
    difference (no ``cdist``, no matmul), tiled over A."""
    n, m = A.shape[0], B.shape[0]
    out = torch.full((n,), float("inf"), dtype=torch.float32, device=A.device)
    if n == 0 or m == 0:
        return out
    rows = max(1, _PLAIN_PAIRS // m)
    bx, by, bz = (B[:, k][None, :] for k in range(3))
    for i0 in range(0, n, rows):
        a = A[i0 : i0 + rows]
        d = (a[:, 0:1] - bx).square_()
        d += (a[:, 1:2] - by).square_()
        d += (a[:, 2:3] - bz).square_()
        out[i0 : i0 + rows] = d.amin(dim=1)
    return out


#: The k-nearest-neighbour kernel: threads per block, queries a thread holds
#: at each list capacity it is compiled for, and B points per step; the
#: library is checked against all three.
KNN_THREADS = 128
KNN_QUERIES_PER_THREAD = {1: 8, 2: 4, 4: 4, 8: 2, 16: 2, 20: 2, 32: 1}
KNN_CAPACITIES = tuple(KNN_QUERIES_PER_THREAD)
KNN_MAX_K = KNN_CAPACITIES[-1]
KNN_B_STEP = 8


def knn_capacity(k: int) -> int:
    """The kernel's list capacity for k neighbours."""
    if not 1 <= k <= KNN_MAX_K:
        raise ValueError(f"k must be in 1..{KNN_MAX_K}, got {k}")
    return next(c for c in KNN_CAPACITIES if k <= c)


def knn_queries_per_block(capacity: int) -> int:
    """Queries one block of the knn kernel covers at a list capacity."""
    return KNN_THREADS * KNN_QUERIES_PER_THREAD[capacity]


def knn_launch_plan(n: int, m: int, capacity: int, sm_count: int, blocks_per_sm: int) -> LaunchPlan:
    """Grid of the knn kernel at a list capacity for n queries and m > 0
    points of B on a card of ``sm_count`` SMs that holds ``blocks_per_sm``
    blocks of that instantiation: the min-dist kernel's rule."""
    return _launch_plan(n, m, sm_count, blocks_per_sm, knn_queries_per_block(capacity), KNN_B_STEP)


@functools.cache
def _knn_card_slots(index: int, capacity: int) -> tuple:
    """(SMs, resident blocks of the knn kernel per SM at a capacity) of a card."""
    lib = load_extension()
    blocks = _I32(0)
    with torch.cuda.device(index):
        _raise_on(lib.pbr3d_knn_blocks_per_sm(capacity, ctypes.byref(blocks)), "occupancy query")
    if blocks.value < 1:
        raise RuntimeError(f"the knn kernel at capacity {capacity} fits no block on an SM")
    return torch.cuda.get_device_properties(index).multi_processor_count, blocks.value


def _redirect_unreachable(d2: torch.Tensor, idx: torch.Tensor):
    """Entries at an infinite distance point at the nearest neighbour."""
    return torch.where(torch.isfinite(d2), idx, idx[:, :1])


def knn_kernel(A: torch.Tensor, B: torch.Tensor, k: int):
    """The k smallest |A[i] - B[j]|² and their j for A (N, 3), B (M, 3)
    contiguous float32 CUDA tensors on one device, 1 <= k <= ``KNN_MAX_K``:
    (N, k) float32 squared distances ascending and (N, k) int64 indices,
    exact ties to the lower index.  Where k > M the trailing distances are
    +inf and their indices the nearest neighbour's (0 where M = 0).  Launches
    on the current stream without synchronising; N = 0 or M = 0 launches
    nothing."""
    _check_points(A, "A")
    _check_points(B, "B")
    if A.device != B.device:
        raise ValueError(f"A is on {A.device}, B on {B.device}")
    cap = knn_capacity(k)
    n, m = A.shape[0], B.shape[0]
    if n == 0 or m == 0:
        return (torch.full((n, k), float("inf"), dtype=torch.float32, device=A.device),
                torch.zeros((n, k), dtype=torch.int64, device=A.device))
    lib = load_extension()
    plan = knn_launch_plan(n, m, cap, *_knn_card_slots(A.device.index, cap))
    d2 = torch.empty((n, k), dtype=torch.float32, device=A.device)
    idx = torch.empty((n, k), dtype=torch.int64, device=A.device)
    B4 = torch.empty((plan.m_pad, 4), dtype=torch.float32, device=A.device)  # packed by the call
    # the chunk lists; k = 1 merges by atomicMin in idx instead
    parts = [torch.empty((plan.chunks, cap, n), dtype=dt, device=A.device)
             for dt in (torch.float32, torch.int32)] if cap > 1 else []
    with torch.cuda.device(A.device):
        err = lib.pbr3d_knn(A.data_ptr(), n, B.data_ptr(), m, B4.data_ptr(), plan.m_pad,
                            plan.chunk_len, *([t.data_ptr() for t in parts] or [None, None]), k,
                            d2.data_ptr(), idx.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "knn launch")
    knn_kernel.launches += 1
    knn_kernel.pairs[cap] = knn_kernel.pairs.get(cap, 0) + n * m
    return d2, idx


knn_kernel.launches = 0
#: capacity -> (query, point) pairs of the launches since the last clear
knn_kernel.pairs = {}


def knn_plain(A: torch.Tensor, B: torch.Tensor, k: int):
    """Plain PyTorch version of :func:`knn_kernel`: the same direct
    difference tiled over A, then the k smallest of the int64 keys
    ``distance bits << 32 | index`` (a non-negative float32 orders as its
    bits, and the index breaks exact ties, which ``torch.topk`` on the
    distances alone would not promise)."""
    n, m = A.shape[0], B.shape[0]
    d2 = torch.full((n, k), float("inf"), dtype=torch.float32, device=A.device)
    idx = torch.zeros((n, k), dtype=torch.int64, device=A.device)
    if n == 0 or m == 0:
        return d2, idx
    kk = min(k, m)
    rows = max(1, _PLAIN_PAIRS // m)
    bx, by, bz = (B[:, c][None, :] for c in range(3))
    col = torch.arange(m, dtype=torch.int64, device=A.device)[None, :]
    for i0 in range(0, n, rows):
        a = A[i0 : i0 + rows]
        d = (a[:, 0:1] - bx).square_()
        d += (a[:, 1:2] - by).square_()
        d += (a[:, 2:3] - bz).square_()
        key = (d.view(torch.int32).to(torch.int64) << 32) | col
        best = (key.amin(dim=1, keepdim=True) if kk == 1
                else torch.topk(key, kk, dim=1, largest=False, sorted=True).values)
        d2[i0 : i0 + rows, :kk] = (best >> 32).to(torch.int32).view(torch.float32)
        idx[i0 : i0 + rows, :kk] = best & 0xFFFFFFFF
    return d2, _redirect_unreachable(d2, idx)


#: The plain labeller's background label (``pbr3d/ops/components.py``'s
#: ``_BIG``), which bounds a mask's voxel count (the kernels' flat indices
#: are int32); and the rows a block of the scan over the rows' root counts
#: takes, by which the wrapper sizes the scan's tile states.  The library
#: is checked against both.
COMPONENTS_BIG = 1 << 30
COMPONENTS_ROWS_PER_TILE = 4096


def _check_volume(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != 3:
        raise ValueError(f"{name} must have shape (X, Y, Z), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() >= COMPONENTS_BIG:
        raise ValueError(f"{name} has {t.numel()} voxels, the kernels take fewer than {COMPONENTS_BIG}")


def components_kernel(mask: torch.Tensor, full: bool):
    """Connected components of an (X, Y, Z) contiguous uint8 CUDA mask
    (non-zero is foreground) under face (6) or, with ``full``, 26
    connectivity: (labels (X, Y, Z) int32, n), 0 on the background and 1..n
    in the raster order of each component's first voxel, as
    ``scipy.ndimage.label`` numbers them.  Launches the run, merge, rank,
    scan (of the rows' root counts) and label kernels on the current
    stream, which write every voxel of the labels once; reading n
    back synchronises.  An empty mask launches nothing."""
    _check_volume(mask, "mask", torch.uint8)
    if mask.numel() == 0:
        return torch.zeros(mask.shape, dtype=torch.int32, device=mask.device), 0
    lib = load_extension()
    X, Y, Z = mask.shape
    rows, dev = X * Y, mask.device
    labels = torch.empty(mask.shape, dtype=torch.int32, device=dev)
    # one scratch allocation, in int32s: the scan's tile counter and tile
    # states (int64 each), the row offsets and the rows' bits (ceil(Z / 32)
    # words a row)
    n_tiles = 2 * (-(-rows // COMPONENTS_ROWS_PER_TILE) + 1)
    scratch = torch.empty((n_tiles + rows + 1 + rows * -(-Z // 32),), dtype=torch.int32, device=dev)
    tiles = scratch.data_ptr()
    offsets, words = tiles + 4 * n_tiles, tiles + 4 * (n_tiles + rows + 1)
    with torch.cuda.device(dev):
        _raise_on(lib.pbr3d_components(mask.data_ptr(), X, Y, Z, int(bool(full)), words, labels.data_ptr(),
                                       offsets, tiles, torch.cuda.current_stream().cuda_stream),
                  "components launch")
    components_kernel.launches += 1
    return labels, int(scratch[n_tiles + rows])


components_kernel.launches = 0


def _shift_min(lab: torch.Tensor, axis: int) -> torch.Tensor:
    """min(lab, lab shifted by ±1 along ``axis``), nothing from past the
    border."""
    out = lab.clone()
    n = lab.shape[axis]
    if n > 1:
        lo, hi = out.narrow(axis, 0, n - 1), out.narrow(axis, 1, n - 1)
        lo.copy_(torch.minimum(lo, lab.narrow(axis, 1, n - 1)))
        hi.copy_(torch.minimum(hi, lab.narrow(axis, 0, n - 1)))
    return out


def components_plain(mask: torch.Tensor, full: bool):
    """Plain PyTorch version of :func:`components_kernel`, on any device: the
    JAX package's relaxation (``pbr3d.ops.components._label_roots``) without
    its segmented scans.  Every foreground voxel starts at its flat index;
    each step takes the masked minimum over the face cross or the full 3³
    box, then jumps pointers (``lab = lab.view(-1)[lab]``) until they stop
    moving; the loop ends at its fixpoint, where each voxel holds its
    component's smallest flat index.  The same dense relabel follows."""
    m = mask.bool().contiguous()
    shape, N = m.shape, m.numel()
    labels = torch.zeros(shape, dtype=torch.int32, device=m.device)
    if N == 0:
        return labels, 0
    big = torch.tensor(COMPONENTS_BIG, dtype=torch.int32, device=m.device)
    idx = torch.arange(N, dtype=torch.int32, device=m.device).view(shape)
    lab = torch.where(m, idx, big)
    while True:
        out = lab
        for ax in range(3):
            out = _shift_min(out, ax) if full else torch.minimum(out, _shift_min(lab, ax))
        new = torch.where(m, out, big)
        while True:
            flat = new.view(-1)
            jumped = torch.where(m, flat.index_select(0, flat.clamp(max=N - 1)).view(shape), big)
            if torch.equal(jumped, new):
                break
            new = jumped
        if torch.equal(new, lab):
            break
        lab = new
    rank = torch.cumsum((lab == idx).view(-1), 0, dtype=torch.int32)
    labels = torch.where(m, rank.index_select(0, lab.view(-1).clamp(max=N - 1)).view(shape), labels)
    return labels, int(rank[-1])


def component_stats_kernel(labels: torch.Tensor, n: int):
    """Statistics of ids 1..n in an (X, Y, Z) contiguous int32 CUDA label
    volume: (bbox min (n + 1, 3), bbox max (n + 1, 3) inclusive, count
    (n + 1,), coordinate sums (n + 1, 3)), all int64 on the card; row 0 and
    absent ids keep (2**30, -1, 0, 0), other labels are ignored.  Launches on
    the current stream without synchronising."""
    _check_volume(labels, "labels", torch.int32)
    if not 0 <= n < COMPONENTS_BIG:
        raise ValueError(f"n must be in 0..{COMPONENTS_BIG - 1}, got {n}")
    rows, dev = n + 1, labels.device
    mins = torch.full((rows, 3), COMPONENTS_BIG, dtype=torch.int32, device=dev)
    maxs = torch.full((rows, 3), -1, dtype=torch.int32, device=dev)
    count = torch.zeros((rows,), dtype=torch.int64, device=dev)
    sums = torch.zeros((rows, 3), dtype=torch.int64, device=dev)
    if n and labels.numel():
        lib = load_extension()
        with torch.cuda.device(dev):
            _raise_on(lib.pbr3d_component_stats(labels.data_ptr(), *labels.shape, rows, mins.data_ptr(),
                                                maxs.data_ptr(), count.data_ptr(), sums.data_ptr(),
                                                torch.cuda.current_stream().cuda_stream),
                      "component stats launch")
        component_stats_kernel.launches += 1
    return mins.long(), maxs.long(), count, sums


component_stats_kernel.launches = 0


def component_stats_plain(labels: torch.Tensor, n: int):
    """Plain PyTorch version of :func:`component_stats_kernel`, on any
    device: ``scatter_reduce`` amin / amax of the voxels' coordinates, an
    int64 ``bincount`` and int64 ``index_add_`` sums."""
    rows, dev = n + 1, labels.device
    coords = torch.nonzero((labels > 0) & (labels <= n))  # (K, 3) int64
    lab = labels[tuple(coords.unbind(1))].long()
    at = lab[:, None].expand(-1, 3)
    mins = torch.full((rows, 3), COMPONENTS_BIG, dtype=torch.int64, device=dev)
    mins.scatter_reduce_(0, at, coords, "amin")
    maxs = torch.full((rows, 3), -1, dtype=torch.int64, device=dev).scatter_reduce_(0, at, coords, "amax")
    count = torch.bincount(lab, minlength=rows)
    sums = torch.zeros((rows, 3), dtype=torch.int64, device=dev).index_add_(0, lab, coords)
    return mins, maxs, count, sums


#: Stage 2's kernels: the threads of an LM block (one warp a fit), and the
#: most parts the splat-IoU kernel counts (a part's counts live in one lane);
#: the library is checked against both.
LM_THREADS = 32
SPLAT_IOU_MAX_PARTS = 32
LM_LOSS_TYPES = ("L2", "L1")


def _check_tensor(t, name: str, dtype: torch.dtype, shape: tuple, spelled: str) -> None:
    """dtype and shape (None: any extent); :func:`_on_one_card` checks the
    rest once every tensor's dtype and shape have passed."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(s is not None and s != n for s, n in zip(shape, t.shape)):
        raise ValueError(f"{name} must have shape {spelled}, got {tuple(t.shape)}")


def _on_one_card(**tensors) -> torch.device:
    """The one CUDA device of the (non-None) tensors, each contiguous."""
    given = {n: t for n, t in tensors.items() if t is not None}
    for name, t in given.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    devs = {t.device for t in given.values()}
    if len(devs) > 1:
        raise ValueError(f"tensors on several devices: { {n: str(t.device) for n, t in given.items()} }")
    return devs.pop()


def lm_fit_kernel(x0: torch.Tensor, vox: torch.Tensor, img: torch.Tensor, mask: torch.Tensor,
                  lo: torch.Tensor, hi: torch.Tensor, loss_type: str = "L2", max_iters: int = 200):
    """Bounded Levenberg-Marquardt fits of V cameras to their keypoints, all
    in one launch: starts ``x0``, bounds ``lo``, ``hi`` (V, 9), voxel
    keypoints ``vox`` (V, K, 3), image keypoints ``img`` (V, K, 2) and their
    1/0 ``mask`` (V, K) (views with fewer keypoints are padded with masked
    ones), all contiguous float32 CUDA tensors on one device.  Returns
    (x (V, 9), loss (V,), steps (V,) int32), the function of
    :func:`lm_fit_plain`, on the current stream without synchronising."""
    if loss_type not in LM_LOSS_TYPES:
        raise ValueError(f"loss_type must be one of {LM_LOSS_TYPES}, got {loss_type!r}")
    if not isinstance(max_iters, int) or max_iters < 0:
        raise ValueError(f"max_iters must be a non-negative int, got {max_iters!r}")
    _check_tensor(x0, "x0", torch.float32, (None, 9), "(V, 9)")
    V = x0.shape[0]
    _check_tensor(vox, "vox", torch.float32, (V, None, 3), "(V, K, 3)")
    K = vox.shape[1]
    _check_tensor(img, "img", torch.float32, (V, K, 2), "(V, K, 2)")
    _check_tensor(mask, "mask", torch.float32, (V, K), "(V, K)")
    _check_tensor(lo, "lo", torch.float32, (V, 9), "(V, 9)")
    _check_tensor(hi, "hi", torch.float32, (V, 9), "(V, 9)")
    dev = _on_one_card(x0=x0, vox=vox, img=img, mask=mask, lo=lo, hi=hi)
    if V >= 1 << 31 or K >= 1 << 28:
        raise ValueError(f"{V} fits of {K} keypoints: too many for one launch")
    x = torch.empty((V, 9), dtype=torch.float32, device=dev)
    loss = torch.empty((V,), dtype=torch.float32, device=dev)
    steps = torch.empty((V,), dtype=torch.int32, device=dev)
    if V == 0:
        return x, loss, steps
    lib = load_extension()
    with torch.cuda.device(dev):
        err = lib.pbr3d_lm_fit(x0.data_ptr(), vox.data_ptr(), img.data_ptr(), mask.data_ptr(), lo.data_ptr(),
                               hi.data_ptr(), V, K, int(loss_type == "L1"), max_iters, _ISCLOSE_TOL,
                               x.data_ptr(), loss.data_ptr(), steps.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "lm_fit launch")
    lm_fit_kernel.launches += 1
    return x, loss, steps


lm_fit_kernel.launches = 0

#: Forward-mode AD keeps one dual level for the whole process, and a second
#: thread that enters it raises "Nested forward mode AD is not supported":
#: concurrent fits on CPU tensors (``run_all``'s preparation pool) take
#: turns.  Only the plain version takes it; the kernel needs no AD.
_FORWARD_AD_LOCK = threading.Lock()


def lm_fit_plain(x0: torch.Tensor, vox: torch.Tensor, img: torch.Tensor, mask: torch.Tensor,
                 lo: torch.Tensor, hi: torch.Tensor, loss_type: str = "L2", max_iters: int = 200):
    """Plain PyTorch version of :func:`lm_fit_kernel`, on any device: the
    port's forward-AD fit of the JAX package's ``_lm_fit``, the V fits side
    by side.

    The JAX package loops ``while it < max_iters and |delta| > 1e-10``.
    Here all ``max_iters`` steps run, and a step taken once ``|delta|`` has
    fallen to 1e-10 (or is NaN) changes nothing, so the state freezes where
    the JAX loop would have stopped, with no host sync per step; ``steps``
    counts the live ones.

    The Jacobian is forward-mode AD, as ``jax.jacfwd``: one dual evaluation
    of the residuals at 9 copies of each x whose tangents are the unit
    vectors (the projection takes a camera batch), so a step costs two
    batched residual evaluations and no per-direction loop."""
    import torch.autograd.forward_ad as fwAD

    if loss_type not in LM_LOSS_TYPES:
        raise ValueError(f"loss_type must be one of {LM_LOSS_TYPES}, got {loss_type!r}")
    V = x0.shape[0]

    def residuals(x, vox, img, mask):  # (V, B, 9) -> (V, B, R)
        u, v, _ = project_points(vox[:, None], x[..., 0:3], x[..., 3:6], x[..., 6], x[..., 7], x[..., 8])
        r = (torch.stack([u, v], dim=-1) - img[:, None]) * mask[:, None, :, None]
        if loss_type == "L1":
            # Smooth |r| so the Jacobian exists everywhere.
            r = torch.sqrt(r * r + 1e-12) * mask[:, None, :, None]
        return r.reshape(*x.shape[:2], -1)

    def loss(x):  # (V, B, 9) -> (V, B)
        r = residuals(x, vox, img, mask)
        return (r * r).sum(dim=-1) if loss_type == "L2" else r.abs().sum(dim=-1)

    eye = torch.eye(9, dtype=torch.float32, device=x0.device)
    x = x0
    lam = torch.full((V,), 1e-3, dtype=torch.float32, device=x0.device)
    dn = torch.ones((V,), dtype=torch.float32, device=x0.device)
    steps = torch.zeros((V,), dtype=torch.int32, device=x0.device)
    with _FORWARD_AD_LOCK, fwAD.dual_level():
        # The keypoints enter as duals with zero tangents: forward AD of an
        # op that mixes dual and plain operands takes a slow decomposition.
        consts = [fwAD.make_dual(t, torch.zeros_like(t)) for t in (vox, img, mask)]
        for _ in range(max_iters):
            active = dn > 1e-10
            r = residuals(fwAD.make_dual(x[:, None].expand(V, 9, 9).clone(), eye.expand(V, 9, 9)), *consts)
            if loss_type == "L1":
                # LM on the squared residuals: for L1 they are sqrt(|r|), so
                # LM minimises Σ|r| via IRLS.
                r = torch.sqrt(r.abs() + 1e-12)
            out = fwAD.unpack_dual(r)
            r, J = out.primal[:, 0], out.tangent.transpose(1, 2)  # (V, R), (V, R, 9)
            JtJ = (J[:, :, :, None] * J[:, :, None, :]).sum(dim=1)
            g = (J * r[:, :, None]).sum(dim=1)
            delta = torch.linalg.solve_ex(JtJ + lam[:, None, None] * eye, -g)[0]
            x_new = torch.clamp(x + delta, lo, hi)
            l_new, l_old = loss(torch.stack([x_new, x], dim=1)).unbind(1)
            better = l_new < l_old
            lam_new = torch.clamp(torch.where(better, lam * 0.5, lam * 4.0), 1e-8, 1e12)
            x = torch.where((active & better)[:, None], x_new, x)
            lam = torch.where(active, lam_new, lam)
            dn = torch.where(active, torch.sqrt((delta * delta).sum(dim=1)), dn)
            steps += active.to(torch.int32)
    return x, loss(x[:, None])[:, 0], steps


def _part_ids(part_ids) -> list:
    ids = [int(i) for i in np.asarray(part_ids).reshape(-1)]
    if not 1 <= len(ids) <= SPLAT_IOU_MAX_PARTS or not all(0 <= i < 256 for i in ids):
        raise ValueError(f"part_ids must be 1..{SPLAT_IOU_MAX_PARTS} uint8 labels, got {ids}")
    return ids


def splat_iou_kernel(cams: torch.Tensor, pts: torch.Tensor, labels: torch.Tensor, valid, gt: torch.Tensor,
                     part_ids: Sequence[int], hw=None) -> torch.Tensor:
    """Mean part IoU (V, P) float32 of P cameras ``cams`` (V, P, 9) per view:
    the splat of the view's points ``pts`` (V, N, 3) float32 with ``labels``
    (V, N) uint8 (the last point wins a pixel; ``valid`` (V, N) bool or None
    masks padding) against the view's ground truth ``gt`` (V, H, W) uint8,
    per part of ``part_ids``; ``hw`` (V, 2) int32 is each view's true
    (Ht, Wt) inside the (H, W) allocation, or None.  Contiguous CUDA tensors
    on one device; the function of :func:`splat_iou_plain`.  A memset and
    three launches on the current stream, no synchronisation; the int32
    scratch (a plane per camera and the counts) is allocated here."""
    ids = _part_ids(part_ids)
    _check_tensor(cams, "cams", torch.float32, (None, None, 9), "(V, P, 9)")
    V, P = cams.shape[:2]
    _check_tensor(pts, "pts", torch.float32, (V, None, 3), "(V, N, 3)")
    N = pts.shape[1]
    _check_tensor(labels, "labels", torch.uint8, (V, N), "(V, N)")
    if valid is not None:
        _check_tensor(valid, "valid", torch.bool, (V, N), "(V, N)")
    _check_tensor(gt, "gt", torch.uint8, (V, None, None), "(V, H, W)")
    H, W = gt.shape[1:]
    if hw is not None:
        _check_tensor(hw, "hw", torch.int32, (V, 2), "(V, 2)")
    dev = _on_one_card(cams=cams, pts=pts, labels=labels, valid=valid, gt=gt, hw=hw)
    if V > 65535 or P > 65535 or N >= (1 << 31) - 1 or H * W >= 1 << 31 or H * W == 0:
        raise ValueError(f"{V} views x {P} cameras x {N} points on {H} x {W}: outside the kernel's grid")
    out = torch.empty((V, P), dtype=torch.float32, device=dev)
    if V == 0 or P == 0:
        return out
    lib = load_extension()
    scratch = torch.empty((V * P * (H * W + 2 * len(ids)),), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.pbr3d_splat_iou(
            cams.data_ptr(), pts.data_ptr(), labels.data_ptr(), None if valid is None else valid.data_ptr(),
            None if hw is None else hw.data_ptr(), gt.data_ptr(), (_I32 * len(ids))(*ids), len(ids), V, P, N,
            H, W, _ISCLOSE_TOL, scratch.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "splat_iou launch")
    splat_iou_kernel.launches += 1
    return out


splat_iou_kernel.launches = 0


def splat_iou_plain(cams: torch.Tensor, pts: torch.Tensor, labels: torch.Tensor, valid, gt: torch.Tensor,
                    part_ids: Sequence[int], hw=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`splat_iou_kernel`, on any device: the
    route the kernel replaces, ``projection.splat_labels`` (its int64 keys,
    last point wins) with the views' points against their P cameras, then
    ``projection.partwise_iou``'s mean."""
    V = cams.shape[0]
    H, W = gt.shape[-2:]
    true_hw = None if hw is None else (hw[:, 0].view(V, 1, 1), hw[:, 1].view(V, 1, 1))
    img = splat_labels(pts[:, None], labels[:, None], None if valid is None else valid[:, None],
                       cams[..., 0:3], cams[..., 3:6], cams[..., 6], cams[..., 7], cams[..., 8], H, W, true_hw)
    return partwise_iou(img, gt[:, None], part_ids)[1]
