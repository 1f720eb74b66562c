"""Hand-written CUDA kernels for Hopper — the counterpart of
``pbr3d.ops.pallas_kernels``.

``min_dist2_kernel`` replaces ``pbr3d.ops.pallas_kernels._min_dist2_kernel``
(see ``pbr3d_torch/csrc/min_dist2.cu`` for its design).  The kernels are
built from ``pbr3d_torch/csrc/`` at first use, with nvcc for ``sm_90a``,
into ``build/torch_kernels/`` at the root of the checkout, and bound with
``torch.utils.cpp_extension.load``.  Nothing is built or imported from
the CUDA toolchain when this module is imported.

Beside each kernel sits its plain PyTorch version, which the CPU tests use
and the on-card smoke compares the kernel against.  The kernel wrapper
accepts CUDA tensors only and raises on anything else; choosing the plain
version for CPU tensors is :func:`pbr3d_torch.ops.neighbors.min_dist2`'s job.
"""

from __future__ import annotations

import functools
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"


@functools.cache
def load_extension():
    """Build (first call) and load the kernels' extension module.  Raises if
    the toolchain is missing or the build fails."""
    from torch.utils.cpp_extension import load

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return load(
        name="pbr3d_torch_kernels",
        sources=[str(_CSRC / "min_dist2_bind.cpp"), str(_CSRC / "min_dist2.cu")],
        build_directory=str(BUILD_DIR),
        extra_cflags=["-O2"],
        extra_cuda_cflags=["-O3", "-gencode=arch=compute_90a,code=sm_90a"],
    )


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
    current stream without synchronising; N = 0 launches nothing."""
    _check_points(A, "A")
    _check_points(B, "B")
    if A.device != B.device:
        raise ValueError(f"A is on {A.device}, B on {B.device}")
    if A.shape[0] == 0:
        return torch.empty((0,), dtype=torch.float32, device=A.device)
    out = load_extension().min_dist2(A, B)
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
