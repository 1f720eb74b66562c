"""Morphological and smoothing primitives as plain tensor ops, as in
``pbr3d.ops.morphology`` (which covers the reference's uses of
``scipy.ndimage``: binary dilation with the cross structuring element,
binary closing and small-region removal, ``gaussian_filter``).

Everything here is shifts, ORs/ANDs and explicit float32 multiply-adds: no
convolution (a float32 convolution on the card runs in TF32 unless a global
flag says otherwise) and no pooling.  Inputs may be arrays or tensors on any
device; the work runs on ``device`` and a tensor on it is returned.
"""

from __future__ import annotations

import numpy as np
import torch


def _shifted(mask: torch.Tensor, axis: int, fill: bool):
    """``mask`` moved by one towards the start and towards the end of
    ``axis``, the vacated plane set to ``fill``."""
    n = mask.shape[axis]
    edge = torch.full_like(mask.narrow(axis, 0, 1), fill)
    fwd = torch.cat([mask.narrow(axis, 1, n - 1), edge], dim=axis)
    bwd = torch.cat([edge, mask.narrow(axis, 0, n - 1)], dim=axis)
    return fwd, bwd


def binary_dilation(mask, iterations: int = 1, *, device) -> torch.Tensor:
    """Dilate with the scipy-default cross (face) structuring element."""
    mask = torch.as_tensor(mask, device=device).bool()
    for _ in range(iterations):
        out = mask
        for ax in range(mask.dim()):
            fwd, bwd = _shifted(mask, ax, False)
            out = out | fwd | bwd
        mask = out
    return mask


def binary_erosion(mask, iterations: int = 1, *, device) -> torch.Tensor:
    """Erode with the cross structuring element (zero-padded border)."""
    mask = torch.as_tensor(mask, device=device).bool()
    for _ in range(iterations):
        out = mask
        for ax in range(mask.dim()):
            fwd, bwd = _shifted(mask, ax, False)
            out = out & fwd & bwd
        mask = out
    return mask


def binary_closing(mask, iterations: int = 1, *, device) -> torch.Tensor:
    return binary_erosion(binary_dilation(mask, iterations, device=device), iterations, device=device)


def _window_reduce(m: torch.Tensor, ksize: int, pad_value: bool, combine) -> torch.Tensor:
    """Separable ``ksize`` window reduction along every axis with the padding
    of a "SAME" window: ``(ksize - 1) // 2`` of ``pad_value`` before and
    ``ksize // 2`` after."""
    lo, hi = (ksize - 1) // 2, ksize // 2
    for ax in range(m.dim()):
        n = m.shape[ax]
        shape = list(m.shape)
        parts = []
        for width in (lo, hi):
            shape[ax] = width
            parts.append(torch.full(shape, pad_value, dtype=torch.bool, device=m.device))
        padded = torch.cat([parts[0], m, parts[1]], dim=ax)
        out = padded.narrow(ax, 0, n)
        for s in range(1, ksize):
            out = combine(out, padded.narrow(ax, s, n))
        m = out
    return m


def binary_closing_square(mask, ksize: int, *, device) -> torch.Tensor:
    """EXACT ``cv2.morphologyEx(m, MORPH_CLOSE, np.ones((k, k)))`` semantics:
    a dense k x k dilation with the border read as 0, then the erosion with
    the border read as 1.  Both are separable window filters."""
    m = torch.as_tensor(mask, device=device).bool()
    dil = _window_reduce(m, int(ksize), False, torch.logical_or)
    return _window_reduce(dil, int(ksize), True, torch.logical_and)


def remove_small_regions(mask, min_area: int, connectivity: str = "full") -> np.ndarray:
    """Drop connected regions smaller than ``min_area`` pixels (host
    labelling, as everywhere in the port; a host bool array)."""
    from pbr3d_torch.ops.components import component_stats, connected_components

    mask = mask.cpu().numpy() if isinstance(mask, torch.Tensor) else np.asarray(mask)
    labels, n = connected_components(mask.astype(bool), connectivity)
    if n == 0:
        return mask.astype(bool)
    stats = component_stats(labels, n)
    keep = np.where(stats["count"] >= min_area)[0]
    keep = keep[keep > 0]
    return np.isin(labels, keep)


def _gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy-compatible Gaussian kernel (radius = int(truncate*sigma + 0.5))."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_filter(vol, sigma: float, truncate: float = 4.0, *, device) -> torch.Tensor:
    """Separable Gaussian blur with scipy's default 'reflect' boundary (the
    edge sample repeated: numpy's "symmetric"), in float32.  Each axis is
    2r + 1 explicit shifted multiply-adds, taps in order."""
    k = _gaussian_kernel1d(sigma, truncate)
    r = (len(k) - 1) // 2
    out = torch.as_tensor(vol, device=device).to(torch.float32)
    for ax in range(out.dim()):
        n = out.shape[ax]
        # the mirrored border by flip and cat; a border wider than the axis
        # keeps mirroring, as numpy's "symmetric" does
        period = torch.cat([out, out.flip(ax)], dim=ax)
        idx = (torch.arange(-r, n + r, device=out.device) % (2 * n))
        padded = period.index_select(ax, idx)
        acc = padded.narrow(ax, 0, n) * float(k[0])
        for t in range(1, 2 * r + 1):
            acc = acc + padded.narrow(ax, t, n) * float(k[t])
        out = acc
    return out
