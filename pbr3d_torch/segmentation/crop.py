"""Symmetric cropping (reference: segmentation_utils/crop_ops.py:6-23,
crop_ui.py:83-99,160-175), as in ``pbr3d.segmentation.crop``.

Host numpy: the symmetry-axis search scores each candidate column in float32
in a Python loop, as the JAX package does, so that near ties resolve the
same way (a vectorised reduction sums in another order and can move the
argmin).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _clamp(v, lo, hi):
    return max(lo, min(hi, v))


def apply_crop(
    img: np.ndarray,
    bbox: Tuple[int, int, int, int],
    sym_on: bool = False,
    sym_x: Optional[int] = None,
):
    """Crop with optional symmetric expansion about ``sym_x``.

    Returns (cropped image copy, effective (L, T, R, B)).
    """
    L, T, R, B = bbox
    H, W = img.shape[:2]
    L, R = _clamp(L, 0, W), _clamp(R, 0, W)
    T, B = _clamp(T, 0, H), _clamp(B, 0, H)
    if sym_on and sym_x is not None:
        L, R = expand_box_symmetric(L, R, sym_x, W)
    if R <= L or B <= T:
        raise ValueError("Invalid crop")
    return img[T:B, L:R].copy(), (L, T, R, B)


def expand_box_symmetric(L: int, R: int, sym_x: int, W: int) -> Tuple[int, int]:
    """Expand [L, R) so it is symmetric about sym_x
    (reference: crop_ui.py:166-169)."""
    half = max(sym_x - L, R - sym_x)
    return _clamp(sym_x - half, 0, W), _clamp(sym_x + half, 0, W)


def _gray(img: np.ndarray) -> np.ndarray:
    """float32 channel mean as the JAX package's ``jnp.mean(axis=2)`` runs on
    XLA's CPU backend: the channels summed left to right, then multiplied by
    float32 ``1/C`` (XLA turns the division by the constant count into that
    product, which may differ from the quotient by one ulp)."""
    img = np.asarray(img, np.float32)
    total = img[:, :, 0].copy()
    for c in range(1, img.shape[2]):
        total += img[:, :, c]
    return total * np.float32(1.0 / img.shape[2])


def find_symmetry_axis(img: np.ndarray) -> int:
    """Column minimizing mean |left(mirrored) - right| over [W/4, 3W/4)
    (reference: crop_ui.py:83-99); ties go to the first minimum.

    The gray plane is :func:`_gray`, bit-equal to the JAX package's.
    """
    H, W = img.shape[:2]
    gray = _gray(img)  # (H, W)
    lo, hi = W // 4, 3 * W // 4
    best_x, best_err = W // 2, np.inf
    for x in range(lo, hi):
        w = min(x, W - x)
        if w <= 0:
            continue
        left = gray[:, :x][:, ::-1][:, :w]
        right = gray[:, x : x + w]
        err = float(np.abs(left - right).mean())
        if err < best_err:
            best_err, best_x = err, x
    return int(best_x)
