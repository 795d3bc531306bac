"""Image I/O helpers (PIL).

``save_img`` auto-normalizes values outside [0, 1], accepts ``(H, W)``
grayscale or channel-first/-last RGB, and writes 8-bit.  ``load_img``
returns float32 in [0, 1], channel-last; ``load_img_u8`` the raw bytes.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def load_img(path: str) -> np.ndarray:
    """Load an image as float32 in [0, 1], shape (H, W, C) or (H, W)."""
    with Image.open(path) as im:
        arr = np.asarray(im)
    if arr.dtype == np.uint8:
        return arr.astype(np.float32) / 255.0
    if arr.dtype == np.uint16:
        return arr.astype(np.float32) / 65535.0
    return arr.astype(np.float32)


def load_img_u8(path: str) -> np.ndarray:
    """Load an 8-bit image as raw uint8, ``(H, W, C)`` or ``(H, W)``, for
    the u8 serving ingest (normalized on the device)."""
    with Image.open(path) as im:
        arr = np.asarray(im)
    if arr.dtype != np.uint8:
        raise ValueError(f'{path}: u8 ingest needs 8-bit views, '
                         f'got {arr.dtype}')
    return arr


def save_img(path: str, arr) -> None:
    """Save an array as an 8-bit image, normalizing if out of [0, 1].

    Accepts (H, W), (3, H, W) or (H, W, 3)/(H, W, 4).
    """
    arr = np.asarray(arr, dtype=np.float32)

    a_min, a_max = float(np.min(arr)), float(np.max(arr))
    if a_min < 0.0 or a_max > 1.0:
        rng = a_max - a_min
        arr = (arr - a_min) / rng if rng > 0 else np.zeros_like(arr)

    if arr.ndim == 3 and arr.shape[0] in (3, 4) and arr.shape[2] not in (3, 4):
        arr = np.transpose(arr, (1, 2, 0))

    out = np.clip(np.round(arr * 255.0), 0, 255).astype(np.uint8)
    Image.fromarray(out).save(path)
