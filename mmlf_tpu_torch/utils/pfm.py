"""Portable-float-map (PFM) I/O.

Images are stored bottom-up and the sign of the scale line encodes
endianness; callers ``np.flip(..., 0)`` after load and before save, as the
dataset code does.
"""

from __future__ import annotations

import sys

import numpy as np


def load(path: str) -> np.ndarray:
    """Read a PFM file into an ``(H, W)`` or ``(H, W, 3)`` float32 array,
    in file order (bottom-up)."""
    with open(path, 'rb') as f:
        magic = f.readline().strip()
        if magic == b'PF':
            channels = 3
        elif magic == b'Pf':
            channels = 1
        else:
            raise ValueError(f'{path}: not a PFM file (magic {magic!r})')

        dims = f.readline().split()
        if len(dims) != 2:
            raise ValueError(f'{path}: malformed PFM dimension line')
        width, height = int(dims[0]), int(dims[1])

        scale = float(f.readline().strip())
        endian = '<' if scale < 0 else '>'

        data = np.fromfile(f, dtype=endian + 'f4',
                           count=width * height * channels)

    if channels == 3:
        return data.reshape(height, width, 3)
    return data.reshape(height, width)


def save(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    """Write a float32 array as PFM (bottom-up, endianness of the dtype)."""
    image = np.asarray(image)
    if image.dtype != np.float32:
        raise ValueError('PFM images must be float32')

    if image.ndim == 3 and image.shape[2] == 3:
        magic = b'PF\n'
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        magic = b'Pf\n'
    else:
        raise ValueError('image must be (H, W), (H, W, 1) or (H, W, 3)')

    little = image.dtype.byteorder == '<' or (
        image.dtype.byteorder == '=' and sys.byteorder == 'little')
    if little:
        scale = -scale

    with open(path, 'wb') as f:
        f.write(magic)
        f.write(f'{image.shape[1]} {image.shape[0]}\n'.encode())
        f.write(f'{scale:f}\n'.encode())
        image.tofile(f)
