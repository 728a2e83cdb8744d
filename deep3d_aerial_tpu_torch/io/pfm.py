"""Portable Float Map (PFM) codec.

Used for depth maps (`*_init.pfm`), probability maps (`*_prob.pfm`) and
3-channel normal maps (`*_normal.pfm`) — the same inter-stage artifacts as the
reference pipeline (format spec: reference IO/pfm.py:19-84).

PFM stores rows bottom-up; arrays here are top-down (row 0 = top of image),
so both read and write flip vertically. A negative scale marks little-endian.
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np

_DIM_RE = re.compile(rb"^(\d+)\s+(\d+)\s*$")


def read_pfm(path) -> Tuple[np.ndarray, float]:
    """Read a PFM file -> (array [H,W] or [H,W,3] float32 top-down, scale)."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file (header {header!r})")

        m = _DIM_RE.match(f.readline())
        if not m:
            raise ValueError(f"{path}: malformed PFM dimensions line")
        width, height = int(m.group(1)), int(m.group(2))

        scale = float(f.readline().strip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)

        data = np.fromfile(f, dtype=endian + "f4", count=width * height * channels)
        if data.size != width * height * channels:
            raise ValueError(f"{path}: truncated PFM payload")

    shape = (height, width, 3) if channels == 3 else (height, width)
    return np.flipud(data.reshape(shape)).astype(np.float32), scale


def write_pfm(path, image: np.ndarray, scale: float = 1.0) -> None:
    """Write a float32 [H,W] / [H,W,1] / [H,W,3] array as PFM (little-endian)."""
    image = np.asarray(image)
    if image.dtype != np.float32:
        raise ValueError(f"PFM requires float32, got {image.dtype}")

    if image.ndim == 3 and image.shape[2] == 3:
        header = b"PF\n"
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        header = b"Pf\n"
        image = image.reshape(image.shape[0], image.shape[1])
    else:
        raise ValueError(f"PFM image must be HxW[, {{1,3}}], got {image.shape}")

    with open(path, "wb") as f:
        f.write(header)
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(f"{-abs(scale):f}\n".encode())  # negative => little-endian
        np.flipud(image).astype("<f4").tofile(f)
