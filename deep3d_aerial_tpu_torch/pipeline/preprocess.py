"""Image + camera preprocessing for network input.

Equivalent of reference mvs/mvs_cas/datasets/preprocess.py:19-115:
uniform rescale, center-crop to a multiple of `base` (default 32) no larger
than (max_h, max_w), intrinsics adjusted accordingly; normalization modes
'standard' (/255), 'mean' (per-image standardize), 'vit' (ImageNet stats).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..geometry.camera import Camera


def scale_image(img: np.ndarray, scale: float) -> np.ndarray:
    if scale == 1.0:
        return img
    import cv2

    return cv2.resize(img, None, fx=scale, fy=scale, interpolation=cv2.INTER_LINEAR)


def scale_to_network(
    img: np.ndarray, cam: Camera, scale: float = 1.0
) -> Tuple[np.ndarray, Camera]:
    return scale_image(img, scale), cam.scaled(scale)


def crop_window(
    h: int, w: int, max_h: int, max_w: int, base: int = 32
) -> Tuple[int, int, int, int]:
    """The (start_h, start_w, new_h, new_w) center-crop window used by
    crop_to_network. Exposed so GT maps (depth/mask/normal) can be sliced
    with the SAME window as the image they supervise."""
    new_h = (min(h, max_h) // base) * base
    new_w = (min(w, max_w) // base) * base
    if new_h == 0 or new_w == 0:
        raise ValueError(f"image {h}x{w} smaller than one {base}-block")
    start_h = max(0, (h - new_h) // 2)
    start_w = max(0, (w - new_w) // 2)
    return start_h, start_w, new_h, new_w


def crop_to_network(
    img: np.ndarray,
    cam: Camera,
    max_h: int,
    max_w: int,
    base: int = 32,
) -> Tuple[np.ndarray, Camera]:
    """Center-crop to <= (max_h, max_w), rounded DOWN to a multiple of `base`.

    (The reference rounds up and can produce negative crop starts for small
    images, preprocess.py:68-79; rounding down is always valid.)
    """
    h, w = img.shape[:2]
    start_h, start_w, new_h, new_w = crop_window(h, w, max_h, max_w, base)
    img = img[start_h:start_h + new_h, start_w:start_w + new_w]
    cam = cam.cropped(start_w, start_h, new_w, new_h)
    return img, cam


def center_image(img: np.ndarray, mode: str = "mean") -> np.ndarray:
    img = np.asarray(img, np.float32)
    if mode == "standard":
        return img / 255.0
    if mode == "mean":
        mean = img.mean(axis=(0, 1), keepdims=True)
        std = img.std(axis=(0, 1), keepdims=True)
        return (img - mean) / (std + 1e-8)
    if mode == "vit":
        mean = np.array([123.675, 116.28, 103.53], np.float32)
        std = np.array([58.395, 57.12, 57.375], np.float32)
        return (img - mean) / (std + 1e-8)
    raise ValueError(f"unknown normalize mode {mode!r}")
