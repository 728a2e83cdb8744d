"""Photometric training augmentation (a copy of the JAX package's
pipeline/augment.py, comments aside).

Parity with the reference augmentation (datasets/preprocess.py:119-161):
random color/brightness/contrast/sharpness jitter + optional gaussian noise,
implemented as pure NumPy on uint8/float images (host-side, per sample).
"""

from __future__ import annotations

import numpy as np


# the uniform draws random_photometric takes from its rng, whatever the
# image: a dataset that skips a sample advances its rng by these per view
PHOTOMETRIC_DRAWS = 4


def random_photometric(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """img uint8 [H, W, 3] -> augmented uint8 (PHOTOMETRIC_DRAWS uniform
    draws from rng)."""
    x = img.astype(np.float32)

    # color saturation: blend with per-pixel gray
    gray = x.mean(axis=-1, keepdims=True)
    sat = rng.uniform(0.0, 3.0)
    x = gray + sat * (x - gray)

    # brightness
    x = x * rng.uniform(0.1, 2.0)

    # contrast: blend with the global mean
    mean = x.mean()
    x = mean + rng.uniform(0.1, 2.0) * (x - mean)

    # sharpness: unsharp-mask blend with a 3x3 box blur
    sharp = rng.uniform(0.0, 3.0)
    if abs(sharp - 1.0) > 1e-3:
        pad = np.pad(x, ((1, 1), (1, 1), (0, 0)), mode="edge")
        blur = sum(
            pad[dy:dy + x.shape[0], dx:dx + x.shape[1]]
            for dy in range(3) for dx in range(3)
        ) / 9.0
        x = blur + sharp * (x - blur)

    return np.clip(x, 0, 255).astype(np.uint8)


def random_gaussian_noise(
    img: np.ndarray, rng: np.random.Generator, mean=0.02, sigma=0.03
) -> np.ndarray:
    x = img.astype(np.float32) / 255.0
    x = x + rng.normal(mean, sigma, x.shape).astype(np.float32)
    return np.clip(x * 255.0, 0, 255).astype(np.uint8)
