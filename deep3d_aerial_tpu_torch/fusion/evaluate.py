"""Parity evaluation: depth-map and point-cloud agreement metrics (copy
of deep3d_aerial_tpu/fusion/evaluate.py).

Implements the BASELINE acceptance measures (BASELINE.md): fraction of
depth-map pixels within a relative threshold (default 0.01 — the fusion
depth_threshold), and symmetric nearest-neighbor cloud-to-cloud agreement
for fused outputs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def depth_agreement(
    depth_a: np.ndarray,
    depth_b: np.ndarray,
    rel_threshold: float = 0.01,
    mask: Optional[np.ndarray] = None,
) -> float:
    """Fraction of jointly-valid pixels with |a-b|/a < rel_threshold."""
    a = np.asarray(depth_a, np.float64)
    b = np.asarray(depth_b, np.float64)
    valid = (a > 0) & (b > 0)
    if mask is not None:
        valid &= mask
    if not valid.any():
        return 0.0
    rel = np.abs(a[valid] - b[valid]) / a[valid]
    return float((rel < rel_threshold).mean())


def _grid_nn_dist(query: np.ndarray, ref: np.ndarray, cell: float) -> np.ndarray:
    """Approximate NN distance via a hash grid (exact within a 3x3x3 cell
    neighborhood; points farther than ~cell get +inf)."""
    if len(ref) == 0:
        return np.full(len(query), np.inf)
    key = np.floor(ref / cell).astype(np.int64)
    table: dict = {}
    for i, k in enumerate(map(tuple, key)):
        table.setdefault(k, []).append(i)

    out = np.full(len(query), np.inf)
    qk = np.floor(query / cell).astype(np.int64)
    for i, (q, k) in enumerate(zip(query, qk)):
        best = np.inf
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    idxs = table.get((k[0] + dx, k[1] + dy, k[2] + dz))
                    if idxs:
                        d = np.min(np.linalg.norm(ref[idxs] - q, axis=1))
                        best = min(best, d)
        out[i] = best
    return out


def cloud_agreement(
    cloud_a: np.ndarray,
    cloud_b: np.ndarray,
    dist_threshold: float,
    sample: int = 5000,
    seed: int = 0,
) -> Tuple[float, float]:
    """(fraction of A within dist of B, fraction of B within dist of A).

    Subsamples both clouds to `sample` points for tractability.
    """
    rng = np.random.default_rng(seed)

    def sub(c):
        c = np.asarray(c, np.float64).reshape(-1, 3)
        if len(c) > sample:
            c = c[rng.choice(len(c), sample, replace=False)]
        return c

    a = sub(cloud_a)
    b = sub(cloud_b)
    cell = max(dist_threshold, 1e-9)
    da = _grid_nn_dist(a, np.asarray(cloud_b, np.float64).reshape(-1, 3), cell)
    db = _grid_nn_dist(b, np.asarray(cloud_a, np.float64).reshape(-1, 3), cell)
    return float((da < dist_threshold).mean()), float((db < dist_threshold).mean())


def surface_rmse(
    points: np.ndarray, z_fn, trim_quantile: float = 0.95
) -> float:
    """Trimmed RMSE of points against an analytic surface z = f(x, y)
    (synthetic-scene acceptance checks)."""
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    if len(pts) == 0:
        return float("inf")
    err = np.abs(pts[:, 2] - z_fn(pts[:, 0], pts[:, 1]))
    cut = np.quantile(err, trim_quantile)
    kept = err[err <= cut]
    return float(np.sqrt(np.mean(kept**2)))
