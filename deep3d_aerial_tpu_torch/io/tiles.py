"""Tiled point-cloud loading with cached per-tile borders (copy of
deep3d_aerial_tpu/io/tiles.py).

Parity with the reference's batched LAS/PLY block loaders
(its IO/points_io.py:115-744): scan a directory of point tiles,
cache each tile's bbox next to it, and load only tiles intersecting a query
block — the host-side feed for DSM/mesh over large scenes.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .las import las_bbox, read_las
from .ply import read_ply


def _tile_bbox(path: str) -> np.ndarray:
    if path.endswith(".las"):
        return np.asarray(las_bbox(path), np.float64)
    pts, _, _ = read_ply(path)
    if len(pts) == 0:
        return np.zeros(6)
    return np.array([
        pts[:, 0].min(), pts[:, 0].max(),
        pts[:, 1].min(), pts[:, 1].max(),
        pts[:, 2].min(), pts[:, 2].max(),
    ])


def _cache_path(path: str) -> str:
    return path + ".bbox.json"


def tile_border(path: str, use_cache: bool = True) -> np.ndarray:
    """Tile bbox with a sidecar cache (reference caches borders per tile,
    points_io.py:384-443)."""
    cache = _cache_path(path)
    if use_cache and os.path.exists(cache):
        try:
            return np.asarray(json.load(open(cache)), np.float64)
        except Exception:
            pass
    bbox = _tile_bbox(path)
    if use_cache:
        try:
            json.dump([float(v) for v in bbox], open(cache, "w"))
        except OSError:
            pass
    return bbox


def bbox_intersects(a: Sequence[float], b: Sequence[float]) -> bool:
    return not (
        a[1] < b[0] or b[1] < a[0] or a[3] < b[2] or b[3] < a[2]
    )


class TiledPointCloud:
    """Directory of .las/.ply tiles queried by block bbox."""

    def __init__(self, folder: str, exts=(".las", ".ply"), workers: int = 4):
        self.folder = folder
        self.paths = sorted(
            os.path.join(folder, f) for f in os.listdir(folder)
            if f.endswith(tuple(exts))
        )
        with ThreadPoolExecutor(max_workers=workers) as pool:
            self.borders = list(pool.map(tile_border, self.paths))

    def tiles_in(self, block: Sequence[float]) -> List[str]:
        return [
            p for p, b in zip(self.paths, self.borders)
            if bbox_intersects(b, block)
        ]

    def load_block(
        self, block: Sequence[float], with_colors: bool = False
    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Concatenate points of intersecting tiles, cropped to the block."""
        pts_all, col_all = [], []
        for p in self.tiles_in(block):
            if p.endswith(".las"):
                pts, colors, _ = read_las(p)
            else:
                pts, _, colors = read_ply(p)
            m = (
                (pts[:, 0] >= block[0]) & (pts[:, 0] <= block[1])
                & (pts[:, 1] >= block[2]) & (pts[:, 1] <= block[3])
            )
            pts_all.append(pts[m])
            if with_colors and colors is not None:
                col_all.append(colors[m])
        if not pts_all:
            return np.zeros((0, 3)), None
        pts = np.concatenate(pts_all)
        colors = np.concatenate(col_all) if col_all else None
        return pts, colors
