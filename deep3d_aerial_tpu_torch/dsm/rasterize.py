"""DSM (digital surface model) rasterization from point clouds and meshes
(counterpart of deep3d_aerial_tpu/dsm/rasterize.py).

The reference's dsm/ module is absent from its repo (external download,
reference dsm/readme.txt); behavior here is defined by the call sites
(run.py:209-248) and config surface (config.yaml:46-52):

  DSM_from_PC(input, output, unit, size, select_method, interp_method).create(bbx)
  DSM_from_Mesh(input, output, unit, size).create(bbx)

  select_method : 'Max' (per-cell max z) | 'Robust_Max' (outlier-trimmed max)
  interp_method : None | 'MovingAverage' (fill empty cells from neighbors)

Grid convention: cell (row 0, col 0) is the NORTH-WEST corner (y_max), row
index grows southward — standard GeoTIFF/TFW layout; empty cells = nodata.

Per-cell z-reduction and the mesh's max-z rasterization run in the native
core (native/dsm_reduce.cc, built at first use by utils/native.py; a failed
build raises). The NumPy bodies stay beside them by name
(`rasterize_max_numpy`, `rasterize_robust_max_numpy`,
`rasterize_mesh_numpy`) as their plain versions: a vectorized scatter-max
(np.maximum.at), a MAD-trimmed max per cell, and barycentric coverage per
triangle.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

NODATA = -9999.0


@dataclasses.dataclass
class DSMConfig:
    cell_size: Tuple[float, float] = (0.2, 0.2)  # (dx, dy) meters
    size: Optional[Tuple[int, int]] = None  # (cols, rows); derived if None
    select_method: str = "Max"  # 'Max' | 'Robust_Max'
    interp_method: Optional[str] = None  # None | 'MovingAverage'
    robust_percentile: float = 99.0
    interp_window: int = 5
    nodata: float = NODATA


def _grid_shape(bbx, cfg: DSMConfig) -> Tuple[int, int]:
    if cfg.size is not None:
        return int(cfg.size[1]), int(cfg.size[0])  # (rows, cols)
    cols = int(np.ceil((bbx[1] - bbx[0]) / cfg.cell_size[0]))
    rows = int(np.ceil((bbx[3] - bbx[2]) / cfg.cell_size[1]))
    return rows, cols


def _cell_indices(x, y, bbx, cfg, shape):
    rows, cols = shape
    ix = np.floor((x - bbx[0]) / cfg.cell_size[0]).astype(np.int64)
    iy = np.floor((bbx[3] - y) / cfg.cell_size[1]).astype(np.int64)  # north-up
    ok = (ix >= 0) & (ix < cols) & (iy >= 0) & (iy < rows)
    return iy, ix, ok


def rasterize_max(points: np.ndarray, bbx, cfg: DSMConfig) -> np.ndarray:
    """Per-cell max-z grid [rows, cols]; empty cells = nodata."""
    from ..utils.native import dsm_reduce

    return dsm_reduce(points, bbx, cfg.cell_size, _grid_shape(bbx, cfg),
                      cfg.nodata, robust=False)


def rasterize_max_numpy(points: np.ndarray, bbx, cfg: DSMConfig) -> np.ndarray:
    """The plain NumPy version of `rasterize_max`."""
    rows, cols = _grid_shape(bbx, cfg)
    grid = np.full(rows * cols, -np.inf, np.float64)
    iy, ix, ok = _cell_indices(points[:, 0], points[:, 1], bbx, cfg, (rows, cols))
    flat = iy[ok] * cols + ix[ok]
    np.maximum.at(grid, flat, points[ok, 2])
    grid = grid.reshape(rows, cols)
    out = np.where(np.isfinite(grid), grid, cfg.nodata).astype(np.float32)
    return out


def rasterize_robust_max(points: np.ndarray, bbx, cfg: DSMConfig) -> np.ndarray:
    """Outlier-trimmed per-cell max: the `robust_percentile` z within each
    cell — rejects isolated high returns (birds, matching spikes) that plain
    Max keeps."""
    from ..utils.native import dsm_reduce

    return dsm_reduce(points, bbx, cfg.cell_size, _grid_shape(bbx, cfg),
                      cfg.nodata, robust=True)


def rasterize_robust_max_numpy(points: np.ndarray, bbx,
                               cfg: DSMConfig) -> np.ndarray:
    """The plain NumPy version of `rasterize_robust_max`."""
    rows, cols = _grid_shape(bbx, cfg)
    iy, ix, ok = _cell_indices(points[:, 0], points[:, 1], bbx, cfg, (rows, cols))
    flat = iy[ok] * cols + ix[ok]
    z = points[ok, 2]

    order = np.argsort(flat, kind="stable")
    flat_s = flat[order]
    z_s = z[order]
    grid = np.full(rows * cols, cfg.nodata, np.float32)
    if len(flat_s):
        # segment boundaries of equal cells
        starts = np.flatnonzero(np.concatenate([[True], flat_s[1:] != flat_s[:-1]]))
        ends = np.concatenate([starts[1:], [len(flat_s)]])
        for s, e in zip(starts, ends):
            seg = z_s[s:e]
            if len(seg) < 4:
                grid[flat_s[s]] = seg.max()
            else:
                # MAD-based outlier rejection, then max of the inliers
                med = np.median(seg)
                mad = np.median(np.abs(seg - med)) + 1e-9
                inliers = seg[np.abs(seg - med) < 5.0 * 1.4826 * mad]
                grid[flat_s[s]] = (
                    inliers.max() if len(inliers) else
                    np.percentile(seg, cfg.robust_percentile)
                )
    return grid.reshape(rows, cols)


def moving_average_fill(grid: np.ndarray, cfg: DSMConfig) -> np.ndarray:
    """Fill nodata cells with the mean of valid cells in a window
    ('MovingAverage' interpolation)."""
    valid = grid != cfg.nodata
    vals = np.where(valid, grid, 0.0).astype(np.float64)
    k = cfg.interp_window
    pad = k // 2

    # box-filter via summed-area table
    def box_sum(a):
        ii = np.pad(a, ((1, 0), (1, 0))).cumsum(0).cumsum(1)
        H, W = a.shape
        out = np.empty_like(a)
        ys = np.arange(H)
        y0 = np.clip(ys - pad, 0, H)
        y1 = np.clip(ys + pad + 1, 0, H)
        xs = np.arange(W)
        x0 = np.clip(xs - pad, 0, W)
        x1 = np.clip(xs + pad + 1, 0, W)
        out = (
            ii[np.ix_(y1, x1)] - ii[np.ix_(y0, x1)]
            - ii[np.ix_(y1, x0)] + ii[np.ix_(y0, x0)]
        )
        return out

    s = box_sum(vals)
    c = box_sum(valid.astype(np.float64))
    filled = np.divide(s, c, out=np.full_like(s, cfg.nodata), where=c > 0)
    return np.where(valid, grid, filled.astype(np.float32))


def rasterize_mesh(
    vertices: np.ndarray, faces: np.ndarray, bbx, cfg: DSMConfig
) -> np.ndarray:
    """Rasterize a triangle mesh to a max-z DSM via per-triangle coverage
    (native/dsm_reduce.cc rasterize_mesh_max)."""
    if not len(faces):
        return np.full(_grid_shape(bbx, cfg), cfg.nodata, np.float32)
    from ..utils.native import rasterize_mesh_native

    return rasterize_mesh_native(vertices[faces], bbx, cfg.cell_size,
                                 _grid_shape(bbx, cfg), cfg.nodata)


def rasterize_mesh_numpy(
    vertices: np.ndarray, faces: np.ndarray, bbx, cfg: DSMConfig
) -> np.ndarray:
    """The plain NumPy version of `rasterize_mesh` (one step per
    triangle)."""
    rows, cols = _grid_shape(bbx, cfg)
    grid = np.full((rows, cols), -np.inf, np.float64)
    dx, dy = cfg.cell_size

    # cell-center coordinates
    def cell_xy(iy, ix):
        x = bbx[0] + (ix + 0.5) * dx
        y = bbx[3] - (iy + 0.5) * dy
        return x, y

    tri = vertices[faces]  # [F, 3, 3]
    for t in tri:
        xmin, ymin = t[:, 0].min(), t[:, 1].min()
        xmax, ymax = t[:, 0].max(), t[:, 1].max()
        ix0 = max(0, int(np.floor((xmin - bbx[0]) / dx)))
        ix1 = min(cols - 1, int(np.floor((xmax - bbx[0]) / dx)))
        iy0 = max(0, int(np.floor((bbx[3] - ymax) / dy)))
        iy1 = min(rows - 1, int(np.floor((bbx[3] - ymin) / dy)))
        if ix1 < ix0 or iy1 < iy0:
            continue
        iys, ixs = np.mgrid[iy0:iy1 + 1, ix0:ix1 + 1]
        cx, cy = cell_xy(iys, ixs)
        # barycentric coordinates
        x1, y1 = t[0, 0], t[0, 1]
        x2, y2 = t[1, 0], t[1, 1]
        x3, y3 = t[2, 0], t[2, 1]
        den = (y2 - y3) * (x1 - x3) + (x3 - x2) * (y1 - y3)
        if abs(den) < 1e-12:
            continue
        l1 = ((y2 - y3) * (cx - x3) + (x3 - x2) * (cy - y3)) / den
        l2 = ((y3 - y1) * (cx - x3) + (x1 - x3) * (cy - y3)) / den
        l3 = 1.0 - l1 - l2
        inside = (l1 >= -1e-9) & (l2 >= -1e-9) & (l3 >= -1e-9)
        z = l1 * t[0, 2] + l2 * t[1, 2] + l3 * t[2, 2]
        sel_iy = iys[inside]
        sel_ix = ixs[inside]
        np.maximum.at(grid, (sel_iy, sel_ix), z[inside])

    return np.where(np.isfinite(grid), grid, cfg.nodata).astype(np.float32)


class DSMFromPointCloud:
    """Point cloud -> DSM raster (reference API: pc2dsm.DSM_from_PC,
    call site run.py:239-240)."""

    def __init__(self, cfg: DSMConfig = DSMConfig()):
        self.cfg = cfg

    def create(self, points: np.ndarray, bbx: Sequence[float]) -> np.ndarray:
        if self.cfg.select_method == "Max":
            grid = rasterize_max(points, bbx, self.cfg)
        elif self.cfg.select_method == "Robust_Max":
            grid = rasterize_robust_max(points, bbx, self.cfg)
        else:
            raise ValueError(f"unknown select_method {self.cfg.select_method!r}")
        if self.cfg.interp_method == "MovingAverage":
            grid = moving_average_fill(grid, self.cfg)
        elif self.cfg.interp_method not in (None, "none", "None"):
            raise ValueError(f"unknown interp_method {self.cfg.interp_method!r}")
        return grid


class DSMFromMesh:
    """Triangle mesh -> DSM raster (reference API: mesh2dsm.DSM_from_Mesh,
    call site run.py:231-232)."""

    def __init__(self, cfg: DSMConfig = DSMConfig()):
        self.cfg = cfg

    def create(self, vertices: np.ndarray, faces: np.ndarray,
               bbx: Sequence[float]) -> np.ndarray:
        grid = rasterize_mesh(vertices, faces, bbx, self.cfg)
        if self.cfg.interp_method == "MovingAverage":
            grid = moving_average_fill(grid, self.cfg)
        return grid
