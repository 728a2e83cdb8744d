"""LAS 1.2 point-cloud codec (point formats 0 and 2; copy of
deep3d_aerial_tpu/io/las.py, whose system and software ids it writes too).

Own implementation of the subset the reference handles through `laspy`
(its IO/points_io.py:115-443): read/write xyz (+rgb), scaled
int32 storage with offsets, bounding box in the header. Little-endian,
227-byte LAS 1.2 public header.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

_HEADER_SIZE = 227
_POINT_SIZES = {0: 20, 1: 28, 2: 26, 3: 34}


def write_las(
    path,
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    scale: Tuple[float, float, float] = (0.001, 0.001, 0.001),
) -> None:
    points = np.asarray(points, np.float64).reshape(-1, 3)
    n = len(points)
    fmt = 2 if colors is not None else 0
    psize = _POINT_SIZES[fmt]

    offset = points.min(axis=0) if n else np.zeros(3)
    scaled = np.round((points - offset) / np.asarray(scale)).astype("<i4")

    mins = points.min(axis=0) if n else np.zeros(3)
    maxs = points.max(axis=0) if n else np.zeros(3)

    with open(path, "wb") as f:
        f.write(b"LASF")
        f.write(struct.pack("<HHI", 0, 0, 0))  # source id, encoding, guid1
        f.write(struct.pack("<HH", 0, 0))  # guid2, guid3
        f.write(b"\x00" * 8)  # guid4
        f.write(struct.pack("<BB", 1, 2))  # version 1.2
        f.write(b"deep3d_aerial_tpu".ljust(32, b"\x00"))  # system id
        f.write(b"deep3d_aerial_tpu".ljust(32, b"\x00"))  # software
        f.write(struct.pack("<HH", 1, 2026))  # day, year
        f.write(struct.pack("<HII", _HEADER_SIZE, _HEADER_SIZE, 0))
        f.write(struct.pack("<BHI", fmt, psize, n))
        f.write(struct.pack("<5I", n, 0, 0, 0, 0))  # returns histogram
        f.write(struct.pack("<3d", *scale))
        f.write(struct.pack("<3d", *offset))
        f.write(struct.pack("<dd", maxs[0], mins[0]))
        f.write(struct.pack("<dd", maxs[1], mins[1]))
        f.write(struct.pack("<dd", maxs[2], mins[2]))

        if fmt == 0:
            rec = np.zeros(n, dtype=[("x", "<i4"), ("y", "<i4"), ("z", "<i4"),
                                     ("intensity", "<u2"), ("flags", "u1"),
                                     ("cls", "u1"), ("rank", "i1"),
                                     ("user", "u1"), ("src", "<u2")])
        else:
            rec = np.zeros(n, dtype=[("x", "<i4"), ("y", "<i4"), ("z", "<i4"),
                                     ("intensity", "<u2"), ("flags", "u1"),
                                     ("cls", "u1"), ("rank", "i1"),
                                     ("user", "u1"), ("src", "<u2"),
                                     ("r", "<u2"), ("g", "<u2"), ("b", "<u2")])
        rec["x"], rec["y"], rec["z"] = scaled[:, 0], scaled[:, 1], scaled[:, 2]
        if fmt == 2:
            c = np.asarray(colors).reshape(-1, 3)
            if c.dtype == np.uint8:
                c = c.astype(np.uint16) * 257  # 8-bit -> 16-bit color
            rec["r"], rec["g"], rec["b"] = c[:, 0], c[:, 1], c[:, 2]
        rec.tofile(f)


def read_las(path) -> Tuple[np.ndarray, Optional[np.ndarray], dict]:
    """-> (points [N, 3] float64, colors [N, 3] uint8 | None, header dict)."""
    with open(path, "rb") as f:
        if f.read(4) != b"LASF":
            raise ValueError(f"{path}: not a LAS file")
        f.seek(24)
        ver = struct.unpack("<BB", f.read(2))
        f.seek(94)
        header_size, data_offset, n_vlr = struct.unpack("<HII", f.read(10))
        fmt, psize, n_legacy = struct.unpack("<BHI", f.read(7))
        f.seek(5 * 4, 1)
        scale = np.array(struct.unpack("<3d", f.read(24)))
        offset = np.array(struct.unpack("<3d", f.read(24)))
        max_x, min_x, max_y, min_y, max_z, min_z = struct.unpack(
            "<6d", f.read(48))
        header = {
            "version": ver, "point_format": fmt, "count": n_legacy,
            "scale": scale, "offset": offset,
            "bbox": [min_x, max_x, min_y, max_y, min_z, max_z],
        }
        f.seek(data_offset)
        if fmt in (0, 1):
            base = [("x", "<i4"), ("y", "<i4"), ("z", "<i4"),
                    ("intensity", "<u2"), ("flags", "u1"), ("cls", "u1"),
                    ("rank", "i1"), ("user", "u1"), ("src", "<u2")]
            if fmt == 1:
                base += [("gps", "<f8")]
            dtype = np.dtype(base)
            has_color = False
        elif fmt in (2, 3):
            base = [("x", "<i4"), ("y", "<i4"), ("z", "<i4"),
                    ("intensity", "<u2"), ("flags", "u1"), ("cls", "u1"),
                    ("rank", "i1"), ("user", "u1"), ("src", "<u2")]
            if fmt == 3:
                base += [("gps", "<f8")]
            base += [("r", "<u2"), ("g", "<u2"), ("b", "<u2")]
            dtype = np.dtype(base)
            has_color = True
        else:
            raise ValueError(f"{path}: unsupported LAS point format {fmt}")
        if dtype.itemsize != psize:
            # tolerate extra bytes per record
            dtype = np.dtype({
                "names": [d[0] for d in base],
                "formats": [d[1] for d in base],
                "itemsize": psize,
            })
        rec = np.fromfile(f, dtype=dtype, count=n_legacy)

    pts = np.stack([rec["x"], rec["y"], rec["z"]], -1).astype(np.float64)
    pts = pts * scale + offset
    colors = None
    if has_color:
        colors = (np.stack([rec["r"], rec["g"], rec["b"]], -1) // 257).astype(
            np.uint8)
    return pts, colors, header


def las_bbox(path) -> np.ndarray:
    """Header-only bounding box [xmin, xmax, ymin, ymax, zmin, zmax] — the
    cheap per-tile border used by the reference's batched block loaders
    (points_io.py:526-744) without scanning points."""
    _, _, header = _read_header_only(path)
    return np.asarray(header["bbox"])


def _read_header_only(path):
    with open(path, "rb") as f:
        if f.read(4) != b"LASF":
            raise ValueError(f"{path}: not a LAS file")
        f.seek(94)
        header_size, data_offset, n_vlr = struct.unpack("<HII", f.read(10))
        fmt, psize, n_legacy = struct.unpack("<BHI", f.read(7))
        f.seek(5 * 4, 1)
        scale = np.array(struct.unpack("<3d", f.read(24)))
        offset = np.array(struct.unpack("<3d", f.read(24)))
        max_x, min_x, max_y, min_y, max_z, min_z = struct.unpack("<6d", f.read(48))
    return None, None, {
        "point_format": fmt, "count": n_legacy, "scale": scale,
        "offset": offset,
        "bbox": [min_x, max_x, min_y, max_y, min_z, max_z],
    }
