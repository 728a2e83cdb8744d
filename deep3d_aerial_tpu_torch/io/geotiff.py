"""Minimal GeoTIFF (float32, single band) writer/reader + ESRI world file.

Replaces the reference's GDAL dependency for DSM output
(reference IO/gdal_io.py:65-134) with a dependency-free codec:
classic little-endian TIFF, uncompressed, one strip, float32 samples, plus
ModelPixelScale/ModelTiepoint GeoTIFF tags and a GDAL_NODATA tag. Also
writes the `.tfw` world file the reference emits next to each DSM.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

_II = b"II"  # little-endian
_TYPE_SHORT = 3
_TYPE_LONG = 4
_TYPE_ASCII = 2
_TYPE_DOUBLE = 12


def _entry(tag, typ, count, value_or_offset):
    return struct.pack("<HHII", tag, typ, count, value_or_offset)


def write_geotiff(
    path,
    grid: np.ndarray,
    origin_xy: Tuple[float, float],
    cell_size: Tuple[float, float],
    nodata: Optional[float] = None,
) -> None:
    """Write a [rows, cols] float32 grid.

    origin_xy : world (x, y) of the OUTER corner of the top-left pixel
    cell_size : (dx, dy) positive; y decreases with row index (north-up)
    """
    grid = np.asarray(grid, dtype="<f4")
    rows, cols = grid.shape
    data = grid.tobytes()

    header_size = 8
    data_offset = header_size
    ifd_offset = data_offset + len(data)

    entries = []
    extras = b""
    extra_offset_base = None  # patched later

    def add_extra(buf: bytes) -> int:
        nonlocal extras
        off = len(extras)
        extras += buf
        return off

    # pixel scale + tiepoint (GeoTIFF georeferencing)
    scale_off = add_extra(struct.pack("<3d", cell_size[0], cell_size[1], 0.0))
    tie_off = add_extra(
        struct.pack("<6d", 0.0, 0.0, 0.0, origin_xy[0], origin_xy[1], 0.0)
    )
    # GeoKeyDirectory: version 1.1.0, 3 keys: ModelType=1 (projected),
    # RasterType=1 (pixel-is-area), Citation absent
    geokeys = struct.pack(
        "<16H",
        1, 1, 0, 3,
        1024, 0, 1, 1,   # GTModelTypeGeoKey = Projected
        1025, 0, 1, 1,   # GTRasterTypeGeoKey = PixelIsArea
        3072, 0, 1, 32767,  # ProjectedCSTypeGeoKey = user-defined
    )
    geo_off = add_extra(geokeys)

    tags = [
        (256, _TYPE_LONG, 1, cols),  # ImageWidth
        (257, _TYPE_LONG, 1, rows),  # ImageLength
        (258, _TYPE_SHORT, 1, 32),  # BitsPerSample
        (259, _TYPE_SHORT, 1, 1),  # Compression: none
        (262, _TYPE_SHORT, 1, 1),  # Photometric: BlackIsZero
        (273, _TYPE_LONG, 1, data_offset),  # StripOffsets
        (277, _TYPE_SHORT, 1, 1),  # SamplesPerPixel
        (278, _TYPE_LONG, 1, rows),  # RowsPerStrip
        (279, _TYPE_LONG, 1, len(data)),  # StripByteCounts
        (339, _TYPE_SHORT, 1, 3),  # SampleFormat: IEEE float
        (33550, _TYPE_DOUBLE, 3, ("extra", scale_off)),  # ModelPixelScale
        (33922, _TYPE_DOUBLE, 6, ("extra", tie_off)),  # ModelTiepoint
        (34735, _TYPE_SHORT, len(geokeys) // 2, ("extra", geo_off)),
    ]
    if nodata is not None:
        nodata_ascii = f"{nodata:g}".encode() + b"\x00"
        if len(nodata_ascii) <= 4:
            # TIFF6 requires values that fit in 4 bytes to be stored INLINE
            # in the value field (zero-padded), not behind an offset
            inline = struct.unpack("<I", nodata_ascii.ljust(4, b"\x00"))[0]
            tags.append((42113, _TYPE_ASCII, len(nodata_ascii), inline))
        else:
            tags.append((42113, _TYPE_ASCII, len(nodata_ascii),
                         ("extra", add_extra(nodata_ascii))))
    tags.sort(key=lambda t: t[0])

    n = len(tags)
    ifd_size = 2 + n * 12 + 4
    extra_offset_base = ifd_offset + ifd_size

    ifd = struct.pack("<H", n)
    for tag, typ, count, val in tags:
        if isinstance(val, tuple):
            val = extra_offset_base + val[1]
        ifd += _entry(tag, typ, count, val)
    ifd += struct.pack("<I", 0)  # no next IFD

    with open(path, "wb") as f:
        f.write(_II + struct.pack("<HI", 42, ifd_offset))
        f.write(data)
        f.write(ifd)
        f.write(extras)


def read_geotiff(path):
    """Read a single-band TIFF written by write_geotiff (or similar simple
    layouts) -> (grid [rows, cols], origin_xy, cell_size, nodata|None)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:2] != _II or struct.unpack("<H", raw[2:4])[0] != 42:
        raise ValueError(f"{path}: not a little-endian classic TIFF")
    (ifd_off,) = struct.unpack("<I", raw[4:8])
    (n,) = struct.unpack("<H", raw[ifd_off:ifd_off + 2])
    tags = {}
    for i in range(n):
        off = ifd_off + 2 + i * 12
        tag, typ, count, val = struct.unpack("<HHII", raw[off:off + 12])
        tags[tag] = (typ, count, val)

    cols = tags[256][2]
    rows = tags[257][2]
    strip_off = tags[273][2]
    nbytes = tags[279][2]
    if tags.get(259, (0, 0, 1))[2] != 1:
        raise ValueError("compressed TIFF unsupported")
    grid = np.frombuffer(raw[strip_off:strip_off + nbytes], dtype="<f4").reshape(
        rows, cols
    ).copy()

    origin = (0.0, 0.0)
    cell = (1.0, 1.0)
    if 33550 in tags:
        _, _, off = tags[33550]
        sx, sy, _ = struct.unpack("<3d", raw[off:off + 24])
        cell = (sx, sy)
    if 33922 in tags:
        _, _, off = tags[33922]
        vals = struct.unpack("<6d", raw[off:off + 48])
        origin = (vals[3], vals[4])
    nodata = None
    if 42113 in tags:
        typ, count, off = tags[42113]
        if count <= 4:
            s = struct.pack("<I", off)[:count]
        else:
            s = raw[off:off + count]
        nodata = float(s.rstrip(b"\x00"))
    return grid, origin, cell, nodata


def write_tfw(path, origin_xy, cell_size) -> None:
    """ESRI world file: pixel size, rotation, and CENTER of top-left pixel
    (reference gdal_io.py:122-134 writes the same sidecar)."""
    dx, dy = cell_size
    with open(path, "w") as f:
        f.write(f"{dx:.10f}\n0.0\n0.0\n{-dy:.10f}\n")
        f.write(f"{origin_xy[0] + dx / 2:.10f}\n{origin_xy[1] - dy / 2:.10f}\n")
