"""OpenMVS raw depth-map container (.dmap) codec (copy of
deep3d_aerial_tpu/io/dmap.py).

Binary parity with the reference's IO/dmap_io.py:173-270 (the public OpenMVS
DepthData raw export): header magic 21060 (u16 'DR'), type bit-flags
(1 = depth, 2 = +normal, 4 = +confidence), image + depth sizes, depth range,
image filename, neighbor view IDs, K/R/C pose (f64), then row-major f32 maps.
Also reads COLMAP's '&'-delimited photometric array format (read_array).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Tuple

import numpy as np

MAGIC = 21060


@dataclasses.dataclass
class DepthDataRaw:
    image_file_name: str
    neighbor_ids: List[int]
    image_size: Tuple[int, int]  # (height, width)
    K: np.ndarray
    R: np.ndarray
    C: np.ndarray
    d_min: float
    d_max: float
    depth: np.ndarray  # [h, w] f32
    normal: Optional[np.ndarray] = None  # [h, w, 3]
    confidence: Optional[np.ndarray] = None  # [h, w]


def write_dmap(path, data: DepthDataRaw) -> None:
    depth = np.ascontiguousarray(data.depth, "<f4")
    h, w = depth.shape
    header_type = 1
    if data.normal is not None and data.normal.size:
        header_type |= 2
    if data.confidence is not None and data.confidence.size:
        header_type |= 4

    with open(path, "wb") as f:
        f.write(struct.pack("<HBB", MAGIC, header_type, 0))
        f.write(struct.pack("<IIII", data.image_size[1], data.image_size[0],
                            w, h))
        f.write(struct.pack("<ff", data.d_min, data.d_max))
        name = data.image_file_name.encode("utf-8")
        f.write(struct.pack("<H", len(name)))
        f.write(name)
        f.write(struct.pack("<I", len(data.neighbor_ids)))
        for nid in data.neighbor_ids:
            f.write(struct.pack("<I", nid))
        f.write(np.ascontiguousarray(data.K, "<f8").tobytes())
        f.write(np.ascontiguousarray(data.R, "<f8").tobytes())
        f.write(np.ascontiguousarray(np.asarray(data.C).reshape(3, 1),
                                     "<f8").tobytes())
        f.write(depth.tobytes())
        if header_type & 2:
            f.write(np.ascontiguousarray(data.normal, "<f4").tobytes())
        if header_type & 4:
            f.write(np.ascontiguousarray(data.confidence, "<f4").tobytes())


def read_dmap(path) -> DepthDataRaw:
    with open(path, "rb") as f:
        magic, header_type, _pad = struct.unpack("<HBB", f.read(4))
        if magic != MAGIC:
            raise ValueError(f"{path}: bad .dmap magic {magic}")
        img_w, img_h, w, h = struct.unpack("<IIII", f.read(16))
        d_min, d_max = struct.unpack("<ff", f.read(8))
        (name_len,) = struct.unpack("<H", f.read(2))
        name = f.read(name_len).decode("utf-8")
        (n_ids,) = struct.unpack("<I", f.read(4))
        ids = list(struct.unpack(f"<{n_ids}I", f.read(4 * n_ids))) if n_ids else []
        K = np.frombuffer(f.read(72), "<f8").reshape(3, 3).copy()
        R = np.frombuffer(f.read(72), "<f8").reshape(3, 3).copy()
        C = np.frombuffer(f.read(24), "<f8").reshape(3).copy()
        depth = np.frombuffer(f.read(4 * h * w), "<f4").reshape(h, w).copy()
        normal = None
        if header_type & 2:
            normal = np.frombuffer(f.read(12 * h * w), "<f4").reshape(h, w, 3).copy()
        conf = None
        if header_type & 4:
            conf = np.frombuffer(f.read(4 * h * w), "<f4").reshape(h, w).copy()
    return DepthDataRaw(name, ids, (img_h, img_w), K, R, C, d_min, d_max,
                        depth, normal, conf)


def read_colmap_array(path) -> np.ndarray:
    """COLMAP's photometric/geometric .bin array: 'w&h&c&' header then f32
    column-major payload (reference dmap_io.py:155-170)."""
    with open(path, "rb") as f:
        header = b""
        while header.count(b"&") < 3:
            c = f.read(1)
            if not c:
                raise ValueError(f"{path}: truncated COLMAP array header")
            header += c
        w, h, ch = (int(v) for v in header.split(b"&")[:3])
        data = np.fromfile(f, np.float32)
    arr = data.reshape((w, h, ch), order="F")
    return np.transpose(arr, (1, 0, 2)).squeeze()
