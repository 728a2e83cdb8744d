"""COLMAP sparse-model ingest (binary + text) and match-database access.

Reads the standard COLMAP artifacts this pipeline consumes as *input*
(capability parity with reference pycolmap/read_write_model.py and
pycolmap/utils.py): `cameras.bin/.txt`, `images.bin/.txt`,
`points3D.bin/.txt`, and the sqlite `database.db` matches table.

Implementation is written fresh from the public COLMAP format spec:
  cameras.bin  : num_cameras Q, then per camera: id i, model_id i, width Q,
                 height Q, params d*num_params(model)
  images.bin   : num_images Q, then per image: id i, qvec 4d, tvec 3d,
                 camera_id i, name cstr, num_points2D Q, (x d, y d, p3d q)*
  points3D.bin : num_points Q, then per point: id Q, xyz 3d, rgb 3B, error d,
                 track_len Q, (image_id i, point2D_idx i)*
"""

from __future__ import annotations

import dataclasses
import os
import sqlite3
import struct
from typing import Dict, Tuple

import numpy as np

from ..geometry.camera import qvec2rotmat  # noqa: F401 — re-exported: callers use sparse.colmap.qvec2rotmat

# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray  # (N, 2)
    point3D_ids: np.ndarray  # (N,) int64, -1 = untracked


@dataclasses.dataclass
class ColmapPoint3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def _read(fid, fmt: str):
    size = struct.calcsize("<" + fmt)
    return struct.unpack("<" + fmt, fid.read(size))


def _read_cstr(fid) -> str:
    chars = []
    while True:
        c = fid.read(1)
        if c == b"\x00" or c == b"":
            break
        chars.append(c)
    return b"".join(chars).decode("utf-8")


# ---------------------------------------------------------------------------
# binary readers
# ---------------------------------------------------------------------------


def read_cameras_binary(path) -> Dict[int, ColmapCamera]:
    cameras = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "Q")
        for _ in range(num):
            cam_id, model_id, width, height = _read(f, "iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "d" * num_params))
            cameras[cam_id] = ColmapCamera(cam_id, name, width, height, params)
    return cameras


def read_images_binary(path) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "Q")
        for _ in range(num):
            vals = _read(f, "idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = _read_cstr(f)
            (n2d,) = _read(f, "Q")
            raw = np.fromfile(f, dtype=np.dtype("<f8,<f8,<i8"), count=n2d)
            xys = np.stack([raw["f0"], raw["f1"]], axis=-1) if n2d else np.empty((0, 2))
            p3d = raw["f2"].astype(np.int64) if n2d else np.empty(0, np.int64)
            images[image_id] = ColmapImage(
                image_id, qvec, tvec, camera_id, name, xys, p3d
            )
    return images


def read_points3d_binary(path) -> Dict[int, ColmapPoint3D]:
    points = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "Q")
        for _ in range(num):
            vals = _read(f, "QdddBBBd")
            pid = vals[0]
            xyz = np.array(vals[1:4])
            rgb = np.array(vals[4:7], dtype=np.uint8)
            error = vals[7]
            (track_len,) = _read(f, "Q")
            raw = np.fromfile(f, dtype=np.dtype("<i4,<i4"), count=track_len)
            points[pid] = ColmapPoint3D(
                pid, xyz, rgb, error,
                raw["f0"].astype(np.int64), raw["f1"].astype(np.int64),
            )
    return points


# ---------------------------------------------------------------------------
# text readers
# ---------------------------------------------------------------------------


def _data_lines(path):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path) -> Dict[int, ColmapCamera]:
    cameras = {}
    for line in _data_lines(path):
        e = line.split()
        cameras[int(e[0])] = ColmapCamera(
            int(e[0]), e[1], int(e[2]), int(e[3]), np.array(e[4:], dtype=np.float64)
        )
    return cameras


def read_images_text(path) -> Dict[int, ColmapImage]:
    images = {}
    lines = list(_data_lines(path))
    for i in range(0, len(lines), 2):
        e = lines[i].split()
        image_id = int(e[0])
        qvec = np.array(e[1:5], dtype=np.float64)
        tvec = np.array(e[5:8], dtype=np.float64)
        camera_id = int(e[8])
        name = e[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array(
            [(float(pts[j]), float(pts[j + 1])) for j in range(0, len(pts), 3)]
        ).reshape(-1, 2)
        p3d = np.array([int(pts[j + 2]) for j in range(0, len(pts), 3)], dtype=np.int64)
        images[image_id] = ColmapImage(image_id, qvec, tvec, camera_id, name, xys, p3d)
    return images


def read_points3d_text(path) -> Dict[int, ColmapPoint3D]:
    points = {}
    for line in _data_lines(path):
        e = line.split()
        pid = int(e[0])
        track = np.array(e[8:], dtype=np.int64).reshape(-1, 2)
        points[pid] = ColmapPoint3D(
            pid,
            np.array(e[1:4], dtype=np.float64),
            np.array(e[4:7], dtype=np.uint8),
            float(e[7]),
            track[:, 0],
            track[:, 1],
        )
    return points


def read_model(path, ext: str = ""):
    """Read a COLMAP model directory -> (cameras, images, points3D) dicts.

    Auto-detects .bin vs .txt when `ext` is empty.
    """
    if not ext:
        ext = ".bin" if os.path.exists(os.path.join(path, "cameras.bin")) else ".txt"
    if ext == ".bin":
        return (
            read_cameras_binary(os.path.join(path, "cameras.bin")),
            read_images_binary(os.path.join(path, "images.bin")),
            read_points3d_binary(os.path.join(path, "points3D.bin")),
        )
    return (
        read_cameras_text(os.path.join(path, "cameras.txt")),
        read_images_text(os.path.join(path, "images.txt")),
        read_points3d_text(os.path.join(path, "points3D.txt")),
    )


# ---------------------------------------------------------------------------
# binary writers (round-trip support + test fixtures)
# ---------------------------------------------------------------------------


def write_cameras_binary(cameras: Dict[int, ColmapCamera], path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            model_id = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, model_id, cam.width, cam.height))
            f.write(struct.pack("<" + "d" * len(cam.params), *cam.params))


def write_images_binary(images: Dict[int, ColmapImage], path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec, im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", len(im.point3D_ids)))
            for (x, y), pid in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", x, y, pid))


def write_points3d_binary(points: Dict[int, ColmapPoint3D], path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for pt in points.values():
            f.write(struct.pack("<QdddBBBd", pt.id, *pt.xyz, *pt.rgb, pt.error))
            f.write(struct.pack("<Q", len(pt.image_ids)))
            for iid, p2d in zip(pt.image_ids, pt.point2D_idxs):
                f.write(struct.pack("<ii", int(iid), int(p2d)))


def write_model(cameras, images, points, path) -> None:
    write_cameras_binary(cameras, os.path.join(path, "cameras.bin"))
    write_images_binary(images, os.path.join(path, "images.bin"))
    write_points3d_binary(points, os.path.join(path, "points3D.bin"))


# ---------------------------------------------------------------------------
# match database (sqlite)
# ---------------------------------------------------------------------------

MAX_IMAGE_ID = 2147483647


def pair_id_to_image_ids(pair_id: int) -> Tuple[int, int]:
    image_id2 = pair_id % MAX_IMAGE_ID
    image_id1 = (pair_id - image_id2) // MAX_IMAGE_ID
    return image_id1, image_id2


def image_ids_to_pair_id(image_id1: int, image_id2: int) -> int:
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * MAX_IMAGE_ID + image_id2


def read_matches(database_path) -> Dict[int, np.ndarray]:
    """COLMAP database.db matches table -> {pair_id: (N,2) keypoint index array}."""
    matches = {}
    with sqlite3.connect(database_path) as conn:
        for pair_id, rows, cols, blob in conn.execute(
            "SELECT pair_id, rows, cols, data FROM matches WHERE rows > 0"
        ):
            arr = np.frombuffer(blob, dtype=np.uint32).reshape(rows, cols)
            matches[pair_id] = arr
    return matches
