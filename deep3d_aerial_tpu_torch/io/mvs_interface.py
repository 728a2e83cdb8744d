"""OpenMVS Interface (.mvs) scene serialization, version 6.

Binary contract parity with the reference writer/reader
(reference IO/mvs_io.py:377-750) and the public OpenMVS Interface.h:

  header   : "MVSI", uint32 version, uint32 reserved
  platforms: u64 count, per platform: u64 name-len + name,
             u64 n_cameras { u64 name-len+name, u64 band-len+band (v>3),
                             u32 width, u32 height (v>0),
                             K[3x3] f64, R[3x3] f64, C[3x1] f64 },
             u64 n_poses { R[3x3] f64, C[3x1] f64 }
  images   : u64 count, per image: u64 name-len+name,
             u64 mask-len+mask (v>4), u32 platformID, u32 cameraID,
             u32 poseID, u32 ID (v>2)
  vertices : u64 count, per vertex: X[3] f32, u64 n_views { u32 imageID,
             f32 confidence }
  normals  : u64 count, then count*3 f32
  colors   : u64 count, then count*3 u8
  lines/linesNormal/linesColor: u64 zeros
  transform: 4x4 f64 (v>1); OBB rot 3x3 + ptMin/ptMax f64 (v>5)

Vertex serialization is numpy-vectorized (single buffer scatter) — the
reference packs per-struct in Python, which is minutes for multi-million
point blocks; this is milliseconds.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class MVSCamera:
    name: str = ""
    band_name: str = ""
    width: int = 0
    height: int = 0
    K: np.ndarray = None  # (3,3) f64
    R: np.ndarray = None  # (3,3) f64, relative to platform (identity usually)
    C: np.ndarray = None  # (3,) f64

    def __post_init__(self):
        if self.K is None:
            self.K = np.eye(3)
        if self.R is None:
            self.R = np.eye(3)
        if self.C is None:
            self.C = np.zeros(3)


@dataclasses.dataclass
class MVSPose:
    R: np.ndarray  # (3,3) world->cam rotation
    C: np.ndarray  # (3,) camera center in world


@dataclasses.dataclass
class MVSImage:
    name: str
    platform_id: int
    camera_id: int
    pose_id: int
    id: int
    mask_name: str = ""


@dataclasses.dataclass
class MVSPlatform:
    name: str = ""
    cameras: List[MVSCamera] = dataclasses.field(default_factory=list)
    poses: List[MVSPose] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class MVSScene:
    platforms: List[MVSPlatform] = dataclasses.field(default_factory=list)
    images: List[MVSImage] = dataclasses.field(default_factory=list)
    vertices: np.ndarray = None  # (N, 3) f32
    vertex_views: Optional[List[np.ndarray]] = None  # per point image-id array
    vertex_confidences: Optional[List[np.ndarray]] = None
    normals: Optional[np.ndarray] = None  # (N, 3) f32
    colors: Optional[np.ndarray] = None  # (N, 3) u8
    transform: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float64)
    )
    obb_rot: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(3, dtype=np.float64)
    )
    obb_min: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, dtype=np.float64)
    )
    obb_max: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, dtype=np.float64)
    )


def _s(f, text: str):
    f.write(struct.pack("<Q", len(text)))
    if text:
        f.write(text.encode("utf-8"))


def _serialize_vertices(
    X: np.ndarray, views, confs
) -> bytes:
    """Vectorized vertex block: per point 12B X + 8B count + 8B per view.

    `views` is a VisibilityCSR or a sequence of per-point id arrays;
    `confs` likewise (or None for all-zero confidences)."""
    n = len(X)
    X = np.ascontiguousarray(X, dtype="<f4")
    if hasattr(views, "counts"):  # CSR fast path — no per-point loops at all
        counts = views.counts.astype("<u8")
        flat_views_src = views.values
    else:
        counts = np.array([len(v) for v in views], dtype="<u8")
        flat_views_src = None
    rec_sizes = 12 + 8 + 8 * counts
    offsets = np.concatenate([[0], np.cumsum(rec_sizes)]).astype(np.int64)
    buf = np.zeros(int(offsets[-1]), np.uint8)

    # X bytes
    idx = offsets[:-1, None] + np.arange(12)
    buf[idx] = X.view(np.uint8).reshape(n, 12)
    # counts
    idx = offsets[:-1, None] + 12 + np.arange(8)
    buf[idx] = counts.view(np.uint8).reshape(n, 8)
    # views + confidences interleaved
    counts_i = counts.astype(np.int64)
    total_views = int(counts_i.sum())
    if total_views:
        if flat_views_src is not None:
            flat_views = flat_views_src.astype("<u4")
        else:
            flat_views = np.concatenate(views).astype("<u4")
        if confs is None:
            flat_confs = np.zeros(total_views, "<f4")
        elif hasattr(confs, "values"):
            flat_confs = confs.values.astype("<f4")
        else:
            flat_confs = np.concatenate(confs).astype("<f4")
        pair = np.empty((total_views, 8), np.uint8)
        pair[:, :4] = flat_views.view(np.uint8).reshape(-1, 4)
        pair[:, 4:] = flat_confs.view(np.uint8).reshape(-1, 4)
        # position of each view record
        base = np.repeat(offsets[:-1] + 20, counts_i)
        starts = np.concatenate([[0], np.cumsum(counts_i)[:-1]])
        within = np.arange(total_views) - np.repeat(starts, counts_i)
        pos = base + 8 * within
        buf[pos[:, None] + np.arange(8)] = pair
    return buf.tobytes()


def write_mvs(path, scene: MVSScene, version: int = 6) -> None:
    n = 0 if scene.vertices is None else len(scene.vertices)
    views = scene.vertex_views or [np.zeros(0, np.uint32)] * n
    with open(path, "wb") as f:
        f.write(b"MVSI")
        f.write(struct.pack("<II", version, 0))

        f.write(struct.pack("<Q", len(scene.platforms)))
        for p in scene.platforms:
            _s(f, p.name)
            f.write(struct.pack("<Q", len(p.cameras)))
            for c in p.cameras:
                _s(f, c.name)
                if version > 3:
                    _s(f, c.band_name)
                if version > 0:
                    f.write(struct.pack("<II", c.width, c.height))
                f.write(np.ascontiguousarray(c.K, "<f8").tobytes())
                f.write(np.ascontiguousarray(c.R, "<f8").tobytes())
                f.write(np.ascontiguousarray(c.C, "<f8").tobytes())
            f.write(struct.pack("<Q", len(p.poses)))
            for pose in p.poses:
                f.write(np.ascontiguousarray(pose.R, "<f8").tobytes())
                f.write(np.ascontiguousarray(pose.C, "<f8").tobytes())

        f.write(struct.pack("<Q", len(scene.images)))
        for im in scene.images:
            _s(f, im.name)
            if version > 4:
                _s(f, im.mask_name)
            f.write(struct.pack("<III", im.platform_id, im.camera_id, im.pose_id))
            if version > 2:
                f.write(struct.pack("<I", im.id))

        f.write(struct.pack("<Q", n))
        if n:
            f.write(_serialize_vertices(
                scene.vertices, views, scene.vertex_confidences
            ))

        normals = scene.normals if scene.normals is not None else np.zeros((0, 3))
        f.write(struct.pack("<Q", len(normals)))
        f.write(np.ascontiguousarray(normals, "<f4").tobytes())

        colors = scene.colors if scene.colors is not None else np.zeros((0, 3))
        f.write(struct.pack("<Q", len(colors)))
        f.write(np.ascontiguousarray(colors, np.uint8).tobytes())

        f.write(struct.pack("<QQQ", 0, 0, 0))  # lines / normals / colors

        if version > 1:
            f.write(np.ascontiguousarray(scene.transform, "<f8").tobytes())
        if version > 5:
            f.write(np.ascontiguousarray(scene.obb_rot, "<f8").tobytes())
            f.write(np.ascontiguousarray(scene.obb_min, "<f8").tobytes())
            f.write(np.ascontiguousarray(scene.obb_max, "<f8").tobytes())


class _Reader:
    def __init__(self, f):
        self.f = f

    def u32(self):
        return struct.unpack("<I", self.f.read(4))[0]

    def u64(self):
        return struct.unpack("<Q", self.f.read(8))[0]

    def string(self):
        return self.f.read(self.u64()).decode("utf-8")

    def mat(self, rows, cols, dt):
        size = np.dtype(dt).itemsize * rows * cols
        return np.frombuffer(self.f.read(size), dt).reshape(rows, cols).copy()


def read_mvs(path) -> MVSScene:
    scene = MVSScene()
    with open(path, "rb") as f:
        r = _Reader(f)
        if f.read(4) != b"MVSI":
            raise ValueError(f"{path}: not an MVSI file")
        version = r.u32()
        if version > 6:
            raise ValueError(f"{path}: unsupported MVS version {version}")
        r.u32()

        for _ in range(r.u64()):
            p = MVSPlatform(name=r.string())
            for _ in range(r.u64()):
                c = MVSCamera()
                c.name = r.string()
                if version > 3:
                    c.band_name = r.string()
                if version > 0:
                    c.width, c.height = struct.unpack("<II", f.read(8))
                c.K = r.mat(3, 3, "<f8")
                c.R = r.mat(3, 3, "<f8")
                c.C = r.mat(3, 1, "<f8").reshape(3)
                p.cameras.append(c)
            for _ in range(r.u64()):
                R = r.mat(3, 3, "<f8")
                C = r.mat(3, 1, "<f8").reshape(3)
                p.poses.append(MVSPose(R, C))
            scene.platforms.append(p)

        for _ in range(r.u64()):
            name = r.string()
            mask = r.string() if version > 4 else ""
            pid, cid, poid = struct.unpack("<III", f.read(12))
            iid = r.u32() if version > 2 else 0
            scene.images.append(MVSImage(name, pid, cid, poid, iid, mask))

        n = r.u64()
        X = np.empty((n, 3), np.float32)
        views: List[np.ndarray] = []
        confs: List[np.ndarray] = []
        for i in range(n):
            X[i] = np.frombuffer(f.read(12), "<f4")
            k = r.u64()
            raw = np.frombuffer(f.read(8 * k), np.uint8).reshape(k, 8) if k else (
                np.zeros((0, 8), np.uint8)
            )
            views.append(raw[:, :4].copy().view("<u4").reshape(-1))
            confs.append(raw[:, 4:].copy().view("<f4").reshape(-1))
        scene.vertices = X
        scene.vertex_views = views
        scene.vertex_confidences = confs

        nn = r.u64()
        scene.normals = np.frombuffer(f.read(12 * nn), "<f4").reshape(nn, 3).copy()
        nc = r.u64()
        scene.colors = np.frombuffer(f.read(3 * nc), np.uint8).reshape(nc, 3).copy()

        struct.unpack("<QQQ", f.read(24))  # lines
        if version > 1:
            scene.transform = r.mat(4, 4, "<f8")
        if version > 5:
            scene.obb_rot = r.mat(3, 3, "<f8")
            scene.obb_min = r.mat(3, 1, "<f8").reshape(3)
            scene.obb_max = r.mat(3, 1, "<f8").reshape(3)
    return scene


def scene_from_fusion(
    cameras: Sequence,  # geometry Camera records (K, width, height)
    images: Sequence,  # tuples (image_id, camera_index, name, R_cw, center)
    points: np.ndarray,
    visibility: List[np.ndarray],
    normals: Optional[np.ndarray] = None,
    colors: Optional[np.ndarray] = None,
    image_id_to_index: Optional[dict] = None,
) -> MVSScene:
    """Assemble an MVSScene: one platform per physical camera (reference
    readCamera, mvs_io.py:421-456), one pose per image."""
    scene = MVSScene()
    plat_of_cam = {}
    for ci, cam in enumerate(cameras):
        plat = MVSPlatform(name=f"platform{ci}")
        plat.cameras.append(MVSCamera(
            name=f"camera{ci}", width=int(cam.width), height=int(cam.height),
            K=np.asarray(cam.K, np.float64),
        ))
        plat_of_cam[ci] = plat
        scene.platforms.append(plat)

    for idx, (image_id, cam_idx, name, R_cw, center) in enumerate(images):
        plat = plat_of_cam[cam_idx]
        pose_id = len(plat.poses)
        plat.poses.append(MVSPose(
            np.asarray(R_cw, np.float64), np.asarray(center, np.float64)
        ))
        scene.images.append(MVSImage(
            name=name, platform_id=cam_idx, camera_id=0,
            pose_id=pose_id, id=int(image_id),
        ))

    # remap visibility image ids -> image indices in this scene (vectorized)
    if image_id_to_index is None:
        image_id_to_index = {
            im[0]: i for i, im in enumerate(images)
        }
    from ..utils.csr import VisibilityCSR, remap_ids

    if not hasattr(visibility, "counts"):
        visibility = VisibilityCSR.from_lists(list(visibility))
    vis = remap_ids(visibility, image_id_to_index)

    scene.vertices = np.asarray(points, np.float32)
    scene.vertex_views = vis
    scene.vertex_confidences = None
    scene.normals = None if normals is None else np.asarray(normals, np.float32)
    scene.colors = None if colors is None else np.asarray(colors, np.uint8)
    return scene
