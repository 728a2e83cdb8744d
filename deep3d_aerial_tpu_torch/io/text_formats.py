"""Text-file contracts shared with the reference pipeline.

These files are the inter-stage API of the original Deep3D pipeline and are
kept byte-compatible so outputs are interchangeable on the same scenes:

  cameras.txt / images.txt ("predef")  reference IO/params_io.py:67-116,273-314
  image_path.txt                       params_io.py:317-331
  viewpair.txt                         params_io.py:417-426
  blocks.txt                           params_io.py:430-444
  scene border txt                     params_io.py:447-462
  per-view MVS cam txt ("red cam")     datasets/data_io.py:291-314, reader
                                       fuse/fusion_3d_normal.py:112-133
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..geometry.camera import Camera, Pose

# ---------------------------------------------------------------------------
# predef cameras.txt / images.txt
# ---------------------------------------------------------------------------


class PredefImage:
    """One row of predef images.txt: pose in XrightYup/Rwc/twc + depth range."""

    __slots__ = ("image_id", "camera_id", "pose", "depth_min", "depth_max", "name")

    def __init__(self, image_id, camera_id, pose: Pose, depth_min, depth_max, name):
        self.image_id = int(image_id)
        self.camera_id = int(camera_id)
        self.pose = pose  # canonical Pose
        self.depth_min = float(depth_min)
        self.depth_max = float(depth_max)
        self.name = name


def read_predef_cameras(path) -> Dict[int, Camera]:
    cams: Dict[int, Camera] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split()
            cams[int(e[0])] = Camera(
                camera_id=int(e[0]),
                width=int(e[1]),
                height=int(e[2]),
                pixelsize=float(e[3]),
                fx=float(e[4]),
                fy=float(e[5]),
                cx=float(e[6]),
                cy=float(e[7]),
                distortion=tuple(float(v) for v in e[8:12]),
            )
    return cams


def write_predef_cameras(path, cams: Sequence[Camera]) -> None:
    with open(path, "w") as f:
        f.write(f"# Number of cameras: {len(cams)}\n")
        f.write("# CAMERA_MODEL: OPENCV\n")
        f.write("# Camera list with one line of data per camera:\n")
        f.write(
            "# CAMERA_ID, WIDTH, HEIGHT, PIXELSIZE, PARAMS[fx,fy,cx,cy],"
            " DISTORTION[K1, K2, P1, P2]\n"
        )
        for c in cams:
            d = list(c.distortion) + [0.0] * 4
            f.write(
                f"{c.camera_id} {c.width} {c.height} "
                f"{c.pixelsize:.6f} {c.fx:.6f} {c.fy:.6f} {c.cx:.6f} {c.cy:.6f} "
                f"{d[0]:.6f} {d[1]:.6f} {d[2]:.6f} {d[3]:.6f}\n"
            )


def read_predef_images(path) -> Dict[int, PredefImage]:
    """Rows store Rwc[9] twc[3] in XrightYup axes; converted to canonical."""
    images: Dict[int, PredefImage] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split()
            R = np.array([float(v) for v in e[2:11]]).reshape(3, 3)
            t = np.array([float(v) for v in e[11:14]])
            pose = Pose.from_convention(
                R, t, axes="xrightyup", rotation="Rwc", translation="twc"
            )
            images[int(e[0])] = PredefImage(
                image_id=int(e[0]),
                camera_id=int(e[1]),
                pose=pose,
                depth_min=float(e[14]),
                depth_max=float(e[15]),
                name=e[16],
            )
    return images


def write_predef_images(path, images: Sequence[PredefImage]) -> None:
    with open(path, "w") as f:
        f.write(f"# Number of images: {len(images)}\n")
        f.write("# Image list with two lines of data per image:\n")
        f.write("# CAMERA ORI: [ XrightYup | Rwc | twc ]\n")
        f.write("#  IMAGE_ID, CAMERA_ID, Rwc[9], twc[3], MINDEPTH, MAXDEPTH, NAME\n")
        for im in images:
            R, t = im.pose.to_convention(
                axes="xrightyup", rotation="Rwc", translation="twc"
            )
            f.write(f"{im.image_id} {im.camera_id} ")
            f.write(" ".join(f"{v:.6f}" for v in R.reshape(-1)) + " ")
            f.write(" ".join(f"{v:.6f}" for v in t.reshape(-1)) + " ")
            f.write(f"{im.depth_min:.6f} {im.depth_max:.6f} {im.name}\n")


# ---------------------------------------------------------------------------
# image_path.txt :  N, then rows "ID NAME ABS_PATH"
# ---------------------------------------------------------------------------


def read_image_paths(path) -> Tuple[Dict[int, str], Dict[int, str]]:
    """Returns (paths_by_id, names_by_id)."""
    tokens = open(path).read().split()
    n = int(tokens[0])
    paths, names = {}, {}
    for i in range(n):
        idx = int(tokens[i * 3 + 1])
        names[idx] = tokens[i * 3 + 2]
        paths[idx] = tokens[i * 3 + 3]
    return paths, names


def write_image_paths(path, entries: Sequence[Tuple[int, str, str]]) -> None:
    """entries: (id, name, abs_path) rows."""
    with open(path, "w") as f:
        f.write(f"{len(entries)}\n")
        for idx, name, p in entries:
            f.write(f"{idx} {name} {p}\n")


# ---------------------------------------------------------------------------
# center offset txt : "X\nY\nZ" (reference params_io.py:119-137,465-475)
# ---------------------------------------------------------------------------


def read_center_offset(path) -> np.ndarray:
    vals = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                vals.append(float(line.split()[0]))
    return np.asarray(vals, dtype=np.float64)


def write_center_offset(path, offset: Sequence[float]) -> None:
    with open(path, "w") as f:
        f.write("# Center offset\n")
        for v in offset:
            f.write(f"{v}\n")


# ---------------------------------------------------------------------------
# viewpair.txt : N, then per ref view: "ref_id" newline "k src score src score …"
# ---------------------------------------------------------------------------


def read_view_pairs(path) -> List[Tuple[int, List[Tuple[int, float]]]]:
    """-> [(ref_id, [(src_id, score), ...]), ...]"""
    out = []
    with open(path) as f:
        n = int(f.readline())
        for _ in range(n):
            ref = int(f.readline().strip())
            toks = f.readline().split()
            k = int(toks[0])
            pairs = [
                (int(toks[1 + 2 * i]), float(toks[2 + 2 * i])) for i in range(k)
            ]
            out.append((ref, pairs))
    return out


def write_view_pairs(path, score: Sequence[Tuple[int, Sequence[Tuple[int, float]]]]):
    text = f"{len(score)}\n"
    for ref, pairs in score:
        text += f"{ref}\n{len(pairs)} "
        for src, s in pairs:
            text += f"{src} {s:.4f} "
        text += "\n"
    with open(path, "w") as f:
        f.write(text)


def expand_view_pairs(
    pairs: Sequence[Tuple[int, float]], view_num: int
) -> List[int]:
    """Source list for one ref view, padded to `view_num`-1 sources by repeating
    the best source (reference behavior, datasets/data_io.py:170-175)."""
    srcs = [p[0] for p in pairs]
    if not srcs:
        return []
    need = view_num - 1
    if len(srcs) < need:
        srcs = srcs + [srcs[0]] * (need - len(srcs))
    return srcs[:need]


# ---------------------------------------------------------------------------
# blocks.txt : N, then per block: 6-float bbx line + ref-id list line
# ---------------------------------------------------------------------------


def read_blocks(path) -> List[Tuple[List[float], List[int]]]:
    out = []
    with open(path) as f:
        n = int(f.readline())
        for _ in range(n):
            bbx = [float(x) for x in f.readline().split()]
            refs = [int(x) for x in f.readline().split()]
            out.append((bbx, refs))
    return out


def write_blocks(path, blocks: Sequence[Tuple[Sequence[float], Sequence[int]]]):
    text = f"{len(blocks)}\n"
    for bbx, refs in blocks:
        text += " ".join(f"{v:.4f}" for v in bbx) + " \n"
        text += " ".join(str(i) for i in refs) + " \n"
    with open(path, "w") as f:
        f.write(text)


# ---------------------------------------------------------------------------
# scene border txt : 6 floats, one per line
# ---------------------------------------------------------------------------


def read_border(path) -> np.ndarray:
    with open(path) as f:
        lines = f.read().splitlines()
    return np.array(lines[:6], dtype=np.float64)


def write_border(path, border: Sequence[float]) -> None:
    with open(path, "w") as f:
        for b in border:
            f.write(f"{b}\n")


# ---------------------------------------------------------------------------
# per-view MVS cam txt ("red cam"): Tcw 4x4 + K + depth line + location line
# ---------------------------------------------------------------------------


class MVSCam:
    """Per-view camera artifact written next to each depth map."""

    __slots__ = ("T_cw", "K", "depth_min", "depth_interval", "depth_num",
                 "depth_max", "width", "height", "image_id", "name", "image_path")

    def __init__(self, T_cw, K, depth_min, depth_interval, depth_num, depth_max,
                 width, height, image_id, name, image_path=""):
        self.T_cw = np.asarray(T_cw, dtype=np.float64)
        self.K = np.asarray(K, dtype=np.float64)
        self.depth_min = float(depth_min)
        self.depth_interval = float(depth_interval)
        self.depth_num = int(depth_num)
        self.depth_max = float(depth_max)
        self.width = int(width)
        self.height = int(height)
        self.image_id = int(image_id)
        self.name = name
        self.image_path = image_path


def write_mvs_cam(path, cam: MVSCam) -> None:
    with open(path, "w") as f:
        f.write("extrinsic: XrightYdown, [Rcw|tcw]\n")
        for i in range(4):
            f.write(" ".join(str(cam.T_cw[i, j]) for j in range(4)) + " \n")
        f.write("\n")
        f.write("intrinsic\n")
        for i in range(3):
            f.write(" ".join(str(cam.K[i, j]) for j in range(3)) + " \n")
        f.write(
            f"\n{cam.depth_min} {cam.depth_interval} {cam.depth_num} {cam.depth_max}\n"
        )
        f.write("\n")
        f.write(
            f"{cam.width} {cam.height} {cam.image_id} {cam.name} {cam.image_path}\n"
        )


def read_mvs_cam(path, scale: float = 1.0) -> MVSCam:
    """Reader tolerant of the reference writer's exact line layout
    (fusion_3d_normal.py:112-133): extrinsic lines [1,5), K lines [7,10),
    depth line 11, info line 13."""
    with open(path) as f:
        lines = [ln.rstrip() for ln in f.readlines()]
    T_cw = np.fromstring(" ".join(lines[1:5]), dtype=np.float64, sep=" ").reshape(4, 4)
    K = np.fromstring(" ".join(lines[7:10]), dtype=np.float64, sep=" ").reshape(3, 3)
    K[:2, :] *= scale
    d = np.fromstring(lines[11], dtype=np.float64, sep=" ")
    info = lines[13].split(" ")
    return MVSCam(
        T_cw, K, d[0], d[1], int(d[2]), d[3],
        int(info[0]), int(info[1]), int(info[2]), info[3],
        info[4] if len(info) > 4 else "",
    )
