"""The reference's inputs, worked out again from the raw frames and the
files the benchmark wrote: each view's normalised image, the per-stage
relative projections and the reference view's depth range.

Plain NumPy in float64 where the geometry is concerned, as the pipeline's
loaders do it (the reference cameras.txt / images.txt / viewpair.txt
formats and the WHU-OMVS cam files); nothing here comes from the program.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

# camera axes of the files (XrightYup) onto the canonical x right, y down,
# z forward
_O = np.diag([1.0, -1.0, -1.0])


def normalise(frame: np.ndarray) -> np.ndarray:
    """[H, W] or [H, W, 3] uint8 -> [H, W, 3] float32, each channel
    standardised over the image: (x - mean) / (std + 1e-8)."""
    img = np.asarray(frame, np.float32)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    mean = img.mean(axis=(0, 1), keepdims=True)
    std = img.std(axis=(0, 1), keepdims=True)
    return (img - mean) / (std + 1e-8)


def projection(K: np.ndarray, Rwc: np.ndarray, twc: np.ndarray) -> np.ndarray:
    """4x4 K [R_cw | t_cw] of a pose stated in XrightYup axes as Rwc, twc."""
    R_cw = _O @ Rwc.T
    P = np.eye(4)
    P[:3, :3] = K @ R_cw
    P[:3, 3] = K @ (-R_cw @ twc)
    return P


def stage_relative(P: np.ndarray, stages: int = 3) -> np.ndarray:
    """[V, 4, 4] full-resolution projections -> [S, V-1, 4, 4] float32:
    stage s scales the pixel rows by 2^-(S-1-s); each source's P_v @
    inv(P_0), in float64."""
    out = []
    for s in range(stages):
        Ps = np.array(P, dtype=np.float64)
        Ps[:, :2, :] /= 2.0 ** (stages - 1 - s)
        out.append(Ps[1:] @ np.linalg.inv(Ps[0]))
    return np.stack(out).astype(np.float32)


def _rows(path: Path) -> List[List[str]]:
    return [line.split() for line in path.read_text().splitlines()
            if line.strip() and not line.startswith("#")]


def read_export(export: Path, views: int) -> Dict:
    """The export/ workspace: {'K', 'poses' {id: (Rwc, twc)}, 'ranges' {id:
    (dmin, dmax)}, 'sources' {ref id: [src ids]}}."""
    cam = _rows(export / "cameras.txt")[0]
    fx, fy, cx, cy = (float(v) for v in cam[4:8])
    K = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
    poses, ranges = {}, {}
    for e in _rows(export / "images.txt"):
        i = int(e[0])
        poses[i] = (np.array([float(v) for v in e[2:11]]).reshape(3, 3),
                    np.array([float(v) for v in e[11:14]]))
        ranges[i] = (float(e[14]), float(e[15]))
    tok = (export / "viewpair.txt").read_text().split()
    sources, k = {}, 1
    for _ in range(int(tok[0])):
        ref, n = int(tok[k]), int(tok[k + 1])
        srcs = [int(tok[k + 2 + 2 * j]) for j in range(n)]
        if len(srcs) < views - 1:
            srcs += [srcs[0]] * (views - 1 - len(srcs))
        sources[ref] = srcs[:views - 1]
        k += 2 + 2 * n
    return {"K": K, "poses": poses, "ranges": ranges, "sources": sources}


def infer_inputs(export: Dict, frames: Dict[int, np.ndarray], ref: int) -> Tuple:
    """(imgs [V, H, W, 3] float32, rel [3, V-1, 4, 4] float32, dmin, dmax) of
    reference view `ref` (a 1-based id) from the raw frames by id."""
    ids = [ref] + export["sources"][ref]
    imgs = np.stack([normalise(frames[i]) for i in ids])
    P = np.stack([projection(export["K"], *export["poses"][i]) for i in ids])
    dmin, dmax = export["ranges"][ref]
    return imgs, stage_relative(P), dmin, dmax


def read_whu_cam(path: Path) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float, float]:
    """A WHU-OMVS cam file: (K, Rwc, twc, dmin, dmax); 'Twc' is the
    XrightYup camera-to-world transform."""
    w = path.read_text().split()
    T = np.array(w[1:17], dtype=np.float64).reshape(4, 4)
    K = np.array(w[18:27], dtype=np.float64).reshape(3, 3)
    return K, T[:3, :3], T[:3, 3], float(w[27]), float(w[28])


def train_inputs(scene: Path, frames: Dict[int, np.ndarray],
                 depths: Dict[int, np.ndarray], ref: int, srcs: List[int]) -> Dict:
    """One training sample of the WHU-layout scene, from the raw frames and
    ground-truth depths (by 1-based id): imgs, rel_projs, depth_min,
    depth_max, depth_gt and mask (depth > 0)."""
    ids = [ref] + list(srcs)
    Ps, rng = [], None
    for i in ids:
        K, Rwc, twc, d0, d1 = read_whu_cam(scene / "cams" / f"v{i:03d}.txt")
        Ps.append(projection(K, Rwc, twc))
        rng = rng or (d0, d1)
    gt = depths[ref].astype(np.float32)
    return {"imgs": np.stack([normalise(frames[i]) for i in ids]),
            "rel_projs": stage_relative(np.stack(Ps)),
            "depth_min": rng[0], "depth_max": rng[1],
            "depth_gt": np.where(gt > 0, gt, 0).astype(np.float32),
            "mask": (gt > 0).astype(np.float32)}
