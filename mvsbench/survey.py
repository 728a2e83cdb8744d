"""The traffic generator's scene: a seeded synthetic aerial survey.

A textured height field seen by a grid of nadir cameras (focal 130 px per
96 px of frame width, ~55% side-lap at 100 m), ray-cast into frames on the
device, and written to disk in the formats the port reads: an `export/`
workspace for dense matching (cameras.txt, images.txt, image_path.txt,
viewpair.txt) and a WHU-OMVS layout folder for training (images, cams, PFM
depths, info/). Frozen copy of `chip_smoke.py`'s terrain_z, texture,
survey, render, write_workspace and write_whu_folder (see README.md), with
the seed moving the survey over the terrain and jittering its altitudes.

Poses are kept as the files state them: XrightYup axes, Rwc and twc (a
nadir camera has Rwc = I). Everything here depends on the seed only, never
on the program under test.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np
import torch


def terrain_z(x, y):
    return (3.0 * torch.sin(0.08 * x) * torch.cos(0.06 * y)
            + 1.5 * torch.sin(0.021 * x + 0.033 * y))


def texture(x, y):
    return (0.5 + 0.2 * torch.sin(0.9 * x) * torch.cos(0.7 * y)
            + 0.15 * torch.sin(0.23 * x + 1.3 * y)
            + 0.15 * torch.sin(2.1 * x - 1.7 * y))


@dataclass
class Survey:
    """A camera (W x H, f, principal point at the centre) and one centre per
    view; `shift` moves the whole survey over the terrain."""

    W: int
    H: int
    f: float
    centers: np.ndarray  # [N, 3] world positions (twc)
    shift: np.ndarray    # [2] world offset of the terrain

    @property
    def K(self) -> np.ndarray:
        return np.array([[self.f, 0.0, self.W / 2], [0.0, self.f, self.H / 2],
                         [0.0, 0.0, 1.0]])

    def nearest(self, ref: int, n: int) -> List[int]:
        """The n views whose centres lie nearest to view ref's, nearest
        first."""
        dist = np.linalg.norm(self.centers - self.centers[ref], axis=1)
        return [int(j) for j in np.argsort(dist, kind="stable") if j != ref][:n]


def survey(W: int, H: int, nx: int, ny: int, seed: int) -> Survey:
    """An nx x ny grid of nadir cameras 100 m (+-2 m) over the terrain,
    spaced at 0.45 of the footprint; the seed draws the altitudes and the
    survey's offset over the terrain."""
    rng = np.random.default_rng(seed)
    f = 130.0 * W / 96.0
    fp = W / f * 100.0
    centers = []
    for gy in range(ny):
        for gx in range(nx):
            centers.append([(gx - (nx - 1) / 2) * 0.45 * fp,
                            (gy - (ny - 1) / 2) * 0.45 * fp * H / W,
                            100.0 + rng.uniform(-2, 2)])
    shift = rng.uniform(-500.0, 500.0, 2)
    return Survey(W, H, f, np.array(centers), shift)


def render(sv: Survey, view: int, dev) -> tuple:
    """(gray frame [H, W] uint8 as a numpy array, depth [H, W] float32 numpy)
    of one view, by ray-casting the height field on `dev` (fixed-point
    iteration, float64)."""
    K = torch.tensor(sv.K, dtype=torch.float64, device=dev)
    c = torch.tensor(sv.centers[view], dtype=torch.float64, device=dev)
    # canonical camera axes (x right, y down, z forward) of a nadir view
    Rwc = torch.tensor([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]],
                       dtype=torch.float64, device=dev)
    gy, gx = torch.meshgrid(torch.arange(sv.H, dtype=torch.float64, device=dev),
                            torch.arange(sv.W, dtype=torch.float64, device=dev),
                            indexing="ij")
    rays = torch.stack([gx, gy, torch.ones_like(gx)], -1) @ torch.linalg.inv(K).T @ Rwc.T
    sx, sy = float(sv.shift[0]), float(sv.shift[1])
    depth = (0.0 - c[2]) / rays[..., 2]
    for _ in range(30):
        w = c + rays * depth[..., None]
        depth = (terrain_z(w[..., 0] + sx, w[..., 1] + sy) - c[2]) / rays[..., 2]
    w = c + rays * depth[..., None]
    gray = texture(w[..., 0] + sx, w[..., 1] + sy).clamp(0, 1)
    frame = (gray.float() * 255).to(torch.uint8)
    return frame.cpu().numpy(), depth.float().cpu().numpy()


def depth_range(depth: np.ndarray) -> tuple:
    """The depth range written for a view: its rendered depths padded by a
    quarter of their span and 1 m, rounded as the files state it."""
    pad = (depth.max() - depth.min()) / 4 + 1.0
    return float(f"{depth.min() - pad:.6f}"), float(f"{depth.max() + pad:.6f}")


def save_png(path: Path, gray: np.ndarray) -> None:
    """A gray frame as an 8-bit RGB PNG (fast compression: set-up time)."""
    from PIL import Image

    Image.fromarray(np.dstack([gray] * 3)).save(path, compress_level=1)


def write_export(ws: Path, sv: Survey, frames: List[np.ndarray],
                 ranges: List[tuple], views: int) -> None:
    """ws/images/*.png and ws/export/{cameras,images,image_path,viewpair}.txt
    in the port's text formats: one camera, each view's pose (XrightYup,
    Rwc = I, twc = its centre) and depth range, and for each view its
    views-1 nearest as sources."""
    (ws / "images").mkdir(parents=True)
    export = ws / "export"
    export.mkdir()
    lines_im, lines_path = [], []
    for i, (frame, (d0, d1)) in enumerate(zip(frames, ranges), start=1):
        path = ws / "images" / f"im_{i:02d}.png"
        save_png(path, frame)
        R = " ".join(f"{v:.6f}" for v in np.eye(3).reshape(-1))
        t = " ".join(f"{v:.6f}" for v in sv.centers[i - 1])
        lines_im.append(f"{i} 1 {R} {t} {d0:.6f} {d1:.6f} {path.name}\n")
        lines_path.append(f"{i} {path.name} {path}\n")
    (export / "cameras.txt").write_text(
        "# CAMERA_ID, WIDTH, HEIGHT, PIXELSIZE, PARAMS[fx,fy,cx,cy], DISTORTION\n"
        f"1 {sv.W} {sv.H} 0.000000 {sv.f:.6f} {sv.f:.6f} {sv.W / 2:.6f} "
        f"{sv.H / 2:.6f} 0.000000 0.000000 0.000000 0.000000\n")
    (export / "images.txt").write_text(
        "# IMAGE_ID, CAMERA_ID, Rwc[9], twc[3], MINDEPTH, MAXDEPTH, NAME "
        "(XrightYup)\n" + "".join(lines_im))
    (export / "image_path.txt").write_text(f"{len(frames)}\n" + "".join(lines_path))
    pairs = f"{len(frames)}\n"
    for r in range(len(frames)):
        srcs = sv.nearest(r, views - 1)
        dist = np.linalg.norm(sv.centers[srcs] - sv.centers[r], axis=1)
        pairs += f"{r + 1}\n{len(srcs)} " + "".join(
            f"{j + 1} {1.0 / d:.4f} " for j, d in zip(srcs, dist)) + "\n"
    (export / "viewpair.txt").write_text(pairs)


def write_pfm(path: Path, image: np.ndarray) -> None:
    """A float32 [H, W] map as a little-endian PFM (rows bottom-up)."""
    with open(path, "wb") as f:
        f.write(b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(b"-1.000000\n")
        np.flipud(image).astype("<f4").tofile(f)


def write_whu(root: Path, sv: Survey, frames: List[np.ndarray],
              depths: List[np.ndarray], ranges: List[tuple], refs: List[int],
              views: int) -> None:
    """A WHU-OMVS layout training folder of one scene (the port's
    train/dataset_whu.py reads it with gt_format 'pfm'): images/*.png,
    cams/*.txt ('Twc' in XrightYup axes, 'K_mat', 'dmin dmax interval'),
    depths/*.pfm, info/image_path.txt and info/viewpair.txt with `refs`
    as reference views, each with its views-1 nearest as sources."""
    scene = root / "scene"
    for sub in ("images", "cams", "depths", "info"):
        (scene / sub).mkdir(parents=True)
    (root / "index.txt").write_text("scene\n")
    K = sv.K
    for i, (frame, depth, (d0, d1)) in enumerate(zip(frames, depths, ranges), start=1):
        name = f"v{i:03d}"
        save_png(scene / "images" / f"{name}.png", frame)
        write_pfm(scene / "depths" / f"{name}.pfm", depth)
        c = sv.centers[i - 1]
        rows = "".join(f"{r[0]:.9f} {r[1]:.9f} {r[2]:.9f} {t:.9f}\n"
                       for r, t in zip(np.eye(3), c))
        (scene / "cams" / f"{name}.txt").write_text(
            f"Twc\n{rows}0 0 0 1\n\nK_mat\n"
            f"{K[0, 0]:.6f} 0 {K[0, 2]:.6f}\n0 {K[1, 1]:.6f} {K[1, 2]:.6f}\n0 0 1\n\n"
            f"{d0:.6f} {d1:.6f} 0.1\n")
    (scene / "info" / "image_path.txt").write_text(
        f"{len(frames)}\n" + "".join(f"{i} v{i:03d}.png images/v{i:03d}.png\n"
                                     for i in range(1, len(frames) + 1)))
    text = f"{len(refs)}\n"
    for r in refs:
        srcs = sv.nearest(r, views - 1)
        dist = np.linalg.norm(sv.centers[srcs] - sv.centers[r], axis=1)
        text += f"{r + 1}\n{len(srcs)} " + " ".join(
            f"{j + 1} {1.0 / d:.4f}" for j, d in zip(srcs, dist)) + "\n"
    (scene / "info" / "viewpair.txt").write_text(text)
