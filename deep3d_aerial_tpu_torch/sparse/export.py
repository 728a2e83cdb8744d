"""COLMAP sparse model -> 'predef' camera/image text export.

Capability parity with reference format/export_colmap.py:17-91:
per-image depth range from the 0.1/99.9 percentiles of the projected sparse
point depths, padded by range/64 on both ends; poses re-expressed as
XrightYup/Rwc/twc in images.txt (handled canonically by the Pose class).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from ..geometry.camera import Camera, Pose, qvec2rotmat
from ..io import text_formats
from . import colmap


def colmap_camera_to_predef(cam: colmap.ColmapCamera) -> Camera:
    p = cam.params
    if cam.model in ("PINHOLE", "OPENCV", "FULL_OPENCV"):
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        dist = tuple(p[4:8]) if len(p) >= 8 else (0.0, 0.0, 0.0, 0.0)
    elif cam.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL"):
        fx = fy = p[0]
        cx, cy = p[1], p[2]
        dist = (p[3], p[4] if len(p) > 4 else 0.0, 0.0, 0.0) if len(p) > 3 else (0.0,) * 4
    else:
        raise ValueError(f"unsupported COLMAP camera model {cam.model}")
    return Camera(
        camera_id=cam.id, width=cam.width, height=cam.height,
        fx=float(fx), fy=float(fy), cx=float(cx), cy=float(cy),
        pixelsize=0.0, distortion=tuple(float(d) for d in dist),
    )


def depth_range_from_points(
    pose: Pose, xyz: np.ndarray, lo_pct=0.1, hi_pct=99.9, pad_div=64.0
) -> Tuple[float, float]:
    """Percentile depth range of the view's triangulated points, padded."""
    depths = (xyz @ pose.R_cw.T + pose.t_cw)[:, 2]
    dmin, dmax = np.percentile(depths, [lo_pct, hi_pct])
    pad = (dmax - dmin) / pad_div
    return float(dmin - pad), float(dmax + pad)


def export_predef(sparse_path: str, output_path: str):
    """Write cameras.txt + images.txt (predef) from a COLMAP sparse model.

    Returns (cameras dict, images dict) in canonical in-memory form.
    """
    os.makedirs(output_path, exist_ok=True)
    cams, images, points = colmap.read_model(sparse_path)

    predef_cams = [colmap_camera_to_predef(c) for c in cams.values()]

    point_xyz = {pid: pt.xyz for pid, pt in points.items()}
    predef_images: List[text_formats.PredefImage] = []
    for im in images.values():
        # COLMAP poses are XrightYdown / Rcw / tcw (already canonical axes)
        pose = Pose.from_convention(
            qvec2rotmat(im.qvec), im.tvec,
            axes="xrightydown", rotation="Rcw", translation="tcw",
        )
        xyz = np.array(
            [point_xyz[pid] for pid in im.point3D_ids if pid > 0], dtype=np.float64
        )
        if xyz.shape[0] == 0:
            continue
        dmin, dmax = depth_range_from_points(pose, xyz)
        predef_images.append(
            text_formats.PredefImage(
                image_id=im.id, camera_id=im.camera_id, pose=pose,
                depth_min=dmin, depth_max=dmax, name=im.name,
            )
        )

    text_formats.write_predef_cameras(
        os.path.join(output_path, "cameras.txt"), predef_cams
    )
    text_formats.write_predef_images(
        os.path.join(output_path, "images.txt"), predef_images
    )
    return {c.camera_id: c for c in predef_cams}, {
        im.image_id: im for im in predef_images
    }


def export_rednet_cams(cameras_txt: str, images_txt: str, out_dir: str):
    """predef text -> per-view 'rednet' training cam files.

    Parity with reference format/export_predef.py:16-35 +
    IO/params_io.py:183-214: one '<image_id>.txt' per view with a 'Twc'
    header (XrightYup/Rwc/twc 4x4), 'K_mat' 3x3, depth range line, and an
    image-info line.
    """
    os.makedirs(out_dir, exist_ok=True)
    cams = text_formats.read_predef_cameras(cameras_txt)
    images = text_formats.read_predef_images(images_txt)
    written = []
    for im in images.values():
        cam = cams[im.camera_id]
        R, t = im.pose.to_convention(
            axes="xrightyup", rotation="Rwc", translation="twc"
        )
        path = os.path.join(out_dir, f"{im.image_id}.txt")
        with open(path, "w") as f:
            f.write("Twc\n")
            for i in range(3):
                f.write(f"{R[i,0]:.6f} {R[i,1]:.6f} {R[i,2]:.6f} {t[i]:.6f}\n")
            f.write("0.000000 0.000000 0.000000 1.000000\n\n")
            f.write("K_mat\n")
            f.write(f"{cam.fx:.6f} 0.000000 {cam.cx:.6f}\n")
            f.write(f"0.000000 {cam.fy:.6f} {cam.cy:.6f}\n")
            f.write("0.000000 0.000000 1.000000\n\n")
            f.write(f"{im.depth_min:.6f} {im.depth_max:.6f} 0.100000\n\n")
            f.write(f"{im.name} 0 0 0 0 {cam.width} {cam.height}\n")
        written.append(path)
    return written
