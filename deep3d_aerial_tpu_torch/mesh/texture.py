"""Mesh texturing — TextureMesh-stage equivalent (reference wraps the
OpenMVS TextureMesh binary, createmesh.py:115-142).

Round-1 scope: per-vertex colors re-sampled from the source imagery. Each
vertex is colored from the view with the most fronto-parallel ray (best
cosine between the vertex normal and the view direction) among views where
it projects in-frame; falls back to the fused point color. A full texture
atlas (per-face UV charts) is the planned C++ upgrade.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..fusion.consistency import ViewGeometry


@dataclasses.dataclass
class TextureView:
    geom: ViewGeometry
    image: np.ndarray  # [H, W, 3] uint8 or float


def vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals (upward-oriented for 2.5D meshes)."""
    n = np.zeros_like(vertices, dtype=np.float64)
    if len(faces):
        a = vertices[faces[:, 0]]
        b = vertices[faces[:, 1]]
        c = vertices[faces[:, 2]]
        fn = np.cross(b - a, c - a)
        for k in range(3):
            np.add.at(n, faces[:, k], fn)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = np.divide(n, norm, out=np.tile([[0.0, 0.0, 1.0]], (len(n), 1)),
                  where=norm > 1e-12)
    flip = n[:, 2] < 0
    n[flip] = -n[flip]
    return n.astype(np.float32)


def texture_vertices(
    vertices: np.ndarray,
    faces: np.ndarray,
    views: Sequence[TextureView],
    fallback_colors: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Best-view per-vertex colors [N, 3] uint8."""
    n_v = len(vertices)
    colors = (
        fallback_colors.astype(np.uint8).copy()
        if fallback_colors is not None
        else np.full((n_v, 3), 128, np.uint8)
    )
    if n_v == 0 or not views:
        return colors

    normals = vertex_normals(vertices, faces)
    best_score = np.full(n_v, -np.inf)

    for view in views:
        geom = view.geom
        img = view.image
        H, W = img.shape[:2]
        T = np.asarray(geom.T_cw, np.float64)
        K = np.asarray(geom.K, np.float64)
        cam = vertices @ T[:3, :3].T + T[:3, 3]
        z = cam[:, 2]
        uvw = cam @ K.T
        with np.errstate(divide="ignore", invalid="ignore"):
            u = uvw[:, 0] / uvw[:, 2]
            v = uvw[:, 1] / uvw[:, 2]
        inb = (z > 1e-6) & (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)

        center = np.asarray(geom.T_wc, np.float64)[:3, 3]
        rays = center[None] - vertices
        rays /= np.linalg.norm(rays, axis=1, keepdims=True) + 1e-12
        score = np.sum(rays * normals, axis=1)  # cos(view angle)

        better = inb & (score > best_score)
        if not better.any():
            continue
        ui = np.clip(np.round(u[better]).astype(np.int64), 0, W - 1)
        vi = np.clip(np.round(v[better]).astype(np.int64), 0, H - 1)
        sampled = img[vi, ui]
        if sampled.dtype != np.uint8:
            sampled = np.clip(sampled * 255.0, 0, 255).astype(np.uint8)
        colors[better] = sampled[..., :3]
        best_score[better] = score[better]

    return colors


def texture_mesh_file(
    src_ply,
    dst_ply,
    views: Sequence[TextureView],
):
    """File entry: mesh PLY -> textured (vertex-colored) mesh PLY."""
    from .trimesh_io import read_mesh_ply, write_mesh_ply

    verts, faces = read_mesh_ply(src_ply)
    colors = texture_vertices(verts, faces, views)
    write_mesh_ply(dst_ply, verts, faces, colors)
    return colors
