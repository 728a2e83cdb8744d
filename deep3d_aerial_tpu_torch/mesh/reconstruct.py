"""Mesh reconstruction from fused point clouds (counterpart of
deep3d_aerial_tpu/mesh/reconstruct.py).

Stage parity with the reference's OpenMVS ReconstructMesh wrapper
(reference mesh/createmesh.py:50-79). The default is the visibility-driven
3D Delaunay + graph-cut surface of the native core
(`reconstruct_graphcut_from_mvs`, native/delaunay_mesh.cc) from the fused
block's `.mvs` scene. The 2.5-D path is a Delaunay triangulation in the xy
plane over a decimated point set, with long triangles culled by
`insert_distance`; `auto` takes it only where the graph cut has no surface
to offer (no `.mvs` scene, under 16 points, or an error code from the core),
never because the native library is missing: that raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..io.ply import read_ply
from .trimesh_io import write_mesh_ply


@dataclasses.dataclass
class MeshConfig:
    """Reconstruction + clean knobs, 1:1 with the reference's
    RECONSTRUCTMESH YAML block (mesh/config.yaml:8-24)."""

    insert_distance: float = 1.5  # fDistInsert: target point spacing (m)
    decimate_ratio: float = 1.0   # fDecimateMesh: keep fraction of points
    max_edge_factor: float = 8.0  # cull triangles with edges > factor*spacing
    # graph-cut energy weights (quality scales the per-crossing free-space
    # vote, thickness the behind-the-point inside t-link — the same roles
    # OpenMVS's fQualityFactor/fThicknessFactor play in its energy)
    quality_factor: float = 1.0   # fQualityFactor
    thickness_factor: float = 1.0  # fThicknessFactor
    # clean options (mesh/clean.py)
    remove_spurious: int = 20     # fRemoveSpurious: min component faces
    remove_spikes: bool = True    # bRemoveSpikes
    close_holes: int = 30         # nCloseHoles: max boundary edges to fill
    smooth_mesh: int = 1          # nSmoothMesh: Taubin iterations
    target_face_num: int = 0      # nTargetFaceNum: 0 = off


def grid_decimate(
    points: np.ndarray, spacing: float, colors: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
):
    """Keep one point per xy grid cell of side `spacing` (native core)."""
    if spacing <= 0 or len(points) == 0:
        return points, colors, normals

    from ..utils.native import grid_decimate_indices

    idx = grid_decimate_indices(points, spacing)
    return (
        points[idx],
        colors[idx] if colors is not None else None,
        normals[idx] if normals is not None else None,
    )


def grid_decimate_numpy(
    points: np.ndarray, spacing: float, colors: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
):
    """The plain NumPy version of `grid_decimate`: per cell, the point
    closest to the cell's median height."""
    if spacing <= 0 or len(points) == 0:
        return points, colors, normals
    key = np.floor(points[:, :2] / spacing).astype(np.int64)
    # hash cells
    h = key[:, 0] * 73856093 ^ key[:, 1] * 19349663
    order = np.argsort(h, kind="stable")
    h_s = h[order]
    starts = np.flatnonzero(np.concatenate([[True], h_s[1:] != h_s[:-1]]))
    ends = np.concatenate([starts[1:], [len(h_s)]])

    idx_keep = []
    for s, e in zip(starts, ends):
        seg = order[s:e]
        # representative: the point closest to the cell's median height
        z = points[seg, 2]
        idx_keep.append(seg[np.argmin(np.abs(z - np.median(z)))])
    idx_keep = np.asarray(idx_keep)
    return (
        points[idx_keep],
        colors[idx_keep] if colors is not None else None,
        normals[idx_keep] if normals is not None else None,
    )


def delaunay_mesh_25d(
    points: np.ndarray,
    cfg: MeshConfig = MeshConfig(),
    colors: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
):
    """Points [N, 3] -> (vertices, faces [M, 3], vertex_colors|None)."""
    from scipy.spatial import Delaunay

    pts, colors, normals = grid_decimate(
        points, cfg.insert_distance, colors, normals
    )
    if cfg.decimate_ratio < 1.0 and len(pts) > 10:
        keep = max(4, int(len(pts) * cfg.decimate_ratio))
        sel = np.linspace(0, len(pts) - 1, keep).astype(np.int64)
        pts = pts[sel]
        colors = colors[sel] if colors is not None else None

    if len(pts) < 4:
        return pts, np.zeros((0, 3), np.int32), colors

    tri = Delaunay(pts[:, :2])
    faces = tri.simplices.astype(np.int32)

    # cull degenerate sliver triangles spanning holes
    a = pts[faces[:, 0], :2]
    b = pts[faces[:, 1], :2]
    c = pts[faces[:, 2], :2]
    edges = np.stack([
        np.linalg.norm(a - b, axis=1),
        np.linalg.norm(b - c, axis=1),
        np.linalg.norm(c - a, axis=1),
    ])
    max_edge = cfg.max_edge_factor * max(cfg.insert_distance, 1e-6)
    keep = edges.max(0) < max_edge
    faces = faces[keep]

    # consistent upward orientation (2.5D): counter-clockwise in xy
    det = (b[keep, 0] - a[keep, 0]) * (c[keep, 1] - a[keep, 1]) - (
        b[keep, 1] - a[keep, 1]
    ) * (c[keep, 0] - a[keep, 0])
    flip = det < 0
    faces[flip] = faces[flip][:, ::-1]

    return pts.astype(np.float32), faces, colors


def create_mesh_from_ply(src_ply, dst_ply, cfg: MeshConfig = MeshConfig()):
    """ReconstructMesh-equivalent file entry: fused PLY -> mesh PLY."""
    from .clean import clean_mesh

    pts, normals, colors = read_ply(src_ply)
    verts, faces, vcolors = delaunay_mesh_25d(pts, cfg, colors, normals)
    verts, faces, vcolors = clean_mesh(
        verts, faces, vcolors,
        remove_spurious_faces=cfg.remove_spurious,
        spikes=cfg.remove_spikes, holes=cfg.close_holes,
        smooth=cfg.smooth_mesh, target_faces=cfg.target_face_num)
    write_mesh_ply(dst_ply, verts, faces, vcolors)
    return verts, faces


def reconstruct_graphcut_from_mvs(
    mvs_path,
    cfg: MeshConfig = MeshConfig(),
    alpha_vis: float = 1.0,
    inside_w: float = 2.0,
    min_component: int = 20,
):
    """Visibility-driven 3D Delaunay + graph-cut surface from an OpenMVS
    interface scene (the ReconstructMesh algorithm the reference shells out
    for, createmesh.py:50-79; C++ core native/delaunay_mesh.cc).

    Consumes scene_i.mvs — vertices WITH their per-point visibility lists
    and camera poses — so vertical facades and overhangs reconstruct where
    a 2.5D heightfield provably cannot. Returns (verts, faces, colors), or
    None for a scene of under 16 points or an error code from the core (the
    caller then takes the 2.5-D mesh). A native library that cannot be
    built raises.
    """
    from ..io.mvs_interface import read_mvs
    from ..utils.native import reconstruct_mesh_native

    scene = read_mvs(mvs_path)
    pts = np.asarray(scene.vertices, np.float64)
    if pts.shape[0] < 16:
        return None
    views = scene.vertex_views
    if hasattr(views, "counts"):
        vals = np.asarray(views.values, np.int32)
        offs = np.asarray(views.offsets, np.int64)
    else:
        offs = np.concatenate(
            [[0], np.cumsum([len(v) for v in views])]).astype(np.int64)
        vals = (np.concatenate(views).astype(np.int32) if len(views)
                else np.zeros(0, np.int32))

    # camera center per image INDEX (visibility stores image indices)
    cams = np.zeros((len(scene.images), 3), np.float64)
    for i, im in enumerate(scene.images):
        pose = scene.platforms[im.platform_id].poses[im.pose_id]
        cams[i] = np.asarray(pose.C, np.float64)

    colors = scene.colors

    # optional decimation (keeps CSR rows aligned)
    if cfg.decimate_ratio < 1.0 and len(pts) > 100:
        keep = np.linspace(0, len(pts) - 1,
                           max(16, int(len(pts) * cfg.decimate_ratio)),
                           ).astype(np.int64)
        counts = np.diff(offs)[keep]
        sel_vals = np.concatenate(
            [vals[offs[i]:offs[i + 1]] for i in keep]) if len(keep) else vals[:0]
        pts = pts[keep]
        colors = colors[keep] if colors is not None else None
        vals = sel_vals
        offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    tris = reconstruct_mesh_native(
        pts, vals, offs, cams,
        alpha_vis=alpha_vis * cfg.quality_factor,
        inside_w=inside_w * cfg.thickness_factor,
        min_component=max(min_component, cfg.remove_spurious),
    )
    if tris is None:
        return None
    from .clean import clean_mesh

    verts32 = pts.astype(np.float32)
    verts32, tris, colors = clean_mesh(
        verts32, tris.astype(np.int32), colors,
        spikes=cfg.remove_spikes, holes=cfg.close_holes,
        smooth=cfg.smooth_mesh, target_faces=cfg.target_face_num)
    return verts32, np.asarray(tris, np.int32), colors


def create_mesh_from_scene(
    src_ply, dst_ply, cfg: MeshConfig = MeshConfig(), mvs_path=None,
    method: str = "auto",
):
    """Mesh entry with method selection: 'graphcut3d' consumes the .mvs
    visibility scene (OpenMVS-equivalent), '2.5d' is the xy-Delaunay
    heightfield, 'auto' prefers graph-cut when the scene exists and has a
    surface to offer (reference batch_run_mesh scans fusion/*.mvs the same
    way, createmesh.py:175-214)."""
    import os

    if method in ("auto", "graphcut3d") and mvs_path and os.path.exists(
            str(mvs_path)):
        out = reconstruct_graphcut_from_mvs(mvs_path, cfg)
        if out is not None:
            verts, faces, colors = out
            write_mesh_ply(dst_ply, verts, faces, colors)
            return verts, faces
        if method == "graphcut3d":
            raise RuntimeError(
                "graphcut3d requested but the graph cut gave no surface "
                f"for {mvs_path} (under 16 points, or an error code from "
                "the native core)"
            )
    return create_mesh_from_ply(src_ply, dst_ply, cfg)
