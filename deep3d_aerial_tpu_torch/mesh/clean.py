"""Mesh cleanup — the RECONSTRUCTMESH "Clean options" block.

The reference forwards these flags to the OpenMVS binary
(createmesh.py:50-79; mesh/config.yaml:14-24): ``fRemoveSpurious``,
``bRemoveSpikes``, ``nCloseHoles``, ``nSmoothMesh``, ``nTargetFaceNum``.
This module implements each as a vectorized NumPy pass over the triangle
mesh; the entry points in reconstruct.py apply them after surface extraction.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _edge_table(faces: np.ndarray):
    """Sorted undirected edges [3F, 2] + owning face index [3F]."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    fidx = np.tile(np.arange(len(faces)), 3)
    e = np.sort(e, axis=1)
    return e, fidx


def face_components(faces: np.ndarray) -> np.ndarray:
    """Connected-component label per face (shared-edge adjacency),
    via union-find over the sorted edge table (no Python BFS)."""
    n_f = len(faces)
    parent = np.arange(n_f)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    e, fidx = _edge_table(faces)
    order = np.lexsort((e[:, 1], e[:, 0]))
    e, fidx = e[order], fidx[order]
    same = (e[1:] == e[:-1]).all(1)
    for i in np.nonzero(same)[0]:
        ra, rb = find(fidx[i]), find(fidx[i + 1])
        if ra != rb:
            parent[ra] = rb
    return np.fromiter((find(i) for i in range(n_f)), np.int64, n_f)


def remove_spurious(faces: np.ndarray, min_faces: int = 20) -> np.ndarray:
    """Drop connected components with fewer than `min_faces` triangles
    (fRemoveSpurious semantics — OpenMVS interprets the flag as a size
    threshold relative to the largest component percentage; we use the
    absolute face count, matching our native core)."""
    if len(faces) == 0 or min_faces <= 1:
        return faces
    comp = face_components(faces)
    _, inv, cnt = np.unique(comp, return_inverse=True, return_counts=True)
    return faces[cnt[inv] >= min_faces]


def remove_spikes(
    vertices: np.ndarray, faces: np.ndarray, sigma: float = 4.0,
    iterations: int = 3,
) -> np.ndarray:
    """Drop faces with an edge far beyond the median edge length
    (bRemoveSpikes: spike triangles from mis-triangulated outliers form
    long slivers; iterate since removal exposes new boundary spikes)."""
    faces = np.asarray(faces)
    for _ in range(iterations):
        if len(faces) == 0:
            break
        fv = vertices[faces]
        el = np.stack([
            np.linalg.norm(fv[:, 0] - fv[:, 1], axis=1),
            np.linalg.norm(fv[:, 1] - fv[:, 2], axis=1),
            np.linalg.norm(fv[:, 2] - fv[:, 0], axis=1),
        ], 1)
        med = np.median(el)
        keep = el.max(1) <= sigma * (med + 1e-12)
        if keep.all():
            break
        faces = faces[keep]
    return faces


def boundary_loops(faces: np.ndarray) -> List[np.ndarray]:
    """Closed vertex loops of boundary edges (edges with one face)."""
    if len(faces) == 0:
        return []
    e, _ = _edge_table(faces)
    order = np.lexsort((e[:, 1], e[:, 0]))
    es = e[order]
    same_prev = np.concatenate([[False], (es[1:] == es[:-1]).all(1)])
    same_next = np.concatenate([(es[1:] == es[:-1]).all(1), [False]])
    boundary = es[~same_prev & ~same_next]
    if len(boundary) == 0:
        return []
    # walk loops
    nxt = {}
    for a, b in boundary:
        nxt.setdefault(int(a), []).append(int(b))
        nxt.setdefault(int(b), []).append(int(a))
    visited = set()
    loops = []
    for start in nxt:
        if start in visited:
            continue
        loop = [start]
        visited.add(start)
        cur, prev = start, -1
        while True:
            cands = [v for v in nxt[cur] if v != prev and v not in visited]
            if not cands:
                # closed if we can return to start
                if start in nxt[cur] and len(loop) > 2:
                    loops.append(np.asarray(loop, np.int64))
                break
            prev, cur = cur, cands[0]
            visited.add(cur)
            loop.append(cur)
    return loops


def close_holes(
    vertices: np.ndarray, faces: np.ndarray, max_edges: int = 30,
) -> np.ndarray:
    """Fan-triangulate boundary loops with <= `max_edges` edges
    (nCloseHoles). The outermost boundary of an open terrain mesh is
    normally far longer than the threshold, so only interior holes close."""
    if max_edges < 3 or len(faces) == 0:
        return faces
    loops = boundary_loops(faces)
    add = []
    for loop in loops:
        if 3 <= len(loop) <= max_edges:
            # fan around the loop centroid index 0
            for i in range(1, len(loop) - 1):
                add.append((loop[0], loop[i], loop[i + 1]))
    if add:
        faces = np.concatenate([faces, np.asarray(add, faces.dtype)])
    return faces


def decimate_to_target(
    vertices: np.ndarray, faces: np.ndarray, colors, target_faces: int,
) -> Tuple[np.ndarray, np.ndarray, object]:
    """Vertex-cluster decimation until the face count is <= target
    (nTargetFaceNum; 0 = off)."""
    if target_faces <= 0 or len(faces) <= target_faces:
        return vertices, faces, colors
    from .refine import decimate_mesh

    ratio = target_faces / len(faces)
    return decimate_mesh(vertices, faces, ratio, colors)


def clean_mesh(
    vertices: np.ndarray,
    faces: np.ndarray,
    colors=None,
    remove_spurious_faces: int = 0,
    spikes: bool = False,
    holes: int = 0,
    smooth: int = 0,
    target_faces: int = 0,
):
    """Apply the full RECONSTRUCTMESH clean-block in OpenMVS order:
    spurious -> spikes -> holes -> smooth -> decimate."""
    if spikes:
        faces = remove_spikes(vertices, faces)
    if remove_spurious_faces > 1:
        faces = remove_spurious(faces, remove_spurious_faces)
    if holes >= 3:
        faces = close_holes(vertices, faces, holes)
    if smooth > 0 and len(faces):
        from .refine import RefineConfig, taubin_smooth

        vertices = taubin_smooth(
            vertices, faces, RefineConfig(iterations=smooth))
    if target_faces > 0:
        vertices, faces, colors = decimate_to_target(
            vertices, faces, colors, target_faces)
    return vertices, faces, colors
