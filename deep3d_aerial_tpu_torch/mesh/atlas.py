"""UV texture atlas — full TextureMesh-stage equivalent.

The reference wraps the OpenMVS ``TextureMesh`` binary
(createmesh.py:115-142), whose essence is: label every face with its best
observing view (MRF-smoothed), grow contiguous same-label charts, pack the
charts' image-space footprints into one atlas image, and emit a mesh whose
faces carry per-corner UVs into that atlas
(``scene_dense_mesh_refine_texture_*.ply`` + ``.png``, SURVEY §2.8).

This is the redesign of that algorithm in vectorized NumPy:

1. per-face view scores = cos(face normal, ray to camera) gated on all
   three projected corners being in-frame → argmax label;
2. label smoothing = iterative majority vote over the face-adjacency graph
   restricted to views valid for the face (the graph-cut seam term's
   cheap fixpoint analog);
3. charts = connected components of same-label faces; each chart's texels
   are a 1:1 crop of its view image (texel == source pixel, exactly the
   OpenMVS resolution-preserving choice);
4. shelf packing into a power-of-two atlas, 2-texel gutters;
5. writers for PLY-with-texcoords (``comment TextureFile``, per-face
   ``property list uchar float texcoord`` — the OpenMVS output grammar)
   and OBJ+MTL.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .texture import TextureView


# --------------------------------------------------------------- labeling
def _project(vertices: np.ndarray, view: TextureView):
    """Pixel coords (u, v), cam-z for every vertex in `view`."""
    g = view.geom
    T = np.asarray(g.T_cw, np.float64)
    K = np.asarray(g.K, np.float64)
    cam = vertices @ T[:3, :3].T + T[:3, 3]
    z = cam[:, 2]
    uvw = cam @ K.T
    with np.errstate(divide="ignore", invalid="ignore"):
        u = uvw[:, 0] / uvw[:, 2]
        v = uvw[:, 1] / uvw[:, 2]
    return u, v, z


def face_view_labels(
    vertices: np.ndarray,
    faces: np.ndarray,
    views: Sequence[TextureView],
    smooth_iters: int = 2,
    outlier_threshold: float = 0.0,
    data_smoothness_ratio: float = 0.1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Best-view label per face ([F] int, -1 = unseen) + validity [F, V].

    `outlier_threshold` > 0 enables photo-outlier rejection
    (fOutlierThreshold): a view whose face color deviates from the
    cross-view median by more than the threshold (in [0,1] gray units —
    moving objects, specularities, misregistration) is excluded from the
    label competition for that face.

    `data_smoothness_ratio` (fRatioDataSmoothness, reference
    mesh/config.yaml TEXTUREMESH) trades label-data fidelity against chart
    compactness: a face only adopts the neighborhood-majority label when
    the view-score sacrifice is within `(1 - ratio)` of the full score
    range — ratio→1 keeps every face on its own best view (max quality),
    ratio→0 smooths freely (max chart compactness)."""
    n_f = len(faces)
    fv = vertices[faces]  # [F, 3, 3]
    centers = fv.mean(1)
    fn = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    fn /= np.linalg.norm(fn, axis=1, keepdims=True) + 1e-12
    flip = fn[:, 2] < 0  # 2.5D aerial: orient up
    fn[flip] = -fn[flip]

    scores = np.full((n_f, len(views)), -np.inf, np.float64)
    valid = np.zeros((n_f, len(views)), bool)
    fcol = np.full((n_f, len(views)), np.nan, np.float64)
    for vi, view in enumerate(views):
        H, W = view.image.shape[:2]
        u, v, z = _project(vertices, view)
        inb = (z > 1e-6) & (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
        f_ok = inb[faces].all(1)
        center = np.asarray(view.geom.T_wc, np.float64)[:3, 3]
        rays = center[None] - centers
        rays /= np.linalg.norm(rays, axis=1, keepdims=True) + 1e-12
        cosang = np.sum(rays * fn, axis=1)
        scores[f_ok, vi] = cosang[f_ok]
        valid[:, vi] = f_ok
        if outlier_threshold > 0 and f_ok.any():
            img = view.image
            gray = (np.asarray(img, np.float64).mean(-1)
                    if img.ndim == 3 else np.asarray(img, np.float64))
            if gray.max() > 1.5:
                gray = gray / 255.0
            cu = np.clip(np.round(u[faces].mean(1)), 0, W - 1).astype(int)
            cv = np.clip(np.round(v[faces].mean(1)), 0, H - 1).astype(int)
            fcol[f_ok, vi] = gray[cv[f_ok], cu[f_ok]]

    if outlier_threshold > 0:
        import warnings

        with np.errstate(invalid="ignore"), warnings.catch_warnings():
            # faces no view colors (all-NaN rows) are handled by has_inlier
            warnings.simplefilter("ignore", RuntimeWarning)
            med = np.nanmedian(fcol, axis=1)
            outlier = np.abs(fcol - med[:, None]) > outlier_threshold
        # never reject ALL views of a face
        keep_any = ~outlier & valid
        has_inlier = keep_any.any(1)
        scores[outlier & has_inlier[:, None]] = -np.inf
        valid = np.where(has_inlier[:, None], keep_any, valid)

    labels = np.where(valid.any(1), scores.argmax(1), -1)

    if smooth_iters > 0 and n_f:
        nbrs = _face_adjacency(faces)
        for _ in range(smooth_iters):
            changed = False
            for f in range(n_f):
                nls = [labels[o] for o in nbrs[f]
                       if labels[o] >= 0 and valid[f, labels[o]]]
                if not nls:
                    continue
                vals, cnt = np.unique(nls, return_counts=True)
                top = vals[cnt.argmax()]
                # adopt the neighborhood majority when it dominates AND
                # the data-score sacrifice stays within the smoothness
                # allowance (scores are cosines, full range = 2)
                if cnt.max() >= 2 and top != labels[f]:
                    if labels[f] >= 0:
                        sacrifice = scores[f, labels[f]] - scores[f, top]
                        if sacrifice > (1.0 - data_smoothness_ratio) * 2.0:
                            continue
                    labels[f] = top
                    changed = True
            if not changed:
                break
    return labels, valid


def _face_adjacency(faces: np.ndarray) -> List[List[int]]:
    """Faces sharing an edge, via a sorted-edge table (vectorized build)."""
    n_f = len(faces)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e.sort(1)
    fidx = np.tile(np.arange(n_f), 3)
    order = np.lexsort((e[:, 1], e[:, 0]))
    e, fidx = e[order], fidx[order]
    same = (e[1:] == e[:-1]).all(1)
    nbrs: List[List[int]] = [[] for _ in range(n_f)]
    for i in np.nonzero(same)[0]:
        a, b = fidx[i], fidx[i + 1]
        nbrs[a].append(b)
        nbrs[b].append(a)
    return nbrs


# ----------------------------------------------------------------- charts
def _charts(faces: np.ndarray, labels: np.ndarray) -> List[np.ndarray]:
    """Connected components of same-label faces (BFS over adjacency)."""
    nbrs = _face_adjacency(faces)
    seen = np.zeros(len(faces), bool)
    charts = []
    for seed in range(len(faces)):
        if seen[seed]:
            continue
        seen[seed] = True
        comp = [seed]
        stack = [seed]
        while stack:
            f = stack.pop()
            for o in nbrs[f]:
                if not seen[o] and labels[o] == labels[seed]:
                    seen[o] = True
                    comp.append(o)
                    stack.append(o)
        charts.append(np.asarray(comp))
    return charts


@dataclasses.dataclass
class TextureAtlas:
    image: np.ndarray       # [A, A, 3] uint8
    uv: np.ndarray          # [F, 3, 2] float32, origin bottom-left, in [0,1]
    labels: np.ndarray      # [F] int32 view index (-1 = unseen)


def build_texture_atlas(
    vertices: np.ndarray,
    faces: np.ndarray,
    views: Sequence[TextureView],
    smooth_iters: int = 2,
    gutter: int = 2,
    max_size: int = 8192,
    empty_color: Tuple[int, int, int] = (166, 166, 166),  # nColEmpty
    outlier_threshold: float = 0.0,   # fOutlierThreshold
    seam_level: bool = False,         # bLocalSeamLeveling
    global_seam_level: bool = False,  # bGlobalSeamLeveling
    size_multiple: int = 0,           # nTextureSizeMultiple (0 = pow2)
    packing_heuristic: int = 3,       # nRectPackingHeuristic
    data_smoothness_ratio: float = 0.1,  # fRatioDataSmoothness
) -> TextureAtlas:
    """Pack best-view image crops into one atlas; per-face-corner UVs."""
    n_f = len(faces)
    uv = np.zeros((n_f, 3, 2), np.float32)
    empty = np.asarray(empty_color, np.uint8)
    if n_f == 0 or not views:
        return TextureAtlas(np.broadcast_to(empty, (4, 4, 3)).copy(), uv,
                            np.full(n_f, -1, np.int32))

    labels, _ = face_view_labels(vertices, faces, views, smooth_iters,
                                 outlier_threshold=outlier_threshold,
                                 data_smoothness_ratio=data_smoothness_ratio)
    charts = _charts(faces, labels)

    # per-view vertex projections (reused across charts)
    proj = []
    for view in views:
        u, v, _ = _project(vertices, view)
        proj.append((u, v))

    # chart footprints: integer crop rects in the source image
    rects = []  # (w, h, chart_idx, x0, y0, view_idx)
    for ci, comp in enumerate(charts):
        lab = labels[comp[0]]
        if lab < 0:
            rects.append((2, 2, ci, 0, 0, -1))
            continue
        vids = np.unique(faces[comp].ravel())
        u, v = proj[lab]
        H, W = views[lab].image.shape[:2]
        x0 = int(np.clip(np.floor(u[vids].min()), 0, W - 1))
        x1 = int(np.clip(np.ceil(u[vids].max()), 0, W - 1))
        y0 = int(np.clip(np.floor(v[vids].min()), 0, H - 1))
        y1 = int(np.clip(np.ceil(v[vids].max()), 0, H - 1))
        rects.append((x1 - x0 + 1, y1 - y0 + 1, ci, x0, y0, lab))

    pos, atlas_w = _pack_charts(rects, gutter, max_size,
                                size_multiple, packing_heuristic)
    atlas = np.empty((atlas_w, atlas_w, 3), np.uint8)
    atlas[:] = empty

    for ci, comp in enumerate(charts):
        w, h, _, x0, y0, lab = rects[ci]
        ax, ay = pos[ci]
        if lab >= 0:
            img = views[lab].image
            crop = img[y0:y0 + h, x0:x0 + w]
            if crop.dtype != np.uint8:
                crop = np.clip(crop * 255.0, 0, 255).astype(np.uint8)
            if crop.ndim == 2:
                crop = np.dstack([crop] * 3)
            atlas[ay:ay + h, ax:ax + w] = crop[..., :3]
            u, v = proj[lab]
            fu = (u[faces[comp]] - x0 + ax) / atlas_w
            fv = (v[faces[comp]] - y0 + ay) / atlas_w
            uv[comp, :, 0] = np.clip(fu, 0, 1)
            uv[comp, :, 1] = np.clip(1.0 - fv, 0, 1)  # bottom-left origin
        else:
            uv[comp] = [(ax + 1) / atlas_w, 1.0 - (ay + 1) / atlas_w]

    if global_seam_level and len(charts) > 1:
        _global_seam_level(atlas, vertices, faces, charts, labels, rects,
                           pos, proj, views)
    if seam_level and len(charts) > 1:
        _local_seam_level(atlas, vertices, faces, charts, labels, rects, pos,
                          proj, views)
    return TextureAtlas(atlas, uv, labels.astype(np.int32))


def _seam_samples(vertices, faces, charts, labels, proj, views):
    """vertex id -> list of (chart index, sampled rgb float64[3]) for
    every chart whose source view sees that vertex (shared vertices are
    the texture seams both leveling modes reason about)."""
    samples: dict = {}
    for ci, comp in enumerate(charts):
        lab = labels[comp[0]]
        if lab < 0:
            continue
        img = views[lab].image
        if img.dtype != np.uint8:
            img = np.clip(np.asarray(img, np.float64) * 255, 0, 255)
        if img.ndim == 2:
            img = np.dstack([img] * 3)
        H, W = img.shape[:2]
        u, v = proj[lab]
        for vid in np.unique(faces[comp].ravel()):
            x = int(np.clip(round(u[vid]), 0, W - 1))
            y = int(np.clip(round(v[vid]), 0, H - 1))
            samples.setdefault(int(vid), []).append(
                (ci, np.asarray(img[y, x][:3], np.float64)))
    return samples


def _apply_chart_offsets(atlas, offsets, rects, pos):
    for ci, off in offsets.items():
        w, h, _, _, _, lab = rects[ci]
        if lab < 0 or ci not in pos:
            continue
        ax, ay = pos[ci]
        region = atlas[ay:ay + h, ax:ax + w].astype(np.float64) + off
        atlas[ay:ay + h, ax:ax + w] = np.clip(region, 0, 255).astype(np.uint8)


def _local_seam_level(atlas, vertices, faces, charts, labels, rects, pos,
                      proj, views):
    """bLocalSeamLeveling analog: per-chart constant RGB offset so seam
    vertices agree with the mean color all adjacent charts sample there.
    (OpenMVS solves a smooth leveling field; the constant-per-chart
    offset is the zeroth-order term and removes the dominant exposure
    steps between views.)"""
    samples = _seam_samples(vertices, faces, charts, labels, proj, views)
    # per-chart offset = mean over its multi-chart vertices of
    # (cross-chart mean - own sample)
    acc: dict = {}
    for vid, lst in samples.items():
        if len(lst) < 2:
            continue
        mean = np.mean([c for _, c in lst], axis=0)
        for ci, col in lst:
            acc.setdefault(ci, []).append(mean - col)
    _apply_chart_offsets(
        atlas, {ci: np.mean(d, axis=0) for ci, d in acc.items()}, rects, pos)


def _global_seam_level(atlas, vertices, faces, charts, labels, rects, pos,
                       proj, views, reg: float = 1e-3, iters: int = 200):
    """bGlobalSeamLeveling analog: per-chart RGB offsets solved JOINTLY
    over the whole chart graph — minimize
    sum_seam-pairs ||(o_i + c_i) - (o_j + c_j)||^2 + reg * sum ||o_i||^2.

    Unlike the local pass (each chart independently matches its own seam
    means) the joint solve propagates exposure corrections across chains
    of charts that never touch directly — OpenMVS's global leveling term.
    Solved matrix-free by Jacobi iteration on the chart-graph Laplacian
    (diagonally dominant for reg > 0), so chart count is unbounded."""
    samples = _seam_samples(vertices, faces, charts, labels, proj, views)
    n_ch = len(charts)
    deg = np.zeros(n_ch, np.float64)
    b = np.zeros((n_ch, 3), np.float64)
    pair_i: List[int] = []
    pair_j: List[int] = []
    for vid, lst in samples.items():
        if len(lst) < 2:
            continue
        for a in range(len(lst)):
            for c in range(len(lst)):
                if a == c:
                    continue
                ci, coli = lst[a]
                cj, colj = lst[c]
                deg[ci] += 1.0
                b[ci] += colj - coli
                pair_i.append(ci)
                pair_j.append(cj)
    if not pair_i:
        return
    pi = np.asarray(pair_i)
    pj = np.asarray(pair_j)
    off = np.zeros((n_ch, 3), np.float64)
    denom = (deg + reg)[:, None]
    for _ in range(iters):
        nbr_sum = np.zeros((n_ch, 3), np.float64)
        np.add.at(nbr_sum, pi, off[pj])
        new = (b + nbr_sum) / denom
        if np.abs(new - off).max() < 1e-6:
            off = new
            break
        off = new
    _apply_chart_offsets(
        atlas, {ci: off[ci] for ci in np.unique(pi)}, rects, pos)


def _round_size(n: int, multiple: int) -> int:
    """Atlas side length rule — nTextureSizeMultiple: 0 = next power of
    two (OpenMVS default), k > 0 = next multiple of k."""
    n = max(int(n), 1)
    if multiple <= 0:
        return 1 << int(np.ceil(np.log2(n)))
    return int(np.ceil(n / multiple)) * multiple


def _pack_charts(rects, gutter, max_size, size_multiple, heuristic):
    """Pack chart rects into the smallest square honoring the size rule.

    nRectPackingHeuristic mapping (redesign of the OpenMVS rect-packer
    family — same knob role, our packers):
      0 shelf, height-sorted   1 shelf, width-sorted
      2 shelf, area-sorted     >=3 skyline bottom-left (default; tightest)
    """
    if heuristic == 1:
        key = lambda i: -rects[i][0]
    elif heuristic == 2:
        key = lambda i: -(rects[i][0] * rects[i][1])
    else:
        key = lambda i: -rects[i][1]
    order = sorted(range(len(rects)), key=key)
    need = max(max(max(r[0], r[1]) for r in rects) + 2 * gutter, 64)
    atlas_w = _round_size(need, size_multiple)
    while True:
        if heuristic >= 3:
            pos, ok = _skyline_pack(rects, order, atlas_w, atlas_w, gutter)
        else:
            pos, ok = _shelf_pack(rects, order, atlas_w, atlas_w, gutter)
        if ok or atlas_w >= max_size:
            return pos, atlas_w
        atlas_w = min(_round_size(atlas_w + max(atlas_w // 2, 1),
                                  size_multiple), max(max_size, 1))


def _skyline_pack(rects, order, W, H, gutter):
    """Bottom-left skyline packing over a segment list; places each rect
    at the lowest (then leftmost) position — tighter than shelves for
    the mixed chart sizes an aerial block produces."""
    segs = [(0, W, 0)]  # (x, width, height) left-to-right
    pos = {}

    def height_over(x, w):
        top = 0
        for sx, sw, sh in segs:
            if sx + sw <= x or sx >= x + w:
                continue
            top = max(top, sh)
        return top

    for i in order:
        w, h = rects[i][0] + 2 * gutter, rects[i][1] + 2 * gutter
        if w > W:
            return pos, False
        best = None  # (y, x)
        for sx, _sw, _sh in segs:
            if sx + w > W:
                continue
            y = height_over(sx, w)
            if best is None or (y, sx) < best:
                best = (y, sx)
        if best is None or best[0] + h > H:
            return pos, False
        y, x = best
        pos[rects[i][2]] = (x + gutter, y + gutter)
        # splice the new plateau [x, x+w) at height y+h into the skyline
        new_segs = []
        for sx, sw, sh in segs:
            if sx + sw <= x or sx >= x + w:
                new_segs.append((sx, sw, sh))
                continue
            if sx < x:
                new_segs.append((sx, x - sx, sh))
            if sx + sw > x + w:
                new_segs.append((x + w, sx + sw - (x + w), sh))
        new_segs.append((x, w, y + h))
        new_segs.sort()
        # merge equal-height neighbors
        segs = []
        for s in new_segs:
            if segs and segs[-1][2] == s[2] \
                    and segs[-1][0] + segs[-1][1] == s[0]:
                segs[-1] = (segs[-1][0], segs[-1][1] + s[1], s[2])
            else:
                segs.append(s)
    return pos, True


def _shelf_pack(rects, order, W, H, gutter):
    """Greedy shelves; returns ({chart: (x, y)}, fits_flag)."""
    pos = {}
    x = y = shelf_h = 0
    for i in order:
        w, h = rects[i][0] + 2 * gutter, rects[i][1] + 2 * gutter
        if x + w > W:
            y += shelf_h
            x = shelf_h = 0
        if y + h > H or w > W:
            return pos, False
        pos[rects[i][2]] = (x + gutter, y + gutter)
        x += w
        shelf_h = max(shelf_h, h)
    return pos, True


# ---------------------------------------------------------------- writers
def write_textured_mesh_ply(
    path,
    vertices: np.ndarray,
    faces: np.ndarray,
    uv: np.ndarray,
    texture_file: str,
) -> None:
    """Binary PLY with per-face texcoord lists + TextureFile comment
    (the OpenMVS textured-mesh grammar the reference pipeline emits)."""
    vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
    faces = np.asarray(faces, np.int32).reshape(-1, 3)
    uv = np.asarray(uv, np.float32).reshape(-1, 3, 2)
    n, m = len(vertices), len(faces)
    header = [
        "ply", "format binary_little_endian 1.0",
        f"comment TextureFile {texture_file}",
        f"element vertex {n}",
        "property float x", "property float y", "property float z",
        f"element face {m}",
        "property list uchar int vertex_indices",
        "property list uchar float texcoord",
        "end_header",
    ]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        vrec = np.empty(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4")])
        vrec["x"], vrec["y"], vrec["z"] = vertices.T
        vrec.tofile(f)
        frec = np.empty(m, dtype=[("k", "u1"), ("i", "<i4", 3),
                                  ("t", "u1"), ("uv", "<f4", 6)])
        frec["k"] = 3
        frec["i"] = faces
        frec["t"] = 6
        frec["uv"] = uv.reshape(-1, 6)
        frec.tofile(f)


def read_textured_mesh_ply(path):
    """Read back (vertices, faces, uv [F,3,2], texture_file)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY")
        n_vertex = n_face = 0
        texture_file = None
        element = None
        while True:
            tokens = f.readline().strip().decode("ascii", "replace").split()
            if not tokens:
                continue
            if tokens[0] == "comment" and len(tokens) >= 3 \
                    and tokens[1] == "TextureFile":
                texture_file = tokens[2]
            elif tokens[0] == "element":
                element = tokens[1]
                if element == "vertex":
                    n_vertex = int(tokens[2])
                else:
                    n_face = int(tokens[2])
            elif tokens[0] == "end_header":
                break
        vrec = np.fromfile(f, dtype=[("x", "<f4"), ("y", "<f4"),
                                     ("z", "<f4")], count=n_vertex)
        verts = np.stack([vrec["x"], vrec["y"], vrec["z"]], -1)
        faces = np.empty((n_face, 3), np.int32)
        uv = np.empty((n_face, 3, 2), np.float32)
        for i in range(n_face):
            (k,) = struct.unpack("<B", f.read(1))
            faces[i] = np.frombuffer(f.read(4 * k), "<i4")[:3]
            (t,) = struct.unpack("<B", f.read(1))
            uv[i] = np.frombuffer(f.read(4 * t), "<f4")[:6].reshape(3, 2)
    return verts, faces, uv, texture_file


def write_textured_mesh_obj(
    path,
    vertices: np.ndarray,
    faces: np.ndarray,
    uv: np.ndarray,
    texture_file: str,
) -> None:
    """OBJ + MTL companion (broad-viewer interop)."""
    path = os.fspath(path)
    mtl = os.path.splitext(path)[0] + ".mtl"
    with open(mtl, "w") as f:
        f.write("newmtl textured\nKd 1 1 1\n"
                f"map_Kd {texture_file}\n")
    with open(path, "w") as f:
        f.write(f"mtllib {os.path.basename(mtl)}\nusemtl textured\n")
        for v in np.asarray(vertices, np.float32):
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        uvf = np.asarray(uv, np.float32).reshape(-1, 2)
        for t in uvf:
            f.write(f"vt {t[0]} {t[1]}\n")
        fa = np.asarray(faces, np.int64)
        for i, tri in enumerate(fa):
            a, b, c = tri + 1
            ta, tb, tc = 3 * i + 1, 3 * i + 2, 3 * i + 3
            f.write(f"f {a}/{ta} {b}/{tb} {c}/{tc}\n")


def texture_atlas_mesh_file(
    src_ply,
    dst_ply,
    views: Sequence[TextureView],
    smooth_iters: int = 2,
    write_obj: bool = False,
    **atlas_kwargs,
) -> TextureAtlas:
    """File entry: mesh PLY -> atlas-textured PLY + PNG (+ optional OBJ).
    `atlas_kwargs` forward to :func:`build_texture_atlas` (empty_color,
    outlier_threshold, seam/global seam leveling, packing knobs...)."""
    from .trimesh_io import read_mesh_ply

    verts, faces = read_mesh_ply(src_ply)
    res = build_texture_atlas(verts, faces, views, smooth_iters=smooth_iters,
                              **atlas_kwargs)
    png = os.path.splitext(os.fspath(dst_ply))[0] + ".png"
    from PIL import Image

    Image.fromarray(res.image).save(png)
    write_textured_mesh_ply(dst_ply, verts, faces, res.uv,
                            os.path.basename(png))
    if write_obj:
        write_textured_mesh_obj(
            os.path.splitext(os.fspath(dst_ply))[0] + ".obj",
            verts, faces, res.uv, os.path.basename(png))
    return res
