"""Mesh refinement — RefineMesh-stage equivalent (reference wraps the
OpenMVS RefineMesh binary, createmesh.py:82-112); counterpart of
deep3d_aerial_tpu/mesh/refine.py.

Two layers: feature-preserving Taubin lambda/mu smoothing of vertex
positions (removes fusion noise without the shrinkage of plain Laplacian)
plus edge-collapse-free decimation by vertex clustering, in NumPy on the
host, and the variational photo-consistency refinement `photometric_refine`
below (OpenMVS RefineMesh's core — gradient descent on a multi-view photo
energy with a segment-sum Laplacian), in PyTorch autograd on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class RefineConfig:
    iterations: int = 10
    lamb: float = 0.5
    mu: float = -0.53
    decimate_ratio: float = 1.0  # keep fraction of vertices (<=1)


def vertex_adjacency(n_vertices: int, faces: np.ndarray):
    """CSR neighbor lists from triangle faces."""
    edges = np.concatenate([
        faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]],
        faces[:, [1, 0]], faces[:, [2, 1]], faces[:, [0, 2]],
    ])
    # unique directed edges
    key = edges[:, 0].astype(np.int64) * n_vertices + edges[:, 1]
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    keep = np.concatenate([[True], key_s[1:] != key_s[:-1]])
    e = edges[order][keep]
    counts = np.bincount(e[:, 0], minlength=n_vertices)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    return e[:, 1], offsets


def taubin_smooth(
    vertices: np.ndarray, faces: np.ndarray, cfg: RefineConfig = RefineConfig()
) -> np.ndarray:
    """Taubin smoothing: alternate positive/negative Laplacian steps."""
    v = np.asarray(vertices, np.float64).copy()
    n = len(v)
    if n == 0 or len(faces) == 0:
        return vertices.astype(np.float32)
    nbr, off = vertex_adjacency(n, faces)
    deg = np.maximum(np.diff(off), 1)

    def laplacian(x):
        sums = np.zeros_like(x)
        np.add.at(sums, np.repeat(np.arange(n), np.diff(off)), x[nbr])
        return sums / deg[:, None] - x

    for _ in range(cfg.iterations):
        v = v + cfg.lamb * laplacian(v)
        v = v + cfg.mu * laplacian(v)
    return v.astype(np.float32)


def decimate_mesh(
    vertices: np.ndarray,
    faces: np.ndarray,
    keep_ratio: float,
    colors: Optional[np.ndarray] = None,
):
    """Vertex-clustering decimation to ~keep_ratio of the vertices."""
    if keep_ratio >= 1.0 or len(vertices) < 16:
        return vertices, faces, colors
    # grid size chosen so expected occupied cells ~= keep_ratio * n
    bbox_min = vertices.min(0)
    extent = np.maximum(vertices.max(0) - bbox_min, 1e-9)
    target = max(4, int(len(vertices) * keep_ratio))
    cell = (extent[0] * extent[1] / target) ** 0.5 if extent[0] * extent[1] > 0 else 1.0
    key = np.floor((vertices[:, :2] - bbox_min[:2]) / max(cell, 1e-9)).astype(np.int64)
    h = key[:, 0] * 73856093 ^ key[:, 1] * 19349663

    uniq, inverse = np.unique(h, return_inverse=True)
    new_v = np.zeros((len(uniq), 3), np.float64)
    cnt = np.bincount(inverse)
    np.add.at(new_v, inverse, vertices)
    new_v /= cnt[:, None]

    new_c = None
    if colors is not None:
        new_c = np.zeros((len(uniq), 3), np.float64)
        np.add.at(new_c, inverse, colors.astype(np.float64))
        new_c = (new_c / cnt[:, None]).astype(np.uint8)

    new_f = inverse[faces]
    valid = (
        (new_f[:, 0] != new_f[:, 1]) & (new_f[:, 1] != new_f[:, 2])
        & (new_f[:, 0] != new_f[:, 2])
    )
    new_f = new_f[valid]
    # drop duplicate faces
    kf = np.sort(new_f, axis=1)
    _, first = np.unique(
        kf[:, 0] * len(uniq) * len(uniq) + kf[:, 1] * len(uniq) + kf[:, 2],
        return_index=True,
    )
    new_f = new_f[np.sort(first)]
    return new_v.astype(np.float32), new_f.astype(np.int32), new_c


def refine_mesh_file(src_ply, dst_ply, cfg: RefineConfig = RefineConfig()):
    """File entry matching the reference RefineMesh stage."""
    from .trimesh_io import read_mesh_ply, write_mesh_ply

    verts, faces = read_mesh_ply(src_ply)
    verts = taubin_smooth(verts, faces, cfg)
    verts, faces, _ = decimate_mesh(verts, faces, cfg.decimate_ratio)
    write_mesh_ply(dst_ply, verts, faces)
    return verts, faces


@dataclasses.dataclass
class PhotoRefineConfig:
    """Variational photo-consistency refinement knobs (the OpenMVS
    RefineMesh core — reference flag surface createmesh.py:82-112)."""

    scales: int = 2               # --scales (coarse-to-fine passes)
    iterations: int = 20          # gradient steps per scale
    gradient_step: float = 0.05   # --gradient-step (x mean edge length)
    regularity_weight: float = 0.2  # --regularity-weight (Laplacian pull)
    max_views: int = 8            # --max-views per vertex
    # photo energy: 'zncc' = 1 - mean pairwise ZNCC of tangent-plane image
    # patches across views (the OpenMVS RefineMesh energy family);
    # 'variance' = per-vertex single-pixel color variance (round-2 energy,
    # kept as the cheap option)
    energy: str = "zncc"
    patch_radius: int = 1         # ZNCC patch = (2r+1)^2 tangent taps
    patch_scale: float = 1.0      # tap spacing x mean edge length


def photometric_refine(
    vertices: np.ndarray,          # [N, 3]
    faces: np.ndarray,             # [F, 3]
    views,                         # [(image [H,W,3] float, K [3,3], T_cw [4,4])]
    cfg: PhotoRefineConfig = PhotoRefineConfig(),
    device: "str | torch.device" = "cuda",
) -> np.ndarray:
    """Variational photo-consistency refinement on `device` (a CUDA device
    unless the caller asks for the CPU): move each vertex along its normal
    down the gradient of a multi-view photo energy with a Laplacian
    regularity term (the gradient-descent essence of OpenMVS RefineMesh;
    coarse-to-fine via `scales` progressively shrinks the step). The
    energy is a plain function of the vertex tensor; its gradient comes
    from `torch.autograd.grad`.

    cfg.energy='zncc' (default): per vertex, a (2r+1)^2 patch of points on
    the vertex's tangent plane is projected into every view; the energy is
    1 - mean pairwise zero-normalized cross-correlation of the sampled
    patches — OpenMVS's patch-consistency energy (exposure/bias invariant,
    unlike raw color variance). 'variance' keeps the round-2 single-pixel
    variance energy.

    The mesh is used at its own size: no vertex, edge or face is padded,
    so every vertex, the last one too, sees only its own edges. The
    Laplacian's scatter-add is an `index_add`, atomic on CUDA, so two runs
    on the card can differ in the last bits. The vertex normals, which set
    each step's direction and the patches' orientation, are computed alike
    on every device: their cross products without fused multiply-adds
    (`_cross`) and their sums in one fixed order (`_corner_passes`)."""
    v0 = np.asarray(vertices, np.float32)
    if len(v0) == 0 or len(faces) == 0 or not views:
        return v0
    mesh, v, mean_edge = refine_setup(v0, faces, views, cfg, device)
    for s in range(cfg.scales):
        step = cfg.gradient_step * mean_edge * (0.5 ** s)
        for _ in range(cfg.iterations):
            v = refine_update(mesh, v, step)
    return v.cpu().numpy().astype(np.float32)


def refine_setup(v0: np.ndarray, faces: np.ndarray, views,
                 cfg: PhotoRefineConfig, device):
    """(the refinement's tensors on `device`, the vertices as a tensor
    there, the mean edge length) for a mesh with at least one face."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("photometric_refine: no CUDA device; pass "
                           "device='cpu' to run on the CPU")
    n = len(v0)
    views = views[: cfg.max_views]

    nbr, off = vertex_adjacency(n, faces)
    counts = np.diff(off)
    passes = _corner_passes(n, faces)
    edge = v0[faces[:, 0]] - v0[faces[:, 1]]
    mean_edge = float(np.linalg.norm(edge, axis=1).mean() + 1e-9)

    # tangent-plane patch taps for the ZNCC energy: (2r+1)^2 offsets in
    # mean-edge units ((0, 0) first so 'variance' mode can reuse tap 0)
    r = max(0, int(cfg.patch_radius))
    grid = [(0.0, 0.0)] + [
        (float(a), float(b))
        for a in range(-r, r + 1) for b in range(-r, r + 1)
        if (a, b) != (0, 0)
    ]

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    imgs = t(np.stack([
        np.asarray(im, np.float32).mean(-1) if np.asarray(im).ndim == 3
        else np.asarray(im, np.float32) for im, _, _ in views]))
    mesh = RefineTensors(
        faces=t(faces, torch.long),
        corner_passes=[(t(r, torch.long), t(f, torch.long)) for r, f in passes],
        nbr=t(nbr, torch.long),
        rows=t(np.repeat(np.arange(n), counts), torch.long),
        deg=t(np.maximum(counts, 1).astype(np.float32)),
        connected=t((counts > 0).astype(np.float32)),
        Ks=t(np.stack([np.asarray(k, np.float32) for _, k, _ in views])),
        Ts=t(np.stack([np.asarray(tt, np.float32) for _, _, tt in views])),
        imgs=imgs, taps=t(np.asarray(grid, np.float32)
                          * (cfg.patch_scale * mean_edge)),
        mode=cfg.energy, reg_w=float(cfg.regularity_weight))
    return mesh, t(v0), mean_edge


def _corner_passes(n: int, faces: np.ndarray):
    """The face corners of each vertex in the order the JAX package's
    scatter adds them (corner slot k = 0, 1, 2, then face), dealt into
    passes [(vertices, faces)]: pass r holds each vertex's r-th corner, so
    no vertex appears twice in a pass. Adding pass by pass sums every
    vertex's face normals in that one order on any device: a vertex whose
    faces' normals nearly cancel gets the same normal on the card as on the
    CPU, where an atomic scatter-add would give it any direction."""
    vert = faces.T.ravel().astype(np.int64)        # slot-major: (k, face)
    face = np.tile(np.arange(len(faces)), 3)
    order = np.argsort(vert, kind="stable")
    vert, face = vert[order], face[order]
    first = np.searchsorted(vert, np.arange(n))
    rank = np.arange(len(vert)) - first[vert]
    return [(vert[rank == r], face[rank == r]) for r in range(int(rank.max()) + 1)]


@dataclasses.dataclass
class RefineTensors:
    """The tensors one refinement reads, on its device: faces [F, 3] and
    their corners in passes (`_corner_passes`), the directed edges as
    (rows -> nbr) with each vertex's degree (>= 1) and whether it has any
    edge, the views' K [V, 3, 3], T_cw [V, 4, 4] and grey images [V, H, W],
    and the patch taps [P, 2]."""

    faces: torch.Tensor
    corner_passes: list
    nbr: torch.Tensor
    rows: torch.Tensor
    deg: torch.Tensor
    connected: torch.Tensor
    Ks: torch.Tensor
    Ts: torch.Tensor
    imgs: torch.Tensor
    taps: torch.Tensor
    mode: str
    reg_w: float


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, one PyTorch op per product and difference,
    so that no device contracts them into fused multiply-adds: the card and
    the CPU round alike."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def _vertex_normals(m: "RefineTensors", v: torch.Tensor) -> torch.Tensor:
    """Unit area-weighted vertex normals (zero for a vertex in no face)."""
    e1 = v[m.faces[:, 1]] - v[m.faces[:, 0]]
    e2 = v[m.faces[:, 2]] - v[m.faces[:, 0]]
    fn = _cross(e1, e2)
    vn = torch.zeros_like(v)
    for rows, face in m.corner_passes:
        vn = vn.index_add(0, rows, fn[face])
    return vn / (torch.linalg.norm(vn, dim=1, keepdim=True) + 1e-12)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip with its gradient: at a bound that x equals, the gradient
    is split 0.5/0.5 (torch.maximum/minimum split ties as jnp's do;
    torch.clamp would pass 1)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _sample(imgs: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear taps of imgs [V, H, W] at x, y [V, ...] (the JAX sampler:
    the cell's corner clipped into the image, the fractions into [0, 1])."""
    V, Hh, Ww = imgs.shape
    x0 = _clip(torch.floor(x), 0, Ww - 2)
    y0 = _clip(torch.floor(y), 0, Hh - 2)
    fx = _clip(x - x0, 0, 1)
    fy = _clip(y - y0, 0, 1)
    x0 = x0.long()
    y0 = y0.long()
    flat = imgs.reshape(V, -1)

    def tap(yi, xi):
        idx = (yi * Ww + xi).reshape(V, -1)
        return torch.gather(flat, 1, idx).reshape(x.shape)

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def _project_sample(m: RefineTensors, pts: torch.Tensor):
    """pts [N, P, 3] world points -> samples [V, N, P], inb [V, N, P]
    (elementwise projective chain, every view at once)."""
    V, Hh, Ww = m.imgs.shape
    R = m.Ts[:, :3, :3].reshape(V, 1, 1, 3, 3)
    tt = m.Ts[:, :3, 3].reshape(V, 1, 1, 3)
    cam = [R[..., a, 0] * pts[..., 0] + R[..., a, 1] * pts[..., 1]
           + R[..., a, 2] * pts[..., 2] + tt[..., a] for a in range(3)]
    K = m.Ks.reshape(V, 1, 1, 3, 3)
    z = torch.maximum(cam[2], cam[2].new_tensor(1e-6))
    x = K[..., 0, 0] * cam[0] / z + K[..., 0, 2]
    y = K[..., 1, 1] * cam[1] / z + K[..., 1, 2]
    inb = ((x >= 0) & (x <= Ww - 1) & (y >= 0) & (y <= Hh - 1)
           & (cam[2] > 1e-6))
    return _sample(m.imgs, x, y), inb


def _tangent_frame(m: RefineTensors, v: torch.Tensor):
    """Per-vertex orthonormal tangent basis from detached normals — the
    patch orientation is held fixed per step, as OpenMVS holds its patch
    parameterization per iteration."""
    nrm = _vertex_normals(m, v).detach()
    a = torch.where(torch.abs(nrm[:, :1]) < 0.9,
                    nrm.new_tensor([[1.0, 0.0, 0.0]]),
                    nrm.new_tensor([[0.0, 1.0, 0.0]]))
    t1 = _cross(nrm, a.expand_as(nrm))
    t1 = t1 / (torch.linalg.norm(t1, dim=1, keepdim=True) + 1e-12)
    t2 = _cross(nrm, t1)
    return t1, t2


def refine_energy(m: RefineTensors, v: torch.Tensor) -> torch.Tensor:
    """The refinement's energy at vertices v [N, 3]: photo term + reg_w x
    mean squared umbrella Laplacian."""
    n = v.shape[0]
    if m.mode == "zncc":
        # 1 - mean pairwise ZNCC of tangent-plane patches (OpenMVS's
        # patch-consistency energy: invariant to per-view gain/bias)
        t1, t2 = _tangent_frame(m, v)
        pts = (v[:, None, :]
               + m.taps[None, :, 0:1] * t1[:, None, :]
               + m.taps[None, :, 1:2] * t2[:, None, :])  # [N, P, 3]
        cols, inb = _project_sample(m, pts)  # [V, N, P]
        w = inb.all(-1).float()  # [V, N]
        P = cols.shape[-1]
        mu = cols.mean(-1, keepdim=True)
        # eps INSIDE the sqrt: d/dx sqrt(x) blows up at the perfectly
        # flat patches a checkered/untextured surface produces
        sd = torch.sqrt(((cols - mu) ** 2).mean(-1, keepdim=True) + 1e-6)
        norm = (cols - mu) / sd * w[..., None]  # [V, N, P]
        cnt = torch.clamp_min(w.sum(0), 1.0)  # [N]
        # mean pairwise zncc = (|sum_v p_v|^2 - sum_v |p_v|^2) /
        #                      (P * cnt * (cnt - 1))
        ssum = (norm.sum(0) ** 2).sum(-1)
        self_ = (norm ** 2).sum(-1).sum(0)
        denom = torch.clamp_min(cnt * (cnt - 1.0), 1.0) * P
        zncc = (ssum - self_) / denom
        score = torch.where(w.sum(0) >= 2, 1.0 - zncc, 0.0)
        photo = score.sum() / n
    else:
        cols, inb = _project_sample(m, v[:, None, :])
        cols = cols[..., 0]
        w = inb[..., 0].float()  # [V, N]
        cnt = torch.clamp_min(w.sum(0), 1.0)
        mean = (cols * w).sum(0) / cnt
        var = ((cols - mean) ** 2 * w).sum(0) / cnt
        photo = torch.where(w.sum(0) >= 2, var, 0.0).sum() / n
    nbr_sum = torch.zeros_like(v).index_add(0, m.rows, v[m.nbr])
    lap = (nbr_sum / m.deg[:, None] - v) * m.connected[:, None]
    reg = (lap ** 2).sum(-1).sum() / n
    return photo + m.reg_w * reg


def refine_update(m: RefineTensors, v: torch.Tensor, step: float) -> torch.Tensor:
    """One gradient step: along each vertex's normal, by `step` at the
    vertex whose normal gradient is largest."""
    with torch.enable_grad():
        vg = v.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(refine_energy(m, vg), vg)
    with torch.no_grad():
        nrm = _vertex_normals(m, v)
        # move along the normal only (tangential drift destroys the
        # parameterization — same constraint OpenMVS applies)
        gn = torch.sum(g * nrm, dim=1, keepdim=True)
        gnorm = torch.clamp_min(torch.abs(gn).max(), 1e-12)
        return v - step * (gn / gnorm) * nrm
