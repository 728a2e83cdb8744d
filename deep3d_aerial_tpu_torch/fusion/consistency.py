"""Multi-view geometric/photometric/normal consistency check, PyTorch on the
device (counterpart of deep3d_aerial_tpu/fusion/consistency.py).

Same decision rule: reproject the ref depth into each src view, read the src
depth/normal at the (rounded) landing pixel, project that src estimate back
into the ref view, and accept when
      reprojection distance < position_threshold (px)
   && |depth_reprojected - depth_ref| / depth_ref < depth_threshold
   && ref confidence > confidence_threshold
   && world-normal cosine > cos(normal_threshold)
   && depth_ref > 0, the landing pixel in-bounds and its src depth > 0.

All matrix inverses are precomputed on the host in float64 (ViewGeometry);
the device part is fp32 elementwise math plus one gather, batched over the
source views. It is plain tensor code, not a kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass
class ViewGeometry:
    """Per-view projective data with host-precomputed float64 inverses."""

    K: np.ndarray  # (3,3)
    T_cw: np.ndarray  # (4,4)
    K_inv: np.ndarray
    T_wc: np.ndarray
    R_wc: np.ndarray  # (3,3) = inv(R_cw), for normal transport

    @classmethod
    def create(cls, K: np.ndarray, T_cw: np.ndarray) -> "ViewGeometry":
        K = np.asarray(K, np.float64)
        T_cw = np.asarray(T_cw, np.float64)
        return cls(
            K=K.astype(np.float32),
            T_cw=T_cw.astype(np.float32),
            K_inv=np.linalg.inv(K).astype(np.float32),
            T_wc=np.linalg.inv(T_cw).astype(np.float32),
            R_wc=np.linalg.inv(T_cw[:3, :3]).astype(np.float32),
        )

    def as_stack(self) -> np.ndarray:
        """Pack into one [5, 4, 4] array (a single device operand)."""
        out = np.zeros((5, 4, 4), np.float32)
        out[0, :3, :3] = self.K
        out[1] = self.T_cw
        out[2, :3, :3] = self.K_inv
        out[3] = self.T_wc
        out[4, :3, :3] = self.R_wc
        return out


def _mm3(v: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """[..., 3] x [..., 3, 3]^T product spelled elementwise, one rounding
    per op as in the JAX package (a TF32 matmul on the card would lose the
    low mantissa bits of world-scale coordinates)."""
    M = M[..., None, None, :, :]  # broadcast over the pixel axes
    return torch.stack(
        [v[..., 0] * M[..., a, 0] + v[..., 1] * M[..., a, 1]
         + v[..., 2] * M[..., a, 2] for a in range(3)],
        dim=-1,
    )


def _translate(v: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    return _mm3(v, T[..., :3, :3]) + T[..., None, None, :3, 3]


def _safe(w: torch.Tensor) -> torch.Tensor:
    return torch.where(w.abs() < 1e-8, torch.full_like(w, 1e-8), w)


def consistency_check(
    depth_ref: torch.Tensor,  # [H, W]
    normal_ref_world: torch.Tensor,  # [H, W, 3] (unit, world frame)
    geom_ref: torch.Tensor,  # [5, 4, 4] ViewGeometry.as_stack()
    depth_src: torch.Tensor,  # [S, H, W]
    normal_src: torch.Tensor,  # [S, H, W, 3] (camera frame of each src)
    geom_src: torch.Tensor,  # [S, 5, 4, 4]
    prob_ref: torch.Tensor,  # [H, W]
    position_threshold: float = 1.0,
    depth_threshold: float = 0.01,
    normal_cos_threshold: float = 0.0,  # cos(90 deg)
    confidence_threshold: float = 0.2,
) -> Dict[str, torch.Tensor]:
    """Check one ref view against S source views at once. Returns a dict
    of [S, ...] tensors:
      mask              [S, H, W] bool  -- consistent pixels
      depth_reprojected [S, H, W]       -- src-supported ref depth (0 where ~mask)
      xyz_world_src     [S, H, W, 3]    -- src-supported world points (0 where ~mask)
      angle_confidence  [S, H, W]       -- normal-cosine weight (0 where ~mask or <0)
      src_y, src_x      [S, H, W] int64 -- consumed src pixel per ref pixel
    """
    S = depth_src.shape[0]
    H, W = depth_ref.shape
    dev = depth_ref.device
    K_ref, T_ref, K_ref_inv, T_ref_inv = (geom_ref[0, :3, :3], geom_ref[1],
                                          geom_ref[2, :3, :3], geom_ref[3])
    K_src, T_src, K_src_inv, T_src_inv, R_src_wc = (
        geom_src[:, 0, :3, :3], geom_src[:, 1], geom_src[:, 2, :3, :3],
        geom_src[:, 3], geom_src[:, 4, :3, :3])

    valid = depth_ref > 0
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    pix = torch.stack([gx, gy, torch.ones_like(gx)], -1)  # [H, W, 3]

    # ref pixel -> world
    cam_ref = _mm3(pix, K_ref_inv) * depth_ref[..., None]
    world = _translate(cam_ref, T_ref_inv)

    # world -> src pixel
    cam_src = _translate(world[None], T_src)  # [S, H, W, 3]
    z_src = cam_src[..., 2]
    uvw = _mm3(cam_src, K_src)
    safe_w = _safe(uvw[..., 2])
    x_s = uvw[..., 0] / safe_w
    y_s = uvw[..., 1] / safe_w

    # int64: a landing point near the src camera plane can exceed int32
    xi = torch.round(x_s).to(torch.int64)
    yi = torch.round(y_s).to(torch.int64)
    inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H) & (z_src > 1e-6)
    xi_c = xi.clamp(0, W - 1)
    yi_c = yi.clamp(0, H - 1)
    flat_idx = (yi_c * W + xi_c).reshape(S, -1)

    d_src = depth_src.reshape(S, -1).gather(1, flat_idx).reshape(S, H, W)
    n_src = normal_src.reshape(S, -1, 3).gather(
        1, flat_idx[..., None].expand(-1, -1, 3)).reshape(S, H, W, 3)

    # src pixel + sampled src depth -> world -> ref view
    pix_src = torch.stack([xi_c.float(), yi_c.float(), torch.ones_like(x_s)], -1)
    cam_src2 = _mm3(pix_src, K_src_inv) * d_src[..., None]
    world_src = _translate(cam_src2, T_src_inv)
    cam_ref2 = _translate(world_src, T_ref)
    depth_reproj = cam_ref2[..., 2]
    uvw2 = _mm3(cam_ref2, K_ref)
    safe_w2 = _safe(uvw2[..., 2])
    x_r = uvw2[..., 0] / safe_w2
    y_r = uvw2[..., 1] / safe_w2

    dist = torch.sqrt((x_r - gx) ** 2 + (y_r - gy) ** 2)
    depth_diff = (depth_reproj - depth_ref).abs()
    rel_diff = depth_diff / torch.where(valid, depth_ref,
                                        torch.ones_like(depth_ref))

    # normal agreement in the world frame
    n_src_world = _mm3(n_src, R_src_wc)
    n_src_world = n_src_world / (
        torch.sqrt((n_src_world * n_src_world).sum(-1, keepdim=True)) + 1e-12)
    cos_sim = (normal_ref_world * n_src_world).sum(-1)

    mask = ((dist < position_threshold)
            & (rel_diff < depth_threshold)
            & (prob_ref > confidence_threshold)
            & (cos_sim > normal_cos_threshold)
            & valid & inb & (d_src > 0))
    zero = torch.zeros_like(depth_reproj)
    return {
        "mask": mask,
        "depth_reprojected": torch.where(mask, depth_reproj, zero),
        "xyz_world_src": torch.where(mask[..., None], world_src,
                                     torch.zeros_like(world_src)),
        "angle_confidence": torch.where(mask, cos_sim.clamp_min(0.0), zero),
        "src_y": yi_c,
        "src_x": xi_c,
    }


def normal_cos_threshold(normal_threshold_deg: float) -> float:
    return math.cos(math.radians(normal_threshold_deg))


def backproject_to_world(depth: np.ndarray, geom: ViewGeometry) -> np.ndarray:
    """Host-side: ref depth map [H, W] -> world points [H, W, 3] (float64)."""
    H, W = depth.shape
    K_inv = np.linalg.inv(np.asarray(geom.K, np.float64))
    T_wc = np.asarray(geom.T_wc, np.float64)
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float64),
                         np.arange(H, dtype=np.float64))
    pix = np.stack([gx, gy, np.ones_like(gx)], -1)
    cam = (pix @ K_inv.T) * depth[..., None]
    return (cam @ T_wc[:3, :3].T + T_wc[:3, 3]).astype(np.float32)


def normals_to_world(normals_cam: np.ndarray, geom: ViewGeometry) -> np.ndarray:
    """Camera-frame normals [H, W, 3] -> unit world-frame normals."""
    n = normals_cam @ np.asarray(geom.R_wc, np.float64).T
    n = n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12)
    return n.astype(np.float32)
