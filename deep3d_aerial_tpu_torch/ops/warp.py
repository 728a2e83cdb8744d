"""Plane-sweep homography warping, plain PyTorch (counterpart of
deep3d_aerial_tpu/ops/warp.py).

Semantics: relative projective transform src_P @ inv(ref_P), per-depth-plane
pixel transfer, bilinear sampling with zero padding at exact pixel
coordinates. Features are channels-last ([H, W, C]), the layout of the JAX
package and of the CUDA sweep kernel (ops/sweep.py). Geometry is float32,
spelled elementwise so every product and sum rounds once, as in the JAX
chain; the CUDA kernel repeats the same chain with round-to-nearest
intrinsics.

The compensated double-single chain (JAX `highp=True`) is not ported yet
(ROADMAP, section A).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def relative_projection(src_P: torch.Tensor, ref_P: torch.Tensor) -> torch.Tensor:
    """rel = src_P @ inv(ref_P), both 4x4 (rows 0-2 = K[R|t]). float32."""
    return src_P.float() @ torch.linalg.inv(ref_P.float())


def bilinear_sample(src: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Sample `src` [H, W, C] at pixel coords (x, y) [...], zero padding.

    Each of the four neighbour taps is zeroed independently when it falls
    outside the image (grid_sample 'zeros' padding).
    """
    H, W, C = src.shape
    x = x.float()
    y = y.float()
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    # int64: a coordinate of a point near the source camera plane can
    # exceed the int32 range; out-of-range taps are masked below anyway
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    x1 = x0 + 1
    y1 = y0 + 1
    flat = src.reshape(H * W, C)

    def tap(xi, yi, w):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        vals = flat[idx.reshape(-1)].reshape(*idx.shape, C)
        w = torch.where(valid, w, torch.zeros_like(w))
        return vals * w[..., None].to(src.dtype)

    return (tap(x0, y0, (1 - fx) * (1 - fy))
            + tap(x1, y0, fx * (1 - fy))
            + tap(x0, y1, (1 - fx) * fy)
            + tap(x1, y1, fx * fy))


def sweep_coordinates(
    rel_proj: torch.Tensor,
    depths: torch.Tensor,
    ref_shape: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Source-image pixel coords for each (depth, ref pixel).

    rel_proj : [4, 4] (or [3, 4]) src_P @ inv(ref_P)
    depths   : [D] or [D, H, W] depth hypotheses (ref-view depths)
    returns  : (x_src, y_src, z_src) each [D, H, W] float32
    """
    H, W = ref_shape
    dev = depths.device
    R = rel_proj[:3, :3].float()
    t = rel_proj[:3, 3].float()
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    # ray = pix @ R.T spelled elementwise (one rounding per op, no matmul)
    ray = [R[a, 0] * gx + R[a, 1] * gy + R[a, 2] for a in range(3)]
    d = depths.float()
    if d.ndim == 1:
        d = d[:, None, None]
    p = [ray[a][None] * d + t[a] for a in range(3)]
    z = p[2]
    safe_z = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    x_src = p[0] / safe_z
    y_src = p[1] / safe_z
    # points behind the source camera must not sample (mirror guard)
    behind = torch.full_like(x_src, -1e9)
    x_src = torch.where(z > 1e-6, x_src, behind)
    y_src = torch.where(z > 1e-6, y_src, behind)
    return x_src, y_src, z


def plane_sweep_warp(src_feat: torch.Tensor, rel_proj: torch.Tensor,
                     depths: torch.Tensor,
                     ref_shape: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Warp `src_feat` [H, W, C] onto the ref view at each depth
    hypothesis ([D] or [D, H, W]) -> [D, H, W, C]."""
    if ref_shape is None:
        ref_shape = tuple(src_feat.shape[:2])
    x_src, y_src, _ = sweep_coordinates(rel_proj, depths, ref_shape)
    return bilinear_sample(src_feat, x_src, y_src)


def plane_sweep_warp_single(src_feat: torch.Tensor, rel_proj: torch.Tensor,
                            depth, ref_shape: Optional[Tuple[int, int]] = None
                            ) -> torch.Tensor:
    """Warp at ONE depth plane ([H, W] or scalar) -> [H, W, C]."""
    if ref_shape is None:
        ref_shape = tuple(src_feat.shape[:2])
    d = torch.as_tensor(depth, dtype=torch.float32, device=src_feat.device)
    d = torch.broadcast_to(d, ref_shape)
    return plane_sweep_warp(src_feat, rel_proj, d[None], ref_shape)[0]
