"""Plane-sweep homography warping, plain PyTorch (counterpart of
deep3d_aerial_tpu/ops/warp.py).

Semantics: relative projective transform src_P @ inv(ref_P), per-depth-plane
pixel transfer, bilinear sampling with zero padding at exact pixel
coordinates. Features are channels-last ([H, W, C]), the layout of the JAX
package and of the CUDA sweep kernel (ops/sweep.py). Geometry is float32,
spelled elementwise so every product and sum rounds once, as in the JAX
chain; the CUDA kernel repeats the same chain with round-to-nearest
intrinsics.

`compensated=True` takes the JAX package's double-single chain (its
`highp=True`, DENSEMATCH.warp_precision 'compensated'): each value an
unevaluated (hi, lo) float32 pair through the ray, p = ray * d + t and one
compensated division per coordinate, ~48 effective mantissa bits for
numerically deep scenes. The helpers below are spelled op by op as the JAX
code's; each op rounds once (no fused multiply-add), which the error-free
transformations need.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def relative_projection(src_P: torch.Tensor, ref_P: torch.Tensor) -> torch.Tensor:
    """rel = src_P @ inv(ref_P), both 4x4 (rows 0-2 = K[R|t]). float32."""
    return src_P.float() @ torch.linalg.inv(ref_P.float())


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    c = a * 4097.0  # 2^12 + 1 (float32 Veltkamp split)
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _ds_add(x, y):
    s, e = _two_sum(x[0], y[0])
    e = e + x[1] + y[1]
    return _two_sum(s, e)


def _ds_mul(x, y):
    p, e = _two_prod(x[0], y[0])
    e = e + x[0] * y[1] + x[1] * y[0]
    return _two_sum(p, e)


def _ds_from(a):
    return a, torch.zeros_like(a)


def _ds_div(x, z):
    """Compensated (hi+lo)/(zhi+zlo): the quotient and one Newton
    correction from the residual x - q*z, evaluated in double-single."""
    q = x[0] / z[0]
    qz = _ds_mul(_ds_from(q), z)
    r = _ds_add(x, (-qz[0], -qz[1]))
    return q + (r[0] + r[1]) / z[0]


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
    compensated: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Source-image pixel coords for each (depth, ref pixel).

    rel_proj    : [4, 4] (or [3, 4]) src_P @ inv(ref_P)
    depths      : [D] or [D, H, W] depth hypotheses (ref-view depths)
    compensated : the double-single chain (the JAX package's highp=True)
    returns     : (x_src, y_src, z_src) each [D, H, W] float32
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
    if compensated:
        dd = _ds_from(d)
        ones = torch.ones_like(gx)
        comps = []
        for a in range(3):
            # the ray component in double-single too: r0*x + r1*y + r2
            # rounded in float32 already costs ~1e-4 px at deep operating
            # points
            ra = _ds_add(_ds_add(_ds_mul(_ds_from(gx), _ds_from(R[a, 0] * ones)),
                                 _ds_mul(_ds_from(gy), _ds_from(R[a, 1] * ones))),
                         _ds_from(R[a, 2] * ones))
            prod = _ds_mul((ra[0][None], ra[1][None]), dd)
            comps.append(_ds_add(prod, _ds_from(t[a])))
        zhi, zlo = comps[2]
        z = zhi + zlo
        bad = zhi.abs() < 1e-8
        safe_z = (torch.where(bad, torch.full_like(zhi, 1e-8), zhi),
                  torch.where(bad, torch.zeros_like(zlo), zlo))
        x_src = _ds_div(comps[0], safe_z)
        y_src = _ds_div(comps[1], safe_z)
    else:
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
                     ref_shape: Optional[Tuple[int, int]] = None,
                     compensated: bool = False) -> torch.Tensor:
    """Warp `src_feat` [H, W, C] onto the ref view at each depth
    hypothesis ([D] or [D, H, W]) -> [D, H, W, C]."""
    if ref_shape is None:
        ref_shape = tuple(src_feat.shape[:2])
    x_src, y_src, _ = sweep_coordinates(rel_proj, depths, ref_shape, compensated)
    return bilinear_sample(src_feat, x_src, y_src)


def plane_sweep_warp_single(src_feat: torch.Tensor, rel_proj: torch.Tensor,
                            depth, ref_shape: Optional[Tuple[int, int]] = None,
                            compensated: bool = False) -> torch.Tensor:
    """Warp at ONE depth plane ([H, W] or scalar) -> [H, W, C]."""
    if ref_shape is None:
        ref_shape = tuple(src_feat.shape[:2])
    d = torch.as_tensor(depth, dtype=torch.float32, device=src_feat.device)
    d = torch.broadcast_to(d, ref_shape)
    return plane_sweep_warp(src_feat, rel_proj, d[None], ref_shape, compensated)[0]
