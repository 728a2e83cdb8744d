"""Depth-hypothesis samplers for the cascade sweeps (counterpart of
deep3d_aerial_tpu/ops/depth_samplers.py).

  * stage 1: uniform inclusive range over [dmin, dmax]
  * later stages: per-pixel window of `ndepth * interval` centred on the
    upsampled previous-stage depth
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .resize import upsample_axis_lerp


def uniform_depth_samples(depth_min, depth_max, ndepth: int) -> torch.Tensor:
    """[D] inclusive linspace over [depth_min, depth_max] (float32), on
    depth_min's device when it is a tensor."""
    lo = torch.as_tensor(depth_min, dtype=torch.float32)
    hi = torch.as_tensor(depth_max, dtype=torch.float32, device=lo.device)
    if ndepth == 1:
        return lo.reshape(1)
    # jnp.linspace's float32 formula: lo * (1 - s) + hi * s with
    # s = k / (D - 1), and the last sample exactly hi
    div = ndepth - 1
    s = torch.arange(div, dtype=torch.float32, device=lo.device) / div
    return torch.cat([lo * (1 - s) + hi * s, hi.reshape(1)])


def window_depth_samples(center_depth: torch.Tensor, ndepth: int,
                         interval) -> torch.Tensor:
    """Per-pixel window [D, H, W] around `center_depth` [H, W]: it spans
    ndepth * interval, re-gridded into ndepth samples."""
    interval = torch.as_tensor(interval, dtype=torch.float32,
                               device=center_depth.device)
    lo = center_depth - ndepth / 2.0 * interval
    hi = center_depth + ndepth / 2.0 * interval
    step = (hi - lo) / (ndepth - 1)
    k = torch.arange(ndepth, dtype=torch.float32,
                     device=center_depth.device)[:, None, None]
    return lo[None] + k * step[None]


def resize_bilinear(x: torch.Tensor, shape) -> torch.Tensor:
    """Resize the last two axes to `shape`, bilinear with half-pixel
    centres. Identity and equal integer-factor upsamples take the exact
    lerp path (ops.resize); other upsamples go through F.interpolate,
    which matches `jax.image.resize` there. Downsampling, where
    `jax.image.resize` antialiases, is not on the ported path and raises."""
    H, W = (int(s) for s in shape)
    h, w = x.shape[-2:]
    if (h, w) == (H, W):
        return x
    if H % h == 0 and W % w == 0 and H // h == W // w:
        p = H // h
        return upsample_axis_lerp(upsample_axis_lerp(x, p, -2), p, -1)
    if H < h or W < w:
        raise NotImplementedError(
            f"bilinear downsampling {h}x{w} -> {H}x{W} is not ported")
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape(-1, 1, h, w), size=(H, W), mode="bilinear",
                      align_corners=False)
    return y.reshape(*lead, H, W)
