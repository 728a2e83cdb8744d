"""Training losses for the cascade MVS zoo (counterpart of the JAX
package's train/losses.py).

  * cas_mvsnet_loss (the reference's cas_mvsnet.py:9-28): per-stage masked
    smooth-L1 on depth, weighted by dlossw (default 0.5, 1.0, 2.0)
  * cas_mvs_vis_loss (its adamvs.py:8-47): adds the mean smooth-L1 over the
    per-view pair depths at stage 1

A stage's depth is resized bilinearly to its GT's shape as
`jax.image.resize(..., "bilinear")` does: upsampling through
ops.depth_samplers.resize_bilinear (half-pixel centres, no antialias), and
downsampling -- which only the GT pyramid of AdaMVS's up-sampled stages
asks for -- through `resize_bilinear_antialias`, the same triangle-kernel
weight matrices the JAX resize builds.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..ops.depth_samplers import resize_bilinear
from ..ops.normals import normals_from_depth


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise Huber/smooth-L1 with beta=1 (torch F.smooth_l1_loss)."""
    diff = torch.abs(pred - target)
    return torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(x.dtype)
    return torch.sum(x * m) / torch.clamp_min(torch.sum(m), 1.0)


def _weight_mat(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] weights of a bilinear (triangle-kernel) resize with
    antialiasing, in the JAX resize's float32 steps: the kernel widened by
    the downscale factor, columns normalised, samples outside the input
    zeroed."""
    inv = torch.tensor(n_in / n_out, dtype=torch.float32)
    kscale = torch.clamp_min(inv, 1.0)
    f = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    x = torch.abs(f[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]) / kscale
    w = torch.clamp_min(1.0 - x, 0.0)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (f >= -0.5) & (f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def resize_bilinear_antialias(x: torch.Tensor, shape) -> torch.Tensor:
    """Resize the last two axes of `x` to `shape` as `jax.image.resize(x,
    shape, "bilinear")` (antialias on) does: a weight matrix per axis."""
    H, W = (int(s) for s in shape)
    h, w = x.shape[-2:]
    wy = _weight_mat(h, H, x.device)
    wx = _weight_mat(w, W, x.device)
    return torch.einsum("...hw,hH,wW->...HW", x, wy, wx)


def resize_to(depth: torch.Tensor, shape) -> torch.Tensor:
    shape = tuple(int(s) for s in shape)
    if tuple(depth.shape[-2:]) == shape:
        return depth
    if shape[0] >= depth.shape[-2] and shape[1] >= depth.shape[-1]:
        return resize_bilinear(depth, shape)
    return resize_bilinear_antialias(depth, shape)


def cascade_depth_loss(
    outputs: Dict,
    depth_gt_stages: Sequence[torch.Tensor],
    mask_stages: Sequence[torch.Tensor],
    stage_weights: Sequence[float] = (0.5, 1.0, 2.0),
    pair_weight: float = 1.0,
    normal_gt=None,
    K_inv=None,
    normal_weight: float = 0.0,
) -> Dict[str, torch.Tensor]:
    """Total cascade loss.

    outputs         : model output dict with 'stageK' sub-dicts
    depth_gt_stages : GT depth per stage, each [h, w]
    mask_stages     : validity masks per stage (>0.5 = supervised)
    normal_gt/K_inv : optional [H, W, 3] GT camera-frame normals + inverse
                      intrinsics; adds `normal_weight * (1 - cos)` between
                      GT and the normals of the final predicted depth
    Returns {'total', 'depth_loss' (last stage), 'stageK' each}.
    """
    total = 0.0
    logs = {}
    last = None
    for s, (gt, mask) in enumerate(zip(depth_gt_stages, mask_stages)):
        key = f"stage{s + 1}"
        stage_out = outputs[key]
        est = resize_to(stage_out["depth"], gt.shape)
        m = mask > 0.5
        loss = _masked_mean(smooth_l1(est, gt), m)

        pair_loss = 0.0
        if pair_weight and "pair_results" in stage_out:
            pairs = resize_to(stage_out["pair_results"], gt.shape)  # [Vs, h, w]
            per = torch.stack([_masked_mean(smooth_l1(p, gt), m) for p in pairs])
            pair_loss = per.mean()

        w = stage_weights[s] if s < len(stage_weights) else 1.0
        total = total + w * (loss + pair_weight * pair_loss)
        logs[key] = loss
        last = loss

    if normal_weight and normal_gt is not None and K_inv is not None:
        gt = depth_gt_stages[-1]
        m = mask_stages[-1] > 0.5
        est = resize_to(outputs[f"stage{len(depth_gt_stages)}"]["depth"],
                         gt.shape)
        n_pred = normals_from_depth(est, K_inv)
        cos = torch.sum(n_pred * normal_gt, dim=-1)
        normal_loss = _masked_mean(1.0 - cos, m)
        total = total + normal_weight * normal_loss
        logs["normal_loss"] = normal_loss

    logs["total"] = total
    logs["depth_loss"] = last
    return logs
