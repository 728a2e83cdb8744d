"""Normal maps from depth maps (counterpart of
deep3d_aerial_tpu/ops/normals.py, `normals_from_depth` only): back-project
depth to camera-space points, take the cross product of the central
differences, keep it unit-length and facing the camera."""

from __future__ import annotations

import torch


def backproject_cam(depth: torch.Tensor, K_inv: torch.Tensor) -> torch.Tensor:
    """depth [H, W] + K_inv [3, 3] -> camera-space points [H, W, 3]."""
    H, W = depth.shape
    gy, gx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=depth.device),
        torch.arange(W, dtype=torch.float32, device=depth.device),
        indexing="ij")
    # elementwise, one rounding per op (no TF32 matmul on the card)
    ray = torch.stack(
        [K_inv[a, 0] * gx + K_inv[a, 1] * gy + K_inv[a, 2] for a in range(3)],
        dim=-1)
    return ray * depth[..., None]


def normals_from_depth(depth: torch.Tensor, K_inv: torch.Tensor) -> torch.Tensor:
    """Per-pixel unit normals [H, W, 3] in the camera frame, facing the
    camera (n . p <= 0); (0, 0, -1) where depth <= 0."""
    pts = backproject_cam(depth, K_inv)
    # central differences, one-sided at the borders
    (dx,) = torch.gradient(pts, dim=1)
    (dy,) = torch.gradient(pts, dim=0)
    n = torch.linalg.cross(dx, dy, dim=-1)
    norm = torch.sqrt((n * n).sum(-1, keepdim=True))
    n = n / norm.clamp_min(1e-12)
    facing = (n * pts).sum(-1, keepdim=True)
    n = torch.where(facing > 0, -n, n)
    default = torch.tensor([0.0, 0.0, -1.0], device=depth.device)
    return torch.where((depth > 0)[..., None], n, default)
