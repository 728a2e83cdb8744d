"""Normal maps from depth maps and the inverse direction (counterpart of
deep3d_aerial_tpu/ops/normals.py): `normals_from_depth` back-projects depth
to camera-space points, takes the cross product of the central differences
and keeps it unit-length and facing the camera; `depth_from_normal`
propagates depth along the neighbours' planes, weighted by the image's
edges (`depth_gradient_weights`). Plain tensor functions: the JAX package
computes them outside any Pallas kernel."""

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


def depth_gradient_weights(image_gray: torch.Tensor, beta: float = 10.0) -> torch.Tensor:
    """Image-gradient edge weights exp(-beta * |grad I|) in [0, 1] (low at
    edges), central differences inside and one-sided at the borders."""
    (gx,) = torch.gradient(image_gray, dim=1)
    (gy,) = torch.gradient(image_gray, dim=0)
    return torch.exp(-beta * torch.sqrt(gx * gx + gy * gy))


def _shift(a: torch.Tensor, dy: int, dx: int, fill: float) -> torch.Tensor:
    """a[y - dy, x - dx], `fill` outside: the value propagated FROM the
    (dy, dx) neighbour."""
    H, W = a.shape
    pad = torch.nn.functional.pad(a[None, None], (1, 1, 1, 1), value=fill)[0, 0]
    return pad[1 - dy:1 - dy + H, 1 - dx:1 - dx + W]


def depth_from_normal(depth: torch.Tensor, normal: torch.Tensor, K: torch.Tensor,
                      image_gray: torch.Tensor, alpha: float = 0.1) -> torch.Tensor:
    """Normal-guided depth propagation: depth [H, W], camera-frame unit
    normals [H, W, 3], intrinsics K [3, 3], luminance [H, W] -> [H, W].

    Each neighbour q's plane (depth(q), n(q)) predicts this pixel's depth,
    depth(q) * (ray(q) . n(q)) / (ray(p) . n(q)) with ray(u) = K^-1 [u, 1],
    the denominator pushed away from 0 to +-1e-3 (0 goes to +1e-3); the 8
    predictions average with weights exp(-alpha * |I(p) - I(q)|). Where a
    neighbour lies outside the image its prediction is the pixel's own
    depth, weighted 1e-6. Every offset divides by its own neighbour's
    plane (the reference's compute_depth_by_normal reuses one offset's
    denominator for two others; the JAX package's code does not, and this
    follows the code)."""
    H, W = depth.shape
    dev = depth.device
    K = K.to(device=dev, dtype=torch.float32)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    rx = (gx - cx) / fx
    ry = (gy - cy) / fy
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    num = rx * nx + ry * ny + nz  # ray(p) . n(p)
    ones = torch.ones_like(depth)
    cands, weights = [], []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            den = (rx * _shift(nx, dy, dx, 0.0) + ry * _shift(ny, dy, dx, 0.0)
                   + _shift(nz, dy, dx, 1.0))  # ray(p) . n(neighbour)
            small = torch.where(den < 0, -1e-3, 1e-3)
            den = torch.where(den.abs() < 1e-3, small, den)
            cand = _shift(depth, dy, dx, 0.0) * _shift(num, dy, dx, 0.0) / den
            inb = _shift(ones, dy, dx, 0.0) > 0.5
            grad = (image_gray - _shift(image_gray, dy, dx, 0.0)).abs()
            w = torch.exp(-alpha * grad) * inb
            cands.append(torch.where(inb, cand, depth))
            weights.append(torch.where(inb, w, 1e-6))
    cands = torch.stack(cands)
    weights = torch.stack(weights)
    return (cands * weights).sum(0) / weights.sum(0)
