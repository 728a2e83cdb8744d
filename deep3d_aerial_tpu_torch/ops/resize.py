"""Integer-factor bilinear upsampling (counterpart of
deep3d_aerial_tpu/ops/resize.py).

Half-pixel centres with edge clamp, which is what `jax.image.resize`
'bilinear' gives for integer upsampling factors, written as one lerp per
output phase.
"""

from __future__ import annotations

import math

import torch


def upsample_axis_lerp(x: torch.Tensor, p: int, axis: int) -> torch.Tensor:
    """Exact bilinear p-x upsampling of `x` along one axis."""
    axis = axis % x.ndim
    n = x.shape[axis]
    xm = x.movedim(axis, -1)
    idx = torch.arange(n, device=x.device)

    def shifted(a):
        if a == 0:
            return xm
        return xm[..., (idx + a).clamp(0, n - 1)]

    phases = []
    for q in range(p):
        src = (q + 0.5) / p - 0.5
        a = math.floor(src)
        f = src - a
        phases.append((1.0 - f) * shifted(a) + f * shifted(a + 1))
    # [..., n, p] -> [..., n * p]: output index n * p + q is phase q of n
    y = torch.stack(phases, dim=-1).reshape(*xm.shape[:-1], n * p)
    return y.movedim(-1, axis).to(x.dtype)
