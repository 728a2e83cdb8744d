"""Building blocks of the cascade MVS networks, NCHW (counterpart of
deep3d_aerial_tpu/models/blocks.py).

Parameter layouts are PyTorch's (conv OIHW; transposed conv [in, out, 3, 3],
flipped, see ops/conv.py), and the submodule names follow the JAX package's tree so
that weights.py maps one onto the other by rule: `Conv_0` / `ConvTranspose_0`
-> `conv`, `GroupNorm_0` -> `norm`, `ConvBlock_i` -> `convs.i`,
`DeconvBlock_i` -> `deconvs.i`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import conv2d_same, conv_transpose2d_same
from ..ops.depth_samplers import resize_bilinear
from ..ops.resize import upsample_axis_lerp


class Conv2d(nn.Module):
    """The JAX package's nn.Conv(padding='SAME'): OIHW weight, optional bias."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 bias: bool = True):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        return conv2d_same(x, self.weight, self.bias, self.stride)


class ConvTranspose2d(nn.Module):
    """The JAX package's nn.ConvTranspose(3x3, strides=2, padding='SAME'):
    exact 2x."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        return conv_transpose2d_same(x, self.weight, self.bias)


class GroupNorm(nn.Module):
    """nn.GroupNorm as the JAX package applies it: groups
    max(1, C // 8), epsilon 1e-6, variance E[x^2] - E[x]^2, and -- because
    Linen reads the first axis of an unbatched [H, W, C] map as a batch axis
    -- statistics per image ROW, over (W, channels of the group)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.groups = max(1, channels // 8)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        N, C, H, W = x.shape
        g = x.reshape(N, self.groups, C // self.groups, H, W)
        mean = g.mean(dim=(2, 4), keepdim=True)
        var = ((g * g).mean(dim=(2, 4), keepdim=True) - mean * mean).clamp_min(0)
        # Linen's order: the scale folds into the inverse deviation
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(
            1, self.groups, C // self.groups, 1, 1)
        y = ((g - mean) * mul).reshape(N, C, H, W)
        return y + self.bias[:, None, None]


def _norm(norm: str, channels: int):
    if norm == "group":
        return GroupNorm(channels)
    if norm == "none":
        return None
    raise NotImplementedError(f"norm {norm!r} is not ported (group, none)")


class ConvBlock(nn.Module):
    """Conv + optional GroupNorm + optional ReLU; bias only without norm."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 relu: bool = True, norm: str = "group"):
        super().__init__()
        self.norm = _norm(norm, cout)
        self.conv = Conv2d(cin, cout, kernel, stride, bias=self.norm is None)
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return torch.relu(x) if self.relu else x


class DeconvBlock(nn.Module):
    """Exact-2x transposed conv + optional GroupNorm + optional ReLU."""

    def __init__(self, cin: int, cout: int, relu: bool = True,
                 norm: str = "group"):
        super().__init__()
        self.norm = _norm(norm, cout)
        self.conv = ConvTranspose2d(cin, cout, bias=self.norm is None)
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return torch.relu(x) if self.relu else x


class DeconvFuse(nn.Module):
    """Upsample 2x, concat with the skip branch, fuse with a conv."""

    def __init__(self, cin: int, cskip: int, cout: int, norm: str = "group"):
        super().__init__()
        self.deconvs = nn.ModuleList([DeconvBlock(cin, cout, norm=norm)])
        self.convs = nn.ModuleList([ConvBlock(cout + cskip, cout, norm=norm)])

    def forward(self, skip, x):
        x = self.deconvs[0](x)
        return self.convs[0](torch.cat([x, skip], dim=1))


class ConvGRUCell(nn.Module):
    """h' = u * h + (1 - u) * tanh(conv([x, r * h])), with
    (r, u) = sigmoid(conv([x, h])) split in two."""

    def __init__(self, cin: int, hidden: int):
        super().__init__()
        self.gates = Conv2d(cin + hidden, 2 * hidden)
        self.cand = Conv2d(cin + hidden, hidden)

    def forward(self, x, h):
        r, u = torch.sigmoid(self.gates(torch.cat([x, h], dim=1))).chunk(2, dim=1)
        c = torch.tanh(self.cand(torch.cat([x, r * h], dim=1)))
        return u * h + (1.0 - u) * c


def upsample_bilinear_int(x: torch.Tensor, p: int) -> torch.Tensor:
    """Bilinear p-x spatial upsampling of [..., H, W] (exact for integer
    factors, as jax.image.resize)."""
    return upsample_axis_lerp(upsample_axis_lerp(x, p, -2), p, -1)


def avgpool_branch(x: torch.Tensor, pool: int, block: ConvBlock) -> torch.Tensor:
    """AvgPool(pool) (VALID) -> 1x1 ConvBlock -> bilinear upsample back:
    the AdaMVS context branch."""
    H, W = x.shape[-2:]
    y = block(F.avg_pool2d(x, pool, stride=pool))
    if y.shape[-2] * pool == H and y.shape[-1] * pool == W:
        return upsample_bilinear_int(y, pool)
    return resize_bilinear(y, (H, W))
