"""Building blocks of the cascade MVS networks, NCHW (counterpart of
deep3d_aerial_tpu/models/blocks.py).

Parameter layouts are PyTorch's (conv OIHW or OIDHW; transposed conv
[in, out, 3, 3] or [in, out, 3, 3, 3], flipped, see ops/conv.py), and the
submodule names follow the JAX package's tree so
that weights.py maps one onto the other by rule: `Conv_0` / `ConvTranspose_0`
-> `conv`, `GroupNorm_0` -> `norm`, `ConvBlock_i` -> `convs.i`,
`DeconvBlock_i` -> `deconvs.i`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import (
    conv2d_same,
    conv3d_same,
    conv_transpose2d_same,
    conv_transpose3d_same,
)
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


class Conv3d(nn.Module):
    """The JAX package's 3-D nn.Conv(padding='SAME'): OIDHW weight, optional
    bias."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 bias: bool = True):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        return conv3d_same(x, self.weight, self.bias, self.stride)


class ConvTranspose3d(nn.Module):
    """The JAX package's nn.ConvTranspose(3x3x3, strides=2, padding='SAME'):
    exact 2x on D, H and W."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout, 3, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        return conv_transpose3d_same(x, self.weight, self.bias)


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(dtype) -> torch.dtype:
    """A model's compute dtype, from a torch dtype or its name: float32 or
    bfloat16 (the JAX package's dtype=jnp.bfloat16: features, volumes and
    recurrent states in bfloat16, the parameters float32); anything else
    raises ValueError naming both."""
    dt = DTYPES.get(dtype, dtype) if isinstance(dtype, str) else dtype
    if dt not in DTYPES.values():
        raise ValueError(f"compute dtype {dtype!r}: the models run float32 or "
                         "bfloat16")
    return dt


WARP_PRECISIONS = ("float32", "compensated")


def compensated_warp(warp_precision: str) -> bool:
    """Whether a model's sweeps project with the double-single chain:
    warp_precision 'compensated' (DENSEMATCH.warp_precision, the JAX
    package's set_high_precision_warp(True)) or 'float32'; anything else
    raises ValueError naming both."""
    if warp_precision not in WARP_PRECISIONS:
        raise ValueError(f"warp_precision {warp_precision!r}: the models take "
                         "'float32' or 'compensated'")
    return warp_precision == "compensated"


CONVS = {2: Conv2d, 3: Conv3d}
CONV_TRANSPOSES = {2: ConvTranspose2d, 3: ConvTranspose3d}


class GroupNorm(nn.Module):
    """nn.GroupNorm as the JAX package applies it: groups
    max(1, C // 8), epsilon 1e-6, variance E[x^2] - E[x]^2, and -- because
    Linen reads the first axis of an unbatched input as a batch axis --
    statistics per slice of the first spatial axis: per image ROW of a
    [N, C, H, W] map, over (W, channels of the group), and per depth PLANE
    of a [N, C, D, H, W] volume, over (H, W, channels of the group). A
    GroupNorm that pools the whole map or volume is a different function.

    A bfloat16 input is normalized as Linen does it in bfloat16
    (force_float32_reductions): statistics and normalization in float32 on
    the upcast input, the result rounded to bfloat16."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.groups = max(1, channels // 8)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        if x.dtype != torch.float32:
            return self.forward(x.float()).to(x.dtype)
        N, C, *spatial = x.shape
        G = self.groups
        g = x.reshape(N, G, C // G, *spatial)
        # the group's channels and every spatial axis but the first
        dims = (2,) + tuple(range(4, g.ndim))
        mean = g.mean(dim=dims, keepdim=True)
        var = ((g * g).mean(dim=dims, keepdim=True) - mean * mean).clamp_min(0)
        # Linen's order: the scale folds into the inverse deviation
        ones = (1,) * len(spatial)
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(1, G, C // G, *ones)
        y = ((g - mean) * mul).reshape(N, C, *spatial)
        return y + self.bias.reshape(C, *ones)


def _norm(norm: str, channels: int):
    if norm == "group":
        return GroupNorm(channels)
    if norm == "none":
        return None
    raise NotImplementedError(f"norm {norm!r} is not ported (group, none)")


class ConvBlock(nn.Module):
    """Conv (2-D, or 3-D with ndim=3) + optional GroupNorm + optional ReLU;
    bias only without norm."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 relu: bool = True, norm: str = "group", ndim: int = 2):
        super().__init__()
        self.norm = _norm(norm, cout)
        self.conv = CONVS[ndim](cin, cout, kernel, stride, bias=self.norm is None)
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return torch.relu(x) if self.relu else x


class DeconvBlock(nn.Module):
    """Exact-2x transposed conv (2-D, or 3-D with ndim=3) + optional
    GroupNorm + optional ReLU."""

    def __init__(self, cin: int, cout: int, relu: bool = True,
                 norm: str = "group", ndim: int = 2):
        super().__init__()
        self.norm = _norm(norm, cout)
        self.conv = CONV_TRANSPOSES[ndim](cin, cout, bias=self.norm is None)
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


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsampling of [..., H, W], by repeats (the JAX package's
    upsample_nearest2x)."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


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
