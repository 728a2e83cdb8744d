"""Building blocks of the cascade MVS networks, NCHW (counterpart of
deep3d_aerial_tpu/models/blocks.py).

Parameter layouts are PyTorch's (conv OIHW or OIDHW; transposed conv
[in, out, 3, 3] or [in, out, 3, 3, 3], flipped, see ops/conv.py), and the
submodule names follow the JAX package's tree so
that weights.py maps one onto the other by rule: `Conv_0` / `ConvTranspose_0`
-> `conv`, `GroupNorm_0` / `LayerNorm_0` / `BatchNorm_0` -> `norm`,
`ConvBlock_i` -> `convs.i`, `DeconvBlock_i` -> `deconvs.i`.
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
    """The JAX package's nn.Conv(padding='SAME'): OIHW weight, optional bias.
    `zero_init`: the JAX module initializes the kernel to zeros
    (weights.init_random_weights does the same)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 bias: bool = True, zero_init: bool = False):
        super().__init__()
        self.stride = stride
        self.zero_init = zero_init
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


class LayerNorm(nn.Module):
    """nn.LayerNorm as the JAX package applies it (defaults, on channels-last
    maps): each position normalized over its channels only -- dim 1 of an
    [N, C, ...] map or volume, not nn.LayerNorm([C, H, W]) -- epsilon 1e-6,
    variance E[x^2] - E[x]^2 clamped at 0, the scale folded into the
    inverse deviation. A bfloat16 input is normalized in float32 and the
    result rounded to bfloat16, as Linen does (force_float32_reductions)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        if x.dtype != torch.float32:
            return self.forward(x.float()).to(x.dtype)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mean = x.mean(dim=1, keepdim=True)
        var = ((x * x).mean(dim=1, keepdim=True) - mean * mean).clamp_min(0)
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(shape)
        return (x - mean) * mul + self.bias.reshape(shape)


class BatchNorm(nn.Module):
    """nn.BatchNorm(use_running_average=True) as the JAX package applies it:
    per channel (dim 1), (x - mean) * rsqrt(var + 1e-5) * scale + bias, with
    the statistics of the `batch_stats` collection, never a batch's own and
    never updated, in training too; a bfloat16 input is normalized in
    float32 and rounded to bfloat16. The statistics are buffers `mean` and
    `var`; weights.py maps them to and from
    `['batch_stats'][...]['BatchNorm_0']['mean' | 'var']`, and a parameter
    tree without them does not load (the JAX `apply` of `params` alone
    raises ScopeCollectionNotFound)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x):
        if x.dtype != torch.float32:
            return self.forward(x.float()).to(x.dtype)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(self.var.reshape(shape) + self.eps) * self.weight.reshape(shape)
        return (x - self.mean.reshape(shape)) * mul + self.bias.reshape(shape)


NORMS = {"group": GroupNorm, "layer": LayerNorm, "batch": BatchNorm}


def _norm(norm: str, channels: int):
    """The norm layer of a ConvBlock or DeconvBlock ('group', 'layer',
    'batch'), or None for 'none'; any other name raises ValueError, as the
    JAX package's _norm_layer does."""
    if norm == "none":
        return None
    if norm not in NORMS:
        raise ValueError(f"unknown norm {norm!r}")
    return NORMS[norm](channels)


class ConvBlock(nn.Module):
    """Conv (2-D, or 3-D with ndim=3) + optional norm (group, layer or
    batch) + optional ReLU; bias only without norm."""

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
    """Exact-2x transposed conv (2-D, or 3-D with ndim=3) + optional norm
    (group, layer or batch) + optional ReLU."""

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


class ConvLSTMCell(nn.Module):
    """Convolutional LSTM cell: one fused 4-gate conv `gates` over
    cat([x, h]), split i, f, o, g; c' = f*c + i*g, h' = o*tanh(c');
    returns (h', c', o)."""

    def __init__(self, cin: int, hidden: int, kernel: int = 3):
        super().__init__()
        self.gates = Conv2d(cin + hidden, 4 * hidden, kernel)

    def forward(self, x, h, c):
        ai, af, ao, ag = self.gates(torch.cat([x, h], dim=1)).chunk(4, dim=1)
        i, f, o = torch.sigmoid(ai), torch.sigmoid(af), torch.sigmoid(ao)
        c_new = f * c + i * torch.tanh(ag)
        return o * torch.tanh(c_new), c_new, o


class DeformConv2d(nn.Module):
    """Modulated deformable convolution (v2) on [N, C, H, W], in plain
    gathers, as the JAX package computes it (outside any Pallas kernel): a
    3x3 `p_conv` gives each of the k*k taps a (dy, dx) offset per pixel (the
    dy of every tap, then every dx), a 3x3 `m_conv` a sigmoid modulation;
    tap t of pixel (y, x) samples the input bilinearly at (y + t//k - r +
    dy, x + t%k - r + dx), r = (k-1)/2, the position CLIPPED to [0, H-1] x
    [0, W-1] before its floor (not the zero padding of torchvision's
    deform_conv2d), and is scaled by its mask. The taps stack tap-major on
    the channels ([t0 channels, t1 channels, ...]) and a biased 1x1 conv
    `w` applies the kernel's weights. p_conv and m_conv start at zero (the
    JAX initializer)."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 modulation: bool = True):
        super().__init__()
        taps = kernel * kernel
        self.kernel = kernel
        self.modulation = modulation
        self.p_conv = Conv2d(cin, 2 * taps, zero_init=True)
        self.m_conv = Conv2d(cin, taps, zero_init=True) if modulation else None
        self.w = Conv2d(taps * cin, features, kernel=1)

    def forward(self, x):
        N, C, H, W = x.shape
        k, taps = self.kernel, self.kernel * self.kernel
        off = self.p_conv(x)  # [N, 2 * taps, H, W]: dy of every tap, then dx
        if self.modulation:
            m = torch.sigmoid(self.m_conv(x))
        gy, gx = torch.meshgrid(torch.arange(H, dtype=x.dtype, device=x.device),
                                torch.arange(W, dtype=x.dtype, device=x.device),
                                indexing="ij")
        r = (k - 1) / 2.0
        flat = x.reshape(N, C, H * W)

        def tap(yi, xi):
            idx = (yi * W + xi).reshape(N, 1, H * W).expand(N, C, H * W)
            return flat.gather(2, idx).reshape(N, C, H, W)

        out = []
        for t in range(taps):
            py = (gy + (t // k - r) + off[:, t]).clamp(0.0, H - 1.0)
            px = (gx + (t % k - r) + off[:, taps + t]).clamp(0.0, W - 1.0)
            y0, x0 = torch.floor(py), torch.floor(px)
            fy, fx = (py - y0)[:, None], (px - x0)[:, None]
            y0, x0 = y0.long(), x0.long()
            y1, x1 = (y0 + 1).clamp_max(H - 1), (x0 + 1).clamp_max(W - 1)
            v = ((1 - fy) * (1 - fx) * tap(y0, x0) + (1 - fy) * fx * tap(y0, x1)
                 + fy * (1 - fx) * tap(y1, x0) + fy * fx * tap(y1, x1))
            if self.modulation:
                v = v * m[:, t:t + 1]
            out.append(v)
        return self.w(torch.cat(out, dim=1))


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
