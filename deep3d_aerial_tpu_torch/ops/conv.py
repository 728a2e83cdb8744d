"""The JAX package's 'SAME' convolutions in PyTorch, 2-D (NCHW, OIHW weights)
and 3-D (NCDHW, OIDHW weights).

Its convs pad a strided 'SAME' conv TensorFlow's way, on every spatial axis
alike (D as well as H and W): out = ceil(n / s) and the total padding
max((out - 1) * s + k - n, 0) splits as (total // 2, rest), so a 3x3 or
3x3x3 stride-2 conv over an even side pads (0, 1) and a 5x5 one (1, 2) --
not PyTorch's symmetric `padding=`. Its stride-2 'SAME' ConvTranspose does
not flip its kernel; per axis
    out[2q] = K[0] x[q-1] + K[2] x[q],    out[2q+1] = K[1] x[q],
and a 3-D one applies that table on D, H and W (the taps multiply). With
the kernel flipped on every spatial axis (weights.py does that once, on
loading) this is PyTorch's conv_transpose2d / conv_transpose3d at stride 2
without padding, cropped to 2n on each axis.

An input in bfloat16 follows the JAX package's Linen `dtype` semantics
(its modules' `dtype=jnp.bfloat16`): the float32 weight and bias are cast
to bfloat16,
the convolution takes bfloat16 operands and gives a bfloat16 output (cuDNN
and the CPU accumulate in float32), and the bias is added to that output
in bfloat16, after it, as Linen adds it. A float32 input takes the float32
path unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def same_pads(n: int, k: int, s: int):
    """(low, high) 'SAME' padding of one spatial side."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel, stride: int) -> torch.Tensor:
    """`x` padded for a 'SAME' conv over its last len(kernel) axes."""
    pads = []
    for n, k in zip(reversed(x.shape[-len(kernel):]), reversed(kernel)):
        pads += same_pads(n, k, stride)
    return F.pad(x, pads) if any(pads) else x


def _low(conv, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
         **kw) -> torch.Tensor:
    """`conv` in x's dtype: float32 as it is; a lower precision with the
    parameters cast to it and the bias added to the rounded output."""
    if x.dtype == torch.float32:
        return conv(x, w, b, **kw)
    y = conv(x, w.to(x.dtype), None, **kw)
    if b is None:
        return y
    return y + b.to(x.dtype).reshape(-1, *(1,) * (y.ndim - 2))


def conv2d_same(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None,
                stride: int = 1) -> torch.Tensor:
    """nn.Conv(padding='SAME') of the JAX package on NCHW `x` with OIHW `w`."""
    return _low(F.conv2d, _pad_same(x, w.shape[-2:], stride), w, b,
                stride=stride)


def conv3d_same(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None,
                stride: int = 1) -> torch.Tensor:
    """nn.Conv(padding='SAME') of the JAX package on NCDHW `x` with OIDHW
    `w`."""
    return _low(F.conv3d, _pad_same(x, w.shape[-3:], stride), w, b,
                stride=stride)


def conv_transpose2d_same(x: torch.Tensor, w: torch.Tensor,
                          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """nn.ConvTranspose(strides=2, padding='SAME') of the JAX package, 3x3,
    on NCHW `x`;
    `w` is [in, out, 3, 3] in PyTorch's transposed layout, already
    flipped (weights.py flips it on loading)."""
    H, W = x.shape[-2:]
    y = _low(F.conv_transpose2d, x, w, b, stride=2)
    return y[..., :2 * H, :2 * W]


def conv_transpose3d_same(x: torch.Tensor, w: torch.Tensor,
                          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """nn.ConvTranspose(strides=2, padding='SAME') of the JAX package,
    3x3x3, on NCDHW `x`; `w` is [in, out, 3, 3, 3], already flipped on all
    three spatial axes (weights.py)."""
    D, H, W = x.shape[-3:]
    y = _low(F.conv_transpose3d, x, w, b, stride=2)
    return y[..., :2 * D, :2 * H, :2 * W]
