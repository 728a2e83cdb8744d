"""The JAX package's 'SAME' convolutions in PyTorch (NCHW, OIHW weights).

Its convs pad a strided 'SAME' conv TensorFlow's way: out = ceil(n / s) and the
total padding max((out - 1) * s + k - n, 0) splits as (total // 2, rest), so
a 3x3 stride-2 conv over an even side pads (0, 1) and a 5x5 one (1, 2) --
not PyTorch's symmetric `padding=`. Its stride-2 'SAME' ConvTranspose does
not flip its kernel: out[2q] = K[0] x[q-1] + K[2] x[q], out[2q+1] = K[1] x[q].
With the kernel flipped (weights.py does that once, on loading) this is
PyTorch's conv_transpose2d at stride 2 without padding, cropped to 2n.
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


def conv2d_same(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None,
                stride: int = 1) -> torch.Tensor:
    """nn.Conv(padding='SAME') of the JAX package on NCHW `x` with OIHW `w`."""
    kh, kw = w.shape[-2:]
    py = same_pads(x.shape[-2], kh, stride)
    px = same_pads(x.shape[-1], kw, stride)
    if any(py + px):
        x = F.pad(x, (px[0], px[1], py[0], py[1]))
    return F.conv2d(x, w, b, stride=stride)


def conv_transpose2d_same(x: torch.Tensor, w: torch.Tensor,
                          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """nn.ConvTranspose(strides=2, padding='SAME') of the JAX package, 3x3,
    on NCHW `x`;
    `w` is [in, out, 3, 3] in PyTorch's transposed layout, already
    flipped (weights.py flips it on loading)."""
    H, W = x.shape[-2:]
    y = F.conv_transpose2d(x, w, b, stride=2)
    return y[..., :2 * H, :2 * W]
