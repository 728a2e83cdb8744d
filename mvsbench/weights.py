"""Seeded random weights, made on the device in one call.

The initializer families of the models (LeCun normal convolution kernels,
zero biases, unit norm scales): one torch.Generator on the device draws
every kernel's normals in a single randn, which is cut into the kernels
and scaled by 1/sqrt(fan-in). The benchmark hands the same tensors to the
program (load_state_dict) and to the reference.
"""

from __future__ import annotations

from typing import Dict

import torch

# the transposed kernels: DeconvBlocks and the regularisers' up-convolutions
_TRANSPOSED = (".deconvs.", ".upconv")


def fan_in(name: str, shape) -> int:
    """In-channels x taps; a transposed kernel ([in, out, k, k]) holds its
    in-channels in dim 0."""
    taps = 1
    for n in shape[2:]:
        taps *= n
    if any(t in name for t in _TRANSPOSED):
        return shape[0] * taps
    return shape[1] * taps


def seeded(shapes: Dict[str, torch.Size], seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 tensors for every name of `shapes` (a state_dict's names and
    shapes), drawn from `seed` on `device`."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    kernels = [n for n, s in shapes.items() if len(s) >= 3]
    total = sum(torch.Size(shapes[n]).numel() for n in kernels)
    draws = torch.randn(total, generator=g, device=device)
    out, k = {}, 0
    for n, s in shapes.items():
        s = torch.Size(s)
        if n in kernels:
            out[n] = draws[k:k + s.numel()].view(s) / fan_in(n, s) ** 0.5
            k += s.numel()
        elif n.endswith("weight"):
            out[n] = torch.ones(s, device=device)
        else:
            out[n] = torch.zeros(s, device=device)
    return out
