"""Weight bridge: the JAX package's parameter tree -> the port's
`state_dict`, and seeded random weights.

The tree arrives as the `.npz` that the JAX package's
train/checkpoint.py `export_params_npz` writes (keys are
`jax.tree_util.keystr` paths such as
`['params']['feature']['ConvBlock_0']['Conv_0']['kernel']`) or as a flat
dict of numpy arrays with those keys; a JAX variables dict's
`['batch_stats']` leaves (BatchNorm's mean and var) come with it. Names map
by rule (models/blocks.py): `Conv_0` / `ConvTranspose_0` -> `conv`,
`GroupNorm_0` / `LayerNorm_0` / `BatchNorm_0` -> `norm`,
`ConvBlock_i` -> `convs.i`, `DeconvBlock_i` -> `deconvs.i`; leaves `kernel`
and `scale` -> `weight`. Conv kernels go HWIO -> OIHW (3-D: DHWIO ->
OIDHW); transposed-conv kernels HWIO -> [in, out, kh, kw] (DHWIO -> [in,
out, kd, kh, kw]), flipped on every spatial axis, because the JAX
package's stride-2 'SAME' ConvTranspose does not flip its kernel and
PyTorch's conv_transpose2d/3d does (ops/conv.py). Any leaf missing, left
over or of the wrong shape raises. `state_dict_to_tree` is the inverse:
the model's parameters as that flat `.npz` tree, exactly (a permutation
and a flip of every array, no arithmetic).
"""

from __future__ import annotations

import os
import re
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from .models.blocks import (BatchNorm, ConvTranspose2d, ConvTranspose3d,
                             GroupNorm, LayerNorm)

_TRANSPOSED = (ConvTranspose2d, ConvTranspose3d)

_KEY = re.compile(r"\['([^']+)'\]")
_RENAME = {"Conv_0": "conv", "ConvTranspose_0": "conv", "GroupNorm_0": "norm",
           "LayerNorm_0": "norm", "BatchNorm_0": "norm",
           "kernel": "weight", "scale": "weight"}
_NORM_NAMES = {GroupNorm: "GroupNorm_0", LayerNorm: "LayerNorm_0",
               BatchNorm: "BatchNorm_0"}
# the collections of a JAX variables dict; BatchNorm's statistics live in
# 'batch_stats', every other leaf in 'params'
_COLLECTIONS = ("params", "batch_stats")
_STATS = ("mean", "var")


def _owner(model: nn.Module, param_name: str) -> nn.Module:
    """The module that holds parameter `param_name` of `model`."""
    path, _, _ = param_name.rpartition(".")
    return model.get_submodule(path)


def torch_key(tree_key: str) -> str:
    """`['params']['a']['ConvBlock_3']['Conv_0']['kernel']` -> a.convs.3.conv.weight
    (`['batch_stats'][...]['BatchNorm_0']['mean']` -> ....norm.mean)"""
    parts = _KEY.findall(tree_key)
    if parts and parts[0] in _COLLECTIONS:
        parts = parts[1:]
    out = []
    for p in parts:
        m = re.fullmatch(r"(ConvBlock|DeconvBlock)_(\d+)", p)
        if m:
            out += ["convs" if m.group(1) == "ConvBlock" else "deconvs", m.group(2)]
        else:
            out.append(_RENAME.get(p, p))
    return ".".join(out)


def load_param_tree(src) -> Dict[str, np.ndarray]:
    """A flat {keystr path: array} from an `.npz` path or a mapping."""
    if isinstance(src, Mapping):
        return {k: np.asarray(v) for k, v in src.items()}
    path = os.fspath(src)
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is an orbax checkpoint directory; the port reads .npz "
            "only. Export it with the JAX package: train/checkpoint.py "
            "export_params_npz(restore_params(path), 'weights.npz').")
    if not path.endswith(".npz"):
        raise ValueError(f"{path}: the port reads weights from .npz only")
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def tree_to_state_dict(model: nn.Module, tree) -> Dict[str, torch.Tensor]:
    """Map a JAX parameter tree onto `model`'s parameters; raise on any
    leaf missing, left over or of the wrong shape."""
    flat = load_param_tree(tree)
    own = dict(_leaves(model))
    out, problems = {}, []
    for fk, arr in flat.items():
        tk = torch_key(fk)
        if tk not in own:
            problems.append(f"left over: {fk} (-> {tk})")
            continue
        a = np.asarray(arr, np.float32)
        if tk.endswith("weight") and a.ndim in (4, 5):
            sp = a.ndim - 2  # spatial axes lead: [*taps, in, out]
            if isinstance(_owner(model, tk), _TRANSPOSED):
                a = a.transpose(sp, sp + 1, *range(sp))[
                    (slice(None),) * 2 + (slice(None, None, -1),) * sp]
            else:
                a = a.transpose(sp + 1, sp, *range(sp))
        if tuple(a.shape) != tuple(own[tk].shape):
            problems.append(f"shape: {fk} {a.shape} vs {tk} "
                            f"{tuple(own[tk].shape)}")
            continue
        out[tk] = torch.from_numpy(np.array(a, np.float32, order="C"))
    problems += [f"missing: {k}" + (" (BatchNorm statistics: the tree needs its "
                                    "'batch_stats' collection)"
                                    if k.endswith(_STATS) else "")
                 for k in own if k not in out]
    if problems:
        raise ValueError("parameter tree does not fit the model:\n  "
                         + "\n  ".join(problems))
    return out


def _leaves(model: nn.Module):
    """(name, tensor) of every leaf a JAX variables dict holds: the
    parameters, then the BatchNorm statistics (buffers)."""
    yield from model.named_parameters()
    for name, b in model.named_buffers():
        if isinstance(_owner(model, name), BatchNorm):
            yield name, b


def _tree_key(model: nn.Module, name: str, ndim: int) -> str:
    """The inverse of torch_key for parameter `name` of `model` (ndim, the
    parameter's rank, tells a conv kernel from a norm scale):
    a.convs.3.conv.weight -> `['params']['a']['ConvBlock_3']['Conv_0']['kernel']`;
    a BatchNorm's mean and var go to the 'batch_stats' collection."""
    *path, leaf = name.split(".")
    parts = []
    for i, p in enumerate(path):
        if p.isdigit() and i and path[i - 1] in ("convs", "deconvs"):
            parts[-1] = ("ConvBlock_" if path[i - 1] == "convs" else "DeconvBlock_") + p
        elif p == "conv" and i == len(path) - 1:
            parts.append("ConvTranspose_0" if isinstance(_owner(model, name), _TRANSPOSED)
                         else "Conv_0")
        elif p == "norm" and i == len(path) - 1:
            parts.append(_NORM_NAMES[type(_owner(model, name))])
        else:
            parts.append(p)
    parts.append(("kernel" if ndim >= 2 else "scale") if leaf == "weight" else leaf)
    stats = leaf in _STATS and isinstance(_owner(model, name), BatchNorm)
    return "".join(f"['{p}']" for p in [_COLLECTIONS[stats], *parts])


def state_dict_to_tree(model: nn.Module) -> Dict[str, np.ndarray]:
    """`model`'s parameters (and BatchNorm statistics, in 'batch_stats') as
    the JAX package's flat parameter tree ({keystr path: float32 array},
    the layout `export_params_npz` writes and `tree_to_state_dict` reads):
    conv kernels OIHW -> HWIO (3-D: OIDHW
    -> DHWIO), transposed-conv kernels [in, out, *taps] unflipped ->
    [*taps, in, out]."""
    out = {}
    for name, p in _leaves(model):
        a = p.detach().cpu().float().numpy()
        if name.endswith("weight") and a.ndim in (4, 5):
            sp = a.ndim - 2
            taps = tuple(range(2, 2 + sp))
            if isinstance(_owner(model, name), _TRANSPOSED):
                a = a[(slice(None),) * 2 + (slice(None, None, -1),) * sp]
                a = a.transpose(*taps, 0, 1)
            else:
                a = a.transpose(*taps, 1, 0)
        out[_tree_key(model, name, a.ndim)] = np.ascontiguousarray(a)
    return out


def load_jax_weights(model: nn.Module, tree) -> nn.Module:
    """Copy a JAX parameter tree (.npz path or flat mapping) into `model`."""
    model.load_state_dict(tree_to_state_dict(model, tree), strict=True)
    return model


def init_random_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights from a torch.Generator (the JAX package's
    initializer families: LeCun-normal conv kernels, zero kernels where the
    JAX module asks for them (DeformConv2d's p_conv and m_conv), zero
    biases, unit norm scales, BatchNorm statistics mean 0 and var 1)."""
    g = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim in (4, 5) and getattr(_owner(model, name), "zero_init", False):
                p.zero_()
            elif p.ndim in (4, 5):
                # fan-in: in-channels x taps (transposed: dim 0 holds in)
                fan_in = p[0].numel() if not isinstance(
                    _owner(model, name), _TRANSPOSED) else p.shape[0] * p[0, 0].numel()
                p.copy_(torch.randn(p.shape, generator=g) / fan_in ** 0.5)
            elif name.endswith("weight"):  # 1-D: a norm's scale
                p.fill_(1.0)
            else:
                p.zero_()
        for name, b in model.named_buffers():
            if isinstance(_owner(model, name), BatchNorm):
                b.fill_(1.0 if name.endswith(".var") else 0.0)
    return model
