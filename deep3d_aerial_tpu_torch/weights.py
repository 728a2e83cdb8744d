"""Weight bridge: the JAX package's parameter tree -> the port's
`state_dict`, and seeded random weights.

The tree arrives as the `.npz` that the JAX package's
train/checkpoint.py `export_params_npz` writes (keys are
`jax.tree_util.keystr` paths such as
`['params']['feature']['ConvBlock_0']['Conv_0']['kernel']`) or as a flat
dict of numpy arrays with those keys. Names map by rule (models/blocks.py):
`Conv_0` / `ConvTranspose_0` -> `conv`, `GroupNorm_0` -> `norm`,
`ConvBlock_i` -> `convs.i`, `DeconvBlock_i` -> `deconvs.i`; leaves `kernel`
and `scale` -> `weight`. Conv kernels go HWIO -> OIHW; transposed-conv
kernels HWIO -> [in, out, kh, kw], flipped in both spatial axes, because
the JAX package's stride-2 'SAME' ConvTranspose does not flip its kernel
and PyTorch's conv_transpose2d does (ops/conv.py). Any leaf missing, left
over or of the wrong shape raises.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from .models.blocks import ConvTranspose2d

_KEY = re.compile(r"\['([^']+)'\]")
_RENAME = {"Conv_0": "conv", "ConvTranspose_0": "conv", "GroupNorm_0": "norm",
           "kernel": "weight", "scale": "weight"}


def torch_key(tree_key: str) -> str:
    """`['params']['a']['ConvBlock_3']['Conv_0']['kernel']` -> a.convs.3.conv.weight"""
    parts = _KEY.findall(tree_key)
    if parts and parts[0] == "params":
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
    own = dict(model.named_parameters())
    out, problems = {}, []
    for fk, arr in flat.items():
        tk = torch_key(fk)
        if tk not in own:
            problems.append(f"left over: {fk} (-> {tk})")
            continue
        a = np.asarray(arr, np.float32)
        if tk.endswith("weight") and a.ndim == 4:
            owner = model.get_submodule(tk.rsplit(".", 1)[0])
            if isinstance(owner, ConvTranspose2d):
                a = a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
            else:
                a = a.transpose(3, 2, 0, 1)
        if tuple(a.shape) != tuple(own[tk].shape):
            problems.append(f"shape: {fk} {a.shape} vs {tk} "
                            f"{tuple(own[tk].shape)}")
            continue
        out[tk] = torch.from_numpy(np.ascontiguousarray(a))
    problems += [f"missing: {k}" for k in own if k not in out]
    if problems:
        raise ValueError("parameter tree does not fit the model:\n  "
                         + "\n  ".join(problems))
    return out


def load_jax_weights(model: nn.Module, tree) -> nn.Module:
    """Copy a JAX parameter tree (.npz path or flat mapping) into `model`."""
    model.load_state_dict(tree_to_state_dict(model, tree), strict=True)
    return model


def init_random_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights from a torch.Generator (the JAX package's
    initializer families: LeCun-normal conv kernels, zero biases, unit
    norm scales)."""
    g = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 4:
                # fan-in: in-channels x taps (transposed: dim 0 holds in)
                fan_in = p[0].numel() if not isinstance(
                    model.get_submodule(name.rsplit(".", 1)[0]),
                    ConvTranspose2d) else p.shape[0] * 9
                p.copy_(torch.randn(p.shape, generator=g) / fan_in ** 0.5)
            elif name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.zero_()
    return model
