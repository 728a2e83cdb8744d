"""Checkpoint save/restore (counterpart of the JAX package's
train/checkpoint.py), with the reference's resume logic: a checkpoint per
epoch holding the model, the optimizer and the epoch; resume picks the
newest; the eval error is encoded in the name.

A checkpoint is a directory named as the JAX package names its own,
`model_{epoch:06d}[_{abs_error:.4f}]`, holding

  params.npz   the parameters in the JAX package's flat keystr layout
               (weights.state_dict_to_tree): the port's pipeline takes it
               as `pretrain_weight`, the JAX package's
               restore_params(".../params.npz") reads it
  state.pt     {"epoch", "optimizer"}: the optimizer's count and moments

The JAX package writes orbax directories, which the port does not read (it
does not depend on orbax): restoring one raises and names the JAX
package's export_params_npz.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..weights import load_jax_weights, state_dict_to_tree

PARAMS = "params.npz"
STATE = "state.pt"


def save_checkpoint(ckpt_dir: str, epoch: int, model: torch.nn.Module,
                    optimizer=None, abs_error: Optional[float] = None) -> str:
    """Write model_{epoch}[_{abs_error}]/ (params.npz, state.pt) under
    `ckpt_dir`, through temporary names; returns its path."""
    name = f"model_{epoch:06d}"
    if abs_error is not None:
        name += f"_{abs_error:.4f}"
    path = os.path.abspath(os.path.join(ckpt_dir, name))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, "params.tmp.npz")
    np.savez_compressed(tmp, **state_dict_to_tree(model))
    os.replace(tmp, os.path.join(path, PARAMS))
    state = {"epoch": int(epoch)}
    if optimizer is not None:
        state["optimizer"] = optimizer.state_dict()
    tmp = os.path.join(path, "state.tmp.pt")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, STATE))
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    entries = []
    for name in os.listdir(ckpt_dir):
        m = re.match(r"model_(\d+)", name)
        if m:
            entries.append((int(m.group(1)), name))
    if not entries:
        return None
    entries.sort()
    return os.path.join(ckpt_dir, entries[-1][1])


def best_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Checkpoint with the LOWEST val error encoded in its name; falls back
    to the newest when no name carries an error (ties broken by newest
    epoch)."""
    if not os.path.isdir(ckpt_dir):
        return None
    entries = []
    for name in os.listdir(ckpt_dir):
        m = re.match(r"model_(\d+)_([0-9.]+)$", name)
        if m:
            entries.append((float(m.group(2)), -int(m.group(1)), name))
    if not entries:
        return latest_checkpoint(ckpt_dir)
    entries.sort()
    return os.path.join(ckpt_dir, entries[0][2])


def _check_port_checkpoint(path: str) -> None:
    if not os.path.isfile(os.path.join(path, PARAMS)):
        raise ValueError(
            f"{path} holds no {PARAMS}: it is not a checkpoint of the port (an "
            "orbax directory of the JAX package?). Export one with the JAX "
            "package: train/checkpoint.py export_params_npz(restore_params(path), "
            "'params.npz'), and load that file.")


def restore_checkpoint(path: str, model: torch.nn.Module, optimizer=None) -> Dict:
    """Load a checkpoint directory into `model` (and `optimizer`, when its
    state is there); returns the state dict ({"epoch", ...})."""
    path = os.path.abspath(path)
    _check_port_checkpoint(path)
    load_jax_weights(model, os.path.join(path, PARAMS))
    state_path = os.path.join(path, STATE)
    state = torch.load(state_path, map_location="cpu") if os.path.isfile(state_path) else {}
    if optimizer is not None and "optimizer" in state:
        optimizer.load_state_dict(state["optimizer"])
    return state


def merge_matching_params(init: Mapping[str, np.ndarray],
                          warm: Mapping[str, np.ndarray]) -> tuple:
    """Partial warm start over flat parameter trees: copy every leaf of
    `warm` whose key exists in `init` with the same shape and kind (float,
    integer), cast to the init leaf's dtype; keep `init` elsewhere.
    Checkpoints thus carry across operating points that change a few shapes
    (the pair regularizer's first conv depends on ndepths[0]). Returns
    (merged, n_ported, n_skipped, skipped_keys)."""
    merged, ported, skipped = {}, 0, []
    for key, leaf in init.items():
        w = warm.get(key)
        leaf = np.asarray(leaf)
        if w is not None and np.shape(w) == leaf.shape and (
                np.asarray(w).dtype.kind == leaf.dtype.kind):
            merged[key] = np.asarray(w).astype(leaf.dtype)
            ported += 1
            continue
        if w is not None:
            skipped.append(key)
        merged[key] = leaf
    return merged, ported, len(skipped), skipped
