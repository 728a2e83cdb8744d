"""Sharded training and inference steps (counterpart of the JAX package's
parallel/train_step.py).

Data-parallel over the batch of reference views ('dp'); depth-block
parallel ('sp') through the sharding context (parallel/context.py).
Parameters are replicated (sharding.replicated). The train step is the
port's train/step.py `make_train_step`, which takes `mesh=` and holds the
gradient rule; the optimizers are train/optim.py's.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict

import numpy as np
import torch

from ..train.step import make_train_step
from .context import gather_rows, use_mesh
from .sharding import shard_batch

__all__ = ["make_train_step", "make_infer_step"]


def make_infer_step(model: torch.nn.Module, mesh=None) -> Callable:
    """Returns infer(imgs, rel_projs, depth_min, depth_max) ->
    {'depth', 'photometric_confidence'} ([B, H, W] each) over a batch of B
    reference views (numpy arrays or tensors, imgs [B, V, H, W, 3],
    rel_projs [B, S, V-1, 4, 4], depth_min/depth_max [B]), on the model's
    device, without gradients.

    With `mesh` every rank is handed the whole batch; it runs the forwards
    of its dp share (shard_batch), under use_mesh so that the depth blocks
    are split over 'sp', and returns the whole batch's outputs, gathered
    over its dp group: every rank holds them, as every device holds the JAX
    step's global arrays."""

    def infer(imgs, rel_projs, depth_min, depth_max) -> Dict[str, torch.Tensor]:
        device = next(model.parameters()).device

        def t(x):
            x = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
            return x.to(device=device, dtype=torch.float32)
        args = [t(x) for x in (imgs, rel_projs, depth_min, depth_max)]
        if mesh is not None:
            args = shard_batch(args, mesh)
        outs = {"depth": [], "photometric_confidence": []}
        with torch.inference_mode(), (use_mesh(mesh) if mesh is not None
                                      else contextlib.nullcontext()):
            for im, rp, a, b in zip(*args):
                out = model(im, rp, float(a), float(b))
                for k in outs:
                    outs[k].append(out[k])
            res = {k: torch.stack(v) for k, v in outs.items()}
            if mesh is not None and mesh.axis_size("dp") > 1:
                res = {k: gather_rows(v, mesh, "dp") for k, v in res.items()}
        return res

    return infer
