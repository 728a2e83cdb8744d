"""One training step on one device (counterpart of the JAX package's
parallel/train_step.py `make_train_step`, single device).

The JAX step vmaps the model over the batch's B samples; here the samples
run one after another, the loss is the mean of their totals and the logs
are the means of their logs, and one backward pass differentiates that
mean. The kernels run forward and their plain versions' VJPs backward
(ops/autograd.py), as the JAX package's custom VJPs do. NaN guard: on a
non-finite loss every gradient is zeroed and the optimizer update is still
applied (its moments decay, its count advances), as in the JAX step.

A model built with depth_shards > 1 trains here too, its depth blocks one
after another on one device (models/cascade.py; the merge of the blocks'
softmax states is out of place, so autograd follows it).

With a mesh (parallel/sharding.py: make_mesh; one process per rank), each
rank runs the step on its dp share of the global batch (shard_batch) and
on its sp share of the depth blocks (the model runs under use_mesh, which
gathers the blocks: parallel/context.py). Gradient rule: every rank of an
sp group computes the same loss L_b of its dp row's samples from the
gathered blocks; the gather's backward sums the group's gradients at each
rank's own blocks, so a rank's gradient is s x (L_b's gradient through its
own blocks) + (L_b's gradient through the paths every rank computes alike,
the features and the pair weights), and the group's local gradients sum to
s x grad L_b. The all_reduce(SUM) of the local gradients over the whole
mesh (dp x s ranks) divided by dp x s is therefore (1/dp) sum_b grad L_b:
the gradient of the global batch's mean loss, as the JAX step's
XLA-inserted all-reduce gives it. The logged loss and logs are global
means (one all_reduce), the NaN guard reads the global loss, and every
rank applies the same update to the same parameters: after the step they
are equal bit for bit (an all_reduce leaves the same sum on every rank).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.context import use_mesh
from .losses import cascade_depth_loss
from .optim import Optimizer

BATCH_KEYS = ("imgs", "rel_projs", "depth_min", "depth_max", "depth_gt", "mask")


def resize_nearest(x: torch.Tensor, shape) -> torch.Tensor:
    """`jax.image.resize(x, shape, "nearest")` on the last two axes: output
    index i reads input floor((i + 0.5) * n_in / n_out) (float32), the
    half-pixel rule, which is not torch's 'nearest' (floor(i * n_in /
    n_out))."""
    for axis, n_out in zip((-2, -1), shape):
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        off = (torch.arange(n_out, dtype=torch.float32) + 0.5) * n_in / n_out
        x = x.index_select(axis, torch.floor(off).to(torch.int64).to(x.device))
    return x


def _tensors(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v
                               ).to(device=device, dtype=torch.float32)
            for k, v in batch.items()}


def make_train_step(model: torch.nn.Module, optimizer: Optimizer,
                    num_stages: int = 3,
                    stage_weights: Sequence[float] = (0.5, 1.0, 2.0),
                    pair_weight: float = 1.0, normal_weight: float = 0.0,
                    gt_pyramid: bool = False, mesh=None) -> Callable:
    """Returns step(batch, mark=None) -> logs (a dict of floats), which
    updates `model`'s parameters in place through `optimizer`.

    batch dict (leading dim B; numpy arrays or tensors):
      imgs [B, V, H, W, 3], rel_projs [B, S, V-1, 4, 4],
      depth_min [B], depth_max [B], depth_gt [B, H, W], mask [B, H, W]
      (+ normal_gt [B, H, W, 3], K_inv [B, 3, 3] when normal_weight > 0)
    With `mesh`, batch is this rank's dp share of the global batch
    (parallel.shard_batch) and the logs are the global batch's.
    `mark(label)`, when given, is called once the forward ('forward'), the
    backward ('backward'), with a mesh the gradients' all-reduce
    ('all_reduce'), and the update ('optimizer') have been enqueued.
    """

    def loss_one(b: Dict[str, torch.Tensor], i: int, with_normals: bool):
        out = model(b["imgs"][i], b["rel_projs"][i], b["depth_min"][i],
                    b["depth_max"][i])
        gt, mask = b["depth_gt"][i], b["mask"][i]
        if gt_pyramid:
            # multi-scale GT (/4, /2, x1), nearest as the JAX step resizes
            gts, masks = [], []
            for s in range(num_stages):
                f = 2 ** (num_stages - 1 - s)
                shp = (gt.shape[0] // f, gt.shape[1] // f)
                gts.append(resize_nearest(gt, shp))
                masks.append(resize_nearest(mask, shp))
        else:
            gts = [gt] * num_stages
            masks = [mask] * num_stages
        return cascade_depth_loss(
            out, gts, masks, stage_weights=stage_weights,
            pair_weight=pair_weight,
            normal_gt=b["normal_gt"][i] if with_normals else None,
            K_inv=b["K_inv"][i] if with_normals else None,
            normal_weight=normal_weight if with_normals else 0.0)

    def step(batch: Dict, mark: Optional[Callable[[str], None]] = None) -> Dict:
        mark = mark or (lambda label: None)
        device = next(model.parameters()).device
        with_normals = (normal_weight > 0 and "normal_gt" in batch
                        and "K_inv" in batch)
        keys = BATCH_KEYS + (("normal_gt", "K_inv") if with_normals else ())
        b = _tensors({k: batch[k] for k in keys}, device)
        B = b["imgs"].shape[0]
        for p in optimizer.params.values():
            p.grad = None
        with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
            logs = [loss_one(b, i, with_normals) for i in range(B)]
            loss = torch.stack([l["total"] for l in logs]).mean()
            mark("forward")
            loss.backward()
        mark("backward")
        keys = list(logs[0])
        means = torch.stack([torch.stack([torch.as_tensor(l[k]).detach().float().reshape(())
                                          for l in logs]).mean() for k in keys])
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in optimizer.params.items()}
        if mesh is not None:
            grads, means = _all_reduce_mean(mesh, grads, means)
            mark("all_reduce")
        means = means.tolist()
        total = means[keys.index("total")]
        if not np.isfinite(total):
            grads = {n: torch.zeros_like(g) for n, g in grads.items()}
        optimizer.step(grads)
        mark("optimizer")
        return dict(zip(keys, means))

    return step


def _all_reduce_mean(mesh, grads: Dict[str, torch.Tensor], logs: torch.Tensor):
    """The mean over the mesh's ranks of each gradient and of the logs: one
    all_reduce(SUM) of them packed flat, divided by the rank count (the
    gradient rule in the module docstring)."""
    names = list(grads)
    flat = torch.cat([grads[n].reshape(-1) for n in names]
                     + [logs.to(grads[names[0]].device)])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    flat /= mesh.size
    out, k = {}, 0
    for n in names:
        g = grads[n]
        out[n] = flat[k:k + g.numel()].view_as(g)
        k += g.numel()
    return out, flat[k:]
