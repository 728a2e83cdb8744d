"""Rank functions for the port's multi-process tests
(tests/test_torch_parallel.py, tests/test_torch_cuda.py).

deep3d_aerial_tpu_torch.parallel.launch.spawn pickles these by name and
runs them in fresh processes, so this module imports neither JAX nor the
JAX package: the JAX oracles are computed in the test process and handed
over as .npz files. Each function takes the rank's device first and
returns plain CPU tensors and numbers. The model cases run as the card
tests' one-process references do (`float32_numerics`).
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from deep3d_aerial_tpu_torch.models import build_model
from deep3d_aerial_tpu_torch.ops import red_step2, sweep
from deep3d_aerial_tpu_torch.parallel import make_mesh, shard_batch
from deep3d_aerial_tpu_torch.parallel.context import constrain, shard_range, use_mesh
from deep3d_aerial_tpu_torch.parallel.sharding import replicated
from deep3d_aerial_tpu_torch.parallel.train_step import make_infer_step, make_train_step
from deep3d_aerial_tpu_torch.train.optim import make_optimizer
from deep3d_aerial_tpu_torch.weights import load_jax_weights

BATCH_KEYS = ("imgs", "rel_projs", "depth_min", "depth_max", "depth_gt", "mask")


def load(path):
    """(flat weights {keystr: array}, batch {key: array}) from an .npz
    written by save()."""
    z = np.load(path)
    flat = {k[2:]: z[k] for k in z.files if k.startswith("w:")}
    batch = {k[2:]: z[k] for k in z.files if k.startswith("b:")}
    return flat, batch


def save(path, flat, batch):
    np.savez(path, **{f"w:{k}": v for k, v in flat.items()},
             **{f"b:{k}": np.asarray(v) for k, v in batch.items()})


def float32_numerics():
    """cuDNN and matmuls in float32 (no TF32), cuDNN's deterministic
    algorithms (C.11); nothing changes on the CPU."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


def gather_case(dev):
    """On a mesh {'sp': s} of the whole world: rows [2, 3] of this rank
    (seeded by rank), gathered; the backward of sum(out * w_rank) (a
    weight that differs between ranks); shard_range(3) (which must raise)
    and shard_range(1) (which must not shard); a broadcast of a seeded
    module from rank 0."""
    mesh = make_mesh({"sp": dist.get_world_size()})
    g = torch.Generator().manual_seed(100 + mesh.rank)
    rows = torch.randn((2, 3), generator=g).to(dev).requires_grad_()
    w = torch.randn((2 * mesh.size, 3), generator=g).to(dev)
    with use_mesh(mesh):
        out = constrain(rows)
        own = shard_range(2 * mesh.size)
        try:
            shard_range(3)
            uneven = None
        except ValueError as e:
            uneven = str(e)
        one = shard_range(1)
    (out * w).sum().backward()
    lin = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(lin.weight, float(mesh.rank))
    replicated(lin, mesh)
    return {"rank": mesh.rank, "rows": rows.detach().cpu(), "w": w.cpu(),
            "out": out.detach().cpu(), "grad": rows.grad.cpu(), "own": list(own),
            "uneven": uneven, "one": list(one), "lin": lin.weight.detach().clone(),
            "gathered": dict(mesh.gathered)}


def mesh_case(dev, axes):
    """This rank's coordinates, the ranks of its group on each axis, and
    the error of a mesh twice the world's size."""
    mesh = make_mesh(axes)
    groups = {}
    for a, grp in mesh.groups.items():
        groups[a] = None if grp is None else dist.get_process_group_ranks(grp)
    try:
        make_mesh({"dp": 2 * dist.get_world_size()})
        wider = None
    except ValueError as e:
        wider = str(e)
    return {"rank": mesh.rank, "coords": mesh.coords, "groups": groups,
            "devices": mesh.devices.tolist(), "wider": wider}


def infer_case(dev, path, name, kw, axes):
    """make_infer_step of `name` (depth_shards from kw) on the mesh `axes`
    over the whole batch of the .npz: the final depth and confidence, this
    rank's gathers and its kernel launches."""
    float32_numerics()
    flat, batch = load(path)
    mesh = make_mesh(axes)
    model = load_jax_weights(build_model(name, **kw), flat).to(dev).eval()
    before = launches()
    out = make_infer_step(model, mesh)(batch["imgs"], batch["rel_projs"],
                                        batch["depth_min"], batch["depth_max"])
    return {"out": {k: v.cpu() for k, v in out.items()},
            "gathered": {str(k): v for k, v in mesh.gathered.items()},
            "launches": {k: v - before[k] for k, v in launches().items()}}


def launches():
    """The kernel wrappers' launch counts (0 on the CPU)."""
    return {f.__name__: f.launches for f in (sweep.sweep_corr, sweep.sweep_cost,
                                             sweep.sweep_var, red_step2.red_step2)}


def train_case(dev, path, name, kw, axes, step_kw, lr=1e-3):
    """One sharded step of `name` on the mesh `axes` from the .npz's
    weights on this rank's dp share of its batch (rmsprop at lr): the logs,
    the gradients the optimizer was handed and the parameters after."""
    float32_numerics()
    flat, batch = load(path)
    mesh = make_mesh(axes)
    model = load_jax_weights(build_model(name, **kw), flat).to(dev)
    opt = make_optimizer(model.named_parameters(), lr, kind="rmsprop")
    grads = {}
    update = opt.step
    opt.step = lambda g: grads.update({n: t.detach().clone() for n, t in g.items()}) \
        or update(g)
    logs = make_train_step(model, opt, mesh=mesh, **step_kw)(
        shard_batch({k: batch[k] for k in BATCH_KEYS}, mesh))
    return {"logs": logs, "grads": {n: g.cpu() for n, g in grads.items()},
            "params": {n: p.detach().cpu().clone() for n, p in model.named_parameters()}}



def coordinator_case(rank, port, out):
    """Host `rank` of 2 joining through parallel.multihost's
    initialize_distributed at tcp://localhost:<port> on the CPU (gloo):
    saves its (rank, world) and an all_reduce of rank + 1. Takes the rank
    first (torch.multiprocessing.spawn's convention, not launch.spawn's)."""
    from deep3d_aerial_tpu_torch.parallel.multihost import initialize_distributed

    torch.set_num_threads(1)
    got = initialize_distributed(f"localhost:{port}", 2, rank, device="cpu")
    t = torch.tensor([rank + 1.0])
    dist.all_reduce(t)
    torch.save({"got": got, "sum": float(t)}, os.path.join(out, f"r{rank}.pt"))
    dist.destroy_process_group()
