"""The sharding context: where model code meets the mesh (counterpart of
the JAX package's parallel/context.py).

The models' blocked depth design (models/cascade.py: the streaming
sweep's online-softmax states, the volume models' per-block scores) splits
the depth hypotheses into n blocks that are computed independently and
merged with the exact online-softmax algebra, so there are no cross-shard
halos. Under `use_mesh` with an 'sp' axis of size s > 1, model code asks
`shard_range(n)` which of the n blocks this rank computes, and hands its
blocks [k, ...] to `constrain(x)`, which returns all n on every rank of
its 'sp' group. Outside `use_mesh`, or on a mesh whose 'sp' axis has size
1, every rank computes every block and `constrain` is the identity, as in
JAX.

The JAX package annotates the block axis and lets XLA place the
collectives; here the gather is written out (`gather_rows`): an
all_reduce(SUM) of a zeroed [n, ...] buffer in which each rank wrote its
own rows. It is exact (it adds only zeros) and it needs nothing beyond
all_reduce, which gloo offers for CUDA tensors too. Its backward is the
all_reduce(SUM) of the gradient, of which each rank keeps its own rows:
every rank of the group computes the same loss from the gathered blocks,
so each rank's gradient of its own rows comes out s times (s the group's
size), which the train step's all-reduce over the whole mesh divides out
(train/step.py).
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

_state = threading.local()


def active_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate a mesh for the model code run inside."""
    prev = active_mesh()
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def _sp_mesh():
    """The active mesh when its 'sp' axis spans more than one rank and this
    rank is in the mesh, else None."""
    mesh = active_mesh()
    if mesh is None or mesh.axis_size("sp") == 1 or mesh.groups.get("sp") is None:
        return None
    return mesh


def shard_range(n: int) -> range:
    """The depth blocks of n this rank computes: its contiguous n/s of them
    on an 'sp' axis of size s, else all n. One block (a model built
    without depth shards) is computed on every rank, as the JAX models then
    place no constraint. ValueError when s does not divide n > 1: a block
    is never computed twice, and the blocks are not padded (the JAX
    sharding constraint would pad)."""
    mesh = _sp_mesh()
    if mesh is None or n == 1:
        return range(n)
    s = mesh.axis_size("sp")
    if n % s:
        raise ValueError(f"{n} depth blocks do not split over {s} ranks of 'sp': "
                         f"choose depth_shards so that the blocks "
                         f"(models/cascade.py:split_depth_blocks) are a multiple of {s}")
    k = n // s
    i = mesh.index("sp")
    return range(i * k, (i + 1) * k)


class _GatherRows(torch.autograd.Function):
    """rows [k, ...] of rank i of a group of s -> [s * k, ...], rank i's rows
    at [i * k, (i + 1) * k); backward: the group's summed gradient at
    this rank's rows."""

    @staticmethod
    def forward(ctx, rows, group, index, size):
        k = rows.shape[0]
        out = rows.new_zeros((size * k, *rows.shape[1:]))
        out[index * k:(index + 1) * k] = rows
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        ctx.group, ctx.index, ctx.k = group, index, k
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad[ctx.index * ctx.k:(ctx.index + 1) * ctx.k], None, None, None


def gather_rows(rows: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every rank's rows [k, ...], in rank order along `axis`, on every rank
    of this rank's line of `axis` (see _GatherRows); differentiable. Counted
    in mesh.gathered by (axis, shape of the rows, dtype)."""
    out = _GatherRows.apply(rows, mesh.groups[axis], mesh.index(axis),
                            mesh.axis_size(axis))
    mesh.gathered[(axis, tuple(rows.shape), rows.dtype)] += 1
    return out


def constrain(x: torch.Tensor) -> torch.Tensor:
    """This rank's depth blocks x [k, ...] (those of shard_range) -> all of
    them, [k * s, ...], on every rank of its 'sp' group; the identity where
    'sp' is not sharded."""
    mesh = _sp_mesh()
    if mesh is None:
        return x
    return gather_rows(x, mesh, "sp")
