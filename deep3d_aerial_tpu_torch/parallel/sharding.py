"""Device meshes over torch.distributed, and batch sharding (counterpart of
the JAX package's parallel/sharding.py).

The multi-card layout: the batch of reference views on 'dp' (one or more
depth maps per card), the blocks of depth hypotheses on 'sp' (the models'
`depth_shards` blocks, gathered and merged exactly: parallel/context.py),
scene blocks on hosts (parallel/multihost.py).

A JAX Mesh is an array of devices; here it is an array of the ranks of the
default process group, one process per card, laid out as `np.reshape`
lays out `jax.devices()`: for {'dp': 2, 'sp': 2} ranks 0 and 1 are dp row
0, ranks 2 and 3 dp row 1. Each rank holds the process group of its line
along each axis (its 'sp' group: the ranks of its dp row; its 'dp' group:
the ranks of its sp column) and the group of the whole mesh, and counts
its gathers (`gathered`: parallel/context.py).
"""

from __future__ import annotations

import collections
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist


def layout(axes: Dict[str, int], n_ranks: int) -> np.ndarray:
    """The ranks of a mesh with named axes `axes` (in their order), as the
    JAX make_mesh lays out the first prod(axes) devices; ValueError when
    it wants more than `n_ranks`."""
    n = int(np.prod(list(axes.values())))
    if n > n_ranks:
        raise ValueError(f"mesh wants {n} devices, only {n_ranks} present")
    return np.arange(n).reshape(tuple(axes.values()))


class Mesh:
    """Named axes over the ranks of the default process group.

    `devices` holds the ranks (the JAX Mesh's devices); `shape` the axis
    sizes by name; `coords` this rank's index on each axis (empty for a
    rank outside the mesh); `groups[axis]` the process group of this
    rank's line along that axis (None for a rank outside the mesh or an
    axis of size 1); `group` the process group of the whole mesh;
    `gathered` the gathers made over it so far, by (axis, shape of a
    rank's rows, dtype).
    """

    def __init__(self, axes: Dict[str, int]):
        world = dist.get_world_size()
        self.devices = layout(axes, world)
        self.axis_names = tuple(axes)
        self.shape = {a: int(s) for a, s in axes.items()}
        self.size = int(self.devices.size)
        self.rank = dist.get_rank()
        self.gathered = collections.Counter()
        inside = self.rank < self.size
        self.coords = ({a: int(i) for a, i in zip(
            self.axis_names, np.argwhere(self.devices == self.rank)[0])}
            if inside else {})
        # every rank creates every group, in the same order
        # (dist.new_group is collective over the whole world)
        self.group = (dist.group.WORLD if self.size == world
                      else dist.new_group(list(range(self.size))))
        if not inside:
            self.group = None
        self.groups: Dict[str, Optional[dist.ProcessGroup]] = {}
        for k, a in enumerate(self.axis_names):
            self.groups[a] = None
            if self.shape[a] == 1:
                continue
            lines = np.moveaxis(self.devices, k, -1).reshape(-1, self.shape[a])
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    self.groups[a] = g

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's position along `axis` (0 for an axis the mesh lacks)."""
        return self.coords.get(axis, 0)


def make_mesh(axes: Dict[str, int]) -> Mesh:
    """A Mesh with named axes over the default process group, e.g.
    make_mesh({'dp': 2, 'sp': 2}); ValueError when it wants more ranks
    than the group has. Every rank of the group must call it."""
    return Mesh(axes)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch, mesh: Mesh, axis: str = "dp"):
    """This rank's contiguous slice of the leading axis of each array or
    tensor of `batch` (a dict, list or tuple of them): the share the JAX
    NamedSharding(P(axis)) places on this rank's devices. ValueError when
    the leading axis is not a multiple of the axis size."""
    n, i = mesh.axis_size(axis), mesh.index(axis)

    def take(x):
        B = x.shape[0]
        if B % n:
            raise ValueError(f"shard_batch: a leading axis of {B} does not split "
                             f"into {n} equal shares on {axis!r}")
        k = B // n
        return x[i * k:(i + 1) * k]
    return _tree_map(take, batch)


def replicated(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank of the mesh, in place
    (dist.broadcast over the mesh's group); returns the module."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0, group=mesh.group)
    return module
