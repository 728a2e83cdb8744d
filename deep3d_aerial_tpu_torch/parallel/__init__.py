"""Multi-card and multi-host execution over torch.distributed (counterpart
of the JAX package's parallel/): meshes of ranks with 'dp' and 'sp' axes,
the sharding context the models' depth blocks follow, the sharded train
and infer steps, the multi-host scene-block plan and driver, and the dry
run of one dp x sp train step.

`make_train_step` is train/step.py's, which itself imports
parallel.context; it is loaded on first use, so that importing any module
of the port first never meets a half-loaded train.step."""

from .context import active_mesh, constrain, use_mesh
from .sharding import make_mesh, shard_batch

__all__ = [
    "active_mesh",
    "constrain",
    "use_mesh",
    "make_mesh",
    "shard_batch",
    "make_train_step",
]


def __getattr__(name):
    if name == "make_train_step":
        from ..train.step import make_train_step

        return make_train_step
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
