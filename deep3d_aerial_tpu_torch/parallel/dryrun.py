"""One dp x sp train step of AdaMVS over n ranks (counterpart of the JAX
package's __graft_entry__.py `dryrun_multichip`).

Layout: sp = 2 when n is even (else 1), dp = n // sp. The model is the
streaming AdaMVS at ndepths (8, 8, 8), num_depth 32, depth_shards = sp,
plane_chunk 4, on a batch of dp samples of 3 views at 32 x 32 (seeded).
Each rank runs the sharded step (its dp share, its sp blocks), then checks
that the loss is finite, that every rank holds the same parameters, and
that the sharded forward on the updated parameters equals the one-process
forward of the same batch within 1e-4 relative (the blocks' merge is exact
algebra: any larger gap is a sharding bug).

    python -m deep3d_aerial_tpu_torch.parallel.dryrun --n 4 [--device cpu]

`--device cuda` needs n cards (NCCL, one rank per card).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

TOL_REL = 1e-4


def _batch(B: int, V: int = 3, H: int = 32, W: int = 32, seed: int = 0):
    """B seeded samples: random images, nadir cameras 100 m up with small
    tilts and offsets, a constant depth target."""
    from ..geometry.camera import Camera, Pose, proj_matrix, stage_relative_projections

    rng = np.random.default_rng(seed)
    cam = Camera(1, W, H, 60.0, 60.0, W / 2, H / 2)
    R_down = np.diag([1.0, -1.0, -1.0])
    imgs, rels = [], []
    for _ in range(B):
        projs = []
        for _ in range(V):
            a, b = rng.normal(scale=0.03, size=2)
            tilt = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                             [0, np.sin(a), np.cos(a)]]) @ np.array(
                [[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
            R = tilt @ R_down
            c = np.array([rng.uniform(-5, 5), rng.uniform(-5, 5), 100.0])
            projs.append(proj_matrix(cam.K, Pose(R, -R @ c)))
        rels.append(stage_relative_projections(np.stack(projs), 3))
        imgs.append(rng.normal(size=(V, H, W, 3)))
    return {"imgs": np.stack(imgs).astype(np.float32),
            "rel_projs": np.stack(rels).astype(np.float32),
            "depth_min": np.full((B,), 80.0, np.float32),
            "depth_max": np.full((B,), 120.0, np.float32),
            "depth_gt": np.full((B, H, W), 100.0, np.float32),
            "mask": np.ones((B, H, W), np.float32)}


def _rank(dev, dp: int, sp: int) -> dict:
    from ..models import build_model
    from ..train.optim import make_optimizer
    from ..weights import init_random_weights
    from .sharding import make_mesh, replicated, shard_batch
    from .train_step import make_infer_step, make_train_step

    mesh = make_mesh({"dp": dp, "sp": sp})
    batch = _batch(dp)
    model = build_model("adamvs", ndepths=(8, 8, 8), num_depth=32,
                        depth_shards=sp, plane_chunk=4)
    model = replicated(init_random_weights(model, seed=0).to(dev), mesh)
    opt = make_optimizer(model.named_parameters(), 1e-3)
    step = make_train_step(model, opt, pair_weight=1.0, mesh=mesh)
    logs = step(shard_batch(batch, mesh))
    if not np.isfinite(logs["total"]):
        raise AssertionError(f"non-finite loss {logs['total']}")
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    first = flat.clone()
    dist.broadcast(first, src=0, group=mesh.group)
    if not torch.equal(flat, first):
        raise AssertionError(f"rank {mesh.rank}: parameters differ from rank 0's "
                             "after the step")
    args = (batch["imgs"], batch["rel_projs"], batch["depth_min"], batch["depth_max"])
    sharded = make_infer_step(model, mesh)(*args)["depth"]
    single = make_infer_step(model)(*args)["depth"]
    rel = float((sharded - single).abs().max() / single.abs().max())
    if not rel <= TOL_REL:
        raise AssertionError(f"sharded forward differs from the one-process forward "
                             f"by {rel:.3e} relative (> {TOL_REL:g})")
    return {"rank": mesh.rank, "coords": mesh.coords, "loss": logs["total"],
            "forward_rel_err": rel}


def dryrun_multichip(n_devices: int, device: str = "cpu") -> list:
    """Spawn n ranks and run one sharded AdaMVS train step (module
    docstring); returns each rank's record. Raises on a failed check."""
    from .launch import spawn

    sp = 2 if n_devices % 2 == 0 else 1
    dp = n_devices // sp
    return spawn(_rank, n_devices, dp, sp, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=4, help="ranks")
    ap.add_argument("--device", default="cuda", help="cuda (one card a rank) or cpu")
    args = ap.parse_args(argv)
    for rec in dryrun_multichip(args.n, device=args.device):
        print(rec, flush=True)


if __name__ == "__main__":
    main()
