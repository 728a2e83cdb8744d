"""Training CLI: python -m deep3d_aerial_tpu_torch.train --data_folder D
[--gt_format pfm] [--device cuda|cpu] ... (train/__main__.py runs
`main`; the code lives here, in a module that the spawned `--dp` ranks
import by name).

The JAX package's train CLI with the same flags (modes train/test, the
model zoo switch, the lr schedule spec, resume, checkpoints, `--dp`) plus
`--device`: the default is cuda and raises when there is no CUDA device;
`--device cpu` trains on the CPU (the kernels' plain versions).

`--dp N` > 1 trains data-parallel over N ranks (parallel/: a mesh
{'dp': N}; each rank takes its share of each global batch of
--batch_size samples, which N must divide). Run plainly, the CLI spawns
the N ranks itself; under torchrun (RANK, WORLD_SIZE and LOCAL_RANK set)
it joins torchrun's group, of WORLD_SIZE ranks. With --device cuda each
rank takes its own card (NCCL; N must not exceed the cards present), with
--device cpu the ranks use gloo.

    python -m deep3d_aerial_tpu_torch.train --data_folder D --dp 2 --batch_size 2
    torchrun --nproc_per_node 4 -m deep3d_aerial_tpu_torch.train --data_folder D \
        --batch_size 4
"""

import argparse
import os

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Train cascade MVS networks (PyTorch/CUDA)")
    ap.add_argument("--mode", default="train", choices=["train", "test"])
    ap.add_argument("--model", default="adamvs",
                    choices=["casmvsnet", "ucsnet", "msrednet", "adamvs"])
    ap.add_argument("--data_folder", required=True, help="WHU-OMVS root")
    ap.add_argument("--val_folder", default=None)
    ap.add_argument("--view_num", type=int, default=5)
    ap.add_argument("--numdepth", type=int, default=384)
    ap.add_argument("--min_interval", type=float, default=0.1)
    ap.add_argument("--max_h", type=int, default=384)
    ap.add_argument("--max_w", type=int, default=768)
    ap.add_argument("--epochs", type=int, default=16)
    ap.add_argument("--lr", type=float, default=0.001)
    ap.add_argument("--lrepochs", default="10,12,14:2")
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--logdir", default="checkpoints")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--optimizer", default="rmsprop")
    ap.add_argument("--gt_format", default="exr_mask",
                    choices=["exr_mask", "pfm", "png64"],
                    help="GT depth format (WHU-OMVS / DTU-style / WHU-MVS)")
    ap.add_argument("--augment", action="store_true",
                    help="photometric augmentation on training views")
    ap.add_argument("--dp", type=int, default=0,
                    help="data-parallel devices (0 = single device)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' for the plain path)")
    return ap.parse_args(argv)


def build(args, device=None, mesh=None):
    """(trainer, train dataset, val dataset or None) as the CLI sets them up,
    on `device` (default: --device) and, with a mesh, as one of its ranks."""
    from ..models import build_model
    from ..pipeline.orchestrator import resolve_device
    from .dataset_whu import WHUOMVSDataset
    from .trainer import Trainer, TrainerConfig

    device = resolve_device(args.device if device is None else device)
    model = build_model(args.model, num_depth=args.numdepth)
    train_ds = WHUOMVSDataset(
        args.data_folder, view_num=args.view_num,
        max_h=args.max_h, max_w=args.max_w,
        gt_format=args.gt_format, augment=args.augment,
    )
    val_ds = (
        WHUOMVSDataset(args.val_folder, view_num=args.view_num,
                       max_h=args.max_h, max_w=args.max_w,
                       gt_format=args.gt_format)
        if args.val_folder else None
    )
    if mesh is None or mesh.rank == 0:
        print(f"train samples: {len(train_ds)}"
              + (f", val samples: {len(val_ds)}" if val_ds else ""), flush=True)
    cfg = TrainerConfig(
        lr=args.lr, lr_epochs=args.lrepochs, epochs=args.epochs,
        batch_size=args.batch_size, min_interval=args.min_interval,
        ckpt_dir=args.logdir, optimizer=args.optimizer,
        pair_weight=1.0 if args.model == "adamvs" else 0.0,
    )
    steps = max(1, len(train_ds) // args.batch_size)
    trainer = Trainer(model, cfg, steps_per_epoch=steps, mesh=mesh, device=device)
    return trainer, train_ds, val_ds


def run(args, device=None, mesh=None):
    """The CLI's work in this process (one rank of `mesh` when given);
    returns the trainer and, in test mode, the metrics."""
    trainer, train_ds, val_ds = build(args, device, mesh)
    main_rank = mesh is None or mesh.rank == 0
    if args.resume:
        resumed = trainer.resume()
        if main_rank:
            print(f"resume: {'ok, epoch ' + str(trainer.epoch) if resumed else 'no checkpoint'}",
                  flush=True)
    shard = (mesh.index("dp"), mesh.axis_size("dp")) if mesh is not None else (0, 1)

    if args.mode == "train":
        trainer.fit(
            lambda: train_ds.batches(args.batch_size, shuffle=True, shard=shard),
            (lambda: val_ds.batches(args.batch_size, shuffle=False))
            if val_ds else None,
        )
        return trainer, None
    if not trainer.initialized:
        raise SystemExit("test mode requires --resume with a checkpoint")
    metrics = trainer.evaluate(val_ds.batches(args.batch_size, shuffle=False)
                               if val_ds else
                               train_ds.batches(args.batch_size, shuffle=False))
    if main_rank:
        print(metrics, flush=True)
    return trainer, metrics


def _rank(device, args):
    """One spawned rank of `--dp N`."""
    import torch.distributed as dist

    from ..parallel import make_mesh

    run(args, device, make_mesh({"dp": dist.get_world_size()}))


def main(argv=None):
    """Run the CLI; returns the trainer and, in test mode, the metrics (in
    the process that spawned `--dp` ranks: (None, None))."""
    args = parse_args(argv)
    from ..parallel import launch

    torchrun = launch.launched_by_torchrun()
    dp = int(os.environ["WORLD_SIZE"]) if torchrun else args.dp
    if dp > 1 and args.batch_size % dp:
        raise ValueError(f"--batch_size {args.batch_size} does not split over {dp} "
                         "data-parallel ranks")

    if torchrun:
        import torch.distributed as dist

        from ..parallel import make_mesh

        if args.dp not in (0, dp):
            raise ValueError(f"--dp {args.dp} under torchrun's {dp} ranks")
        device = launch.init_from_env(args.device)
        try:
            return run(args, device, make_mesh({"dp": dp}))
        finally:
            dist.destroy_process_group()
    if args.dp > 1:
        # the ranks share this process's intra-op threads
        threads = max(1, torch.get_num_threads() // args.dp)
        launch.spawn(_rank, args.dp, args, device=args.device, threads=threads)
        return None, None
    return run(args)
