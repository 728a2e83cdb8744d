"""Training CLI: python -m deep3d_aerial_tpu_torch.train --data_folder D
[--gt_format pfm] [--device cuda|cpu] ...

The JAX package's train CLI with the same flags (modes train/test, the
model zoo switch, the lr schedule spec, resume, checkpoints) plus
`--device`: the default is cuda and raises when there is no CUDA device;
`--device cpu` trains on the CPU (the kernels' plain versions). `--dp` > 1
(data-parallel devices) raises NotImplementedError: ROADMAP A.10.
"""

import argparse


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


def build(args):
    """(trainer, train dataset, val dataset or None) as the CLI sets them up."""
    if args.dp > 1:
        raise NotImplementedError(
            f"--dp {args.dp}: data-parallel training is not ported yet "
            "(ROADMAP A.10, multi-GPU)")
    from ..models import build_model
    from ..pipeline.orchestrator import resolve_device
    from .dataset_whu import WHUOMVSDataset
    from .trainer import Trainer, TrainerConfig

    device = resolve_device(args.device)
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
    print(f"train samples: {len(train_ds)}"
          + (f", val samples: {len(val_ds)}" if val_ds else ""), flush=True)
    cfg = TrainerConfig(
        lr=args.lr, lr_epochs=args.lrepochs, epochs=args.epochs,
        batch_size=args.batch_size, min_interval=args.min_interval,
        ckpt_dir=args.logdir, optimizer=args.optimizer,
        pair_weight=1.0 if args.model == "adamvs" else 0.0,
    )
    steps = max(1, len(train_ds) // args.batch_size)
    trainer = Trainer(model, cfg, steps_per_epoch=steps, device=device)
    return trainer, train_ds, val_ds


def main(argv=None):
    """Run the CLI; returns the trainer and, in test mode, the metrics."""
    args = parse_args(argv)
    trainer, train_ds, val_ds = build(args)
    if args.resume:
        resumed = trainer.resume()
        print(f"resume: {'ok, epoch ' + str(trainer.epoch) if resumed else 'no checkpoint'}",
              flush=True)

    if args.mode == "train":
        trainer.fit(
            lambda: train_ds.batches(args.batch_size, shuffle=True),
            (lambda: val_ds.batches(args.batch_size, shuffle=False))
            if val_ds else None,
        )
        return trainer, None
    if not trainer.initialized:
        raise SystemExit("test mode requires --resume with a checkpoint")
    metrics = trainer.evaluate(val_ds.batches(args.batch_size, shuffle=False)
                               if val_ds else
                               train_ds.batches(args.batch_size, shuffle=False))
    print(metrics, flush=True)
    return trainer, metrics


if __name__ == "__main__":
    main()
