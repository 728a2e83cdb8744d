"""Training harness: epochs, multi-step LR, eval metrics, checkpointing
(counterpart of the JAX package's train/trainer.py), with the reference
train_whu.py's behaviour: RMSprop + MultiStepLR ("10,12,14:2" style), a
checkpoint per epoch with the validation abs-error in its name, resume
from the newest checkpoint, metric logging per step.

The Trainer runs on the card unless the caller asks for the CPU
(`device="cpu"`); without a CUDA device it raises rather than fall back.
On the card TF32 is off (float32 convolutions and matmuls), as in the
pipeline's dense matching.

With a mesh (parallel.make_mesh, one process a rank) every rank builds
the same Trainer: the step is the sharded one (parallel/train_step.py),
the batches it is handed are the rank's dp share of each global batch,
`init` broadcasts rank 0's weights, `resume` loads on every rank, the
evaluation runs every validation batch on every rank (the metrics are the
same everywhere), and rank 0 alone prints and writes checkpoints,
train_record.txt and the TensorBoard events.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from ..parallel.context import use_mesh
from ..parallel.sharding import replicated
from ..pipeline.orchestrator import resolve_device
from ..weights import init_random_weights
from . import checkpoint as ckpt
from .losses import resize_to
from .metrics import abs_depth_error, interval_accuracy
from .optim import make_optimizer
from .step import make_train_step


def parse_lr_epochs(spec: str) -> tuple:
    """'10,12,14:2' -> (milestones=(10,12,14), gamma=1/2) -- the reference's
    lr-epochs syntax (train_whu.py:160-163)."""
    steps, downscale = spec.split(":")
    milestones = tuple(int(s) for s in steps.split(","))
    return milestones, 1.0 / float(downscale)


@dataclasses.dataclass
class TrainerConfig:
    lr: float = 0.001
    lr_epochs: str = "10,12,14:2"
    epochs: int = 16
    batch_size: int = 1
    min_interval: float = 0.1
    ckpt_dir: str = "checkpoints"
    log_every: int = 50
    optimizer: str = "rmsprop"
    # stabilizers (train/optim.py): 0 disables
    clip_norm: float = 0.0
    warmup_steps: int = 0
    pair_weight: float = 1.0
    stage_weights: Sequence[float] = (0.5, 1.0, 2.0)
    # TensorBoard-compatible event logging every `log_every` steps; None
    # disables. Events + a scalars.jsonl mirror land in <ckpt_dir>/tb.
    tb_logdir: Optional[str] = "auto"


class Trainer:
    def __init__(self, model: torch.nn.Module, cfg: TrainerConfig,
                 steps_per_epoch: int = 1000, mesh=None,
                 device: "str | torch.device" = "cuda"):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.is_main = mesh is None or mesh.rank == 0
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.model = model.to(self.device)
        self.cfg = cfg
        milestones, gamma = parse_lr_epochs(cfg.lr_epochs)
        self.optimizer = make_optimizer(
            self.model.named_parameters(), cfg.lr,
            milestones=[m * steps_per_epoch for m in milestones], gamma=gamma,
            kind=cfg.optimizer, clip_norm=cfg.clip_norm,
            warmup_steps=cfg.warmup_steps)
        self.step_fn = make_train_step(
            self.model, self.optimizer, stage_weights=cfg.stage_weights,
            pair_weight=cfg.pair_weight, mesh=mesh)
        self.initialized = False
        self.epoch = 0
        self.global_step = 0
        self._writer = None

    @property
    def writer(self):
        if self._writer is None and self.cfg.tb_logdir is not None:
            from .tb_writer import EventWriter

            logdir = (os.path.join(self.cfg.ckpt_dir, "tb")
                      if self.cfg.tb_logdir == "auto" else self.cfg.tb_logdir)
            self._writer = EventWriter(logdir)
        return self._writer

    def init(self, seed: int = 0):
        """Seeded random weights (weights.init_random_weights) and a fresh
        optimizer state."""
        init_random_weights(self.model, seed)
        if self.mesh is not None:
            replicated(self.model, self.mesh)
        self.optimizer.reset()
        self.initialized = True

    def resume(self) -> bool:
        """Restore the newest checkpoint under ckpt_dir: parameters,
        optimizer state, and the epoch after its own."""
        path = ckpt.latest_checkpoint(self.cfg.ckpt_dir)
        if path is None:
            return False
        state = ckpt.restore_checkpoint(path, self.model, self.optimizer)
        self.initialized = True
        self.epoch = int(state.get("epoch", 0)) + 1
        return True

    def train_epoch(self, batches: Iterable[Dict[str, np.ndarray]]) -> Dict:
        logs_acc = []
        t0 = time.time()
        self.model.train()
        for step, batch in enumerate(batches):
            if not self.initialized:
                self.init()
            logs = self.step_fn(batch)
            self.global_step += 1
            if step % self.cfg.log_every == 0 and self.is_main:
                print(f"[train] epoch {self.epoch} step {step}: "
                      f"loss={logs['total']:.4f} ({time.time() - t0:.1f}s)",
                      flush=True)
                from .tb_writer import save_scalars

                save_scalars(self.writer, "train", logs, self.global_step)
            logs_acc.append(logs)
        return {k: float(np.mean([l[k] for l in logs_acc]))
                for k in logs_acc[0]} if logs_acc else {}

    @torch.no_grad()
    def evaluate(self, batches: Iterable[Dict[str, np.ndarray]]) -> Dict:
        """Validation metrics: outlier-capped abs error + <1/<3/<6 interval."""
        self.model.eval()
        with use_mesh(self.mesh) if self.mesh is not None else contextlib.nullcontext():
            acc = self._evaluate(batches)
        self.model.train()
        return {k: float(np.mean([a[k] for a in acc])) for k in acc[0]} if acc else {}

    def _evaluate(self, batches) -> list:
        iv = self.cfg.min_interval
        acc = []
        for batch in batches:
            for b in range(batch["imgs"].shape[0]):
                def t(key):
                    return torch.as_tensor(np.asarray(batch[key][b]),
                                           dtype=torch.float32, device=self.device)
                out = self.model(t("imgs"), t("rel_projs"),
                                 float(batch["depth_min"][b]),
                                 float(batch["depth_max"][b]))
                gt = t("depth_gt")
                est = resize_to(out["depth"], gt.shape)
                m = t("mask") > 0.5
                r = {"abs_error": abs_depth_error(est, gt, m, iv),
                     "acc_1": interval_accuracy(est, gt, m, 1.0, iv),
                     "acc_3": interval_accuracy(est, gt, m, 3.0, iv),
                     "acc_6": interval_accuracy(est, gt, m, 6.0, iv)}
                acc.append({k: float(v) for k, v in r.items()})
        return acc

    def fit(self, train_batches_fn: Callable[[], Iterable],
            val_batches_fn: Optional[Callable[[], Iterable]] = None):
        os.makedirs(self.cfg.ckpt_dir, exist_ok=True)
        record_path = os.path.join(self.cfg.ckpt_dir, "train_record.txt")
        for epoch in range(self.epoch, self.cfg.epochs):
            self.epoch = epoch
            train_logs = self.train_epoch(train_batches_fn())
            abs_err = None
            val = {}
            if val_batches_fn is not None:
                val = self.evaluate(val_batches_fn())
                abs_err = val.get("abs_error")
                if self.is_main:
                    print(f"[eval] epoch {epoch}: {val}", flush=True)
                    from .tb_writer import save_scalars

                    save_scalars(self.writer, "test", val, self.global_step)
            if self.is_main:
                ckpt.save_checkpoint(self.cfg.ckpt_dir, epoch, self.model,
                                     self.optimizer, abs_err)
                # per-epoch append log (the reference's train_record.txt)
                with open(record_path, "a") as f:
                    f.write(f"epoch {epoch} train {train_logs} val {val}\n")
        return self.model
